"""Functional image ops on host numpy arrays (HWC, uint8 or float): the
counterpart of `paddle_tpu/vision/transforms/functional.py`
(`to_tensor`, `resize`, `crop`, `center_crop`, `hflip`, `vflip`,
`pad`, `rotate`, `to_grayscale`, `normalize`, `adjust_brightness`,
`adjust_contrast`, `adjust_saturation`, `adjust_hue`, `erase`), with
the same arithmetic, so an image gives the same array in both
packages. Augmentation is host-side data-pipeline work; the DataLoader
moves the batch to the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["to_tensor", "resize", "crop", "center_crop", "hflip", "vflip",
           "pad", "rotate", "to_grayscale", "normalize", "adjust_brightness",
           "adjust_contrast", "adjust_saturation", "adjust_hue", "erase"]


def _as_hwc(img) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3:
        raise ValueError(f"expected HW or HWC image, got shape {a.shape}")
    return a


def to_tensor(img, data_format: str = "CHW") -> np.ndarray:
    """uint8 HWC [0,255] → float32 [0,1], CHW by default (reference
    functional.to_tensor semantics)."""
    a = _as_hwc(img)
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    else:
        a = a.astype(np.float32)
    if data_format.upper() == "CHW":
        a = np.transpose(a, (2, 0, 1))
    return a


def _interp_coords(out_size: int, in_size: int) -> Tuple[np.ndarray,
                                                         np.ndarray,
                                                         np.ndarray]:
    # half-pixel-centers bilinear mapping (cv2/PIL 'bilinear' convention)
    x = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size \
        - 0.5
    x = np.clip(x, 0, in_size - 1)
    lo = np.floor(x).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (x - lo).astype(np.float32)
    return lo, hi, frac


def resize(img, size: Union[int, Sequence[int]],
           interpolation: str = "bilinear") -> np.ndarray:
    """Resize HWC. `size` int = shorter-edge (aspect kept), (h, w) = exact."""
    a = _as_hwc(img)
    h, w = a.shape[:2]
    if isinstance(size, (int, np.integer)):
        if h <= w:
            oh, ow = int(size), max(1, int(round(w * size / h)))
        else:
            oh, ow = max(1, int(round(h * size / w))), int(size)
    else:
        oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == (h, w):
        return a.copy()
    if interpolation == "nearest":
        ys = np.minimum((np.arange(oh) * h // oh), h - 1)
        xs = np.minimum((np.arange(ow) * w // ow), w - 1)
        return a[ys][:, xs]
    ylo, yhi, yf = _interp_coords(oh, h)
    xlo, xhi, xf = _interp_coords(ow, w)
    src = a.astype(np.float32)
    top = src[ylo][:, xlo] * (1 - xf)[None, :, None] \
        + src[ylo][:, xhi] * xf[None, :, None]
    bot = src[yhi][:, xlo] * (1 - xf)[None, :, None] \
        + src[yhi][:, xhi] * xf[None, :, None]
    out = top * (1 - yf)[:, None, None] + bot * yf[:, None, None]
    if a.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(a.dtype)
    return out


def crop(img, top: int, left: int, height: int, width: int) -> np.ndarray:
    a = _as_hwc(img)
    return a[top:top + height, left:left + width].copy()


def center_crop(img, output_size: Union[int, Sequence[int]]) -> np.ndarray:
    a = _as_hwc(img)
    if isinstance(output_size, (int, np.integer)):
        oh = ow = int(output_size)
    else:
        oh, ow = output_size
    h, w = a.shape[:2]
    top = max(0, (h - oh) // 2)
    left = max(0, (w - ow) // 2)
    return crop(a, top, left, min(oh, h), min(ow, w))


def hflip(img) -> np.ndarray:
    return _as_hwc(img)[:, ::-1].copy()


def vflip(img) -> np.ndarray:
    return _as_hwc(img)[::-1].copy()


def pad(img, padding: Union[int, Sequence[int]], fill=0,
        padding_mode: str = "constant") -> np.ndarray:
    a = _as_hwc(img)
    if isinstance(padding, (int, np.integer)):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kwargs = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(a, ((pt, pb), (pl, pr), (0, 0)), mode=mode, **kwargs)


def rotate(img, angle: float, interpolation: str = "nearest",
           expand: bool = False, center=None, fill=0) -> np.ndarray:
    """Rotate counter-clockwise by `angle` degrees (inverse-map gather)."""
    a = _as_hwc(img)
    h, w = a.shape[:2]
    theta = np.deg2rad(angle)
    cos, sin = np.cos(theta), np.sin(theta)
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    if expand:
        # round before ceil: cos(90°) ≈ 6e-17 must not bump the canvas
        nw = int(np.ceil(round(abs(w * cos) + abs(h * sin), 6)))
        nh = int(np.ceil(round(abs(h * cos) + abs(w * sin), 6)))
    else:
        nh, nw = h, w
    ys, xs = np.mgrid[0:nh, 0:nw].astype(np.float64)
    ys = ys - (nh - 1) / 2.0
    xs = xs - (nw - 1) / 2.0
    # inverse rotation into source coordinates
    sx = cos * xs - sin * ys + cx
    sy = sin * xs + cos * ys + cy
    six = np.rint(sx).astype(np.int64)
    siy = np.rint(sy).astype(np.int64)
    valid = (six >= 0) & (six < w) & (siy >= 0) & (siy < h)
    out = np.full((nh, nw, a.shape[2]),
                  np.asarray(fill, dtype=a.dtype), dtype=a.dtype)
    out[valid] = a[siy[valid], six[valid]]
    return out


def to_grayscale(img, num_output_channels: int = 1) -> np.ndarray:
    a = _as_hwc(img)
    if a.shape[2] == 1:
        g = a.astype(np.float32)
    else:
        g = (0.299 * a[:, :, 0] + 0.587 * a[:, :, 1]
             + 0.114 * a[:, :, 2]).astype(np.float32)[:, :, None]
    if a.dtype == np.uint8:
        g = np.clip(np.rint(g), 0, 255).astype(np.uint8)
    else:
        g = g.astype(a.dtype)
    return np.repeat(g, num_output_channels, axis=2)


def normalize(img, mean, std, data_format: str = "CHW") -> np.ndarray:
    a = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format.upper() == "CHW":
        shape = (-1, 1, 1)
    else:
        shape = (1, 1, -1)
    return (a - mean.reshape(shape)) / std.reshape(shape)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = a.astype(np.float32) * factor + b.astype(np.float32) * (1 - factor)
    if a.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(a.dtype)


def adjust_brightness(img, factor: float) -> np.ndarray:
    a = _as_hwc(img)
    return _blend(a, np.zeros_like(a), factor)


def adjust_contrast(img, factor: float) -> np.ndarray:
    a = _as_hwc(img)
    mean = to_grayscale(a).astype(np.float32).mean()
    return _blend(a, np.full(a.shape, mean, np.float32), factor)


def adjust_saturation(img, factor: float) -> np.ndarray:
    a = _as_hwc(img)
    gray = to_grayscale(a, num_output_channels=a.shape[2])
    return _blend(a, gray, factor)


def adjust_hue(img, factor: float) -> np.ndarray:
    """factor in [-0.5, 0.5] — shift hue channel in HSV space."""
    if not -0.5 <= factor <= 0.5:
        raise ValueError("hue factor must be in [-0.5, 0.5]")
    a = _as_hwc(img)
    if a.shape[2] == 1:
        return a.copy()
    f = a.astype(np.float32) / (255.0 if a.dtype == np.uint8 else 1.0)
    r, g, b = f[:, :, 0], f[:, :, 1], f[:, :, 2]
    mx, mn = f.max(2), f.min(2)
    diff = mx - mn
    safe = np.where(diff == 0, 1.0, diff)
    h = np.where(mx == r, ((g - b) / safe) % 6,
                 np.where(mx == g, (b - r) / safe + 2, (r - g) / safe + 4))
    h = np.where(diff == 0, 0.0, h) / 6.0
    s = np.where(mx == 0, 0.0, diff / np.where(mx == 0, 1.0, mx))
    v = mx
    h = (h + factor) % 1.0
    i = np.floor(h * 6).astype(np.int64) % 6
    fr = h * 6 - np.floor(h * 6)
    p, q, t = v * (1 - s), v * (1 - fr * s), v * (1 - (1 - fr) * s)
    choices_r = [v, q, p, p, t, v]
    choices_g = [t, v, v, q, p, p]
    choices_b = [p, p, t, v, v, q]
    r2 = np.choose(i, choices_r)
    g2 = np.choose(i, choices_g)
    b2 = np.choose(i, choices_b)
    out = np.stack([r2, g2, b2], axis=2)
    if a.dtype == np.uint8:
        return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)
    return out.astype(a.dtype)


def erase(img, i: int, j: int, h: int, w: int, v, inplace: bool = False
          ) -> np.ndarray:
    a = _as_hwc(img) if not inplace else img
    if not inplace:
        a = a.copy()
    a[i:i + h, j:j + w] = np.asarray(v, dtype=a.dtype)
    return a
