"""Functional image ops on host numpy arrays (HWC, uint8 or float): the
subset of `paddle_tpu/vision/transforms/functional.py` that the ported
transforms call (`to_tensor`, `resize`, `crop`, `center_crop`,
`hflip`, `vflip`, `pad`, `normalize`), with the same arithmetic, so an
image gives the same array in both packages. Augmentation is host-side
data-pipeline work; the DataLoader moves the batch to the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["to_tensor", "resize", "crop", "center_crop", "hflip", "vflip",
           "pad", "normalize"]


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


def normalize(img, mean, std, data_format: str = "CHW") -> np.ndarray:
    a = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format.upper() == "CHW":
        shape = (-1, 1, 1)
    else:
        shape = (1, 1, -1)
    return (a - mean.reshape(shape)) / std.reshape(shape)
