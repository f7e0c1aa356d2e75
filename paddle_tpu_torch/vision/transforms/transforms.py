"""Composable image transforms: the counterparts of every transform of
`paddle_tpu/vision/transforms/transforms.py` (`Compose`,
`BaseTransform`, `ToTensor`, `Resize`, `RandomResizedCrop`,
`CenterCrop`, `RandomHorizontalFlip`, `RandomVerticalFlip`,
`Normalize`, `Transpose`, `BrightnessTransform`, `ContrastTransform`,
`SaturationTransform`, `HueTransform`, `ColorJitter`, `RandomCrop`,
`Pad`, `RandomRotation`, `Grayscale`, `RandomErasing`), callables on
HWC numpy images (a (image, label) pair passes its label through).

Randomness. The JAX package draws from one module-level stream that
follows `paddle_tpu.seed`; the port keeps no global RNG state, so a
random transform takes its seed: an int gives it a stream of its own,
a `SeededRandom` is shared by every transform given it (one stream
across a Compose, as in JAX; a `ColorJitter` hands its stream to its
four parts). Either way the law is JAX's
`_SeededRandom`: per thread, `random.Random((seed · 1000003) ^
(worker_id + 1))`, with worker_id the DataLoader worker's id (-1
outside a worker), so for one seed and worker the draws equal JAX's.
"""
from __future__ import annotations

import random as _random
import threading
from typing import Optional, Sequence, Union

import numpy as np

from . import functional as F

__all__ = ["SeededRandom", "Compose", "BaseTransform", "ToTensor", "Resize",
           "RandomResizedCrop", "CenterCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "Normalize", "Transpose",
           "BrightnessTransform", "ContrastTransform", "SaturationTransform",
           "HueTransform", "ColorJitter", "RandomCrop", "Pad",
           "RandomRotation", "Grayscale", "RandomErasing"]


class SeededRandom:
    """A per-thread `random.Random` seeded (seed · 1000003) ^ (worker id +
    1), re-made when the thread's DataLoader worker changes. Pickles
    without its streams, so a spawned worker starts its own."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._tls = threading.local()

    @staticmethod
    def _worker_id() -> int:
        from ...io import get_worker_info
        info = get_worker_info()
        return -1 if info is None else int(info.id)

    def _get(self) -> _random.Random:
        wid = self._worker_id()
        if getattr(self._tls, "wid", None) != wid:
            self._tls.rand = _random.Random(
                (self.seed * 1000003) ^ (wid + 1))
            self._tls.wid = wid
        return self._tls.rand

    def __getstate__(self):
        return {"seed": self.seed}

    def __setstate__(self, state):
        self.seed = state["seed"]
        self._tls = threading.local()

    def random(self):
        return self._get().random()

    def uniform(self, a, b):
        return self._get().uniform(a, b)

    def randint(self, a, b):
        return self._get().randint(a, b)

    def shuffle(self, x):
        return self._get().shuffle(x)


def _stream(seed: Union[int, SeededRandom]) -> SeededRandom:
    return seed if isinstance(seed, SeededRandom) else SeededRandom(seed)


class Compose:
    """Apply the transforms in order."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        return f"Compose([{', '.join(repr(t) for t in self.transforms)}])"


class BaseTransform:
    """Subclasses implement `_apply_image` (and `_apply_label`); a
    (image, label) pair maps both."""

    def __init__(self, keys: Optional[Sequence[str]] = None):
        self.keys = keys

    def _apply_image(self, img):
        raise NotImplementedError

    def _apply_label(self, label):
        return label

    def __call__(self, data):
        if isinstance(data, tuple) and len(data) == 2:
            img, label = data
            return self._apply_image(img), self._apply_label(label)
        return self._apply_image(data)

    def __repr__(self):
        return f"{type(self).__name__}()"


class ToTensor(BaseTransform):
    """uint8 HWC [0, 255] → float32 [0, 1], CHW by default (a numpy
    array: the DataLoader makes the tensor)."""

    def __init__(self, data_format: str = "CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation: str = "bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class RandomResizedCrop(BaseTransform):
    """A random area / aspect crop, then a resize (the Inception-style
    training augmentation)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation: str = "bilinear", keys=None,
                 seed: Union[int, SeededRandom] = 0):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation
        self.random = _stream(seed)

    def _sample(self, h, w):
        area = h * w
        for _ in range(10):
            target = area * self.random.uniform(*self.scale)
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            ar = np.exp(self.random.uniform(*log_ratio))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = self.random.randint(0, h - ch)
                left = self.random.randint(0, w - cw)
                return top, left, ch, cw
        # fallback: the centred square
        ch, cw = min(h, w), min(h, w)
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def _apply_image(self, img):
        a = np.asarray(img)
        h, w = a.shape[:2]
        top, left, ch, cw = self._sample(h, w)
        return F.resize(F.crop(a, top, left, ch, cw), self.size,
                        self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None,
                 seed: Union[int, SeededRandom] = 0):
        super().__init__(keys)
        self.prob = prob
        self.random = _stream(seed)

    def _apply_image(self, img):
        return F.hflip(img) if self.random.random() < self.prob else img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5, keys=None,
                 seed: Union[int, SeededRandom] = 0):
        super().__init__(keys)
        self.prob = prob
        self.random = _stream(seed)

    def _apply_image(self, img):
        return F.vflip(img) if self.random.random() < self.prob else img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format: str = "CHW",
                 to_rgb: bool = False, keys=None):
        super().__init__(keys)
        self.mean = mean if not np.isscalar(mean) else [mean] * 3
        self.std = std if not np.isscalar(std) else [std] * 3
        self.data_format = data_format

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = tuple(order)

    def _apply_image(self, img):
        a = np.asarray(img)
        if a.ndim == 2:
            a = a[:, :, None]
        return np.transpose(a, self.order)


class _Jitter(BaseTransform):
    """A factor drawn uniformly from [max(0, 1 - value), 1 + value] (no
    draw at value 0), then `_adjust`."""

    def __init__(self, value: float, keys=None,
                 seed: Union[int, SeededRandom] = 0):
        super().__init__(keys)
        self.value = value
        self.random = _stream(seed)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = self.random.uniform(max(0, 1 - self.value),
                                     1 + self.value)
        return type(self)._adjust(img, factor)


class BrightnessTransform(_Jitter):
    _adjust = staticmethod(F.adjust_brightness)


class ContrastTransform(_Jitter):
    _adjust = staticmethod(F.adjust_contrast)

    def __init__(self, value: float, keys=None,
                 seed: Union[int, SeededRandom] = 0):
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        super().__init__(value, keys, seed)


class SaturationTransform(_Jitter):
    _adjust = staticmethod(F.adjust_saturation)


class HueTransform(BaseTransform):
    def __init__(self, value: float, keys=None,
                 seed: Union[int, SeededRandom] = 0):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = value
        self.random = _stream(seed)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return F.adjust_hue(img, self.random.uniform(-self.value,
                                                     self.value))


class ColorJitter(BaseTransform):
    """Brightness, contrast, saturation and hue in a shuffled order, all
    four drawing from this transform's stream."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None, seed: Union[int, SeededRandom] = 0):
        super().__init__(keys)
        self.random = _stream(seed)
        self.ops = [BrightnessTransform(brightness, seed=self.random),
                    ContrastTransform(contrast, seed=self.random),
                    SaturationTransform(saturation, seed=self.random),
                    HueTransform(hue, seed=self.random)]

    def _apply_image(self, img):
        order = list(range(4))
        self.random.shuffle(order)
        for i in order:
            img = self.ops[i]._apply_image(img)
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed: bool = False,
                 fill=0, padding_mode: str = "constant", keys=None,
                 seed: Union[int, SeededRandom] = 0):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode
        self.random = _stream(seed)

    def _apply_image(self, img):
        a = np.asarray(img)
        if self.padding is not None:
            a = F.pad(a, self.padding, self.fill, self.padding_mode)
        h, w = a.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            a = F.pad(a, (max(0, tw - w), max(0, th - h)), self.fill,
                      self.padding_mode)
            h, w = a.shape[:2]
        if h == th and w == tw:
            return a
        top = self.random.randint(0, h - th)
        left = self.random.randint(0, w - tw)
        return F.crop(a, top, left, th, tw)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode: str = "constant",
                 keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation: str = "nearest",
                 expand: bool = False, center=None, fill=0, keys=None,
                 seed: Union[int, SeededRandom] = 0):
        super().__init__(keys)
        if np.isscalar(degrees):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            self.degrees = (-degrees, degrees)
        else:
            self.degrees = tuple(degrees)
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill
        self.random = _stream(seed)

    def _apply_image(self, img):
        angle = self.random.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, self.expand,
                        self.center, self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels: int = 1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class RandomErasing(BaseTransform):
    """A random cutout, on an HWC or a CHW image."""

    def __init__(self, prob: float = 0.5, scale=(0.02, 0.33),
                 ratio=(0.3, 3.3), value=0, inplace: bool = False,
                 keys=None, seed: Union[int, SeededRandom] = 0):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace
        self.random = _stream(seed)

    def _apply_image(self, img):
        if self.random.random() >= self.prob:
            return img
        a = np.asarray(img)
        chw = a.ndim == 3 and a.shape[0] in (1, 3) \
            and a.shape[2] not in (1, 3)
        if chw:
            a = np.transpose(a, (1, 2, 0))
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * self.random.uniform(*self.scale)
            ar = self.random.uniform(*self.ratio)
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                top = self.random.randint(0, h - eh)
                left = self.random.randint(0, w - ew)
                a = F.erase(a, top, left, eh, ew, self.value,
                            inplace=False)
                break
        if chw:
            a = np.transpose(a, (2, 0, 1))
        return a
