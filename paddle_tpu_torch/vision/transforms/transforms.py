"""Composable image transforms: the counterparts of `Compose`,
`BaseTransform`, `ToTensor`, `Normalize`, `Transpose`,
`RandomHorizontalFlip`, `RandomCrop`, `Pad`, `CenterCrop` and `Resize`
of `paddle_tpu/vision/transforms/transforms.py`, callables on HWC numpy
images (a (image, label) pair passes its label through).

Randomness. The JAX package draws from one module-level stream that
follows `paddle_tpu.seed`; the port keeps no global RNG state, so a
random transform takes its seed: an int gives it a stream of its own,
a `SeededRandom` is shared by every transform given it (one stream
across a Compose, as in JAX). Either way the law is JAX's
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

__all__ = ["SeededRandom", "Compose", "BaseTransform", "ToTensor",
           "Normalize", "Transpose", "RandomHorizontalFlip", "RandomCrop",
           "Pad", "CenterCrop", "Resize"]


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

    def randint(self, a, b):
        return self._get().randint(a, b)


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
