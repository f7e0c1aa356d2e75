"""Vision datasets: `MNIST`, `FashionMNIST`, `Cifar10` and `Cifar100`,
the counterparts of `paddle_tpu/vision/datasets/__init__.py`.

The idx-ubyte files (MNIST) and the python-pickle tar.gz (CIFAR) are
read from paths that exist; nothing is downloaded. Without a file, the
synthetic fallback (`set_synthetic_fallback(True)` or
`PTPU_SYNTHETIC_DATA=1`) gives the JAX package's label-dependent
synthetic images bit for bit (`_synth_images`, seeds 42 / 43 for MNIST
and 44 / 45 for CIFAR, 1024 train and 256 test images); without it a
missing file raises `FileNotFoundError`. A sample is (HWC uint8 image,
int64 label), the image through `transform` when one is given.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional, Tuple

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "set_synthetic_fallback", "synthetic_enabled"]

_SYNTHETIC = None  # None: the environment variable decides


def set_synthetic_fallback(flag: bool):
    global _SYNTHETIC
    _SYNTHETIC = bool(flag)


def synthetic_enabled() -> bool:
    if _SYNTHETIC is not None:
        return _SYNTHETIC
    return os.environ.get("PTPU_SYNTHETIC_DATA", "0") not in ("0", "")


def _missing(what: str, path):
    if synthetic_enabled():
        return True
    raise FileNotFoundError(
        f"{what} data not found at {path!r} and nothing is downloaded. "
        "Point data_file / image_path at existing files, or call "
        "paddle_tpu_torch.vision.datasets.set_synthetic_fallback(True) (or "
        "set PTPU_SYNTHETIC_DATA=1) for deterministic synthetic data.")


def _synth_images(n: int, shape: Tuple[int, ...], num_classes: int,
                  seed: int):
    """Label-dependent synthetic images: class k has mean ~ k, so a
    model can fit them."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, (n,)).astype(np.int64)
    base = (labels.astype(np.float32) + 1) * (200.0 / num_classes)
    imgs = rng.randint(0, 56, (n,) + shape).astype(np.float32)
    imgs += base.reshape((n,) + (1,) * len(shape))
    return np.clip(imgs, 0, 255).astype(np.uint8), labels


class _VisionDataset(Dataset):
    def __init__(self, transform: Optional[Callable] = None,
                 backend: str = "cv2"):
        self.transform = transform
        self.backend = backend

    def _out(self, img: np.ndarray, label):
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, dtype=np.int64)

    def __getitem__(self, idx):
        return self._out(self.images[idx], self.labels[idx])

    def __len__(self):
        return len(self.images)


class MNIST(_VisionDataset):
    """idx-ubyte MNIST: 28×28×1 uint8, 10 classes."""

    NUM_CLASSES = 10
    SHAPE = (28, 28, 1)
    _SYNTH_N = {"train": 1024, "test": 256}

    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = True, backend="cv2"):
        super().__init__(transform, backend)
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
        self.mode = mode
        if image_path and os.path.exists(image_path):
            if not (label_path and os.path.exists(label_path)):
                raise ValueError(
                    f"image_path={image_path!r} exists but label_path="
                    f"{label_path!r} does not: both idx files are needed")
            self.images = self._read_images(image_path)
            self.labels = self._read_labels(label_path)
        else:
            _missing(type(self).__name__, image_path)
            self.images, self.labels = _synth_images(
                self._SYNTH_N[mode], self.SHAPE, self.NUM_CLASSES,
                seed=42 if mode == "train" else 43)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") \
            else open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad idx image magic {magic}")
            data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return data.reshape(n, rows, cols, 1)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad idx label magic {magic}")
            return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int64)


class FashionMNIST(MNIST):
    """The same idx format over other files."""


class Cifar10(_VisionDataset):
    """CIFAR-10 from the python-pickle tar.gz: 32×32×3 uint8, 10
    classes."""

    NUM_CLASSES = 10
    SHAPE = (32, 32, 3)
    _SYNTH_N = {"train": 1024, "test": 256}

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = True, backend="cv2"):
        super().__init__(transform, backend)
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
        self.mode = mode
        if data_file and os.path.exists(data_file):
            self.images, self.labels = self._read_tar(data_file, mode)
        else:
            _missing(type(self).__name__, data_file)
            self.images, self.labels = _synth_images(
                self._SYNTH_N[mode], self.SHAPE, self.NUM_CLASSES,
                seed=44 if mode == "train" else 45)

    @staticmethod
    def _member_wanted(name: str, mode: str) -> bool:
        base = os.path.basename(name)
        if mode == "train":
            return base.startswith("data_batch") or base == "train"
        return base.startswith("test_batch") or base == "test"

    def _read_tar(self, path, mode):
        images, labels = [], []
        with tarfile.open(path, "r:*") as tf:
            for m in tf.getmembers():
                if not m.isfile() or not self._member_wanted(m.name, mode):
                    continue
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                lab = d.get(b"labels", d.get(b"fine_labels"))
                images.append(np.asarray(d[b"data"], dtype=np.uint8).reshape(
                    -1, 3, 32, 32).transpose(0, 2, 3, 1))
                labels.append(np.asarray(lab, dtype=np.int64))
        if not images:
            raise ValueError(f"no {mode} batches found in {path}")
        return np.concatenate(images), np.concatenate(labels)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
