"""Vision datasets: `MNIST`, `FashionMNIST`, `Cifar10`, `Cifar100`,
`Flowers`, `VOC2012`, `DatasetFolder`, `ImageFolder` and
`default_loader`, the counterparts of
`paddle_tpu/vision/datasets/__init__.py`.

The idx-ubyte files (MNIST) and the python-pickle tar.gz (CIFAR) are
read from paths that exist; nothing is downloaded. Without a file, the
synthetic fallback (`set_synthetic_fallback(True)` or
`PTPU_SYNTHETIC_DATA=1`) gives the JAX package's label-dependent
synthetic images bit for bit (`_synth_images`, seeds 42 / 43 for MNIST
and 44 / 45 for CIFAR, 1024 train and 256 test images); without it a
missing file raises `FileNotFoundError`; `Flowers` (seed 46) and
`VOC2012` (seed 47) fall back the same way. A sample is (HWC uint8
image, int64 label), the image through `transform` when one is given.
Folder trees of `.npy` files need no PIL; PIL is imported only inside
the loader of an image file.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "VOC2012", "DatasetFolder", "ImageFolder", "default_loader",
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


class Flowers(_VisionDataset):
    """Flowers-102: per-image jpgs and .mat labels, which are not read
    here (a real archive raises, as in JAX: read the extracted tree with
    `ImageFolder`); the synthetic fallback gives JAX's 64 x 64 RGB
    images, 102 classes (256 train, 64 valid / test, seed 46)."""

    NUM_CLASSES = 102

    def __init__(self, data_file: Optional[str] = None,
                 label_file: Optional[str] = None,
                 setid_file: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = True, backend="cv2"):
        super().__init__(transform, backend)
        if mode not in ("train", "valid", "test"):
            raise ValueError(f"mode must be 'train', 'valid' or 'test', "
                             f"got {mode!r}")
        self.mode = mode
        if data_file and os.path.exists(data_file):
            raise NotImplementedError(
                "real Flowers-102 archives need scipy.io loadmat parsing of "
                "the label .mat; use ImageFolder over the extracted tree")
        _missing("Flowers", data_file)
        n = 256 if mode == "train" else 64
        self.images, self.labels = _synth_images(
            n, (64, 64, 3), self.NUM_CLASSES, seed=46)


class VOC2012(_VisionDataset):
    """PASCAL VOC 2012 segmentation pairs: the ImageSets/Segmentation
    list of the mode, read from the trainval tar or an extracted
    `VOCdevkit/VOC2012` tree, yields (image, label mask); the synthetic
    fallback gives JAX's seeded (image, mask) pairs, 21 classes. PIL is
    imported only to read a real image or mask."""

    NUM_CLASSES = 21
    # the reference's MODE_FLAG_MAP (voc2012.py): train reads trainval
    _LISTS = {"train": "trainval.txt", "valid": "val.txt",
              "test": "train.txt"}
    _PREFIX = "VOCdevkit/VOC2012/"

    def __init__(self, data_file: Optional[str] = None,
                 mode: str = "train", transform=None,
                 download: bool = True, backend="cv2"):
        super().__init__(transform, backend)
        if mode not in self._LISTS:
            raise ValueError(f"mode must be one of {sorted(self._LISTS)}, "
                             f"got {mode!r}")
        self.mode = mode
        self._tar_path = None
        self._tls = None
        self._root = None
        self._names: List[str] = []
        if data_file and os.path.exists(data_file):
            if os.path.isdir(data_file):
                self._root = data_file
                lst = os.path.join(data_file, "ImageSets", "Segmentation",
                                   self._LISTS[mode])
                with open(lst) as f:
                    self._names = [ln.strip() for ln in f if ln.strip()]
            else:
                self._tar_path = data_file
                lst = (self._PREFIX + "ImageSets/Segmentation/"
                       + self._LISTS[mode])
                with tarfile.open(data_file) as tf:
                    self._names = [
                        ln.strip() for ln in
                        tf.extractfile(lst).read().decode().split("\n")
                        if ln.strip()]
        else:
            _missing("VOC2012", data_file)
            n = 64 if mode == "train" else 16
            rng = np.random.RandomState(47)
            self._synth_imgs = rng.randint(
                0, 255, (n, 64, 64, 3)).astype(np.uint8)
            masks = rng.randint(0, self.NUM_CLASSES, (n, 64, 64))
            self._synth_masks = masks.astype(np.int64)
            self._names = [str(i) for i in range(n)]

    def _get_tar(self):
        """Per-thread TarFile: DataLoader thread workers each get their
        own handle (a shared handle seeks concurrently → corrupt reads);
        process workers re-open after pickling (see __getstate__)."""
        if self._tls is None:
            self._tls = threading.local()
        tf = getattr(self._tls, "tar", None)
        if tf is None:
            tf = tarfile.open(self._tar_path)
            self._tls.tar = tf
        return tf

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_tls"] = None  # handles don't pickle; workers re-open
        return state

    def _load_pair(self, name):
        if self._root is not None:
            img = default_loader(os.path.join(self._root, "JPEGImages",
                                              name + ".jpg"))
            from PIL import Image
            with Image.open(os.path.join(self._root, "SegmentationClass",
                                         name + ".png")) as m:
                mask = np.asarray(m, dtype=np.int64)
            return img, mask
        if self._tar_path is not None:
            import io as _io
            from PIL import Image
            tf = self._get_tar()
            jf = tf.extractfile(
                self._PREFIX + "JPEGImages/" + name + ".jpg").read()
            mf = tf.extractfile(
                self._PREFIX + "SegmentationClass/" + name + ".png").read()
            with Image.open(_io.BytesIO(jf)) as im:
                img = np.asarray(im.convert("RGB"))
            with Image.open(_io.BytesIO(mf)) as m:
                mask = np.asarray(m, dtype=np.int64)
            return img, mask
        i = int(name)
        return self._synth_imgs[i], self._synth_masks[i]

    def __getitem__(self, idx):
        img, mask = self._load_pair(self._names[idx])
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self._names)


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp", ".npy")


def default_loader(path: str) -> np.ndarray:
    """An `.npy` file as its array; another image file as RGB HWC uint8
    through PIL (imported only here)."""
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class DatasetFolder(_VisionDataset):
    """A tree of class directories → (image, class index), classes in
    sorted order, files walked in sorted order."""

    def __init__(self, root: str, loader: Optional[Callable] = None,
                 extensions: Sequence[str] = IMG_EXTENSIONS,
                 transform=None, is_valid_file: Optional[Callable] = None):
        super().__init__(transform)
        self.root = root
        self.loader = loader or default_loader
        classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        if not classes:
            raise ValueError(f"no class directories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fn in sorted(files):
                    path = os.path.join(dirpath, fn)
                    ok = (is_valid_file(path) if is_valid_file
                          else fn.lower().endswith(tuple(extensions)))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no images under {root}")

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        return self._out(self.loader(path), label)

    def __len__(self):
        return len(self.samples)


class ImageFolder(_VisionDataset):
    """A folder of images, no labels: each sample is (image,)."""

    def __init__(self, root: str, loader: Optional[Callable] = None,
                 extensions: Sequence[str] = IMG_EXTENSIONS,
                 transform=None, is_valid_file: Optional[Callable] = None):
        super().__init__(transform)
        self.root = root
        self.loader = loader or default_loader
        self.samples: List[str] = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                path = os.path.join(dirpath, fn)
                ok = (is_valid_file(path) if is_valid_file
                      else fn.lower().endswith(tuple(extensions)))
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise ValueError(f"no images under {root}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return (img,)

    def __len__(self):
        return len(self.samples)
