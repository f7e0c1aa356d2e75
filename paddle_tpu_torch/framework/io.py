"""State-dict files: numpy's own pickle of a {name: array} dict.

The counterpart of `paddle_tpu/framework/io.py`'s `save` / `load` for
the shapes the port stores: a flat dict of arrays (the serving
artifact), or a nest of dicts of arrays and Python ints (a Trainer's
state, `framework.auto_checkpoint`). The
file unpickles to what numpy's pickle of such a dict holds (each array
reduced through `numpy.ndarray`'s `_reconstruct`, bfloat16 as
`ml_dtypes.bfloat16`, the JAX package's dtype), so either package reads
the other's files. The port reads and writes it without numpy's
bfloat16 extension (which needs `ml_dtypes`):

- `save` emits the pickle opcodes itself;
- `load` is a RESTRICTED unpickler: it resolves only the names such a
  file references (numpy's array and dtype reconstruction, the
  bfloat16 type, `collections.OrderedDict`) and refuses any other, so
  it runs no code from the file. Arrays come back as CPU tensors.
  `PTPU_FORBID_PICKLE=1` refuses every load, as the reference's does.
"""
from __future__ import annotations

import collections
import os
import pickle
import struct
from typing import Dict

import numpy as np
import torch

__all__ = ["save", "load"]

_BF16_STATE = (3, "<", None, None, None, 2, 2, 64)   # numpy's, for
# ml_dtypes.bfloat16
_NUMPY_DTYPES = {torch.float32: "f4", torch.float16: "f2",
                 torch.float64: "f8", torch.int8: "i1", torch.uint8: "u1",
                 torch.int16: "i2", torch.int32: "i4", torch.int64: "i8",
                 torch.bool: "b1"}


def _reconstruct_name():
    """Where this numpy keeps `_reconstruct` ('numpy._core.multiarray'
    from numpy 2, 'numpy.core.multiarray' before), as numpy's own
    pickles name it."""
    fn = np.zeros(1).__reduce__()[0]
    return fn.__module__, fn.__name__


class _Writer:
    def __init__(self, f):
        self.f = f

    def op(self, code: bytes, payload: bytes = b""):
        self.f.write(code + payload)

    def glob(self, module: str, name: str):
        self.op(pickle.GLOBAL, f"{module}\n{name}\n".encode())

    def int(self, v: int):
        if 0 <= v < 256:
            self.op(pickle.BININT1, bytes([v]))
        else:
            self.op(pickle.BININT, struct.pack("<i", v))

    def str(self, s: str):
        b = s.encode("utf-8")
        if len(b) < 256:
            self.op(pickle.SHORT_BINUNICODE, bytes([len(b)]) + b)
        else:
            self.op(pickle.BINUNICODE, struct.pack("<I", len(b)) + b)

    def bytes(self, b):
        if len(b) < 256:
            self.op(pickle.SHORT_BINBYTES, bytes([len(b)]) + bytes(b))
        elif len(b) < 2 ** 32:
            self.op(pickle.BINBYTES, struct.pack("<I", len(b)))
            self.f.write(b)
        else:
            self.op(pickle.BINBYTES8, struct.pack("<Q", len(b)))
            self.f.write(b)

    def dtype(self, t: torch.Tensor):
        self.glob("numpy", "dtype")
        if t.dtype == torch.bfloat16:
            self.glob("ml_dtypes", "bfloat16")
            state = _BF16_STATE
        else:
            spec = _NUMPY_DTYPES.get(t.dtype)
            if spec is None:
                raise TypeError(f"cannot store dtype {t.dtype}")
            dt = np.dtype(spec)
            _, (spec, _, _), state = dt.__reduce__()
            self.str(spec)
        self.op(pickle.NEWFALSE)
        self.op(pickle.NEWTRUE)
        self.op(pickle.TUPLE3)
        self.op(pickle.REDUCE)
        self.op(pickle.MARK)
        for v in state:
            if v is None:
                self.op(pickle.NONE)
            elif isinstance(v, str):
                self.str(v)
            else:
                self.int(v)
        self.op(pickle.TUPLE)
        self.op(pickle.BUILD)

    def value(self, v, recon, where="state"):
        """A nest of dicts (string keys) of tensors and Python ints, as
        pickle writes it (no memo)."""
        if isinstance(v, torch.Tensor):
            self.array(v, recon)
        elif isinstance(v, dict):
            self.op(pickle.EMPTY_DICT)
            if v:
                self.op(pickle.MARK)
                for k, x in v.items():
                    self.str(str(k))
                    self.value(x, recon, f"{where}[{k!r}]")
                self.op(pickle.SETITEMS)
        elif isinstance(v, int) and -2 ** 31 <= v < 2 ** 31:
            self.op(pickle.BININT, struct.pack("<i", v))
        else:
            raise TypeError(f"{where}: cannot store a {type(v).__name__}")

    def array(self, t: torch.Tensor, recon):
        t = t.detach().cpu().contiguous()
        self.glob(*recon)
        self.glob("numpy", "ndarray")
        self.int(0)
        self.op(pickle.TUPLE1)
        self.bytes(b"b")
        self.op(pickle.TUPLE3)
        self.op(pickle.REDUCE)
        self.op(pickle.MARK)
        self.int(1)
        self.op(pickle.MARK)
        for d in t.shape:
            self.int(int(d))
        self.op(pickle.TUPLE)
        self.dtype(t)
        self.op(pickle.NEWFALSE)                        # C order
        raw = t.reshape(-1).view(torch.uint8) if t.dtype != torch.bool \
            else t.reshape(-1).to(torch.uint8)
        self.bytes(memoryview(raw.numpy()))
        self.op(pickle.TUPLE)
        self.op(pickle.BUILD)


def save(state: Dict[str, object], path: str):
    """Write a dict of tensors (or a nest of dicts of tensors and Python
    ints: a Trainer's state) as numpy's pickle of the matching dict of
    arrays (protocol 4)."""
    if not isinstance(state, dict):
        raise TypeError(f"a state is a dict, not a {type(state).__name__}")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    recon = _reconstruct_name()
    with open(path, "wb") as f:
        w = _Writer(f)
        w.op(pickle.PROTO, bytes([4]))
        w.value(state, recon)
        w.op(pickle.STOP)


class _BF16:
    """Stands in for `ml_dtypes.bfloat16` while loading."""


class _DType:
    """Stands in for a `numpy.dtype` while loading: the type argument,
    and the byte order from the dtype's state."""

    def __init__(self, spec, align=False, copy=True):
        self.spec = spec
        self.order = "<"

    def __setstate__(self, state):
        self.order = state[1]


class _Array:
    """Stands in for a `numpy.ndarray` while loading: its state (shape,
    dtype, order, raw bytes) becomes a CPU tensor after the load."""

    def __setstate__(self, state):
        _, self.shape, self.dtype, self.fortran, self.raw = state

    def tensor(self) -> torch.Tensor:
        if not isinstance(self.raw, (bytes, bytearray)):
            raise pickle.UnpicklingError("object arrays are not data")
        shape = tuple(int(d) for d in self.shape)
        order = "F" if self.fortran else "C"
        if self.dtype.spec is _BF16:
            a = np.frombuffer(self.raw, "<i2").reshape(shape, order=order)
            return torch.from_numpy(np.array(a, order="C")).view(
                torch.bfloat16)
        dt = np.dtype(self.dtype.spec)
        if self.dtype.order in "<>":
            dt = dt.newbyteorder(self.dtype.order)
        a = np.frombuffer(self.raw, dt).reshape(shape, order=order)
        # a writable, native-order, C-order copy (0-d stays 0-d)
        return torch.from_numpy(np.array(a, dtype=dt.newbyteorder("="),
                                         order="C"))


def _reconstruct(cls, shape, typecode):
    return _Array()


_ALLOWED = {
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): _DType,
    ("ml_dtypes", "bfloat16"): _BF16,
    ("collections", "OrderedDict"): collections.OrderedDict,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        fn = _ALLOWED.get((module, name))
        if fn is None:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not part of a state-dict file")
        return fn


def _tensors(obj, path, where="state"):
    """The loaded nest with every array a CPU tensor."""
    if isinstance(obj, _Array):
        return obj.tensor()
    if isinstance(obj, dict):
        return {(str(k) if not isinstance(k, (int, str)) else k):
                _tensors(v, path, f"{where}[{k!r}]") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tensors(v, path, where) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise pickle.UnpicklingError(f"{path}: {where} is no array")


def load(path: str) -> Dict[str, object]:
    """Read a dict pickle of arrays (`save`'s, or the JAX package's
    `framework.io.save` of a state dict or of a Trainer's state tree)
    with every array a CPU tensor. Refuses when `PTPU_FORBID_PICKLE=1`
    is set."""
    if os.environ.get("PTPU_FORBID_PICKLE") == "1":
        raise RuntimeError(
            f"refusing pickle load of {path}: PTPU_FORBID_PICKLE=1 is "
            "set. Unset it for trusted checkpoints.")
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    if not isinstance(obj, dict):
        raise pickle.UnpicklingError(
            f"{path}: a {type(obj).__name__}, not a state dict")
    return {str(k): _tensors(v, path, repr(k)) for k, v in obj.items()}
