"""The ops' shared input and output rules.

Inputs: a tensor stays on its device; a numpy array, a list or a Python
scalar goes to the default device (`core.default_device()`) with the
reference's dtypes (64-bit canonicalised to 32-bit, a Python float as
fp32, an int as int32). In a binary op a Python scalar is weak, as in
JAX: it takes the other operand's dtype within its kind.

Outputs: the JAX package runs with x64 off, so no result of it is
64-bit; torch returns int64 indices and counts, which `out` casts to
int32 (and any other 64-bit dtype to its 32-bit twin).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .. import core


def dev() -> torch.device:
    """The default device (raises for "cuda" without a card)."""
    return core.resolve_device(None)


def a(x, device=None) -> torch.Tensor:
    """`x` as a tensor: a tensor as it is, host data on `device` (the
    default device for None) in the reference's dtype."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)) and any(isinstance(v, torch.Tensor)
                                            for v in x):
        return torch.stack([a(v, device) for v in x])
    device = dev() if device is None else device
    if isinstance(x, bool):
        return torch.tensor(x, device=device)
    if isinstance(x, numbers.Integral):
        return torch.tensor(int(x), dtype=torch.int32, device=device)
    if isinstance(x, numbers.Real):
        return torch.tensor(float(x), dtype=core.get_default_dtype(),
                            device=device)
    if isinstance(x, numbers.Complex):
        return torch.tensor(complex(x), dtype=torch.complex64,
                            device=device)
    t = core.host_tensor(np.asarray(x))
    return t.to(device=device, dtype=core.canonical_dtype(t.dtype))


def pair(x, y):
    """Both operands of a binary op as tensors on one device and of one
    dtype (JAX's promotion), a Python scalar weak-typed against the
    tensor (it takes the tensor's dtype when both are of one kind, as
    JAX's weak types do)."""
    xs, ys = isinstance(x, numbers.Number), isinstance(y, numbers.Number)
    if xs and not ys:
        y = a(y)
        return _weak(x, y), y
    if ys and not xs:
        x = a(x)
        return x, _weak(y, x)
    if isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        y = a(y, x.device)
    elif isinstance(y, torch.Tensor) and not isinstance(x, torch.Tensor):
        x = a(x, y.device)
    else:
        x, y = a(x), a(y)
    if x.dtype != y.dtype:
        # JAX promotes arrays of any rank (torch's products do not)
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return x, y


def _weak(s, t: torch.Tensor) -> torch.Tensor:
    dtype = core.canonical_dtype(torch.result_type(t, s))
    return torch.tensor(s, dtype=dtype, device=t.device)


def out(t):
    """A result (a tensor, or a tuple / list of them) with every 64-bit
    dtype cast to its 32-bit twin."""
    if isinstance(t, torch.Tensor):
        d = core.canonical_dtype(t.dtype)
        return t if d == t.dtype else t.to(d)
    if isinstance(t, (tuple, list)):
        return type(t)(out(v) for v in t)
    return t


def floating(x: torch.Tensor) -> torch.Tensor:
    """`x` cast to the default float dtype if it is not floating (or
    complex): the reference's mean / var / logsumexp of an integer
    tensor are floats."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(core.get_default_dtype())


def dims(axis, ndim: int):
    """An axis spec (None, an int, a list) as a tuple of axes in [0,
    ndim), None meaning all."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(v) % max(ndim, 1) for v in axis)
    return (int(axis) % max(ndim, 1),)


def shape_of(shape):
    """A shape spec (an int, a list, a tuple, a tensor) as a tuple."""
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, numbers.Integral):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def long(index) -> torch.Tensor:
    """An index tensor as int64, the dtype torch's indexing takes."""
    return a(index).long()
