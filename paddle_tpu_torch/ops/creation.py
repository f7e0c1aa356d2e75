"""Tensor creation ops: the counterpart of `paddle_tpu/ops/creation.py`.

Every op places its result on the default device (`core.get_device()`,
set by `set_device`), or on the device of the tensor it is given; the
dtypes are the reference's (64-bit names canonicalised to 32-bit).
The random ops draw from the default generator (`core.
default_generator()`, reproducible under `paddle_tpu_torch.seed`): each
draw seeds a fresh `torch.Generator` on the result's device, so their
streams equal JAX's in law, not in bits. `uniform(seed=s)` with s != 0
draws from its own (s, 0) key, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import core
from ._common import a, dev, out, shape_of

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "diag", "diagflat", "tril", "triu", "meshgrid", "clone", "assign",
    "rand", "randn", "randint", "uniform", "normal", "randperm", "bernoulli",
    "multinomial", "standard_normal", "tril_indices", "triu_indices",
    "one_hot", "complex",
]


def _dt(dtype, default=None):
    d = core.convert_dtype(dtype)
    return d if d is not None else (default or core.get_default_dtype())


def to_tensor(data, dtype=None, stop_gradient: bool = True, place=None):
    """`paddle.to_tensor`: a tensor stays on its device (unless `place`
    names one), host data goes to `place` or the default device; 64-bit
    data becomes 32-bit (a 64-bit `dtype` too). `stop_gradient` is
    accepted for the reference's signature: gradients are functional
    (`autograd`)."""
    device = core.resolve_device(place) if place is not None else None
    t = a(data, device)
    if device is not None:
        t = t.to(device)
    dtype = core.convert_dtype(dtype)
    if dtype is not None:
        t = t.to(dtype)
    return t


def zeros(shape, dtype=None):
    return torch.zeros(shape_of(shape), dtype=_dt(dtype), device=dev())


def ones(shape, dtype=None):
    return torch.ones(shape_of(shape), dtype=_dt(dtype), device=dev())


def full(shape, fill_value, dtype=None):
    if dtype is None and isinstance(fill_value, bool):
        dtype = torch.bool
    elif dtype is None and isinstance(fill_value, int):
        dtype = torch.int32
    return torch.full(shape_of(shape), fill_value, dtype=_dt(dtype),
                      device=dev())


def empty(shape, dtype=None):
    """Zeros, as the reference's (XLA has no uninitialised buffer)."""
    return zeros(shape, dtype)


def zeros_like(x, dtype=None):
    return torch.zeros_like(a(x), dtype=core.convert_dtype(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(a(x), dtype=core.convert_dtype(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(a(x), fill_value, dtype=core.convert_dtype(dtype))


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    dtype = core.convert_dtype(dtype)
    if dtype is None and all(isinstance(v, (int, np.integer))
                             for v in (start, end, step)):
        dtype = torch.int32
    return torch.arange(start, end, step, dtype=dtype or _dt(None),
                        device=dev())


def linspace(start, stop, num, dtype=None):
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=dev())


def logspace(start, stop, num, base=10.0, dtype=None):
    return torch.logspace(start, stop, int(num), base=base, dtype=_dt(dtype),
                          device=dev())


def eye(num_rows, num_columns=None, dtype=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dt(dtype), device=dev())


def diag(x, offset=0, padding_value=0):
    x = a(x)
    res = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones(x.shape[0], dtype=torch.bool,
                                     device=x.device), offset)
        res = torch.where(mask, res, torch.as_tensor(
            padding_value, dtype=res.dtype, device=x.device))
    return res


def diagflat(x, offset=0):
    return torch.diagflat(a(x), offset)


def tril(x, diagonal=0):
    return torch.tril(a(x), diagonal)


def triu(x, diagonal=0):
    return torch.triu(a(x), diagonal)


def tril_indices(row, col=None, offset=0):
    return out(torch.tril_indices(row, row if col is None else col, offset,
                                  device=dev()))


def triu_indices(row, col=None, offset=0):
    return out(torch.triu_indices(row, row if col is None else col, offset,
                                  device=dev()))


def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*[a(v) for v in args], indexing="ij"))


def clone(x):
    return a(x).clone()


def assign(x, output=None):
    return a(x).clone()


def complex(real, imag):
    return torch.complex(a(real), a(imag))


def one_hot(x, num_classes, dtype=None):
    """Rows of `num_classes` with a 1 at each index (an index out of
    range gives a row of zeros, as `jax.nn.one_hot`)."""
    x = a(x)
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(_dt(dtype))


# ---- random ---------------------------------------------------------------- #


def rand(shape, dtype=None):
    d = dev()
    return torch.rand(shape_of(shape), generator=core.next_generator(d),
                      device=d).to(_dt(dtype))


def randn(shape, dtype=None):
    d = dev()
    return torch.randn(shape_of(shape), generator=core.next_generator(d),
                       device=d).to(_dt(dtype))


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    d = dev()
    return torch.randint(low, high, shape_of(shape),
                         generator=core.next_generator(d), device=d
                         ).to(core.convert_dtype(dtype))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):
    d = dev()
    if seed:
        g = torch.Generator(device=d)
        g.manual_seed(core.hash_seed(seed, 0))
    else:
        g = core.next_generator(d)
    u = torch.rand(shape_of(shape), generator=g, device=d)
    return (min + (max - min) * u).to(_dt(dtype))


def normal(mean=0.0, std=1.0, shape=None):
    """mean + std · N(0, 1) of `shape` (else the shape of mean, or of
    std), on the device of a tensor mean or std (else the default)."""
    like = next((v for v in (mean, std) if isinstance(v, torch.Tensor)),
                None)
    d = like.device if like is not None else dev()
    if shape is None:
        m = a(mean, d)
        shape = m.shape if m.dim() else a(std, d).shape
    x = torch.randn(shape_of(shape), generator=core.next_generator(d),
                    device=d)
    return (mean + std * x).to(core.get_default_dtype())


def randperm(n, dtype="int64"):
    d = dev()
    return torch.randperm(n, generator=core.next_generator(d), device=d
                          ).to(core.convert_dtype(dtype))


def bernoulli(x):
    x = a(x)
    return torch.bernoulli(x, generator=core.next_generator(x.device))


def multinomial(x, num_samples=1, replacement=False):
    x = a(x)
    return out(torch.multinomial(x, num_samples, replacement,
                                 generator=core.next_generator(x.device)))
