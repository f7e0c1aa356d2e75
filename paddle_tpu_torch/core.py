"""Core runtime helpers of the PyTorch/CUDA package: device resolution,
dtype names, seeded generators and the flags.

The counterpart of `paddle_tpu/core.py`, reduced to what the port's
entry points need. Device policy: every entry point takes an explicit
`device`, defaulting to "cuda". Asking for "cuda" on a machine without
a card raises — the port never drops quietly to the CPU; the CPU runs
only when the caller names it (the tests do).

`host_tensor` turns a host array (a numpy array from the JAX package,
its `bfloat16` extension dtype included, or a tensor) into a CPU tensor.

Flags: `set_flags` / `get_flags` over the JAX package's flag table,
reduced to the one flag the port reads, `check_nan_inf` (the Trainer's
numerics check), with the same `FLAGS_<name>` environment bridge.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["default_device", "resolve_device", "resolve_dtype",
           "make_generator", "cast_floating", "host_tensor", "set_flags",
           "get_flags", "foreach_groups", "fp32_norms", "mul_fp32"]

_FLAG_DEFAULTS = {
    "check_nan_inf": False,
}
_flags = dict(_FLAG_DEFAULTS)
for _k, _d in _FLAG_DEFAULTS.items():
    _env = os.environ.get("FLAGS_" + _k)
    if _env is not None:
        _flags[_k] = _env.lower() in ("1", "true", "yes") \
            if isinstance(_d, bool) else _env


def set_flags(flags: dict) -> None:
    """Set flags by name; an unknown name raises `KeyError`."""
    for k in flags:
        if k not in _flags:
            raise KeyError(f"unknown flag {k!r}; known: {sorted(_flags)}")
    _flags.update(flags)


def get_flags(keys=None) -> dict:
    """{name: value} of `keys` (a name or a list of names; all flags for
    None)."""
    if keys is None:
        return dict(_flags)
    if isinstance(keys, str):
        keys = [keys]
    return {k: _flags[k] for k in keys}

_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16,
}

DeviceLike = Union[str, torch.device, None]


def default_device() -> str:
    """The device an entry point uses when the caller names none."""
    return "cuda"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` (or the default) as a `torch.device`. Raises
    `RuntimeError` for a CUDA device when no card is present, instead
    of running somewhere the caller did not ask for."""
    dev = torch.device(device if device is not None else default_device())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU explicitly")
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype, None],
                  default: torch.dtype = torch.float32) -> torch.dtype:
    """A dtype given by name ("bf16", "float32", ...) or as a
    `torch.dtype`; None gives `default`."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype).lower()]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def make_generator(seed: int, device: Optional[DeviceLike] = "cpu"
                   ) -> torch.Generator:
    """An explicit seeded `torch.Generator` (the port keeps no global
    RNG state: every random draw names its generator)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor of `a`: a tensor as it is (moved to the CPU), a
    numpy array as a writable copy, numpy's `bfloat16` extension dtype
    carried bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def cast_floating(tree, dtype):
    """Cast every floating-point tensor of a nest of dicts, lists and
    tuples to `dtype`, passing everything else (token ids, masks)
    through. The single home of the AMP cast policy."""
    dtype = resolve_dtype(dtype)
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def foreach_groups(ts):
    """Indices of `ts` grouped by (device, dtype), so every
    `torch._foreach_*` call takes its fast path."""
    out: dict = {}
    for i, t in enumerate(ts):
        out.setdefault((t.device, t.dtype), []).append(i)
    return out.values()


def fp32_norms(ts, ord: float = 2):
    """The `ord` norm of each tensor, reduced in fp32 (0-d fp32
    tensors), one `torch._foreach_norm` per (device, dtype) group."""
    ts = list(ts)
    out = [None] * len(ts)
    for idx in foreach_groups(ts):
        for i, n in zip(idx, torch._foreach_norm([ts[i] for i in idx], ord,
                                                 dtype=torch.float32)):
            out[i] = n
    return out


def mul_fp32(tensors, scale: torch.Tensor):
    """Each tensor times the 0-d fp32 `scale`, the product taken in fp32
    and rounded once to the tensor's dtype (`(g.astype(f32) * s).
    astype(g.dtype)` in the JAX package). fp32 tensors in one
    `torch._foreach_mul` per device; the others one at a time."""
    tensors = list(tensors)
    out = [None] * len(tensors)
    f32: dict = {}
    for i, t in enumerate(tensors):
        if t.dtype == torch.float32:
            f32.setdefault(t.device, []).append(i)
        else:
            out[i] = (t.float() * scale.to(t.device)).to(t.dtype)
    for dev, idx in f32.items():
        for i, r in zip(idx, torch._foreach_mul([tensors[i] for i in idx],
                                                scale.to(dev))):
            out[i] = r
    return out
