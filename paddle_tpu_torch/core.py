"""Core runtime helpers of the PyTorch/CUDA package: device resolution,
dtype names and seeded generators.

The counterpart of `paddle_tpu/core.py`, reduced to what the port's
entry points need. Device policy: every entry point takes an explicit
`device`, defaulting to "cuda". Asking for "cuda" on a machine without
a card raises — the port never drops quietly to the CPU; the CPU runs
only when the caller names it (the tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device", "resolve_device", "resolve_dtype",
           "make_generator", "cast_floating"]

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
