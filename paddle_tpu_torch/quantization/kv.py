"""Quantized KV slabs: one int8 contract for the slotted and paged layouts.

The counterpart of `paddle_tpu/quantization/kv.py`. A per-layer KV slab
is either a plain tensor (fp cache, shape `[..., nh, hd]`) or a dict
`{"q": int8[..., nh, hd], "s": f32[..., nh]}`, the quantized form. Code
that merely moves slabs treats them as opaque; code that touches rows
goes through the helpers here, so both layouts share one quantization
semantics: per-head, per-row symmetric int8 with the scale derived from
the written row itself (no calibration), so every layout and every
admission schedule stores the same codes for the same position.

Slabs are written IN PLACE (`kv_update` takes the index of the rows to
write; the JAX seam takes a functional setter instead).
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import torch

from . import abs_max_scale, quantize_tensor

__all__ = [
    "KV_DTYPES", "normalize_kv_dtype", "is_quantized", "make_slab",
    "slab_data", "slab_shape", "slab_dtype_str", "slab_nbytes",
    "slab_leaves", "kv_quantize", "kv_dequant", "dequant_slab",
    "kv_update", "map_slab", "take_rows",
]

# "int8" means quantized {"q", "s"} slabs; the rest are fp slabs
KV_DTYPES = ("float32", "bfloat16", "float16", "int8")

_ALIASES = {"bf16": "bfloat16", "fp16": "float16", "f16": "float16",
            "fp32": "float32", "f32": "float32"}

Slab = Union[torch.Tensor, dict]


def normalize_kv_dtype(kv_dtype, default: torch.dtype) -> str:
    """Canonical kv_dtype string: None inherits `default` (the weights'
    dtype); aliases normalise; anything outside KV_DTYPES raises."""
    if kv_dtype is None:
        s = str(default).replace("torch.", "")
    else:
        s = str(kv_dtype).lower().replace("torch.", "")
        s = _ALIASES.get(s, s)
    if s not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    return s


def is_quantized(slab: Slab) -> bool:
    """True iff `slab` is the quantized {"q", "s"} form."""
    return isinstance(slab, dict)


def make_slab(shape: Sequence[int], dtype: torch.dtype, quantized: bool,
              device=None) -> Slab:
    """One zeroed per-layer slab. `shape` is the DATA shape
    `[..., nh, hd]`; the quantized form adds the `[..., nh]` scales."""
    if quantized:
        return {"q": torch.zeros(tuple(shape), dtype=torch.int8,
                                 device=device),
                "s": torch.zeros(tuple(shape[:-1]), dtype=torch.float32,
                                 device=device)}
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def slab_data(slab: Slab) -> torch.Tensor:
    """The code/data tensor (int8 for quantized slabs)."""
    return slab["q"] if is_quantized(slab) else slab


def slab_shape(slab: Slab) -> Tuple[int, ...]:
    return tuple(slab_data(slab).shape)


def slab_dtype_str(slab: Slab) -> str:
    return "int8" if is_quantized(slab) else \
        str(slab.dtype).replace("torch.", "")


def slab_leaves(slab: Slab) -> List[torch.Tensor]:
    """The slab's tensors in a fixed order (byte accounting)."""
    return [slab["q"], slab["s"]] if is_quantized(slab) else [slab]


def slab_nbytes(slab: Slab) -> int:
    return sum(t.numel() * t.element_size() for t in slab_leaves(slab))


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head, per-row symmetric int8: `x[..., nh, hd]` → int8 codes
    and the `[..., nh]` f32 scales. The abs-max and the /127 run in x's
    dtype and only then widen, as the reference; codes divide in fp32
    and round half to even."""
    s = abs_max_scale(x, dim=-1)
    return quantize_tensor(x, s[..., None]), s.float()


def kv_dequant(q: torch.Tensor, s: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Widen int8 codes with their scales (fp32 product) to `dtype`."""
    return (q.float() * s[..., None]).to(dtype)


def dequant_slab(slab: Slab, dtype: torch.dtype) -> torch.Tensor:
    """A dense fp view of the slab (the slab itself when it is fp)."""
    if is_quantized(slab):
        return kv_dequant(slab["q"], slab["s"], dtype)
    return slab


def kv_update(slab: Slab, index, new: torch.Tensor) -> Slab:
    """THE cache-write seam, in place: write the fp K/V rows `new`
    (`[..., nh, hd]`) at `slab[index]`, where `index` addresses only the
    leading (row-space) axes, so the same index writes the codes and
    their scales. Quantized slabs quantize `new` per row first; fp slabs
    store it in their dtype. Returns the slab."""
    if is_quantized(slab):
        qv, sv = kv_quantize(new)
        slab["q"][index] = qv
        slab["s"][index] = sv
    else:
        slab[index] = new.to(slab.dtype)
    return slab


def map_slab(slab: Slab, fn: Callable[[torch.Tensor], torch.Tensor]
             ) -> Slab:
    """Structure-preserving data movement of rows already in cache
    dtype (no quantize/dequant): `fn` on an fp slab, or on the codes
    and the scales alike (it must index only the leading axes)."""
    if is_quantized(slab):
        return {"q": fn(slab["q"]), "s": fn(slab["s"])}
    return fn(slab)


def take_rows(slab: Slab, idx: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """Gather rows along axis 0 by `idx` and widen quantized rows to
    `dtype` (fp slabs keep their dtype) — the paged dense views."""
    idx = idx.long()
    if is_quantized(slab):
        return kv_dequant(slab["q"][idx], slab["s"][idx], dtype)
    return slab[idx]
