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

A TP group's slab (`HeadShards`) is one logical slab held as per-rank
slabs, rank r over its contiguous block of heads, each its own
contiguous tensor (the decode kernels read contiguous slabs). The
helpers here treat it as the logical slab: its shape sums the heads,
its leaves are the ranks' leaves in rank order, a row gather joins the
heads, and a write of full-head rows splits them. `join_heads` /
`split_heads` convert a page payload between the ranks' rows and the
one `[..., nh, hd]` layout an unsharded cache moves, so a payload never
shows the group.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import torch

from . import abs_max_scale, quantize_tensor

__all__ = [
    "KV_DTYPES", "normalize_kv_dtype", "is_quantized", "make_slab",
    "slab_data", "slab_shape", "slab_dtype_str", "slab_nbytes",
    "slab_leaves", "kv_quantize", "kv_dequant", "dequant_slab",
    "kv_update", "map_slab", "take_rows", "HeadShards", "slab_parts",
    "join_heads", "split_heads",
]

# "int8" means quantized {"q", "s"} slabs; the rest are fp slabs
KV_DTYPES = ("float32", "bfloat16", "float16", "int8")

_ALIASES = {"bf16": "bfloat16", "fp16": "float16", "f16": "float16",
            "fp32": "float32", "f32": "float32"}

Slab = Union[torch.Tensor, dict, "HeadShards"]


class HeadShards(list):
    """One logical per-layer slab as the per-rank slabs of a TP group, in
    rank order: rank r holds heads [r * nh / tp, (r + 1) * nh / tp) of
    every row (its data `[..., nh / tp, hd]`, and for int8 its scales
    `[..., nh / tp]`), as a slab of its own (a tensor or a {"q", "s"}
    pair)."""


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
    """True iff `slab` is the quantized {"q", "s"} form (or per-rank
    slabs of that form)."""
    if isinstance(slab, HeadShards):
        return isinstance(slab[0], dict)
    return isinstance(slab, dict)


def slab_parts(slab: Slab) -> List[Slab]:
    """The per-rank slabs of a `HeadShards`, or `[slab]`."""
    return list(slab) if isinstance(slab, HeadShards) else [slab]


def _heads_of(slab: Slab) -> List[int]:
    return [slab_data(p).shape[-2] for p in slab_parts(slab)]


def join_heads(parts):
    """Per-rank rows (tensors, or {"q", "s"} dicts) joined into the
    full-head rows: data along its head axis (-2), scales along theirs
    (-1). One part is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], dict):
        return {"q": torch.cat([p["q"] for p in parts], dim=-2),
                "s": torch.cat([p["s"] for p in parts], dim=-1)}
    return torch.cat(list(parts), dim=-2)


def split_heads(rows, heads: Sequence[int]) -> list:
    """Full-head rows (a tensor or {"q", "s"}) split into per-rank rows
    of `heads` heads each, views in rank order: the inverse of
    `join_heads`."""
    heads = [int(h) for h in heads]
    if isinstance(rows, dict):
        return [{"q": q, "s": s_} for q, s_ in zip(
            torch.split(rows["q"], heads, dim=-2),
            torch.split(rows["s"], heads, dim=-1))]
    return list(torch.split(rows, heads, dim=-2))


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
    """The code/data tensor (int8 for quantized slabs) of an unsharded
    slab."""
    if isinstance(slab, HeadShards):
        raise TypeError("per-rank slabs have one data tensor per rank "
                        "(slab_parts)")
    return slab["q"] if is_quantized(slab) else slab


def slab_shape(slab: Slab) -> Tuple[int, ...]:
    """The logical data shape (a TP group's heads summed)."""
    if isinstance(slab, HeadShards):
        s0 = slab_shape(slab[0])
        return s0[:-2] + (sum(_heads_of(slab)), s0[-1])
    return tuple(slab_data(slab).shape)


def slab_dtype_str(slab: Slab) -> str:
    slab = slab_parts(slab)[0]
    return "int8" if is_quantized(slab) else \
        str(slab.dtype).replace("torch.", "")


def slab_leaves(slab: Slab) -> List[torch.Tensor]:
    """The slab's tensors in a fixed order (byte accounting): the
    ranks' leaves in rank order for a TP group's slab."""
    if isinstance(slab, HeadShards):
        return [t for p in slab for t in slab_leaves(p)]
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
    """A dense fp view of the slab (the slab itself when it is fp; a TP
    group's heads joined)."""
    if isinstance(slab, HeadShards):
        return torch.cat([dequant_slab(p, dtype) for p in slab], dim=-2)
    if is_quantized(slab):
        return kv_dequant(slab["q"], slab["s"], dtype)
    return slab


def kv_update(slab: Slab, index, new: torch.Tensor) -> Slab:
    """THE cache-write seam, in place: write the fp K/V rows `new`
    (`[..., nh, hd]`) at `slab[index]`, where `index` addresses only the
    leading (row-space) axes, so the same index writes the codes and
    their scales. Quantized slabs quantize `new` per row first; fp slabs
    store it in their dtype. A TP group's slab takes per-rank rows (a
    sequence, rank r's heads each) or full-head rows, which it splits
    over its ranks. Returns the slab."""
    if isinstance(slab, HeadShards):
        if isinstance(new, torch.Tensor):
            new = split_heads(new, _heads_of(slab))
        for part, rows in zip(slab, new):
            kv_update(part, index, rows)
        return slab
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
    and the scales alike (it must index only the leading axes); rank by
    rank for a TP group's slab."""
    if isinstance(slab, HeadShards):
        return HeadShards(map_slab(p, fn) for p in slab)
    if is_quantized(slab):
        return {"q": fn(slab["q"]), "s": fn(slab["s"])}
    return fn(slab)


def take_rows(slab: Slab, idx: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """Gather rows along axis 0 by `idx` and widen quantized rows to
    `dtype` (fp slabs keep their dtype) — the paged dense views (a TP
    group's heads joined)."""
    if isinstance(slab, HeadShards):
        return torch.cat([take_rows(p, idx, dtype) for p in slab], dim=-2)
    idx = idx.long()
    if is_quantized(slab):
        return kv_dequant(slab["q"][idx], slab["s"][idx], dtype)
    return slab[idx]
