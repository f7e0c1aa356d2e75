"""Ragged split-K flash-decode for q_len = 1 serving decode: kernels K1,
K4, K5 and K6.

The counterpart of `paddle_tpu/ops_pallas/decode_attention.py`: one
query row per grid row `b` against the rows `[0, lengths[b])` of its
sequence, with the row range of each lane cut into `num_splits`
independent partials. Each partial emits an UNNORMALISED fp32
accumulator plus its (max, sum-exp) pair and the count of `block_k`-row
chunks it visited; `_merge_splits` combines the partials (plain torch,
as it is plain jnp in JAX). That is the plain version the CPU runs.
The CUDA kernel cuts each lane into `cluster_size(T)` ranges instead,
a function of T alone, and merges them inside the launch through a
thread-block cluster: one launch and one output per call. Four
variants share one body and differ in two seams, as the Pallas kernels
do:

| kernel | entry | addressing | storage |
|---|---|---|---|
| K1 | `ragged_decode_attention` | slotted: row r of cache row slot_map[b] | fp32 / bf16 |
| K5 | `ragged_decode_attention(k_scale=, v_scale=)` | slotted | int8 codes + f32 (row, head) scales |
| K4 | `paged_ragged_decode_attention` | paged: row r % page of page tables[b, r // page] | fp32 / bf16 |
| K6 | `paged_ragged_decode_attention(k_scale=, v_scale=)` | paged | int8 codes + f32 scales |

int8 codes widen as `float(code) * scale` in fp32 before any softmax
math (the TPU kernels' widen point).

On CUDA tensors the entries launch the hand-written Hopper kernel
(`csrc/decode_attention.cu`, built on first use by `_build.py`) or
raise; on CPU tensors they run `ragged_decode_split_plain` /
`paged_decode_split_plain`, the same split-K functions in plain torch.
There is no fallback from one to the other. Each variant counts its
launches in its own counter (`LAUNCHES`, `PAGED_LAUNCHES`,
`QUANT_LAUNCHES`, `PAGED_QUANT_LAUNCHES`). `ragged_decode_reference` /
`paged_decode_reference` are the full-slab masked attentions the
results are held against.

TP-sharded decode: `sharded_ragged_decode_attention` and
`sharded_paged_ragged_decode_attention` (the reference's `shard_map`
entries, `paddle_tpu/ops_pallas/decode_attention.py:598` / `:672`) take
a TP group's per-rank slabs (each rank's contiguous `nh / tp` heads)
and call the unsharded entry once per rank on that rank's queries and
slab: K1 / K5 slotted, K4 / K6 paged, tp launches per call. Heads are
independent in attention, so nothing crosses ranks; the visit counts
depend on the lengths alone, equal on every rank, and are returned
once. One slab (not a sequence) is the plain call.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..quantization.kv import kv_dequant

__all__ = ["ragged_decode_attention", "paged_ragged_decode_attention",
           "ragged_decode_reference", "paged_decode_reference",
           "ragged_decode_split_plain", "paged_decode_split_plain",
           "pick_decode_blocks", "pick_paged_decode_blocks",
           "cluster_size", "sharded_ragged_decode_attention",
           "sharded_paged_ragged_decode_attention", "LAUNCHES",
           "PAGED_LAUNCHES", "QUANT_LAUNCHES", "PAGED_QUANT_LAUNCHES",
           "launch_counter"]

NEG_INF = -1e30
_SUPPORTED_HD = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class _LaunchCounter:
    """Plain-int count of kernel launches (one per wrapper call on a
    CUDA tensor). A run resets it, drives a path, and reads it to show
    the path really went through the kernel. `instances` lists every
    counter, so that a CUDA graph's replay can add the launches its
    capture recorded (`serving/graphs.py`)."""

    instances: list = []

    def __init__(self):
        self.count = 0
        _LaunchCounter.instances.append(self)

    def reset(self):
        self.count = 0


LAUNCHES = _LaunchCounter()               # K1: slotted, fp
PAGED_LAUNCHES = _LaunchCounter()         # K4: paged, fp
QUANT_LAUNCHES = _LaunchCounter()         # K5: slotted, int8
PAGED_QUANT_LAUNCHES = _LaunchCounter()   # K6: paged, int8


def launch_counter(paged: bool, quantized: bool) -> _LaunchCounter:
    """The counter of the variant with this addressing and storage."""
    return {(False, False): LAUNCHES, (True, False): PAGED_LAUNCHES,
            (False, True): QUANT_LAUNCHES,
            (True, True): PAGED_QUANT_LAUNCHES}[(bool(paged),
                                                  bool(quantized))]


def _check_scales(k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    return k_scale is not None


def _widen(kc, k_scale, dtype=torch.float32):
    """fp rows as they are; int8 codes times their scales, in fp32."""
    return kc if k_scale is None else kv_dequant(kc, k_scale, dtype)


def ragged_decode_reference(q, kc, vc, lengths, slot_map=None,
                            k_scale=None, v_scale=None):
    """Plain full-slab masked attention (fp32 scores, -1e30 mask):
    q (B, nh, hd), kc/vc (S, T, nh, hd), lengths (B,) → (B, nh, hd) in
    q's dtype; grid row b reads cache row slot_map[b] (identity when
    None). int8 kc/vc with their (S, T, nh) scales are widened to fp32
    first. A lane with no live row gives 0, the kernel's value (a
    softmax over an all-masked row would average V instead)."""
    _check_scales(k_scale, v_scale)
    kc, vc = _widen(kc, k_scale), _widen(vc, v_scale)
    if slot_map is not None:
        kc, vc = kc[slot_map.long()], vc[slot_map.long()]
    T = kc.shape[1]
    keep = (torch.arange(T, device=kc.device)[None, :]
            < lengths[:, None])[:, None, None]                # (B,1,1,T)
    scores = torch.einsum("bqnd,bknd->bnqk", q[:, None].float(), kc.float())
    scores = scores / math.sqrt(q.shape[-1])
    scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(vc.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", w, vc)[:, 0]
    return torch.where((lengths > 0)[:, None, None], out, 0).to(q.dtype)


def _gather_pages(pool, tables):
    """(S, maxp * page, ...) dense view of each lane's pages."""
    S, maxp = tables.shape
    g = pool[tables.long()]                        # (S, maxp, page, ...)
    return g.reshape(S, maxp * pool.shape[1], *pool.shape[2:])


def paged_decode_reference(q, kp, vp, tables, lengths, k_scale=None,
                           v_scale=None):
    """Reference for the PAGED kernels: gather each lane's pages
    through its block-table row into the dense (S, T, nh, hd) view
    (scales alike), then `ragged_decode_reference`."""
    quant = _check_scales(k_scale, v_scale)
    return ragged_decode_reference(
        q, _gather_pages(kp, tables), _gather_pages(vp, tables), lengths,
        k_scale=_gather_pages(k_scale, tables) if quant else None,
        v_scale=_gather_pages(v_scale, tables) if quant else None)


def pick_decode_blocks(max_seq: int, head_dim: int,
                       dtype) -> Tuple[int, int]:
    """(block_k, num_splits) for a decode shape: block_k the largest
    candidate dividing max_seq, 2 splits when they divide too and each
    split still holds at least two chunks. The candidate ladder is
    itemsize-scaled as in the reference (1-byte caches afford twice the
    rows per chunk: int8 gives (512, 1) at T = 1024); the reference's
    TPU autotune table is not used."""
    one_byte = torch.empty((), dtype=dtype).element_size() == 1
    cands = (512, 256, 128, 64, 32, 16, 8) if one_byte \
        else (256, 128, 64, 32, 16, 8)
    for bk in cands:
        if bk <= max_seq and max_seq % bk == 0:
            ns = 2 if max_seq % (bk * 2) == 0 and max_seq // bk >= 4 else 1
            return bk, ns
    return max_seq, 1


def pick_paged_decode_blocks(max_seq: int, page_size: int, head_dim: int,
                             dtype) -> Tuple[int, int]:
    """(block_k, num_splits) for the paged kernels: the slotted pick
    for the same logical length, block_k then halved until it divides
    `page_size` (a chunk never straddles a page), split-K dropped if
    the divisibility no longer holds — the reference's rule, kept so
    that the visit counts match it."""
    bk, ns = pick_decode_blocks(max_seq, head_dim, dtype)
    while bk > 1 and (bk > page_size or page_size % bk != 0):
        bk //= 2
    if max_seq % (bk * ns) != 0:
        ns = 1
    return bk, ns


def cluster_size(max_seq: int) -> int:
    """C(T), the CUDA kernel's CTAs per (lane, head): min(8, max(1,
    T // 128)), each over a fixed range of ceil(T / C) rows. A function
    of T alone, never of the lengths (they live on the device) nor of
    the addressing or block_k, so K1 and K4 give the same bits on the
    same rows, a speculative virtual lane the plain step's, and a lane
    served alone its batched bits. 8 is the portable cluster size.
    Separate from `pick_decode_blocks`, which keeps the reference's
    (block_k, num_splits) for the visit counts."""
    return min(8, max(1, max_seq // 128))


def ragged_decode_split_plain(q, kc, vc, lengths, slot_map, scale: float,
                              block_k: int, num_splits: int,
                              k_scale=None, v_scale=None):
    """The kernel's function in plain torch: per (lane, split) the
    unnormalised accumulator (B, ns, nh, hd) f32, the running max and
    sum-exp (B, ns, 1, nh) f32, and the visited-chunk count (B, ns)
    int32 = clip(ceil((len - split_start) / block_k), 0, split_blocks).
    A split with no live row gives m = -1e30, l = 0, acc = 0. int8
    rows widen as code * scale in fp32, as the kernel does."""
    B, nh, hd = q.shape
    T = kc.shape[1]
    split_rows = T // num_splits
    split_blocks = split_rows // block_k
    sm = slot_map.long()
    kv_k = _widen(kc[sm], None if k_scale is None else k_scale[sm]).float()
    kv_v = _widen(vc[sm], None if v_scale is None else v_scale[sm]).float()
    s = torch.einsum("bnd,btnd->bnt", q.float(), kv_k) * scale
    rows = torch.arange(T, device=q.device)
    live = rows[None, :] < lengths[:, None].long()            # (B, T)
    s = s.reshape(B, nh, num_splits, split_rows)
    live = live.reshape(B, 1, num_splits, split_rows)
    m = torch.where(live, s, NEG_INF).amax(-1)                # (B,nh,ns)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l_ = p.sum(-1)                                            # (B,nh,ns)
    acc = torch.einsum("bnpt,bptnd->bpnd", p,
                       kv_v.reshape(B, num_splits, split_rows, nh, hd))
    starts = torch.arange(num_splits, device=q.device) * split_rows
    num = lengths[:, None].long() - starts[None, :] + block_k - 1
    # truncating division, as lax.div; the clip makes the sign moot
    visits = torch.clamp(torch.div(num, block_k, rounding_mode="trunc"),
                         0, split_blocks).to(torch.int32)
    return (acc.contiguous(), m.permute(0, 2, 1)[:, :, None].contiguous(),
            l_.permute(0, 2, 1)[:, :, None].contiguous(), visits)


def paged_decode_split_plain(q, kp, vp, tables, lengths, scale: float,
                             block_k: int, num_splits: int,
                             k_scale=None, v_scale=None):
    """The paged kernels' function in plain torch: the lanes' pages
    gathered into the dense view, then `ragged_decode_split_plain`
    with the identity slot map (same outputs, same visit counts)."""
    quant = k_scale is not None
    ident = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    return ragged_decode_split_plain(
        q, _gather_pages(kp, tables), _gather_pages(vp, tables), lengths,
        ident, scale, block_k, num_splits,
        k_scale=_gather_pages(k_scale, tables) if quant else None,
        v_scale=_gather_pages(v_scale, tables) if quant else None)


def _merge_splits(o, m, l_, dtype):
    """Cross-split online-softmax merge (tiny tensors; plain torch):
    `m* = max_p m_p; out = sum_p e^(m_p-m*) acc_p / sum_p e^(m_p-m*)
    l_p`. Splits with zero live chunks carry m = -1e30 → weight 0."""
    m_star = m.amax(dim=1, keepdim=True)                     # (B,1,1,nh)
    w = torch.exp(m - m_star)                                # (B,P,1,nh)
    l_tot = (w * l_).sum(dim=1)[:, 0]                        # (B, nh)
    out = (w.transpose(2, 3) * o).sum(dim=1)                 # (B, nh, hd)
    return (out / torch.clamp(l_tot, min=1e-30)[..., None]).to(dtype)


def _check_cuda_args(q, kc, vc, lengths, index, block_k, num_splits,
                     k_scale=None, v_scale=None, page_size: int = 0):
    """The checks run before a CUDA launch. Slotted (`page_size` 0):
    kc/vc (S, T, nh, hd), index = slot_map (B,). Paged: kc/vc
    (num_pages, page_size, nh, hd), index = tables (B, maxp)."""
    dev = q.device
    quant = _check_scales(k_scale, v_scale)
    named = [("kc", kc), ("vc", vc), ("lengths", lengths),
             ("slot_map" if not page_size else "tables", index)]
    if quant:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype} not supported (float32, "
                        f"bfloat16)")
    if quant:
        if kc.dtype != torch.int8 or vc.dtype != torch.int8:
            raise TypeError(f"k_scale/v_scale need int8 kc/vc, got "
                            f"{kc.dtype}, {vc.dtype}")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("k_scale and v_scale must be float32")
        if k_scale.shape != kc.shape[:-1] or v_scale.shape != kc.shape[:-1]:
            raise ValueError(f"scales {tuple(k_scale.shape)} / "
                             f"{tuple(v_scale.shape)} must be "
                             f"{tuple(kc.shape[:-1])}")
    elif kc.dtype != q.dtype or vc.dtype != q.dtype:
        raise TypeError(f"q/kc/vc dtypes differ: {q.dtype}, {kc.dtype}, "
                        f"{vc.dtype} (int8 kc/vc need k_scale/v_scale)")
    if lengths.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError("lengths and slot_map/tables must be int32")
    if kc.shape != vc.shape or kc.dim() != 4:
        raise ValueError(f"kc {tuple(kc.shape)} / vc {tuple(vc.shape)} "
                         f"must both be (S, T, nh, hd)")
    B, nh, hd = q.shape
    if kc.shape[2:] != (nh, hd):
        raise ValueError(f"q heads {(nh, hd)} != cache {tuple(kc.shape[2:])}")
    if page_size:
        if kc.shape[1] != page_size or index.dim() != 2 \
                or index.shape[0] != B:
            raise ValueError(f"paged: pools {tuple(kc.shape)} need page "
                             f"{page_size}, tables {tuple(index.shape)} "
                             f"need ({B}, maxp)")
        if page_size % block_k:
            raise ValueError(f"block_k {block_k} must divide the page "
                             f"size {page_size}")
        T = index.shape[1] * page_size
    else:
        if index.shape != (B,):
            raise ValueError(f"slot_map {tuple(index.shape)} must be "
                             f"({B},)")
        T = kc.shape[1]
    if lengths.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be ({B},)")
    if hd not in _SUPPORTED_HD:
        raise ValueError(f"head_dim {hd} not supported by the kernel "
                         f"(one of {_SUPPORTED_HD})")
    if T % (block_k * num_splits) != 0:
        raise ValueError(f"max_seq {T} must be divisible by "
                         f"block_k*num_splits ({block_k}*{num_splits})")
    for name, t in [("q", q)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("kc", kc), ("vc", vc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if B < 1 or B > 65535 or nh > 65535 or kc.shape[0] < 1:
        raise ValueError(f"grid rows {B} / heads {nh} out of range")
    return T


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, kc, vc, k_scale, v_scale, lengths, index, out, visits; batch,
    # t_rows, nh, hd, q_dtype, kv_dtype, block_k, num_splits, page_size,
    # max_pages, cluster; scale; stream
    "decode_attention_launch": (ctypes.c_int, [_P] * 9 + [_I] * 11
                                + [ctypes.c_float, _P]),
    "error_string": (ctypes.c_char_p, [_I]),
}


def _launch_cuda(q, kc, vc, lengths, index, scale, block_k, num_splits,
                 k_scale=None, v_scale=None, page_size: int = 0,
                 with_stats: bool = False):
    """One launch of the variant the arguments select (slotted or
    paged by `page_size`, fp or int8 by the scales): the merged output
    (B, nh, hd) in q's dtype, and the (B, num_splits) visit counts when
    `with_stats` (else None). Counts the launch."""
    from ._build import load_library
    T = _check_cuda_args(q, kc, vc, lengths, index, block_k, num_splits,
                         k_scale, v_scale, page_size)
    quant = k_scale is not None
    B, nh, hd = q.shape
    out = torch.empty_like(q)
    visits = torch.empty((B, num_splits), dtype=torch.int32,
                         device=q.device) if with_stats else None
    lib = load_library("decode_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, lengths.data_ptr(),
            index.data_ptr(), out.data_ptr(),
            visits.data_ptr() if with_stats else None, B, T, nh, hd,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[kc.dtype], block_k, num_splits,
            page_size, index.shape[1] if page_size else 0, cluster_size(T),
            scale, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")
    launch_counter(page_size > 0, quant).count += 1
    return out, visits


def _run(q, squeeze, with_stats, cuda_fn, plain_fn):
    if q.device.type == "cuda":
        out, visits = cuda_fn()
    elif q.device.type == "cpu":
        o, m, l_, visits = plain_fn()
        out = _merge_splits(o, m, l_, q.dtype)
    else:
        raise ValueError(f"unsupported device {q.device}")
    if squeeze:
        out = out[:, None]
    return (out, visits) if with_stats else out


def ragged_decode_attention(q, kc, vc, lengths,
                            slot_map: Optional[torch.Tensor] = None,
                            block_k: Optional[int] = None,
                            num_splits: Optional[int] = None,
                            with_stats: bool = False,
                            k_scale=None, v_scale=None):
    """Flash-decode over a slotted cache: q (B, nh, hd) or (B, 1, nh, hd)
    against kc/vc (S, T, nh, hd), grid row `b` attending rows
    `[0, lengths[b])` of cache row `slot_map[b]` (identity when None —
    plain decode, B == S; a speculative verify pass repeats slots with
    per-query lengths). int8 kc/vc with their (S, T, nh) f32 scales as
    `k_scale`/`v_scale` select K5 (the block pick then follows the int8
    ladder). Returns the attention output in q's layout and dtype;
    `with_stats=True` also returns the (B, num_splits) visited-chunk
    counts. CUDA tensors run the Hopper kernel (or raise); CPU tensors
    run the same function in plain torch."""
    _check_scales(k_scale, v_scale)
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    S, T, nh, hd = kc.shape
    if slot_map is None:
        if q.shape[0] != S:
            raise ValueError(f"q rows {q.shape[0]} != cache rows {S} "
                             f"need an explicit slot_map")
        slot_map = torch.arange(S, dtype=torch.int32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    if block_k is None or num_splits is None:
        tbk, tns = pick_decode_blocks(T, hd, kc.dtype)
        block_k = block_k or tbk
        num_splits = num_splits or tns
    if T % (block_k * num_splits) != 0:
        raise ValueError(f"max_seq {T} must be divisible by "
                         f"block_k*num_splits ({block_k}*{num_splits})")
    return _run(
        q, squeeze, with_stats,
        lambda: _launch_cuda(q, kc, vc, lengths, slot_map, scale, block_k,
                             num_splits, k_scale, v_scale,
                             with_stats=with_stats),
        lambda: ragged_decode_split_plain(q, kc, vc, lengths, slot_map,
                                          scale, block_k, num_splits,
                                          k_scale, v_scale))


def paged_ragged_decode_attention(q, kp, vp, tables, lengths,
                                  block_k: Optional[int] = None,
                                  num_splits: Optional[int] = None,
                                  with_stats: bool = False,
                                  k_scale=None, v_scale=None):
    """Flash-decode over a PAGED cache (K4; K6 with int8 pools): q
    (S, nh, hd) or (S, 1, nh, hd) against the shared page pools kp/vp
    (num_pages, page, nh, hd), lane `s` attending rows `[0, lengths[s])`
    addressed through its block-table row `tables[s]` (maxp page ids;
    row r lives at (tables[s, r // page], r % page)). `block_k` must
    divide the page size. int8 pools come with their (num_pages, page,
    nh) f32 scale pools as `k_scale`/`v_scale`. Same split-K outputs,
    merge and visit counts as `ragged_decode_attention`."""
    _check_scales(k_scale, v_scale)
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    S, maxp = tables.shape
    _, page, nh, hd = kp.shape
    T = maxp * page
    scale = 1.0 / math.sqrt(hd)
    if block_k is None or num_splits is None:
        tbk, tns = pick_paged_decode_blocks(T, page, hd, kp.dtype)
        block_k = block_k or tbk
        num_splits = num_splits or tns
    if page % block_k != 0:
        raise ValueError(f"block_k {block_k} must divide the page size "
                         f"{page} (a chunk cannot straddle pages)")
    if T % (block_k * num_splits) != 0:
        raise ValueError(f"max_seq {T} must be divisible by "
                         f"block_k*num_splits ({block_k}*{num_splits})")
    return _run(
        q, squeeze, with_stats,
        lambda: _launch_cuda(q, kp, vp, lengths, tables, scale, block_k,
                             num_splits, k_scale, v_scale, page_size=page,
                             with_stats=with_stats),
        lambda: paged_decode_split_plain(q, kp, vp, tables, lengths, scale,
                                         block_k, num_splits, k_scale,
                                         v_scale))


def _rank_queries(q, k_cache):
    """Rank r's queries: q a per-rank sequence (returned as it is, the
    output per rank), or one (B, [1,] nh, hd) tensor split into the
    ranks' head blocks (the output joined back). Raises when the heads
    do not split evenly or disagree with the slabs."""
    tp = len(k_cache)
    if isinstance(q, (list, tuple)):
        if len(q) != tp:
            raise ValueError(f"{len(q)} query shards for {tp} slabs")
        return list(q), False
    nh = q.shape[-2]
    if nh % tp:
        raise ValueError(f"num_heads {nh} not divisible by tp={tp}")
    if any(k.shape[-2] != nh // tp for k in k_cache):
        raise ValueError(f"slab heads {[k.shape[-2] for k in k_cache]} != "
                         f"{nh // tp} per rank")
    return [t.contiguous() for t in q.split(nh // tp, dim=-2)], True


def _sharded(entry, q, k_cache, v_cache, args, k_scale, v_scale,
             with_stats, kw):
    if isinstance(k_cache, torch.Tensor):              # tp = 1
        return entry(q, k_cache, v_cache, *args, with_stats=with_stats,
                     k_scale=k_scale, v_scale=v_scale, **kw)
    qs, joined = _rank_queries(q, k_cache)
    ks = k_scale if k_scale is not None else [None] * len(qs)
    vs = v_scale if v_scale is not None else [None] * len(qs)
    outs, visits = [], None
    for qr, kr, vr, ksr, vsr in zip(qs, k_cache, v_cache, ks, vs):
        o = entry(qr.contiguous(), kr, vr, *args, with_stats=with_stats,
                  k_scale=ksr, v_scale=vsr, **kw)
        if with_stats:
            o, visits = o          # the same on every rank: keep one
        outs.append(o)
    out = torch.cat(outs, dim=-2) if joined else outs
    return (out, visits) if with_stats else out


def sharded_ragged_decode_attention(q, k_cache, v_cache, lengths,
                                    slot_map: Optional[torch.Tensor] = None,
                                    block_k: Optional[int] = None,
                                    num_splits: Optional[int] = None,
                                    with_stats: bool = False,
                                    k_scale=None, v_scale=None):
    """`ragged_decode_attention` over a TP group's per-rank slabs (K1,
    or K5 with the ranks' scales): `k_cache` / `v_cache` (and
    `k_scale` / `v_scale` for int8) are sequences, rank r's slab (S, T,
    nh / tp, hd) holding heads [r nh / tp, (r + 1) nh / tp). `q` is a
    per-rank sequence (the output then per rank) or the full (B, [1,]
    nh, hd) queries (split by heads; the output joined). One launch per
    rank on CUDA tensors; the plain version per rank on CPU tensors.
    `lengths`, `slot_map` and the block picks are the unsharded
    entry's, shared by every rank; with `with_stats` the visit counts
    are returned once. A single slab tensor is the plain call."""
    return _sharded(ragged_decode_attention, q, k_cache, v_cache,
                    (lengths,), k_scale, v_scale, with_stats,
                    dict(slot_map=slot_map, block_k=block_k,
                         num_splits=num_splits))


def sharded_paged_ragged_decode_attention(q, k_pool, v_pool, tables,
                                          lengths,
                                          block_k: Optional[int] = None,
                                          num_splits: Optional[int] = None,
                                          with_stats: bool = False,
                                          k_scale=None, v_scale=None):
    """`paged_ragged_decode_attention` over a TP group's per-rank page
    pools (K4, or K6 with the ranks' scale pools): page ids and block
    tables are shared by the group, the page bytes split by heads, rank
    r's pool (num_pages, page, nh / tp, hd). `q` and the output as in
    `sharded_ragged_decode_attention`."""
    return _sharded(paged_ragged_decode_attention, q, k_pool, v_pool,
                    (tables, lengths), k_scale, v_scale, with_stats,
                    dict(block_k=block_k, num_splits=num_splits))
