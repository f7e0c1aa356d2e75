"""Ragged split-K flash-decode for q_len = 1 serving decode (kernel K1).

The counterpart of `paddle_tpu/ops_pallas/decode_attention.py`'s slotted
kernel (`_decode_inner`/`_decode_kernel`, launched by
`_ragged_decode_call`): one query row per grid row `b` against rows
`[0, lengths[b])` of cache row `slot_map[b]`, with the row range of
each lane cut into `num_splits` independent partials. Each partial
emits an UNNORMALISED fp32 accumulator plus its (max, sum-exp) pair
and the count of `block_k`-row chunks it visited; `_merge_splits`
combines the partials (plain torch, as it is plain jnp in JAX).

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
(`csrc/decode_attention.cu`, built on first use by `_build.py`) or
raises; on CPU tensors it runs `ragged_decode_split_plain`, the same
split-K function in plain torch. There is no fallback from one to the
other. `ragged_decode_reference` is the full-slab masked attention the
result is held against (the `_masked_attend` numerics).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

__all__ = ["ragged_decode_attention", "ragged_decode_reference",
           "ragged_decode_split_plain", "pick_decode_blocks",
           "LAUNCHES"]

NEG_INF = -1e30
_SUPPORTED_HD = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class _LaunchCounter:
    """Plain-int count of kernel launches (one per wrapper call on a
    CUDA tensor). A run resets it, drives a path, and reads it to show
    the path really went through the kernel."""

    def __init__(self):
        self.count = 0

    def reset(self):
        self.count = 0


LAUNCHES = _LaunchCounter()


def ragged_decode_reference(q, kc, vc, lengths, slot_map=None):
    """Plain full-slab masked attention (fp32 scores, -1e30 mask):
    q (B, nh, hd), kc/vc (S, T, nh, hd), lengths (B,) → (B, nh, hd) in
    q's dtype; grid row b reads cache row slot_map[b] (identity when
    None). A lane with no live row gives 0, the kernel's value (a
    softmax over an all-masked row would average V instead)."""
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


def pick_decode_blocks(max_seq: int, head_dim: int,
                       dtype) -> Tuple[int, int]:
    """(block_k, num_splits) for a decode shape: block_k the largest
    candidate dividing max_seq, 2 splits when they divide too and each
    split still holds at least two chunks. The candidate ladder is
    itemsize-scaled as in the reference (1-byte caches afford twice the
    rows per chunk); the reference's TPU autotune table is not used."""
    one_byte = torch.empty((), dtype=dtype).element_size() == 1
    cands = (512, 256, 128, 64, 32, 16, 8) if one_byte \
        else (256, 128, 64, 32, 16, 8)
    for bk in cands:
        if bk <= max_seq and max_seq % bk == 0:
            ns = 2 if max_seq % (bk * 2) == 0 and max_seq // bk >= 4 else 1
            return bk, ns
    return max_seq, 1


def ragged_decode_split_plain(q, kc, vc, lengths, slot_map, scale: float,
                              block_k: int, num_splits: int):
    """The kernel's function in plain torch: per (lane, split) the
    unnormalised accumulator (B, ns, nh, hd) f32, the running max and
    sum-exp (B, ns, 1, nh) f32, and the visited-chunk count (B, ns)
    int32 = clip(ceil((len - split_start) / block_k), 0, split_blocks).
    A split with no live row gives m = -1e30, l = 0, acc = 0."""
    B, nh, hd = q.shape
    T = kc.shape[1]
    split_rows = T // num_splits
    split_blocks = split_rows // block_k
    kv_k = kc[slot_map.long()].float()                       # (B,T,nh,hd)
    kv_v = vc[slot_map.long()].float()
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


def _merge_splits(o, m, l_, dtype):
    """Cross-split online-softmax merge (tiny tensors; plain torch):
    `m* = max_p m_p; out = sum_p e^(m_p-m*) acc_p / sum_p e^(m_p-m*)
    l_p`. Splits with zero live chunks carry m = -1e30 → weight 0."""
    m_star = m.amax(dim=1, keepdim=True)                     # (B,1,1,nh)
    w = torch.exp(m - m_star)                                # (B,P,1,nh)
    l_tot = (w * l_).sum(dim=1)[:, 0]                        # (B, nh)
    out = (w.transpose(2, 3) * o).sum(dim=1)                 # (B, nh, hd)
    return (out / torch.clamp(l_tot, min=1e-30)[..., None]).to(dtype)


def _check_cuda_args(q, kc, vc, lengths, slot_map, block_k, num_splits):
    dev = q.device
    for name, t in (("kc", kc), ("vc", vc), ("lengths", lengths),
                    ("slot_map", slot_map)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported (float32, "
                        f"bfloat16)")
    if kc.dtype != q.dtype or vc.dtype != q.dtype:
        raise TypeError(f"q/kc/vc dtypes differ: {q.dtype}, {kc.dtype}, "
                        f"{vc.dtype}")
    if lengths.dtype != torch.int32 or slot_map.dtype != torch.int32:
        raise TypeError("lengths and slot_map must be int32")
    if kc.shape != vc.shape or kc.dim() != 4:
        raise ValueError(f"kc {tuple(kc.shape)} / vc {tuple(vc.shape)} "
                         f"must both be (S, T, nh, hd)")
    B, nh, hd = q.shape
    S, T = kc.shape[0], kc.shape[1]
    if kc.shape[2:] != (nh, hd):
        raise ValueError(f"q heads {(nh, hd)} != cache {tuple(kc.shape[2:])}")
    if lengths.shape != (B,) or slot_map.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} / slot_map "
                         f"{tuple(slot_map.shape)} must be ({B},)")
    if hd not in _SUPPORTED_HD:
        raise ValueError(f"head_dim {hd} not supported by the kernel "
                         f"(one of {_SUPPORTED_HD})")
    if T % (block_k * num_splits) != 0:
        raise ValueError(f"max_seq {T} must be divisible by "
                         f"block_k*num_splits ({block_k}*{num_splits})")
    for name, t in (("q", q), ("kc", kc), ("vc", vc), ("lengths", lengths),
                    ("slot_map", slot_map)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("kc", kc), ("vc", vc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if B < 1 or B > 65535 or nh > 65535 or S < 1:
        raise ValueError(f"grid rows {B} / heads {nh} out of range")


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, kc, vc, lengths, slot_map, acc, m, l, visits; B, S, T, nh, hd,
    # dtype, block_k, num_splits; scale; stream
    "ragged_decode_launch": (ctypes.c_int,
                             [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P]),
    "error_string": (ctypes.c_char_p, [_I]),
}


def _launch_cuda(q, kc, vc, lengths, slot_map, scale, block_k, num_splits):
    from ._build import load_library
    _check_cuda_args(q, kc, vc, lengths, slot_map, block_k, num_splits)
    B, nh, hd = q.shape
    S, T = kc.shape[0], kc.shape[1]
    acc = torch.empty((B, num_splits, nh, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((B, num_splits, 1, nh), dtype=torch.float32,
                    device=q.device)
    l_ = torch.empty_like(m)
    visits = torch.empty((B, num_splits), dtype=torch.int32,
                         device=q.device)
    lib = load_library("decode_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ragged_decode_launch(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(),
            slot_map.data_ptr(), acc.data_ptr(), m.data_ptr(),
            l_.data_ptr(), visits.data_ptr(), B, S, T, nh, hd,
            _DTYPE_CODE[q.dtype], block_k, num_splits, scale, stream)
    if err != 0:
        raise RuntimeError(f"ragged_decode kernel launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")
    LAUNCHES.count += 1
    return acc, m, l_, visits


def ragged_decode_attention(q, kc, vc, lengths,
                            slot_map: Optional[torch.Tensor] = None,
                            block_k: Optional[int] = None,
                            num_splits: Optional[int] = None,
                            with_stats: bool = False):
    """Flash-decode over a slotted cache: q (B, nh, hd) or (B, 1, nh, hd)
    against kc/vc (S, T, nh, hd), grid row `b` attending rows
    `[0, lengths[b])` of cache row `slot_map[b]` (identity when None —
    plain decode, B == S; a speculative verify pass repeats slots with
    per-query lengths). Returns the attention output in q's layout and
    dtype; `with_stats=True` also returns the (B, num_splits) visited-
    chunk counts. CUDA tensors run the Hopper kernel (or raise); CPU
    tensors run the same function in plain torch."""
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
    if q.device.type == "cuda":
        o, m, l_, visits = _launch_cuda(q, kc, vc, lengths, slot_map, scale,
                                        block_k, num_splits)
    elif q.device.type == "cpu":
        o, m, l_, visits = ragged_decode_split_plain(
            q, kc, vc, lengths, slot_map, scale, block_k, num_splits)
    else:
        raise ValueError(f"unsupported device {q.device}")
    out = _merge_splits(o, m, l_, q.dtype)
    if squeeze:
        out = out[:, None]
    return (out, visits) if with_stats else out
