"""Flash attention for training: forward (kernel K2) and backward (K3).

The counterpart of `paddle_tpu/ops_pallas/flash_attention.py`: the
forward `_fwd_kernel` (launched by `_flash_forward_flat`), the merged
backward `_bwd_merged_kernel` (launched by `_flash_backward_flat`), the
`_flash_attention` custom VJP that joins them, the
`dot_product_attention` dispatcher and the `_attention_reference` the
kernels are held against. Layout (batch, seq, heads, head_dim), as in
the JAX package.

On a CUDA tensor `FlashAttentionFunction` launches hand-written Hopper
kernels (`csrc/flash_attention_fwd.cu`, `csrc/flash_attention_bwd.cu`:
TMA loads and wgmma products), built on first use by `_build.py`, on
one of two routes fixed by dtype (`_check_cuda_args`, which raises on
anything else), both at head dim 32, 64 or 128: bf16 goes to the
`wgmma` route (bf16 products), fp32 to the `tf32x3` route (each fp32
product as three TF32 products over hi and lo parts, which a split
kernel writes first, with the transposed copies TF32 wgmma needs;
`tf32_split` is its arithmetic in plain torch). On CPU tensors it runs
`flash_forward_plain` / `flash_backward_plain`, the same functions in
plain torch. There is no fallback from one to the other. Each CUDA
launch adds one to `FWD_LAUNCHES` or `BWD_LAUNCHES` and to its route's
own counter (one backward call launches the split, delta, dk/dv and dq
kernels, and counts once).

Causal attention with sq > sk leaves the first sq - sk query rows with
no visible key; every version gives them the reference's uniform
softmax over all sk keys (`empty_rows`).

The wgmma route reads q, k, v through TMA tensor maps over their
(batch, seq, head) strides, so the slices of the fused qkv projection
go in without copies; TMA needs a contiguous head dim, a 16-byte
aligned base and strides that are multiples of 16 bytes. The tf32x3
route reads an input that meets those rules the same way, as its own hi
part (the tensor cores read fp32 as TF32 by dropping the 13 low bits),
and its split kernel writes the rest with plain loads, so it takes any
strides with a contiguous head dim. The logsumexp is
(batch, heads, seq_q) fp32; the JAX kernels keep it as
(batch * heads, 1, seq_q).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .decode_attention import _LaunchCounter

__all__ = ["dot_product_attention", "FlashAttentionFunction",
           "flash_forward_plain", "flash_backward_plain",
           "flash_delta_plain", "attention_reference", "empty_rows",
           "tf32_split", "FWD_LAUNCHES", "BWD_LAUNCHES",
           "WGMMA_FWD_LAUNCHES", "WGMMA_BWD_LAUNCHES",
           "TF32X3_FWD_LAUNCHES", "TF32X3_BWD_LAUNCHES"]

NEG_INF = -1e30
# (dtype, head dim) -> route: K2/K3 with bf16 products (`wgmma`) and
# with 3xTF32 products for fp32 (`tf32x3`)
WGMMA, TF32X3 = "wgmma", "tf32x3"
_ROUTES = {(torch.bfloat16, 32): WGMMA, (torch.bfloat16, 64): WGMMA,
           (torch.bfloat16, 128): WGMMA, (torch.float32, 32): TF32X3,
           (torch.float32, 64): TF32X3, (torch.float32, 128): TF32X3}
_SUPPORTED_HD = tuple(sorted({d for _, d in _ROUTES}))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# every launch of either route (one per forward or backward call)...
FWD_LAUNCHES = _LaunchCounter()
BWD_LAUNCHES = _LaunchCounter()
# ...and each route's own share, so a run can show which route it took
WGMMA_FWD_LAUNCHES = _LaunchCounter()
WGMMA_BWD_LAUNCHES = _LaunchCounter()
TF32X3_FWD_LAUNCHES = _LaunchCounter()
TF32X3_BWD_LAUNCHES = _LaunchCounter()


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, after item 6)")


# --------------------------------------------------------------------------- #
# plain versions (the CPU path, and what the kernels are held against)
# --------------------------------------------------------------------------- #

def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """`_attention_reference` in torch (no mask, no dropout): q (b, sq,
    h, d), k/v (b, sk, h, d); scores in the input dtype, times `scale`,
    then fp32; the causal mask is tril(k = sk - sq) (bottom-right
    aligned); softmax in fp32, weights cast to v's dtype."""
    sq, d = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).float()
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = torch.where(keep, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _scores(q, k, causal: bool, scale: float):
    """fp32 scores (b, h, sq, sk) of bf16-exact products with fp32
    sums, scaled in fp32, -1e30 where the causal rule hides a key."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(keep, s, NEG_INF)
    return s


def flash_forward_plain(q, k, v, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function in plain torch: (out (b, sq, h, d) in q's dtype,
    lse (b, h, sq) fp32). Products take the operands' values exactly and
    sum in fp32; p = exp(s - m) is cast to v's dtype before p.v; a row
    with l == 0 divides by 1. One softmax pass over all keys where the
    kernel goes tile by tile: equal up to fp32 summation order and the
    point where p is rounded."""
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_ = p.sum(-1, keepdim=True)
    l_safe = torch.where(l_ == 0, 1.0, l_)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def flash_delta_plain(out, g):
    """The backward's delta = rowsum(out * g) in fp32, as
    `_flash_backward_flat` computes it, as (b, h, sq) fp32 (the delta
    kernel's function)."""
    f32 = torch.float32
    return (out.to(f32) * g.to(f32)).sum(-1).permute(0, 2, 1)


def empty_rows(sq: int, sk: int, causal: bool, device=None):
    """(sq,) bool: the query rows that see no key. Under the bottom-right
    causal rule row q sees keys j <= q + sk - sq, so with sq > sk the
    first sq - sk rows see none. The reference gives such a row a
    uniform softmax over all sk keys (its -1e30 scores are all equal):
    out = the mean of v, and under `jax.grad` dq = 0, no dk from it and
    dv += g / sk."""
    rows = torch.arange(sq, device=device)
    return rows + (sk - sq) < 0 if causal else torch.zeros_like(
        rows, dtype=torch.bool)


def flash_backward_plain(q, k, v, out, lse, g, causal: bool, scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """K3's function in plain torch: (dq, dk, dv) in the inputs' dtypes,
    with p = exp(s - lse), dv = (p in g's dtype)^T g, dp = g v^T,
    delta = rowsum(out * g) in fp32, ds = p (dp - delta) scale in q's
    dtype, dq = ds k, dk = ds^T q; products of exact operand values
    summed in fp32. A row with no visible key (`empty_rows`) takes
    p = 1 / sk and ds = 0 explicitly: its lse, -1e30 + log sk, rounds to
    -1e30 in fp32 and cannot give that p."""
    f32 = torch.float32
    sq, sk = q.shape[1], k.shape[1]
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    empty = empty_rows(sq, sk, causal, q.device)[:, None]      # (sq, 1)
    p = torch.where(empty, 1.0 / sk, p)
    gf = g.to(f32)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).to(f32), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.to(f32))
    delta = flash_delta_plain(out, g)[..., None]
    ds = torch.where(empty, 0.0, p * (dp - delta) * scale)
    ds = ds.to(q.dtype).to(f32)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(f32))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f32))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_split(x):
    """The tf32x3 route's split of an fp32 tensor (`split_kernel` and
    `to_a_frags` in csrc/flash_attention_common.cuh), in plain torch:
    hi = x with its 13 low mantissa bits cleared, lo = x - hi rounded to
    TF32 (nearest, ties away from zero), both exact in TF32, so the
    tensor cores read them as they are; hi + lo is x within 2^-21 |x|.
    A product a.b runs as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b."""
    x = x.contiguous()
    hi = (x.view(torch.int32) & -8192).view(torch.float32)
    lo = ((x - hi).view(torch.int32) + 4096 & -8192).view(torch.float32)
    return hi, lo


# --------------------------------------------------------------------------- #
# the CUDA path
# --------------------------------------------------------------------------- #

def _check_cuda_args(q, k, v, causal: bool) -> str:
    """What the flash kernels take, and which route: `WGMMA` for bf16,
    `TF32X3` for fp32, both at head dim 32, 64 or 128, a fixed choice by
    dtype and head dim. Raises on anything else (the wrapper never runs
    the plain version on the card)."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"q/{name} dtypes differ: {q.dtype}, {t.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported by the flash "
                        f"kernels (bfloat16, float32)")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must be (b, s, h, d), k and v "
                         f"alike")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head_dim")
    if d not in _SUPPORTED_HD:
        raise ValueError(f"head_dim {d} not supported by the flash kernels "
                         f"(one of {_SUPPORTED_HD})")
    sk = k.shape[1]
    rows = b * h * _lse_rows(max(sq, sk))
    if rows >= 2 ** 31:
        raise ValueError(f"batch * heads * round_up(max(sq, sk), 128) = "
                         f"{rows} reaches 2^31: the kernels index work "
                         f"items and lse rows with 32-bit ints")
    route = _ROUTES[(q.dtype, d)]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(route, name, t)
    return route


def _check_layout(route: str, name, t):
    """The layout a route reads: TMA's rules on the wgmma route, a
    contiguous head dim (the split kernel's plain loads over any
    strides) on the tf32x3 one."""
    if route == WGMMA:
        _check_tma_layout(name, t)
    elif t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous head dim (layout "
                         f"strides {t.stride()})")


def _check_tma_layout(name, t):
    """What a TMA tensor map takes: a contiguous head dim, a 16-byte
    aligned base, and (batch, seq, head) strides that are multiples of
    16 bytes (8 bf16 elements)."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a contiguous head dim (layout "
                         f"strides {t.stride()})")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} base address {t.data_ptr():#x} is not "
                         f"16-byte aligned (TMA)")
    if any(st % 8 for st in t.stride()[:3]):
        raise ValueError(f"{name} strides {t.stride()} must be multiples "
                         f"of 8 elements: TMA needs 16-byte aligned rows")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_FWD_SIGNATURES = {
    # q, k, v, out, lse, counter, scratch; b, h, sq, sk, d, dtype;
    # strides (b, s, h of q, k, v, out); causal; scale; parts; stream
    "flash_fwd_launch": (_I, [_P] * 7 + [_I] * 6 + [_P, _I, _F, _I, _P]),
    "flash_fwd_scratch_floats": (_LL, [_I] * 5),
    "flash_fwd_info": (None, [_I, _I, _P]),
    "error_string": (ctypes.c_char_p, [_I]),
}
_BWD_SIGNATURES = {
    # q, k, v, out, g, lse, rows, counters, dq, dk, dv, scratch; b, h, sq,
    # sk, d, dtype; strides (of q, k, v, out, g, dq, dk, dv); causal;
    # scale; parts; stream
    "flash_bwd_launch": (_I, [_P] * 12 + [_I] * 6 + [_P, _I, _F, _I, _P]),
    "flash_bwd_scratch_floats": (_LL, [_I] * 5),
    "flash_bwd_info": (None, [_I, _I, _I, _P]),
    "error_string": (ctypes.c_char_p, [_I]),
}
_PROBE_SIGNATURES = {
    "tf32_probe_launch": (_I, [_P, _P, _P, _I, _P]),
    "error_string": (ctypes.c_char_p, [_I]),
}
# the parts of a launch (the C entries' `parts` bits): the forward's
# split (tf32x3 only) and kernel; the backward's delta, dk/dv and dq
# kernels and its split (tf32x3 only; the wgmma route ignores the bit)
FWD_SPLIT, FWD_MAIN = 1, 2
FWD_ALL = FWD_SPLIT | FWD_MAIN
BWD_DELTA, BWD_DKDV, BWD_DQ, BWD_SPLIT = 1, 2, 4, 8
BWD_ALL = BWD_DELTA | BWD_DKDV | BWD_DQ | BWD_SPLIT


def _bsh(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _lse_rows(sq: int) -> int:
    """Row length of the fp32 lse and delta buffers: sq rounded up to
    128, the kernels' row block (`lse_rows` in
    csrc/flash_attention_common.cuh), so the backward's bulk copies of
    16- to 64-row slices start 16-byte aligned and stay inside their
    row."""
    return -(-sq // 128) * 128


def _row_buffer(b, h, sq, device, zero=False):
    """A (b, h, sq) fp32 view of a (b, h, _lse_rows(sq)) buffer: the
    layout the kernels write lse and delta in."""
    alloc = torch.zeros if zero else torch.empty
    return alloc((b, h, _lse_rows(sq)), dtype=torch.float32,
                 device=device)[..., :sq]


def _in_row_buffer(t) -> bool:
    b, h, sq = t.shape
    rows = _lse_rows(sq)
    return (t.dtype == torch.float32 and t.stride() == (h * rows, rows, 1)
            and t.data_ptr() % 16 == 0)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _strides(*ts):
    """The (batch, seq, head) element strides of each tensor, as the C
    array the kernels take."""
    return ctypes.cast((_LL * (3 * len(ts)))(
        *(x for t in ts for x in _bsh(t))), ctypes.c_void_p)


def _raise_on(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")


def _scratch(lib, which: str, q, k):
    """The tf32x3 route's fp32 scratch for `which` ("fwd" or "bwd"):
    the split kernel's hi and lo copies (sizes from the C side; the hi
    rows of an input read in place stay unwritten); None on the wgmma
    route."""
    if q.dtype != torch.float32:
        return None
    b, sq, h, d = q.shape
    n = getattr(lib, f"flash_{which}_scratch_floats")(b, h, sq, k.shape[1],
                                                     d)
    return torch.empty(n, dtype=torch.float32, device=q.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, causal: bool, scale: float, parts: int = FWD_ALL,
                scratch=None):
    """(out, lse) through the forward kernel of the route. On the tf32x3
    route `parts` and `scratch` (from `_scratch(lib, "fwd", q, k)`) let
    a timing run launch the split and the kernel one at a time."""
    from ._build import load_library
    route = _check_cuda_args(q, k, v, causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = _row_buffer(b, h, sq, q.device)
    if out.numel() == 0:
        return out, lse
    lib = load_library("flash_attention_fwd", _FWD_SIGNATURES)
    if scratch is None:
        scratch = _scratch(lib, "fwd", q, k)
    counter = torch.empty(1, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), counter.data_ptr(), _ptr(scratch), b, h, sq, sk,
            d, _DTYPE_CODE[q.dtype], _strides(q, k, v, out), int(causal),
            scale, parts, _stream(q))
    _raise_on(err, lib, "flash forward")
    (WGMMA_FWD_LAUNCHES if route == WGMMA else TF32X3_FWD_LAUNCHES
     ).count += 1
    FWD_LAUNCHES.count += 1
    return out, lse


def _bwd_rows(b, h, sq, device):
    """The backward's fp32 scratch (b, h, 2, _lse_rows(sq)): delta, then
    lse * log2(e), row by row; the delta kernel fills both (0 past sq)
    and the dk/dv and dq kernels read them."""
    return torch.empty((b, h, 2, _lse_rows(sq)), dtype=torch.float32,
                       device=device)


def _launch_bwd(q, k, v, out, lse, g, causal: bool, scale: float,
                parts: int = BWD_ALL, rows=None, scratch=None):
    """(dq, dk, dv) through the backward kernels of the route. `parts`,
    `rows` (from `_bwd_rows`) and, on the tf32x3 route, `scratch` (from
    `_scratch(lib, "bwd", q, k)`) let a timing run launch one kernel at
    a time (dk/dv and dq read `rows`, which the delta kernel writes, and
    the split's copies); the autograd path runs them all. `lse` is the
    forward's; one in another layout is copied into a row buffer
    first."""
    from ._build import load_library
    route = _check_cuda_args(q, k, v, causal)
    g = g.contiguous()          # autograd may hand in an expanded tensor
    for name, t in (("out", out), ("g", g)):
        _check_layout(route, name, t)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk, dv
    if not _in_row_buffer(lse):
        lse = _row_buffer(b, h, sq, q.device, zero=True).copy_(lse)
    if rows is None:
        rows = _bwd_rows(b, h, sq, q.device)
    elif rows.shape != (b, h, 2, _lse_rows(sq)) or not rows.is_contiguous():
        raise ValueError("rows must come from _bwd_rows")
    lib = load_library("flash_attention_bwd", _BWD_SIGNATURES)
    if scratch is None:
        scratch = _scratch(lib, "bwd", q, k)
    counters = torch.empty(2, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), rows.data_ptr(),
            counters.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _ptr(scratch), b, h, sq, sk, d,
            _DTYPE_CODE[q.dtype], _strides(q, k, v, out, g, dq, dk, dv),
            int(causal), scale, parts, _stream(q))
    _raise_on(err, lib, "flash backward")
    (WGMMA_BWD_LAUNCHES if route == WGMMA else TF32X3_BWD_LAUNCHES
     ).count += 1
    BWD_LAUNCHES.count += 1
    return dq, dk, dv


def kernel_info(d: int, dtype=torch.bfloat16):
    """{kernel: (registers, local bytes, dynamic shared bytes, threads)}
    of the flash kernels for head dim `d` and `dtype`'s route, from
    cudaFuncGetAttributes (local bytes are spills and stack)."""
    from ._build import load_library
    out = {}
    code = _DTYPE_CODE[dtype]
    fwd = load_library("flash_attention_fwd", _FWD_SIGNATURES)
    bwd = load_library("flash_attention_bwd", _BWD_SIGNATURES)
    for name, call in (("flash_fwd", lambda a: fwd.flash_fwd_info(code, d,
                                                                  a)),
                       ("flash_bwd_delta",
                        lambda a: bwd.flash_bwd_info(code, d, 0, a)),
                       ("flash_bwd_dkdv",
                        lambda a: bwd.flash_bwd_info(code, d, 1, a)),
                       ("flash_bwd_dq",
                        lambda a: bwd.flash_bwd_info(code, d, 2, a))):
        arr = (_I * 4)(-1, -1, -1, -1)
        call(ctypes.cast(arr, ctypes.c_void_p))
        out[name] = tuple(arr)
    return out


def tf32_probe(a, b, mode: int):
    """D = a b^T (a, b (64, 32) fp32 on the card) on the tensor cores by
    `csrc/tf32_probe.cu`: mode 0 one TF32 product of the raw values, 1
    3xTF32 from shared memory, 2 3xTF32 with a from registers (the
    permuted fragments the tf32x3 route's P and dS use). Card only."""
    from ._build import load_library
    if a.device.type != "cuda" or a.shape != (64, 32) or b.shape != (64, 32):
        raise ValueError("tf32_probe takes (64, 32) fp32 tensors on the card")
    a = a.float().contiguous()
    b = b.float().contiguous()
    d = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    lib = load_library("tf32_probe", _PROBE_SIGNATURES)
    with torch.cuda.device(a.device):
        err = lib.tf32_probe_launch(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                    mode, _stream(a))
    _raise_on(err, lib, "tf32 probe")
    return d


def flash_forward(q, k, v, causal: bool, scale: float):
    """(out, lse): K2 on CUDA tensors, the plain version on CPU ones."""
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, scale)
    raise ValueError(f"unsupported device {q.device}")


def flash_backward(q, k, v, out, lse, g, causal: bool, scale: float):
    """(dq, dk, dv): K3 on CUDA tensors, the plain version on CPU ones."""
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, g, causal, scale)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, g, causal, scale)
    raise ValueError(f"unsupported device {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """`_flash_attention`'s custom VJP: the forward saves q, k, v, the
    output and the logsumexp; the backward recomputes p from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def dot_product_attention(q, k, v, mask=None, causal: bool = False,
                          scale: Optional[float] = None,
                          dropout_p: float = 0.0):
    """The dispatcher under `nn.functional.scaled_dot_product_attention`:
    q (b, sq, h, d), k/v (b, sk, h, d) → (b, sq, h, d), differentiable
    through `FlashAttentionFunction`. A mask or dropout > 0 raises (not
    ported; every GPT preset has dropout 0). On CUDA tensors what
    neither kernel route takes raises too (`_check_cuda_args`)."""
    if mask is not None:
        raise _not_ported("an attention mask")
    if dropout_p > 0.0:
        raise _not_ported("attention dropout > 0")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFunction.apply(q, k, v, causal, float(scale))
