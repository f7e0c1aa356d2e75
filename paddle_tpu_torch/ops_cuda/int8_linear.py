"""Fused int8 GEMV for few-row decode: kernel K7.

The counterpart of `_int8_linear_fused` / `_int8_fused_kernel` in
`paddle_tpu/quantization/__init__.py`: for x (m <= 4, k) in fp32 or
bf16, int8 weights (k, n), per-output-channel weight scales `w_scale`
(n,), one activation scale `act_scale` and an optional bias (n,),

    qx  = clip(round_half_even(x.f32 / act_scale), -127, 127)   int8
    acc = qx @ qweight                                           int32
    out = (acc.f32 * (w_scale.f32 * act_scale) + bias.f32).to(x.dtype)

Every step is integer arithmetic or one IEEE-rounded fp32 operation, so
the kernel, its plain version and the TPU kernel give the same bits.

On CUDA tensors `int8_linear_fused` launches the hand-written Hopper
kernel (`csrc/int8_linear.cu`, built on first use by `_build.py`) or
raises; on CPU tensors it runs `int8_linear_plain`. There is no
fallback from one to the other. `INT8_LAUNCHES` counts the launches.

The kernel reads the weight in JAX's (k, n) layout, 16 columns of one
k-row per 16-byte load, four k-rows (a quad) at a time. Rows a, b, c, d
of a quad give, for each word position j (columns 4j..4j+3), four row
words; two rounds of `__byte_perm` (selector nibble i picks byte i of
the result from the 8 bytes {first operand, second operand}) turn them
into one word per column holding its 4 codes along k:

    t0 = prmt(a, b, 0x5140)   t1 = prmt(a, b, 0x7362)
    t2 = prmt(c, d, 0x5140)   t3 = prmt(c, d, 0x7362)
    column 4j   = prmt(t0, t2, 0x5410)   column 4j+1 = prmt(t0, t2, 0x7632)
    column 4j+2 = prmt(t1, t3, 0x5410)   column 4j+3 = prmt(t1, t3, 0x7632)

and `__dp4a(column word, packed codes of x, acc)` adds the quad's 4
products to the int32 sum (the activation's codes are packed the same
way: byte i of word q is k-row 4q + i, 0 past k).
`tests/test_torch_int8_plan.py` replays these selectors in numpy.
`launch_plan` cuts the work: tiles of 16·G columns, k-ranges of whole
quads over the CTAs of a thread-block cluster, k-lanes inside a CTA.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .decode_attention import _LaunchCounter

__all__ = ["int8_linear_fused", "int8_linear_plain", "INT8_LAUNCHES",
           "launch_plan", "LaunchPlan"]

INT8_LAUNCHES = _LaunchCounter()          # K7

_MAX_ROWS = 4
_COLS = 16                    # columns of one 16-byte weight load
_MAX_GROUPS = 4               # column groups of 16 per tile
_MAX_THREADS = 256
_MAX_CLUSTER = 8              # the portable thread-block cluster size
_CTAS_PER_SM = 2              # the kernel's __launch_bounds__
_SPLIT_CTAS_PER_SM = 1.5      # split-k fills about this many CTAs per SM
_MIN_QUADS = 8                # a k-range of at least 32 rows
_SMEM_LIMIT = 232448          # dynamic shared memory a CTA may use
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# timing variants of the kernel (phase 8's breakdown only)
NO_PROLOGUE, NO_REDUCTION, NO_MERGE = 1, 2, 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, qweight, w_scale, act_scale, bias, out; m, k, n, x_dtype,
    # ws_dtype, bias_dtype; the plan (groups, cluster, quads_per_cta,
    # threads, grid); parts; stream
    "int8_linear_launch": (ctypes.c_int, [_P] * 6 + [_I] * 12 + [_P]),
    "timer_empty_launch": (ctypes.c_int, [_I, _I, _P]),
    # p, bytes, sink, grid, stream
    "timer_stream_read_launch": (ctypes.c_int, [_P, ctypes.c_longlong, _P,
                                                _I, _P]),
    "error_string": (ctypes.c_char_p, [_I]),
}


class LaunchPlan(NamedTuple):
    """How the kernel cuts one call: tiles of 16·`groups` columns; each
    tile's k in `cluster` consecutive ranges of `quads_per_cta` quads
    (4 k-rows), one per CTA of a thread-block cluster; `threads` per CTA
    = `groups` × k-lanes; `grid` = clusters × `cluster` CTAs, the
    clusters striding over the tiles."""
    groups: int
    cluster: int
    quads_per_cta: int
    threads: int
    grid: int


def smem_bytes(m: int, plan: LaunchPlan) -> int:
    """Dynamic shared memory of one CTA (as `smem_bytes` in the source):
    the packed codes of its k-range, the reduction rows (k-lane stride
    padded by 4·G words), and two buffers each of cluster partials and
    of the tile's scales and biases; int32 words."""
    g, lanes = plan.groups, plan.threads // plan.groups
    xq = -(-plan.quads_per_cta * m // 4) * 4
    return 4 * (xq + lanes * (16 * m * g + 4 * g)
                + 2 * (m * 16 * g + _MAX_CLUSTER) + 4 * 16 * g)


@functools.lru_cache(maxsize=None)
def launch_plan(m: int, k: int, n: int, num_sms: int) -> LaunchPlan:
    """The launch of (m, k) × (k, n) on a card with `num_sms` SMs.

    - Tiles of 16·G columns, G the largest of 4, 2, 1 that n / 16
      reaches; every load starts at a multiple of 16 columns.
    - Split-k for the narrow shapes: the tiles times the cluster size
      come to about 1.5 CTAs per SM (2 per SM in clusters of 8 did not
      all fit at once on an H100), at most 8 CTAs a cluster,
      each k-range at least `_MIN_QUADS` quads; the ranks' ranges cover
      the ceil(k / 4) quads exactly once, none empty. A k too long for
      one CTA's shared memory takes more ranks.
    - k-lanes: as many as the range has quads, up to 256 / G threads.
    - Wide shapes (more tiles than CTA slots): one CTA per cluster, and
      the clusters stride over the tiles, so x is quantized once per
      CTA rather than once per tile.
    """
    if not (1 <= m <= _MAX_ROWS and k >= 1 and n >= _COLS and n % _COLS == 0
            and num_sms >= 1):
        raise ValueError(f"no K7 plan for m = {m}, k = {k}, n = {n}, "
                         f"{num_sms} SMs")
    quads = -(-k // 4)
    col_groups = n // _COLS
    g = _MAX_GROUPS
    while g > col_groups:
        g //= 2
    tiles = -(-col_groups // g)
    slots = _CTAS_PER_SM * num_sms
    split = int(_SPLIT_CTAS_PER_SM * num_sms / tiles + 0.5)
    want = max(1, min(_MAX_CLUSTER, split, -(-quads // _MIN_QUADS)))
    for s in range(want, _MAX_CLUSTER + 1):
        qpc = -(-quads // s)
        cluster = -(-quads // qpc)              # no empty rank
        lanes = min(_MAX_THREADS // g, qpc)
        threads = max(-(-g * lanes // 32) * 32, 16 * g)
        clusters = min(tiles, max(1, slots // cluster))
        plan = LaunchPlan(g, cluster, qpc, threads, clusters * cluster)
        if smem_bytes(m, plan) <= _SMEM_LIMIT:
            return plan
    raise ValueError(f"k = {k} is too long for the fused GEMV at m = {m}: "
                     f"its codes do not fit {_MAX_CLUSTER} CTAs' shared "
                     f"memory")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int8_linear_plain(x2: torch.Tensor, qweight: torch.Tensor, w_scale,
                      act_scale, bias: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K7's function in plain torch: quantize, an exact int32 product,
    then the fp32 epilogue as separate operations (each one rounding),
    and one cast to x's dtype."""
    from ..quantization import int_product, quantize_tensor
    sx = torch.as_tensor(act_scale, device=x2.device).float()
    acc = int_product(quantize_tensor(x2, sx), qweight)
    ws = torch.as_tensor(w_scale, device=x2.device).float()
    out = acc.float() * (ws * sx)
    if bias is not None:
        out = out + bias.float()
    return out.to(x2.dtype)


def _check_cuda_args(x2, qweight, w_scale, act_scale, bias):
    dev = x2.device
    named = [("qweight", qweight), ("w_scale", w_scale),
             ("act_scale", act_scale)]
    if bias is not None:
        named.append(("bias", bias))
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x2.dtype} not supported (float32, "
                        f"bfloat16)")
    if qweight.dtype != torch.int8:
        raise TypeError(f"qweight must be int8, got {qweight.dtype}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} dtype {t.dtype} not supported "
                            f"(float32, bfloat16)")
    if act_scale.dtype != torch.float32 or act_scale.numel() != 1:
        raise TypeError("act_scale must be one float32 value")
    if x2.dim() != 2 or qweight.dim() != 2:
        raise ValueError(f"x {tuple(x2.shape)} and qweight "
                         f"{tuple(qweight.shape)} must be 2-D")
    m, k = x2.shape
    if qweight.shape[0] != k:
        raise ValueError(f"x has k = {k}, qweight {tuple(qweight.shape)}")
    n = qweight.shape[1]
    if not 1 <= m <= _MAX_ROWS:
        raise ValueError(f"the fused GEMV takes 1..{_MAX_ROWS} rows, "
                         f"got {m}")
    if n % _COLS:
        raise ValueError(f"n = {n} must be a multiple of {_COLS}")
    if w_scale.numel() != n or (bias is not None and bias.numel() != n):
        raise ValueError(f"w_scale / bias must have n = {n} values")
    for name, t in [("x", x2)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qweight.data_ptr() % 16:
        raise ValueError("qweight must be 16-byte aligned")


def _library():
    from ._build import load_library
    return load_library("int8_linear", _SIGNATURES)


def _raise_on(lib, err, what="int8_linear kernel"):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")


def _launch_cuda(x2, qweight, w_scale, act_scale, bias, parts=0):
    """One launch of K7 (`parts` 0), or of a timing variant of it
    (`parts` NO_PROLOGUE, NO_REDUCTION, both, or NO_MERGE; 4 rows; the
    output is not the function; not counted)."""
    _check_cuda_args(x2, qweight, w_scale, act_scale, bias)
    m, k = x2.shape
    n = qweight.shape[1]
    plan = launch_plan(m, k, n, _sm_count(x2.device.index))
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    lib = _library()
    with torch.cuda.device(x2.device):
        err = lib.int8_linear_launch(
            x2.data_ptr(), qweight.data_ptr(), w_scale.data_ptr(),
            act_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            m, k, n, _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w_scale.dtype],
            _DTYPE_CODE[bias.dtype] if bias is not None else 0, *plan,
            parts, torch.cuda.current_stream(x2.device).cuda_stream)
    _raise_on(lib, err)
    if not parts:
        INT8_LAUNCHES.count += 1
    return out


def timer_empty(device, grid: int = 1, cluster: int = 1) -> None:
    """Launch the empty yardstick kernel (the timer's floor) on
    `device`'s current stream: `grid` CTAs, in thread-block clusters of
    `cluster` that meet once at a cluster barrier when `cluster` > 1."""
    lib = _library()
    with torch.cuda.device(device):
        _raise_on(lib, lib.timer_empty_launch(
            grid, cluster, torch.cuda.current_stream(device).cuda_stream),
            "empty kernel")


def timer_stream_read(t: torch.Tensor, sink: torch.Tensor,
                      grid: int) -> None:
    """Read every byte of the contiguous CUDA tensor `t` once with
    16-byte loads over `grid` CTAs of 256 threads (a yardstick: what a
    perfect GEMV could read under the same timer). `sink` is one int32
    on the same device that the kernel never writes in practice."""
    if not (t.is_cuda and t.is_contiguous() and sink.device == t.device
            and sink.dtype == torch.int32 and sink.numel() >= 1):
        raise ValueError("stream read wants a contiguous CUDA tensor and "
                         "one int32 sink on its device")
    lib = _library()
    with torch.cuda.device(t.device):
        _raise_on(lib, lib.timer_stream_read_launch(
            t.data_ptr(), t.numel() * t.element_size(), sink.data_ptr(),
            grid, torch.cuda.current_stream(t.device).cuda_stream),
            "stream-read kernel")


def int8_linear_fused(x2: torch.Tensor, qweight: torch.Tensor, w_scale,
                      act_scale, bias: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The fused int8 GEMV over x2 (m <= 4, k): K7 on CUDA tensors (or a
    raise on arguments it does not take), the plain version on CPU
    tensors. Returns (m, n) in x2's dtype."""
    if x2.device.type == "cuda":
        sx = torch.as_tensor(act_scale, dtype=torch.float32,
                             device=x2.device)
        ws = torch.as_tensor(w_scale, device=x2.device).reshape(-1)
        if ws.numel() == 1:             # one scale for every column
            ws = ws.expand(qweight.shape[-1]).contiguous()
        return _launch_cuda(x2, qweight, ws, sx, bias)
    if x2.device.type == "cpu":
        return int8_linear_plain(x2, qweight, w_scale, act_scale, bias)
    raise ValueError(f"unsupported device {x2.device}")
