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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .decode_attention import _LaunchCounter

__all__ = ["int8_linear_fused", "int8_linear_plain", "INT8_LAUNCHES"]

INT8_LAUNCHES = _LaunchCounter()          # K7

_MAX_ROWS = 4
_COLS = 16                                # columns per CTA in the kernel
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, qweight, w_scale, act_scale, bias, out; m, k, n, x_dtype,
    # ws_dtype, bias_dtype; stream
    "int8_linear_launch": (ctypes.c_int, [_P] * 6 + [_I] * 6 + [_P]),
    "error_string": (ctypes.c_char_p, [_I]),
}


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


def _launch_cuda(x2, qweight, w_scale, act_scale, bias):
    from ._build import load_library
    _check_cuda_args(x2, qweight, w_scale, act_scale, bias)
    m, k = x2.shape
    n = qweight.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    lib = load_library("int8_linear", _SIGNATURES)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.int8_linear_launch(
            x2.data_ptr(), qweight.data_ptr(), w_scale.data_ptr(),
            act_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            m, k, n, _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w_scale.dtype],
            _DTYPE_CODE[bias.dtype] if bias is not None else 0, stream)
    if err != 0:
        raise RuntimeError(f"int8_linear kernel launch failed: "
                           f"{lib.error_string(err).decode()} ({err})")
    INT8_LAUNCHES.count += 1
    return out


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
