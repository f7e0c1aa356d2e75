"""Symmetric int8 numerics: the abs-max scale, quantize and dequantize.

The counterpart of the core numerics of `paddle_tpu/quantization/__init__.py`
(`abs_max_scale`, `quantize_tensor`, `dequantize_tensor`); QAT, PTQ and
the int8 layers are not ported yet (ROADMAP Queue 1 item 10). The
rounding points are the reference's, because an int8 code is decided
at them:

- the abs-max and the division by 127 run in the INPUT's dtype, so a
  bf16 input gives a bf16-rounded scale (widened later by the caller);
- quantizing divides in fp32 whatever the input dtype, rounds half to
  even (`torch.round`, as `jnp.round`) and clips to [-127, 127].
"""
from __future__ import annotations

import torch

__all__ = ["abs_max_scale", "quantize_tensor", "dequantize_tensor"]


def abs_max_scale(x: torch.Tensor, dim=None, keepdim: bool = False,
                  eps: float = 1e-8) -> torch.Tensor:
    """Symmetric abs-max scale `max(|x|, eps) / 127`, in x's dtype."""
    a = x.abs()
    m = a.amax() if dim is None else a.amax(dim=dim, keepdim=keepdim)
    return torch.clamp(m, min=eps) / 127.0


def quantize_tensor(x: torch.Tensor, scale) -> torch.Tensor:
    """float → int8: fp32 divide, round half to even, clip to ±127."""
    scale = torch.as_tensor(scale, device=x.device).float()
    return torch.clamp(torch.round(x.float() / scale), -127, 127) \
        .to(torch.int8)


def dequantize_tensor(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale
