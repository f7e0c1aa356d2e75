"""Quantization: symmetric int8 numerics, QAT (fake-quant with a
straight-through gradient), PTQ calibration and the int8 Linear.

The counterpart of `paddle_tpu/quantization/__init__.py` for Linear
layers (its quantized convolutions, `QuantedConv2D` and `Int8Conv2D`,
are not ported yet: ROADMAP Queue 1, item 13.1's rest). The rounding
points are the reference's, because an int8 code is decided at them:

- the abs-max and the division by 127 run in the INPUT's dtype, so a
  bf16 input gives a bf16-rounded scale (widened later by the caller);
- quantizing divides in fp32 whatever the input dtype, rounds half to
  even (`torch.round`, as `jnp.round`) and clips to [-127, 127];
- the int8 product accumulates exactly in int32, and the epilogue
  rescales in fp32 (`acc * (sx * sw)`, then `+ bias` widened to fp32)
  before one cast to the activation's dtype.

`int8_linear` is the one quantized-linear forward. Few-row inputs
(`_fused_ok`: at most 4 rows, k and n multiples of 128, a scalar
activation scale) go to the fused GEMV `ops_cuda.int8_linear` (kernel
K7 on CUDA tensors, its plain version on CPU tensors); the rest take
the unfused `int8_matmul`. Both paths compute the same integers and the
same fp32 epilogue, so they give the same bits.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["QuantConfig", "fake_quant", "quantize_tensor",
           "dequantize_tensor", "abs_max_scale", "QuantedLinear", "QAT",
           "PTQ", "Int8Linear", "int_product", "int8_matmul",
           "int8_linear"]


# --------------------------------------------------------------------------- #
# core numerics
# --------------------------------------------------------------------------- #

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


def _jnp_dtype(*ts: torch.Tensor) -> torch.dtype:
    """The dtype JAX promotes these arrays to (bf16 with f32 gives f32).
    torch would keep a dimensioned tensor's dtype beside a 0-dim one, so
    the port promotes explicitly wherever JAX mixes them."""
    out = ts[0].dtype
    for t in ts[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


class _FakeQuant(torch.autograd.Function):
    """Quantize → dequantize in float; the gradient passes straight
    through inside the clip range and is zero outside it; the scale
    gets a zero gradient (it is a statistic)."""

    @staticmethod
    def forward(ctx, x, scale):
        dt = _jnp_dtype(x, scale)
        xd, sd = x.to(dt), scale.to(dt)
        ctx.save_for_backward(xd, sd)
        ctx.x_dtype = x.dtype
        return torch.clamp(torch.round(xd / sd), -127, 127) * sd

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        inside = (x.abs() <= 127.0 * scale).to(g.dtype)
        return (g * inside).to(ctx.x_dtype), torch.zeros_like(scale)


def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize→dequantize in float (the QAT forward) with JAX's
    straight-through backward."""
    scale = torch.as_tensor(scale, device=x.device)
    if not scale.is_floating_point():
        scale = scale.float()
    return _FakeQuant.apply(x, scale)


def int_product(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 (m, K) and int8 (K, N):
    `torch._int_mm`. On CUDA it wants more than 16 rows, and cuBLASLt
    refuses some K and N that are no multiples of 128 (K = 104 with
    N = 48, for one), so fewer rows are padded with zero rows (rows are
    independent: the padding changes no real row) and K and N up to
    multiples of 128 with zero codes (they add nothing to any sum)."""
    m, k = qx.shape
    n = qw.shape[1]
    if qx.device.type == "cuda":
        pad_k, pad_n = -k % 128, -n % 128
        qx = torch.nn.functional.pad(qx, (0, pad_k, 0, max(0, 17 - m)))
        if pad_k or pad_n:
            qw = torch.nn.functional.pad(qw, (0, pad_n, 0, pad_k))
    return torch._int_mm(qx.contiguous(), qw.contiguous())[:m, :n]


def int8_matmul(qx: torch.Tensor, qw: torch.Tensor, sx, sw,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 (..., K) × int8 (K, N) accumulated exactly in int32, then
    the rank-1 rescale in fp32 before the output cast. `sw` may be per
    output channel. The product is `int_product`."""
    lead = qx.shape[:-1]
    acc = int_product(qx.reshape(-1, qx.shape[-1]), qw)
    sx = torch.as_tensor(sx, device=acc.device).float()
    sw = torch.as_tensor(sw, device=acc.device).float()
    out = acc.float() * (sx * sw)
    return out.reshape(*lead, qw.shape[1]).to(out_dtype)


def _lead_rows(x: torch.Tensor) -> int:
    rows = 1
    for d in x.shape[:-1]:
        rows *= int(d)
    return rows


def _fused_ok(x: torch.Tensor, qweight: torch.Tensor, act_scale) -> bool:
    """The few-row rule that sends a quantized linear to the fused GEMV
    (K7): at most 4 leading rows, k and n multiples of 128, a scalar
    activation scale. The reference adds a backend test (TPU only); here
    the device is decided by the tensors — K7 on CUDA, its plain
    version on the CPU."""
    if x.dim() < 2 or qweight.dim() != 2:
        return False
    if torch.as_tensor(act_scale).numel() != 1:
        return False            # the fused kernel wants one scalar scale
    k, n = qweight.shape
    return x.shape[-1] == k and _lead_rows(x) <= 4 and n % 128 == 0 \
        and k % 128 == 0


def int8_linear(x: torch.Tensor, qweight: torch.Tensor, w_scale,
                act_scale, bias: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The one quantized-linear forward: quantize the activation with
    the calibrated scale, int8 product with int32 accumulation, fp32
    rescale and bias, one cast to x's dtype. Shared by `Int8Linear` and
    the serving path (`models.gpt._apply_linear`)."""
    if _fused_ok(x, qweight, act_scale):
        from ..ops_cuda.int8_linear import int8_linear_fused
        lead = x.shape[:-1]
        x2 = x.reshape(_lead_rows(x), x.shape[-1])
        out = int8_linear_fused(x2, qweight, w_scale, act_scale, bias)
        return out.reshape(*lead, qweight.shape[1])
    qx = quantize_tensor(x, act_scale)
    out = int8_matmul(qx, qweight, act_scale, w_scale, torch.float32)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------------- #

class QuantConfig:
    """The reference's QAT knobs, reduced to what int8-symmetric needs."""

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 weight_quantize_type: str = "channel_wise_abs_max",
                 activation_quantize_type: str = "moving_average_abs_max",
                 moving_rate: float = 0.9,
                 quantizable_layer_type: Sequence[str] = ("Linear",
                                                          "Conv2D")):
        if weight_bits != 8 or activation_bits != 8:
            raise NotImplementedError("int8 symmetric only")
        self.weight_quantize_type = weight_quantize_type
        self.activation_quantize_type = activation_quantize_type
        self.moving_rate = moving_rate
        self.quantizable_layer_type = tuple(quantizable_layer_type)


# --------------------------------------------------------------------------- #
# QAT layer
# --------------------------------------------------------------------------- #

class QuantedLinear(nn.Module):
    """Wraps a float Linear (weight (in, out)); fake-quants the
    activation (moving-average abs-max buffer `_act_scale`) and the
    weight (channel-wise abs-max over the out axis, recomputed from the
    live weight). While `_calibrating` it runs the pure float layer, so
    PTQ's observers see the float model's activations."""

    def __init__(self, inner: nn.Module, config: QuantConfig):
        super().__init__()
        self.inner = inner
        self._moving_rate = config.moving_rate
        self._per_channel = \
            config.weight_quantize_type == "channel_wise_abs_max"
        self._calibrating = False
        self.register_buffer("_act_scale", torch.tensor(
            1.0, dtype=torch.float32, device=inner.weight.device))

    def _w(self):
        return self.inner.weight

    def _b(self):
        return self.inner.bias

    def weight_scale(self, w: torch.Tensor) -> torch.Tensor:
        if self._per_channel:
            return abs_max_scale(w, dim=0, keepdim=True)      # (1, out)
        return abs_max_scale(w)

    def act_scale(self) -> torch.Tensor:
        return self._act_scale

    def _quant_act(self, x):
        if self._calibrating:
            return x
        scale = self._act_scale
        if self.training:
            with torch.no_grad():
                # 0-dim tensors promote as JAX arrays do: the batch term
                # rounds in x's dtype, the sum in fp32
                scale = self._moving_rate * scale \
                    + (1 - self._moving_rate) * abs_max_scale(x.detach())
                self._act_scale = scale
        return fake_quant(x, scale)

    def forward(self, x):
        from ..nn import functional as F
        w = self._w()
        if self._calibrating:
            return F.linear(x, w, self._b())
        qx, qw = self._quant_act(x), fake_quant(w, self.weight_scale(w))
        dt = _jnp_dtype(qx, qw)
        return F.linear(qx.to(dt), qw.to(dt), self._b())


# --------------------------------------------------------------------------- #
# transforms
# --------------------------------------------------------------------------- #

def _swap_layers(model: nn.Module, should, make) -> int:
    """Replace matching submodules in place; returns the count. Targets
    are collected before any swap, so the walk never descends into a
    new wrapper."""
    targets = [(parent, name, child)
               for _, parent in model.named_modules()
               for name, child in parent.named_children() if should(child)]
    for parent, name, child in targets:
        setattr(parent, name, make(child))
    return len(targets)


class QAT:
    """Quantization-aware training: swap each quantizable Linear for a
    fake-quant `QuantedLinear` in place (`quantize`), and later turn
    the wrappers into int8 `Int8Linear`s (`convert`)."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: nn.Module) -> nn.Module:
        types = self.config.quantizable_layer_type

        def should(m):
            return "Linear" in types and type(m).__name__ == "Linear" \
                and isinstance(getattr(m, "weight", None), torch.Tensor)

        if _swap_layers(model, should,
                        lambda m: QuantedLinear(m, self.config)) == 0:
            raise ValueError("no quantizable layers found")
        return model

    def convert(self, model: nn.Module) -> nn.Module:
        _swap_layers(model, lambda m: isinstance(m, QuantedLinear),
                     Int8Linear.from_quanted)
        model.eval()
        return model


class PTQ:
    """Post-training quantization: wrap (`quantize`), run calibration
    batches through the float model (`sample`), then `convert` with
    activation scales from the observed abs-max of each layer's input
    (`algo="abs_max"`: the largest over the batches; `"percentile"`: a
    quantile of the per-batch maxima). Each observation is a host
    float; the scale `max(m, 1e-8) / 127` is computed in Python double
    and stored as fp32, as the reference."""

    def __init__(self, config: Optional[QuantConfig] = None,
                 algo: str = "abs_max", percentile: float = 0.999):
        if algo not in ("abs_max", "percentile"):
            raise ValueError(f"unknown algo {algo!r}")
        self.config = config or QuantConfig()
        self.algo = algo
        self.percentile = percentile
        self._observed: Dict[int, List[float]] = {}
        self._hooks: List = []

    def quantize(self, model: nn.Module) -> nn.Module:
        QAT(self.config).quantize(model)
        model.eval()
        for sub in model.modules():
            if isinstance(sub, QuantedLinear):
                sub._calibrating = True
                self._observed[id(sub)] = []
                self._hooks.append(sub.register_forward_pre_hook(
                    self._observer(id(sub))))
        return model

    def _observer(self, store: int):
        def hook(layer, args):
            self._observed[store].append(float(args[0].abs().max()))
        return hook

    @torch.no_grad()
    def sample(self, model: nn.Module, data) -> nn.Module:
        """Run calibration batches (token ids, or (ids, ...) tuples)
        through the model on its own device."""
        dev = next(model.parameters()).device
        for batch in data:
            xs = batch[0] if isinstance(batch, (tuple, list)) else batch
            model(torch.as_tensor(np.asarray(xs), device=dev))
        return model

    def convert(self, model: nn.Module) -> nn.Module:
        for sub in model.modules():
            if isinstance(sub, QuantedLinear):
                sub._calibrating = False
                maxima = self._observed.get(id(sub), [])
                if maxima:
                    if self.algo == "percentile":
                        m = float(np.quantile(np.asarray(maxima),
                                              self.percentile))
                    else:
                        m = float(np.max(maxima))
                    sub._act_scale = torch.tensor(
                        max(m, 1e-8) / 127.0, dtype=torch.float32,
                        device=sub._act_scale.device)
        for h in self._hooks:
            h.remove()
        self._hooks = []
        return QAT(self.config).convert(model)


# --------------------------------------------------------------------------- #
# int8 inference layer
# --------------------------------------------------------------------------- #

class Int8Linear(nn.Module):
    """Weights stored as int8 codes (in, out) with per-output-channel
    scales; the forward quantizes the activation with the calibrated
    scale and runs `int8_linear`. Everything is a buffer, under the
    reference's names (`qweight`, `w_scale`, `act_scale`, `bias`)."""

    def __init__(self, qweight, w_scale, act_scale, bias=None):
        super().__init__()
        self.register_buffer("qweight", qweight)
        self.register_buffer("w_scale", torch.as_tensor(w_scale))
        self.register_buffer("act_scale", torch.as_tensor(act_scale))
        self.register_buffer("bias", bias)

    @classmethod
    @torch.no_grad()
    def from_quanted(cls, layer: QuantedLinear) -> "Int8Linear":
        w = layer._w().detach()
        ws = layer.weight_scale(w)
        b = layer._b()
        return cls(quantize_tensor(w, ws), ws.reshape(-1),
                   layer.act_scale().detach().clone(),
                   None if b is None else b.detach().clone())

    def forward(self, x):
        return int8_linear(x, self.qweight, self.w_scale, self.act_scale,
                           self.bias)
