"""The functional ops the GPT training path uses, in PyTorch.

A subset of `paddle_tpu/nn/functional.py` with the same rounding points:
`linear` is `x @ w` (weight (in, out)) with the bias cast to the output
dtype, and under `amp.auto_cast` (O1) casts x and w to the compute
dtype first, as the JAX `linear` does; `layer_norm` normalises in fp32,
casts to the activation dtype and THEN applies weight and bias in that
dtype (so bf16 stays bf16; the serving path's `models.gpt._ln` keeps
the decode wiring's fp32 affine); `gelu` and `embedding` as in JAX;
`dropout` (both modes, `axis`), `dropout2d`, `dropout3d` and
`alpha_dropout` draw their masks from the training step's key
(`nn.rng`); `scaled_dot_product_attention` goes through the dispatcher
of `ops_cuda.flash_attention` (the flash kernels, or the dense
function for a mask or dropout).
"""
from __future__ import annotations

import torch

from .. import amp as _amp
from ..ops_cuda import flash_attention as _fa
from . import rng as _rng

__all__ = ["linear", "layer_norm", "gelu", "embedding", "dropout",
           "dropout2d", "dropout3d", "alpha_dropout",
           "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """y = x @ weight + bias, weight stored (in_features, out_features);
    a white-list op under O1."""
    x, weight = _amp.white_op_hint(x, weight, op="linear")
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """Statistics in fp32 (at least), the centred (x - mean)^2 variance;
    the normalised value is cast to x's dtype before the affine, which
    runs in x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def gelu(x, approximate: bool = False):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def embedding(x, weight):
    return weight[x]


def _weak(v: float, x):
    """A Python number as JAX meets it beside an array: in the array's
    dtype (a weak type), so x / (1 - p) divides a bf16 x by a bf16
    1 - p."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", keep=None):
    """JAX's `dropout`: in training each entry is kept with probability
    1 - p (one draw per position of the kept `axis` dims, broadcast
    over the others) and, in "upscale_in_train" mode, divided by 1 - p;
    "downscale_in_infer" multiplies by 1 - p outside training instead.
    `keep` (bool, the mask's shape) replaces the draw: the tests hold
    the arithmetic against JAX's own mask with it."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * _weak(1 - p, x)
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    if keep is None:
        keep = _rng.keep_mask(1.0 - p, shape, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / _weak(1.0 - p, x), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW", keep=None):
    """Whole channels: one draw per (sample, channel)."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p=p, axis=axis, training=training, keep=keep)


def dropout3d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCDHW", keep=None):
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p=p, axis=axis, training=training, keep=keep)


def alpha_dropout(x, p: float = 0.5, training: bool = True, keep=None):
    """SELU-preserving dropout: dropped entries take -alpha scale, then
    the affine a x + b that keeps mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    if keep is None:
        keep = _rng.keep_mask(1.0 - p, x.shape, x.device)
    a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    return (_weak(a, x) * torch.where(keep, x, _weak(alpha_p, x))
            + _weak(b, x)).to(x.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """Layout (batch, seq, heads, head_dim); the flash kernels K2/K3 on
    CUDA tensors, their plain versions on CPU tensors; a mask or
    dropout (in training) through `attention_dense`."""
    return _fa.dot_product_attention(
        query, key, value, mask=attn_mask, causal=is_causal,
        dropout_p=dropout_p if training else 0.0)
