"""The functional ops the GPT training path uses, in PyTorch.

A subset of `paddle_tpu/nn/functional.py` with the same rounding points:
`linear` is `x @ w` (weight (in, out)) with the bias cast to the output
dtype; `layer_norm` normalises in fp32, casts to the activation dtype
and THEN applies weight and bias in that dtype (so bf16 stays bf16; the
serving path's `models.gpt._ln` keeps the decode wiring's fp32 affine);
`gelu` and `embedding` as in JAX; `dropout` is the identity at p = 0
(every GPT preset) and raises above it; `scaled_dot_product_attention`
goes to the flash kernels through `ops_cuda.flash_attention`.
"""
from __future__ import annotations

import torch

from ..ops_cuda import flash_attention as _fa

__all__ = ["linear", "layer_norm", "gelu", "embedding", "dropout",
           "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """y = x @ weight + bias, weight stored (in_features, out_features)."""
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


def dropout(x, p: float = 0.5, training: bool = True):
    """The identity when not training or at p = 0; p > 0 in training is
    not ported (ROADMAP Queue 1, after item 6)."""
    if not training or p == 0.0:
        return x
    raise NotImplementedError(
        f"dropout p={p} in training is not ported yet (ROADMAP Queue 1, "
        f"after item 6); every GPT preset has dropout=0.0")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """Layout (batch, seq, heads, head_dim); the flash kernels K2/K3 on
    CUDA tensors, their plain versions on CPU tensors."""
    return _fa.dot_product_attention(
        query, key, value, mask=attn_mask, causal=is_causal,
        dropout_p=dropout_p if training else 0.0)
