"""The layers GPT is built from: Linear, Embedding, LayerNorm, GELU and
Dropout, the counterparts of `paddle_tpu/nn/layers_common.py` and
`layers_norm.py`.

They keep the JAX package's parameter names and layouts (`weight` and
`bias`; Linear's weight is (in, out)) so a model's `named_parameters()`
equal the JAX `raw_parameters()` keys. Weights are drawn from an
explicit `torch.Generator` (the port keeps no global RNG state): Linear
and Embedding take a normal std, LayerNorm starts at weight 1, bias 0.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["Linear", "Embedding", "LayerNorm", "GELU", "Dropout"]


def _normal(shape, std: float, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=gen))


class Linear(nn.Module):
    """y = x @ weight + bias with weight (in, out), the JAX layout;
    weight ~ N(0, std), bias 0."""

    def __init__(self, in_features: int, out_features: int, std: float,
                 gen: torch.Generator, bias: bool = True):
        super().__init__()
        self.weight = _normal((in_features, out_features), std, gen)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias \
            else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Lookup table (num, dim) ~ N(0, std)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, std: float,
                 gen: torch.Generator):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), std, gen)

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(nn.Module):
    """Over the trailing `normalized_shape`; the affine runs in the
    activation dtype (see `functional.layer_norm`)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class GELU(nn.Module):
    def __init__(self, approximate: bool = False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Dropout(nn.Module):
    """`functional.dropout` with the module's training flag; identity at
    p = 0 or in eval mode."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train"):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)
