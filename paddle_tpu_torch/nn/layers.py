"""The layers GPT is built from: Linear, Embedding, LayerNorm, GELU and
Dropout, the counterparts of `paddle_tpu/nn/layers_common.py` and
`layers_norm.py`.

They keep the JAX package's parameter names and layouts (`weight` and
`bias`; Linear's weight is (in, out)) so a model's `named_parameters()`
equal the JAX `raw_parameters()` keys. Weights are drawn from an
explicit `torch.Generator` (the port keeps no global RNG state): Linear
and Embedding take a normal std, LayerNorm starts at weight 1, bias 0.
A Linear given no std takes the JAX `Linear`'s weight initializer
instead (`weight_attr`, default `XavierUniform`), as ResNet's head
does, and an Embedding given none JAX's `Normal(0, 1)` (or its
`weight_attr`), with `padding_idx` as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F
from . import initializer as I

__all__ = ["Linear", "Embedding", "LayerNorm", "GELU", "Dropout"]


def _normal(shape, std: float, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=gen))


class Linear(nn.Module):
    """y = x @ weight + bias with weight (in, out), the JAX layout;
    weight ~ N(0, std), or without a std from the `weight_attr`
    initializer (XavierUniform by default, as JAX's `Linear`); bias 0,
    or from the `bias_attr` initializer (`bias_attr=False` or
    `bias=False`: none)."""

    def __init__(self, in_features: int, out_features: int,
                 std: Optional[float] = None,
                 gen: Optional[torch.Generator] = None, bias: bool = True,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        shape = (in_features, out_features)
        if std is not None:
            self.weight = _normal(shape, std, gen)
        else:
            w_init = weight_attr if isinstance(weight_attr, I.Initializer) \
                else I.XavierUniform()
            self.weight = nn.Parameter(w_init(shape, gen))
        if not bias or bias_attr is False:
            self.bias = None
        elif isinstance(bias_attr, I.Initializer):
            self.bias = nn.Parameter(bias_attr((out_features,), gen))
        else:
            self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Lookup table (num, dim): ~ N(0, std) when a std is given (GPT's
    form, `Embedding(num, dim, std, gen)`), else from the `weight_attr`
    initializer (JAX's default `Normal(0, 1)`; another non-initializer
    attribute: XavierUniform). A `padding_idx` (negative counts from
    the end) has its row zeroed at init and gives zeros, and no
    gradient, where the input holds it."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 std: Optional[float] = None,
                 gen: Optional[torch.Generator] = None, *,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = None if padding_idx is None else (
            padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx)
        shape = (num_embeddings, embedding_dim)
        if std is not None:
            self.weight = _normal(shape, std, gen)
        else:
            init = weight_attr if isinstance(weight_attr, I.Initializer) \
                else I.Normal(0.0, 1.0) if weight_attr is None \
                else I.XavierUniform()
            self.weight = nn.Parameter(init(shape, gen))
        # the ZeRO-3 hint of the reference: a table's fsdp shard goes on
        # its vocab dim (`parallel.sharding.fsdp_extend_spec`)
        self.weight.fsdp_dims = (0,)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)


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
