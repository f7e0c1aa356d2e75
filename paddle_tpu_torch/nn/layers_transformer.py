"""Transformer layers: the counterpart of
`paddle_tpu/nn/layers_transformer.py` (`MultiHeadAttention`,
`TransformerEncoderLayer` / `TransformerEncoder`,
`TransformerDecoderLayer` / `TransformerDecoder`, `Transformer`, and the
`Fused*` names of the incubate API).

Attention runs in the (batch, seq, heads, head_dim) layout through
`functional.scaled_dot_product_attention`, as in JAX: without a mask or
dropout the flash kernels K2/K3 on a CUDA tensor (their plain versions
on a CPU one), otherwise `attention_dense`. `need_weights=True` computes
the weights explicitly (softmax in the activation dtype, then dropout)
and returns them. A bool mask keeps where True; any other mask is
added to the scores. `cache=(k_prev, v_prev)` appends this call's keys
and values and returns the new pair.

Parameter names and layouts are JAX's (`self_attn.q_proj.weight` (in,
out), `linear1`, `norm1`, ...). The weights are drawn on the CPU from
`gen` (an explicit `torch.Generator`; a generator seeded with 0 when
none is given) with JAX's initializers (Linear: `weight_attr`, default
XavierUniform; bias 0 or `bias_attr`). An encoder or decoder of n
layers holds n deep copies of the layer it is given, so all n start
from the same weights, as in JAX.
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import torch
from torch import nn

from ..core import make_generator
from . import functional as F
from .layers import Dropout, LayerNorm, Linear
from .layers_common import LayerList

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer"]


def _convert_attn_mask(mask, dtype=None):
    """None, a bool mask (kept bool: True keeps) or an additive float
    mask (kept as it is)."""
    if mask is None:
        return None
    return torch.as_tensor(mask)


def _gen(gen: Optional[torch.Generator]) -> torch.Generator:
    return gen if gen is not None else make_generator(0)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(gen)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = dict(gen=gen, weight_attr=weight_attr, bias_attr=bias_attr)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim, embed_dim, **kw)
        self.v_proj = Linear(vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        if cache is not None:       # incremental decode: (k_prev, v_prev)
            k_prev, v_prev = cache
            k = torch.cat([k_prev, k], dim=1)
            v = torch.cat([v_prev, v], dim=1)
            new_cache = (k, v)
        mask = _convert_attn_mask(attn_mask, q.dtype)
        if self.need_weights:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(
                self.head_dim)
            if mask is not None:
                mask = mask.to(logits.device)
                if mask.dtype == torch.bool:
                    logits = torch.where(mask, logits, -1e30)
                else:
                    logits = logits + mask
            weights = F.softmax(logits, axis=-1)
            weights = F.dropout(weights, self.dropout,
                                training=self.training)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=self.dropout,
                training=self.training)
            weights = None
        b, s = out.shape[:2]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        rets = [out]
        if self.need_weights:
            rets.append(weights)
        if cache is not None:
            rets.append(new_cache)
        return rets[0] if len(rets) == 1 else tuple(rets)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(gen)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(gen=gen, weight_attr=weight_attr, bias_attr=bias_attr)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, new_cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, new_cache)


def _clones(layer, n):
    return LayerList([layer if i == 0 else copy.deepcopy(layer)
                      for i in range(n)])


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(gen)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(gen=gen, weight_attr=weight_attr, bias_attr=bias_attr)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        for layer in self.layers:
            output = layer(output, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output


class Transformer(nn.Module):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(gen)
        self.d_model = d_model
        self.nhead = nhead
        args = (dropout, activation, attn_dropout, act_dropout,
                normalize_before, weight_attr, bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, *args, gen=gen)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, *args, gen=gen)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        return torch.ones((length, length), dtype=torch.bool,
                          device=device).tril()


# the incubate API's fused layers: the same layers (the flash kernels do
# the attention's fusing)
FusedMultiHeadAttention = MultiHeadAttention
FusedTransformerEncoderLayer = TransformerEncoderLayer


class FusedFeedForward(nn.Module):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 activation="relu", act_dropout_rate=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = _gen(gen)
        act_dropout_rate = dropout_rate if act_dropout_rate is None \
            else act_dropout_rate
        self.normalize_before = normalize_before
        kw = dict(gen=gen, weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.dropout = Dropout(act_dropout_rate)
        self.dropout2 = Dropout(dropout_rate)
        self.norm = LayerNorm(d_model)
        self.activation = getattr(F, activation)

    def forward(self, x):
        residual = x
        if self.normalize_before:
            x = self.norm(x)
        x = self.linear2(self.dropout(self.activation(self.linear1(x))))
        x = residual + self.dropout2(x)
        if not self.normalize_before:
            x = self.norm(x)
        return x
