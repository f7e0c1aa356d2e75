"""BERT / ERNIE of the PyTorch/CUDA port: the counterpart of
`paddle_tpu/models/bert.py` (`BertConfig`, `BertSelfAttention`,
`BertLayer`, `Bert`, `BertForSequenceClassification`,
`BertForMaskedLM`, `ernie_base`, `bert_base`, `bert_large`).

A post-norm encoder: token + position + segment embeddings, LayerNorm,
dropout, then per layer the fused qkv projection, attention, the output
projection, dropout, the residual and LayerNorm, the exact-erf GELU
MLP, dropout, the residual and LayerNorm (one `Dropout` module applied
twice, so two draws); a tanh pooler over the first token. Names, shapes
and layouts are JAX's, so `named_parameters()` equals the JAX
`raw_parameters()` keys and a JAX model (and its AdamW state) carries
over with `models.weights.load_jax_state` / `from_jax_train_state(
model=)`. The parameters carry the JAX package's TP `.spec`s
(`paddle_tpu/models/bert.py:48-95`): qkv and fc1 split by columns
(qkv head-aligned, `tp_groups` 3, so a rank holds whole heads), out
and fc2 by rows, the word embedding by vocabulary; under
`Trainer(mesh=)` with tp > 1 each rank runs its shards
(`parallel.tp_layers`: the row-parallel linears and the word lookup
all-reduce over "tp"; the masked-LM head's vocabulary-sharded logits
are all-gathered).

Attention takes slices of the packed (b, s, 3, h, d) qkv through
`nn.functional.scaled_dot_product_attention`, so it routes as JAX's
`_pallas_ok` does: with no mask and no attention dropout (evaluation,
prediction, or `attention_dropout=0` in training) non-causal K2/K3 on a
card; with an `attention_mask` or dropout in training,
`attention_dense`. The (b, s) 1/0 `attention_mask` becomes the additive
(b, 1, 1, s) mask (1 - m) * -1e4 in the activation dtype (under O2 bf16
rounds -1e4 to -9984, as JAX's weak-typed constant does), which
`attention_dense` adds in fp32.

Weights are drawn in fp32 on the CPU from one generator seeded by
`seed` (every Linear and Embedding ~ N(0, initializer_range), but the
MLM head's `transform`, XavierUniform; LayerNorm weight 1, bias 0),
then moved to `device` (the card by default: `core.resolve_device`
raises without one) in `dtype`. There are no published weights here:
a model starts from random weights, as `bench.py`'s ERNIE run does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..core import DeviceLike, make_generator, resolve_device, resolve_dtype
from ..nn import functional as F
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..nn.layers_common import LayerList, Tanh
from ..parallel.mesh import P
from ..parallel.tp_layers import (copy_to_tp, head_block, parallel_matmul,
                                  row_parallel, vocab_parallel)

__all__ = ["BertConfig", "BertSelfAttention", "BertLayer", "Bert",
           "BertForSequenceClassification", "BertForMaskedLM",
           "ernie_base", "bert_base", "bert_large"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02


def _place(module: nn.Module, device: torch.device, dtype) -> None:
    module.to(device=device)
    dt = resolve_dtype(dtype)
    for p in module.parameters():
        p.data = p.data.to(dt)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, gen: torch.Generator):
        super().__init__()
        h, std = cfg.hidden_size, cfg.initializer_range
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.qkv = Linear(h, 3 * h, std, gen)
        _column(self.qkv, groups=3)
        self.out = Linear(h, h, std, gen)
        self.out.weight.spec = P("tp", None)
        self.dropout = cfg.attention_dropout

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        # under tp: the rank's heads
        qkv = self.qkv(copy_to_tp(x)).reshape(b, s, 3, -1, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training,
            head_block=head_block(q.shape[2], self.num_heads))
        return row_parallel(self.out, out.reshape(b, s, -1))


class BertLayer(nn.Module):
    """Post-norm encoder block (the original BERT / ERNIE layout)."""

    def __init__(self, cfg: BertConfig, gen: torch.Generator):
        super().__init__()
        std = cfg.initializer_range
        self.attn = BertSelfAttention(cfg, gen)
        self.ln1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size, std, gen)
        _column(self.fc1)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size, std, gen)
        self.fc2.weight.spec = P("tp", None)
        self.ln2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.dropout(self.attn(x, attn_mask)))
        ffn = row_parallel(self.fc2, F.gelu(self.fc1(copy_to_tp(x))))
        return self.ln2(x + self.dropout(ffn))


def _column(linear: Linear, groups: int = 1) -> None:
    """The JAX specs of a column-parallel linear (weight P(None, "tp"),
    bias P("tp")); `groups` column groups split each over the ranks."""
    linear.weight.spec = P(None, "tp")
    linear.bias.spec = P("tp")
    linear.weight.tp_groups = linear.bias.tp_groups = groups


def additive_mask(attention_mask, dtype):
    """(b, s) 1/0 → the additive (b, 1, 1, s) mask (1 - m) * -1e4, the
    constant rounded to `dtype` first as JAX's weak type is."""
    m = attention_mask[:, None, None, :].to(dtype)
    return (1.0 - m) * torch.tensor(-1e4, dtype=dtype, device=m.device)


class Bert(nn.Module):
    """The encoder and pooler; `forward` returns (sequence output,
    pooled output)."""

    def __init__(self, cfg: BertConfig, seed: int = 0,
                 device: DeviceLike = None, dtype=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)          # fail fast, before the init
        gen = gen if gen is not None else make_generator(seed)
        std = cfg.initializer_range
        self.cfg = cfg
        self.word_emb = Embedding(cfg.vocab_size, cfg.hidden_size, std, gen)
        self.word_emb.weight.spec = P("tp", None)
        self.pos_emb = Embedding(cfg.max_position_embeddings,
                                 cfg.hidden_size, std, gen)
        self.type_emb = Embedding(cfg.type_vocab_size, cfg.hidden_size, std,
                                  gen)
        self.emb_ln = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.emb_drop = Dropout(cfg.hidden_dropout)
        self.layers = LayerList([BertLayer(cfg, gen)
                                 for _ in range(cfg.num_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, std, gen)
        self.pooler_act = Tanh()
        _place(self, dev, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = vocab_parallel(self.word_emb, input_ids) + self.pos_emb(pos) \
            + self.type_emb(token_type_ids)
        x = self.emb_drop(self.emb_ln(x))
        mask = None
        if attention_mask is not None:
            mask = additive_mask(attention_mask, x.dtype)
        for layer in self.layers:
            x = layer(x, mask)
        pooled = self.pooler_act(self.pooler(x[:, 0]))
        return x, pooled


class BertForSequenceClassification(nn.Module):
    def __init__(self, cfg: BertConfig, num_classes: int = 2, seed: int = 0,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        gen = make_generator(seed)
        self.bert = Bert(cfg, device="cpu", gen=gen)
        self.dropout = Dropout(cfg.hidden_dropout)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 cfg.initializer_range, gen)
        _place(self, dev, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForMaskedLM(nn.Module):
    """Logits over the vocabulary through the word embedding (tied)."""

    def __init__(self, cfg: BertConfig, seed: int = 0,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        gen = make_generator(seed)
        self.bert = Bert(cfg, device="cpu", gen=gen)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, gen=gen)
        self.transform_ln = LayerNorm(cfg.hidden_size,
                                      epsilon=cfg.layer_norm_eps)
        _place(self, dev, dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_ln(F.gelu(self.transform(seq)))
        # under tp the rank's vocabulary columns, all-gathered
        return parallel_matmul(h, self.bert.word_emb.weight,
                               transpose_y=True)


def ernie_base(**kw):
    """ERNIE-3.0-base's shape (12 layers, hidden 768, 12 heads, vocab
    40000)."""
    return BertConfig(vocab_size=40000, hidden_size=768, num_layers=12,
                      num_heads=12, intermediate_size=3072, **kw)


def bert_base(**kw):
    return BertConfig(vocab_size=30522, max_position_embeddings=512,
                      type_vocab_size=2, **kw)


def bert_large(**kw):
    return BertConfig(vocab_size=30522, hidden_size=1024, num_layers=24,
                      num_heads=16, intermediate_size=4096,
                      max_position_embeddings=512, type_vocab_size=2, **kw)
