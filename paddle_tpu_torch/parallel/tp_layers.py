"""Tensor-parallel (Megatron) layers: the counterpart of
`paddle_tpu/parallel/tp_layers.py` (`ColumnParallelLinear`,
`RowParallelLinear`, `VocabParallelEmbedding`, `ParallelCrossEntropy`,
`parallel_matmul`).

As in the JAX package, a layer holds its FULL logical weights, each
with its `.spec` (`P(None, "tp")` for a column split, `P("tp", None)`
for a row or vocabulary split), so a checkpoint does not depend on the
degree. JAX lets GSPMD partition the matmuls; here the tp ranks of a
mesh are logical ranks of one process (`nn/ranks.py`), and inside an
SPMD run with tp > 1 each rank computes on its shard:

- column: every rank reads tp rank 0's copy of the input
  (`copy_to_tp`, a broadcast: the values are the same on every rank),
  then `x @ W[:, rank's columns]`; the ranks' input gradients add up
  in that one tensor before the layers below it see them, which is
  Megatron's identity forward and all-reduce backward (a layer norm
  before it takes its weight's gradient from the whole sum, not from
  each rank's share);
- row: the rank's partial product over its rows, `all_reduce` over
  "tp", then the bias once;
- vocabulary embedding: each rank looks up the ids inside its rows
  (the others give 0) and `all_reduce` adds the ranks' rows;
- cross-entropy over vocabulary-sharded logits: the local max, sum of
  exponentials and target logit, joined by `all_reduce` MAX and SUM.

Under `Trainer(mesh=)` a rank's parameters are its shards of the
state's whole tensors (`parallel.sharding.take_shard`); called in a
run of your own with whole weights, a layer takes its shard itself.
Outside a run, or at tp 1, each layer is its plain counterpart. The
collectives go through `parallel.collective` (counted, and replayed
when a checkpoint recomputes the forward), and they carry the
gradient into the other ranks' graphs: the Trainer runs one backward
over the ranks a collective couples.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import functional as F
from ..nn import initializer as I
from ..nn import ranks
from .mesh import P

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "parallel_matmul", "tp_rank", "column_shard", "row_linear",
           "vocab_embedding", "vocab_parallel_ce", "row_parallel",
           "vocab_parallel", "copy_to_tp", "head_block"]


def tp_rank():
    """(this rank's tp index, the tp degree) inside an SPMD run; (0, 1)
    outside one."""
    return ranks.axis_info("tp")


def head_block(heads: int, num_heads: int):
    """(r, n) when an attention layer computes `heads` of its
    `num_heads` heads, block r of n (its qkv is this tp rank's shard),
    for `F.scaled_dot_product_attention(head_block=)`; None when it
    computes them all."""
    if heads == num_heads:
        return None
    return tp_rank()[0], num_heads // heads


def _collective(name, x, **kw):
    from . import collective as C
    return getattr(C, name)(x, group="tp", **kw)


def copy_to_tp(x):
    """The input of a column-parallel product: under tp, tp rank 0's
    copy for every rank (a broadcast over "tp", whose backward sums the
    ranks' gradients in that one tensor); `x` itself at tp 1."""
    if tp_rank()[1] == 1:
        return x
    return _collective("broadcast", x, src=0)


def column_shard(t: torch.Tensor, full: int, dim: int = -1,
                 groups: int = 1) -> torch.Tensor:
    """The rank's block of `t` along `dim` when `t` is whole there
    (`full` entries; `groups` equal column groups each split over the
    ranks, as a fused qkv's), `t` itself when it already is the rank's
    shard."""
    r, n = tp_rank()
    if n == 1 or t.shape[dim] != full:
        return t
    from .sharding import take_shard
    return take_shard(t, dim % t.dim(), r, n, groups)


def row_linear(x, weight, bias, in_features: int,
               input_is_parallel: bool = True):
    """A row-parallel linear: under tp the rank's rows of `weight` (its
    shard, or taken from the whole) times its part of the input's last
    dim (`input_is_parallel`: x is that part already), `all_reduce`
    over "tp", then the bias once; `F.linear` otherwise."""
    r, n = tp_rank()
    if n == 1:
        return F.linear(x, weight, bias)
    weight = column_shard(weight, in_features, dim=0)
    if not input_is_parallel or x.shape[-1] == in_features:
        x = x.narrow(-1, r * (in_features // n), in_features // n)
    out = _collective("all_reduce", F.linear(x, weight, None))
    return out if bias is None else out + bias.to(out.dtype)


def row_parallel(linear, x):
    """A model's row-parallel `Linear` (GPT's attn.out and fc2, BERT's):
    the module itself at tp 1, else `row_linear` over its rank's
    rows."""
    if tp_rank()[1] == 1:
        return linear(x)
    return row_linear(x, linear.weight, linear.bias, linear.in_features)


def vocab_parallel(table, ids):
    """A model's vocabulary-parallel `Embedding` (GPT's wte, BERT's
    word_emb): the module itself at tp 1, else `vocab_embedding`."""
    if tp_rank()[1] == 1:
        return table(ids)
    return vocab_embedding(ids, table.weight, table.num_embeddings)


def vocab_embedding(ids, weight, num_embeddings: int):
    """Rows `ids` of a vocabulary-parallel table: under tp each rank
    looks up the ids inside its rows (the others give 0), and
    `all_reduce` adds the ranks' rows, exactly the one rank's row."""
    r, n = tp_rank()
    if n == 1:
        return F.embedding(ids, weight)
    weight = column_shard(weight, num_embeddings, dim=0)
    rows = weight.shape[0]
    loc = ids - r * rows
    ok = (loc >= 0) & (loc < rows)
    part = torch.where(ok[..., None], weight[loc.clamp(0, rows - 1)],
                       torch.zeros((), dtype=weight.dtype,
                                   device=weight.device))
    return _collective("all_reduce", part)


class ColumnParallelLinear(nn.Module):
    """Y = XW with W (in, out) split over "tp" by columns (`.spec`
    P(None, "tp"), the bias P("tp")): each rank computes its output
    columns. `gather_output` joins them by `all_gather` over "tp"."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 gather_output: bool = True, fuse_matmul_bias=False,
                 mp_group=None, name=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        init = weight_attr if isinstance(weight_attr, I.Initializer) \
            else I.XavierUniform()
        self.weight = nn.Parameter(init((in_features, out_features), gen))
        self.weight.spec = P(None, "tp")
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
            self.bias.spec = P("tp")

    def forward(self, x):
        w = column_shard(self.weight, self.out_features)
        b = None if self.bias is None else \
            column_shard(self.bias, self.out_features)
        y = F.linear(copy_to_tp(x), w, b)
        if self.gather_output and tp_rank()[1] > 1:
            y = _collective("all_gather", y, axis=y.dim() - 1)
        return y


class RowParallelLinear(nn.Module):
    """Y = XW with W (in, out) split over "tp" by rows (`.spec`
    P("tp", None), the bias replicated): the ranks' partial products
    are added by `all_reduce`. `input_is_parallel`: X arrives split on
    its last dim (a ColumnParallelLinear's output without gather); a
    whole X is split here."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 input_is_parallel: bool = False, fuse_matmul_bias=False,
                 mp_group=None, name=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        init = weight_attr if isinstance(weight_attr, I.Initializer) \
            else I.XavierUniform()
        self.weight = nn.Parameter(init((in_features, out_features), gen))
        self.weight.spec = P("tp", None)
        self.bias = None
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
            self.bias.spec = P()

    def forward(self, x):
        return row_linear(x, self.weight, self.bias, self.in_features,
                          self.input_is_parallel)


class VocabParallelEmbedding(nn.Module):
    """A (num, dim) table split over "tp" by rows (`.spec` P("tp",
    None)); N(0, 0.02) at init, as JAX's."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        init = weight_attr if isinstance(weight_attr, I.Initializer) \
            else I.Normal(0.0, 0.02)
        self.weight = nn.Parameter(init((num_embeddings, embedding_dim),
                                        gen))
        self.weight.spec = P("tp", None)
        self.weight.fsdp_dims = (0,)

    def forward(self, x):
        return vocab_embedding(x, self.weight, self.num_embeddings)


class ParallelCrossEntropy(nn.Module):
    """The per-row loss (last dim kept, size 1; 0 for `ignore_index`)
    of vocabulary-sharded logits in fp32, as
    `F.softmax_with_cross_entropy` of the whole logits."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, label):
        if tp_rank()[1] == 1:
            return F.softmax_with_cross_entropy(
                logits.float(), label, ignore_index=self.ignore_index)
        label = torch.as_tensor(label, device=logits.device).long()
        if label.dim() == logits.dim():
            label = label[..., 0]
        lse, tgt = _vocab_lse_target(logits, label)
        loss = torch.where(label == self.ignore_index, 0.0, lse - tgt)
        return loss[..., None]


def parallel_matmul(x, weight, transpose_y: bool = False,
                    gather_out: bool = True):
    """x @ weight (its transpose with `transpose_y`): the lm-head
    projection onto a vocabulary-parallel table, whose rank's block
    gives the rank's vocabulary columns; `gather_out` joins them by
    `all_gather` over "tp"."""
    w = weight.t() if transpose_y else weight
    y = torch.matmul(copy_to_tp(x), w)
    if gather_out and tp_rank()[1] > 1:
        y = _collective("all_gather", y, axis=y.dim() - 1)
    return y


class _VocabParts(torch.autograd.Function):
    """A tp rank's parts of a cross-entropy over vocabulary-sharded
    logits: per row the sum of exp(x - m) over its block and its target
    logit (0 where another rank holds the label), fp32 reductions of
    the (bf16) logits in place, as `models.gpt._MaskedSoftmaxCE` keeps
    them; the backward recomputes exp(x - m) from the saved logits, so
    no fp32 copy of the block outlives the call."""

    @staticmethod
    def forward(ctx, logits, m, loc, ok):
        e = logits.to(torch.float32, copy=True)
        e.sub_(m[..., None]).exp_()
        s = e.sum(dim=-1)
        del e
        t = logits.gather(-1, loc[..., None])[..., 0].float()
        t = torch.where(ok, t, 0.0)
        ctx.save_for_backward(logits, m, loc, ok)
        return s, t

    @staticmethod
    def backward(ctx, gs, gt):
        logits, m, loc, ok = ctx.saved_tensors
        p = logits.to(torch.float32, copy=True)
        p.sub_(m[..., None]).exp_().mul_(gs[..., None])
        p.scatter_add_(-1, loc[..., None], torch.where(ok, gt, 0.0)[..., None])
        return p.to(logits.dtype), None, None, None


def vocab_parallel_ce(logits, labels, ignore_index: int = -100,
                      count=None):
    """Mean cross-entropy over the rows whose label is not
    `ignore_index`, of logits whose last dim is this tp rank's
    vocabulary block: the row max joined by `all_reduce` MAX, the sums
    of exponentials and the target logits by SUM, then as the whole
    logits' loss. The mean divides by `count` (default the valid rows)
    through `nn.ranks.mean_denominator`, as a masked mean under a mesh
    does."""
    labels = labels.long()
    mask = (labels != ignore_index).float()
    if count is None:
        count = mask.sum()
    lse, t = _vocab_lse_target(logits, labels)
    denom = torch.clamp(ranks.mean_denominator(count), min=1.0)
    return ((lse - t) * mask).sum() / denom


def _vocab_lse_target(logits, labels):
    """(logsumexp, target logit) per row, fp32, of the whole logits
    whose last dim is split over the tp ranks (labels out of range, as
    an ignore_index, give a target of 0)."""
    r, _ = tp_rank()
    v = logits.shape[-1]
    m = _collective("all_reduce", logits.detach().amax(dim=-1),
                    op="max").float()
    loc = labels - r * v
    ok = (loc >= 0) & (loc < v)
    s, t = _VocabParts.apply(logits, m, loc.clamp(0, v - 1), ok)
    s = _collective("all_reduce", s)
    t = _collective("all_reduce", t)
    return torch.log(s) + m, t
