"""GPT decoder-only transformer in PyTorch: the training forward and
loss, the cached forward and generation surface, and the serving decode
wiring.

The counterpart of `paddle_tpu/models/gpt.py` (config, presets, the
`GPT` Layer's forward and fused cross-entropy loss, and the functional
decode path the serving engine runs). Layout choices that keep the two
packages comparable name for name:

- parameter names equal the JAX `raw_parameters()` keys
  (`wte.weight`, `blocks.{i}.attn.qkv.weight`, ..., `ln_f.bias`);
- linear weights keep the JAX (in, out) layout, so `_apply_linear` is
  `x @ w` with no transposes;
- the decode functions take a flat `{name: tensor}` parameter dict
  (`GPT.raw_parameters()`), like the JAX functions take the raw pytree.

Numerics follow the reference: LayerNorm statistics in fp32, GELU with
the tanh approximation, attention scores in fp32 with a -1e30 mask;
training attention runs through the flash kernels K2/K3
(`ops_cuda/flash_attention.py`), decode attention through K1 (K4, K5,
K6 for paged and int8 caches), int8 PTQ linears of at most 4 rows
through K7 (`ops_cuda/int8_linear.py`).
Cache slabs are written IN PLACE (the JAX code returns updated arrays
and donates the old ones instead).

Tensor parallel serving: handed a `nn.tp.ShardedParams` (the weights
placed over a TP group by `serving.sharded_kv.shard_serving_params`),
the decode wiring runs the trainer's layout of the reference
(`paddle_tpu/models/gpt.py:358-471`, `tp_param_specs`): qkv (split
head-aligned) and fc1 by columns, out and fc2 by rows, each rank's
partial sums added by `all_reduce` before the row-parallel bias, the
embedding vocab-parallel (masked lookups, one all-reduce) and the tied
head's vocab-sharded logits joined by `all_gather`; LayerNorms, `wpe`
and the row-parallel biases replicated, computed once. Every rank's
attention runs on its own heads and its own KV slabs (`HeadShards`):
the attention callback gets per-rank q / k / v lists. int8-PTQ linears
stay replicated, as the reference leaves them out of its specs.

Model-parallel training (`Trainer(mesh=)`, `parallel/`): the
parameters' specs are JAX's (`parallel.sharding.param_specs`); under
tp a rank's training forward runs its shards: the vocabulary-parallel
embedding, its heads' q / k / v (the fused qkv split head-aligned:
each rank's columns are whole heads of q, k and v, where JAX's spec
splits the (h, 3h) columns contiguously, which GSPMD may do in a
global program; the shard shapes are JAX's), each column-parallel
product reading tp rank 0's copy of its input (`copy_to_tp`), the
row-parallel out and
fc2 (all-reduced over "tp"), and its vocabulary block of the tied
head's logits, whose loss is `parallel.tp_layers.vocab_parallel_ce`.
With `sequence_parallel` "ring" or "ulysses" and sp > 1, each sp rank
holds its chunk of the sequence at its global positions, attention
runs through `parallel.sequence`, and the loss sums the chunks' terms
over "sp" (the reference's `ValueError` for attention dropout kept).

Generation: `GPT.forward(caches=, cache_position=)` over `init_cache`'s
fixed caches; `generate` (eager, greedy or sampled with a
`torch.Generator`); `generate_jit` / `generate_compiled` and
`beam_search` / `beam_search_compiled`, the reference's one-XLA-program
loops, each run on a card as ONE CUDA graph per signature: the prefill
and every decode step unrolled over static buffers
(`serving.graphs.GraphedCall`), so a step's position is a constant of
the capture. `generate` steps through the same serving wiring
(`_decode_forward`) the graphs capture, so eager and graph give the
same bits; the reference's `generate` steps through its module forward,
whose LayerNorm rounds its affine in the activation dtype (equal in
fp32 up to rounding, other bits in bf16).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..core import DeviceLike, make_generator, resolve_device, resolve_dtype
from ..nn import functional as F
from ..nn import ranks
from ..nn.layers import GELU, Dropout, Embedding, LayerNorm, Linear
from ..nn.tp import ShardedParams, all_gather, all_reduce
from ..parallel.tp_layers import (copy_to_tp, head_block, row_parallel,
                                  vocab_parallel)
from ..quantization.kv import (HeadShards, dequant_slab, is_quantized,
                               map_slab, slab_data, slab_shape, take_rows)

__all__ = ["GPTConfig", "GPT", "GPTBlock", "gpt_tiny", "gpt_small",
           "gpt_medium", "gpt_1p3b", "param_shapes", "tp_param_specs",
           "tp_collectives_per_step", "generate_greedy",
           "generate_compiled", "beam_search_compiled"]

NEG_INF = -1e30
Params = Dict[str, torch.Tensor]
# the Linears of a block, by their names under `blocks.{i}.`
BLOCK_LINEARS = ("attn.qkv", "attn.out", "mlp.fc1", "mlp.fc2")


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_embeddings: bool = True
    sequence_parallel: str = "none"

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible "
                             f"by num_heads {self.num_heads}")
        if self.sequence_parallel not in ("none", "ring", "ulysses"):
            raise ValueError(
                f"sequence_parallel must be 'none', 'ring' or 'ulysses', "
                f"got {self.sequence_parallel!r}")

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def param_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    """{name: shape} of every GPT parameter, in construction order."""
    h, f = cfg.hidden_size, cfg.ffn_size
    out = {"wte.weight": (cfg.vocab_size, h),
           "wpe.weight": (cfg.max_seq_len, h)}
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        out.update({
            pre + "ln1.weight": (h,), pre + "ln1.bias": (h,),
            pre + "attn.qkv.weight": (h, 3 * h),
            pre + "attn.qkv.bias": (3 * h,),
            pre + "attn.out.weight": (h, h), pre + "attn.out.bias": (h,),
            pre + "ln2.weight": (h,), pre + "ln2.bias": (h,),
            pre + "mlp.fc1.weight": (h, f), pre + "mlp.fc1.bias": (f,),
            pre + "mlp.fc2.weight": (f, h), pre + "mlp.fc2.bias": (h,),
        })
    out.update({"ln_f.weight": (h,), "ln_f.bias": (h,)})
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = (h, cfg.vocab_size)
    return out


# --------------------------------------------------------------------------- #
# fused next-token cross-entropy
# --------------------------------------------------------------------------- #
#
# The counterpart of the JAX custom VJP `_masked_softmax_ce`: the
# backward recomputes p = exp(lg - lse) from the saved (bf16) logits and
# the (b, s) fp32 logsumexp, so no fp32 copy of the (b, s, vocab) logits
# outlives the call. Plain torch, as XLA computed it in JAX; the fp32
# temporaries are updated in place so one of them exists at a time.

def _ce_fwd_impl(logits, labels, ignore_index: int, count=None):
    # max and gather in the logits' dtype (exact), the exp-sum in fp32
    m = logits.amax(dim=-1, keepdim=True)
    mf = m.float()
    e = logits.to(torch.float32, copy=True)
    e.sub_(mf).exp_()
    lse = torch.log(e.sum(dim=-1)) + mf[..., 0]
    del e
    idx = labels.clamp(min=0).long()
    tgt = logits.gather(-1, idx[..., None])[..., 0].float()
    mask = (labels != ignore_index).float()
    # under a mesh: the count of the global batch (nn.ranks)
    denom = torch.clamp(ranks.mean_denominator(
        mask.sum() if count is None else count), min=1.0)
    loss = ((lse - tgt) * mask).sum() / denom
    return loss, lse, mask, denom


class _MaskedSoftmaxCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ignore_index: int, count=None):
        loss, lse, mask, denom = _ce_fwd_impl(logits, labels, ignore_index,
                                              count)
        ctx.save_for_backward(logits, labels, lse, mask, denom)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, mask, denom = ctx.saved_tensors
        coef = (g * mask / denom)[..., None]               # (b, s, 1) f32
        p = logits.to(torch.float32, copy=True)
        p.sub_(lse[..., None]).exp_()
        idx = labels.clamp(min=0).long()[..., None]
        p.scatter_add_(-1, idx, torch.full(idx.shape, -1.0,
                                           device=p.device))  # p - onehot
        p.mul_(coef)
        return p.to(logits.dtype), None, None, None


def _masked_softmax_ce(logits, labels, ignore_index: int = -100):
    """Mean next-token cross-entropy over the labels that are not
    `ignore_index` (a label of ignore_index contributes nothing; an
    all-ignored batch gives 0). Under a mesh the mean is over the valid
    labels of the global batch: a data rank divides its sum by their
    all-reduced count (`nn.ranks.mean_denominator`), which the Trainer's
    count pass gathers before any backward."""
    if ranks.is_counting():
        return ranks.record_count((labels != ignore_index).sum())
    return _MaskedSoftmaxCE.apply(logits, labels, ignore_index)


# --------------------------------------------------------------------------- #
# modules: the reference's names, init laws and training forward
# --------------------------------------------------------------------------- #

class GPTAttention(nn.Module):
    """Fused-QKV causal self-attention; the flash kernels K2/K3 attend
    the q, k, v slices of the projection in place."""

    def __init__(self, cfg: GPTConfig, gen: torch.Generator):
        super().__init__()
        h, std = cfg.hidden_size, cfg.initializer_range
        self.cfg = cfg
        self.qkv = Linear(h, 3 * h, std, gen)
        self.out = Linear(h, h, std / math.sqrt(2 * cfg.num_layers), gen)
        self.dropout = cfg.dropout

    def forward(self, x, cache=None, cache_position=None):
        """Training: causal attention through the flash kernels. With a
        `cache` (k, v), each (b, T, nh, hd) from `GPT.init_cache`: the
        new rows are written in place at `cache_position` and the
        queries attend rows [0, their position] of the cache through
        `_masked_attend` (the reference computes this with XLA, outside
        its kernels); returns (out, cache)."""
        b, s, h = x.shape
        cfg = self.cfg
        if cache is None:
            # under tp the qkv weight is the rank's head-aligned columns:
            # its heads' q, k and v
            qkv = self.qkv(copy_to_tp(x))
            nh = qkv.shape[-1] // (3 * cfg.head_dim)
            qkv = qkv.reshape(b, s, 3, nh, cfg.head_dim)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if _sp_degree(cfg) > 1:
                if self.training and self.dropout > 0.0:
                    # the sequence-parallel routes have no attention
                    # dropout (a dense fallback would lose the O(S/sp)
                    # memory asked for), as in the reference
                    raise ValueError(
                        "sequence_parallel is incompatible with "
                        "attention dropout > 0 (set dropout=0.0, the "
                        "usual long-context pretraining setting)")
                from ..parallel import sequence as seq
                attn = {"ring": seq.ring_attention,
                        "ulysses": seq.ulysses_attention}[
                            cfg.sequence_parallel]
                out = attn(q, k, v, causal=True)
            else:
                out = F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, dropout_p=self.dropout,
                    training=self.training,
                    head_block=head_block(nh, cfg.num_heads))
            return row_parallel(self.out, out.reshape(b, s, nh * cfg.head_dim))
        qkv = self.qkv(x).reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache_position is None:
            raise ValueError("a fixed-shape cache needs an explicit "
                             "cache_position (see GPT.init_cache)")
        kc, vc = cache
        pos, T = int(cache_position), kc.shape[1]
        if not 0 <= pos <= T - s:
            raise ValueError(f"cache_position {pos} + {s} rows outside "
                             f"the cache's {T} rows")
        kc[:, pos:pos + s] = k.to(kc.dtype)
        vc[:, pos:pos + s] = v.to(vc.dtype)
        q_pos = pos + torch.arange(s, device=x.device)
        keep = torch.arange(T, device=x.device)[None, :] <= q_pos[:, None]
        out = _masked_attend(q, kc, vc, keep[None, None]).to(x.dtype)
        return self.out(out.reshape(b, s, h)), (kc, vc)


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, gen: torch.Generator):
        super().__init__()
        std = cfg.initializer_range
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_size, std, gen)
        self.fc2 = Linear(cfg.ffn_size, cfg.hidden_size,
                          std / math.sqrt(2 * cfg.num_layers), gen)
        self.act = GELU(True)

    def forward(self, x):
        return row_parallel(self.fc2, self.act(self.fc1(copy_to_tp(x))))


def _sp_degree(cfg: GPTConfig) -> int:
    """The sp ranks a sequence-parallel GPT's forward splits over (1
    outside an SPMD run with sp > 1, or with sequence_parallel
    "none")."""
    if cfg.sequence_parallel == "none":
        return 1
    return ranks.axis_info("sp")[1]


class GPTBlock(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, cfg: GPTConfig, gen: torch.Generator):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.ln1 = LayerNorm(cfg.hidden_size, epsilon=eps)
        self.attn = GPTAttention(cfg, gen)
        self.ln2 = LayerNorm(cfg.hidden_size, epsilon=eps)
        self.mlp = GPTMLP(cfg, gen)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, cache=None, cache_position=None):
        if cache is not None:
            a, cache = self.attn(self.ln1(x), cache, cache_position)
            x = x + self.dropout(a)
            return x + self.dropout(self.mlp(self.ln2(x))), cache
        x = x + self.dropout(self.attn(self.ln1(x)))
        return x + self.dropout(self.mlp(self.ln2(x)))


class GPT(nn.Module):
    """Decoder-only LM with the reference's parameter names and init
    laws: N(0, initializer_range) for embeddings, qkv and fc1; std
    initializer_range / sqrt(2 L) for the residual projections out and
    fc2; LayerNorm weights 1 and biases 0; linear biases 0. The weights
    come from `seed` through an explicit generator (drawn in fp32 on
    the CPU, then moved to `device` in `dtype`), so a seed gives the
    same model on every device."""

    def __init__(self, cfg: GPTConfig, seed: int = 0,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        dev = resolve_device(device)         # fail fast, before the init
        self.cfg = cfg
        gen = make_generator(seed)
        std = cfg.initializer_range
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, std, gen)
        self.wpe = Embedding(cfg.max_seq_len, cfg.hidden_size, std, gen)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(GPTBlock(cfg, gen)
                                    for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.lm_head = None if cfg.tie_embeddings else \
            Linear(cfg.hidden_size, cfg.vocab_size, std, gen, bias=False)
        for blk in self.blocks:
            # a tp rank's qkv columns are its heads' q, k and v
            # (`parallel.sharding.model_splits`)
            blk.attn.qkv.weight.tp_groups = blk.attn.qkv.bias.tp_groups = 3
        self.to(device=dev, dtype=resolve_dtype(dtype))

    def init_cache(self, batch: int, max_len: int, dtype=None):
        """Fixed-shape decode caches: per layer (k, v), each (batch,
        max_len, heads, head_dim) zeros in `dtype` (default the
        weights'), written in place by `forward(..., caches=...,
        cache_position=...)`."""
        cfg = self.cfg
        if max_len > cfg.max_seq_len:
            raise ValueError(f"cache max_len {max_len} exceeds max_seq_len "
                             f"{cfg.max_seq_len}")
        dtype = resolve_dtype(dtype, self.dtype)
        shape = (batch, max_len, cfg.num_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(cfg.num_layers)]

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_position=None):
        """Logits (b, s, vocab) of a causal pass over `input_ids` (b, s),
        attention through the flash kernels. With `caches` (from
        `init_cache`) the pass continues a cached sequence from
        `cache_position` (positions default to cache_position + [0, s)),
        writes its rows into the caches in place and returns (logits,
        caches)."""
        b, s = input_ids.shape
        if caches is not None and cache_position is None:
            raise ValueError(
                "forward with caches needs an explicit cache_position "
                "(fixed-shape decode protocol: see GPT.init_cache)")
        sp_i, sp = (0, 1) if caches is not None else \
            ranks.axis_info("sp") if _sp_degree(self.cfg) > 1 else (0, 1)
        if sp > 1:
            # this sp rank's chunk of the sequence, at its global
            # positions
            if s % sp:
                raise ValueError(f"sequence {s} does not split over "
                                 f"sp={sp}")
            s //= sp
            input_ids = input_ids[:, sp_i * s:(sp_i + 1) * s]
            if position_ids is not None and position_ids.shape[-1] != s:
                position_ids = position_ids[..., sp_i * s:(sp_i + 1) * s]
        if position_ids is None:
            ofs = sp_i * s if caches is None else int(cache_position)
            position_ids = ofs + torch.arange(s, device=input_ids.device)[None]
        x = self.drop(vocab_parallel(self.wte, input_ids)
                      + self.wpe(position_ids))
        new_caches = []
        for i, blk in enumerate(self.blocks):
            if caches is None:
                x = blk(x)
            else:
                x, c = blk(x, caches[i], cache_position)
                new_caches.append(c)
        x = self.ln_f(x)
        if caches is None:
            x = copy_to_tp(x)           # the head's vocabulary columns
        logits = self.lm_head(x) if self.lm_head is not None \
            else torch.matmul(x, self.wte.weight.t())
        if caches is not None:
            return logits, new_caches
        if sp > 1:
            ranks.mark_split(logits, "sp", 1)
        if ranks.axis_info("tp")[1] > 1:     # the rank's vocabulary block
            ranks.mark_split(logits, "tp", -1)
        return logits

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Eager decoding over a fixed KV cache: the prompt's prefill,
        then one cached step per token. Greedy when `temperature` is 0
        or `rng` is None; else each token is drawn from softmax(logits
        / temperature) with `rng` (a `torch.Generator` on the model's
        device), the logits below the top_k-th largest masked out (ties
        stay in). Returns (b, prompt + max_new_tokens) token ids."""
        cfg = self.cfg
        ids = torch.as_tensor(input_ids, device=self.device).long()
        b, prompt, total = _decode_dims(cfg, ids, max_new_tokens)
        if max_new_tokens < 1:
            return ids
        greedy = temperature == 0.0 or rng is None

        def pick(t, last):
            if greedy:
                # argmax of the fp32 logits: the scaled and top-k masked
                # logits have the same largest entry
                return torch.argmax(last, dim=-1)
            lg = _top_k_mask(last / max(temperature, 1e-6), top_k)
            return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                     generator=rng)[:, 0]

        k, v = _fixed_cache(cfg, self.dtype, self.device, b, total)
        buf = torch.zeros((b, total), dtype=torch.int64, device=self.device)
        return _generate_loop(cfg, self.serving_params(), ids, k, v, buf,
                              pick)

    def generate_jit(self, input_ids, max_new_tokens: int = 32,
                     temperature: float = 0.0, top_k: int = 0,
                     seed: int = 0) -> torch.Tensor:
        """The whole decode loop as one CUDA graph per signature (see
        `generate_compiled`)."""
        return generate_compiled(self, input_ids, max_new_tokens,
                                 temperature, top_k, seed)

    def beam_search(self, input_ids, beam_size: int = 4,
                    max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None,
                    length_penalty: float = 0.6):
        """Beam search as one CUDA graph per signature (see
        `beam_search_compiled`)."""
        return beam_search_compiled(self, input_ids, beam_size,
                                    max_new_tokens, eos_token_id,
                                    length_penalty)

    def loss(self, logits, labels, ignore_index: int = -100):
        """Next-token cross-entropy: logits[:, :-1] against
        labels[:, 1:], labels equal to `ignore_index` left out.

        Inside an SPMD run: under tp the logits are the rank's
        vocabulary block and the loss is the vocabulary-parallel form
        (`parallel.tp_layers.vocab_parallel_ce`: the row max, sums of
        exponentials and target logits all-reduced, the fp32 reductions
        in place); under sequence parallelism the logits are the rank's
        chunk of positions, the labels the whole sequence: the chunk's
        masked sum over the count of the whole sequence's labels,
        all-reduced over "sp", so every rank holds the whole loss."""
        tp = ranks.axis_info("tp")[1]
        sp_i, sp = ranks.axis_info("sp") if _sp_degree(self.cfg) > 1 \
            else (0, 1)
        if tp == 1 and sp == 1:
            return _masked_softmax_ce(logits[:, :-1], labels[:, 1:],
                                      ignore_index)
        nxt = labels[:, 1:]
        if ranks.is_counting():
            return ranks.record_count((nxt != ignore_index).sum())
        count = None
        if sp > 1:
            count = (nxt != ignore_index).sum().float()
            L = logits.shape[1]
            nxt = torch.cat([nxt, torch.full_like(labels[:, :1],
                                                  ignore_index)], dim=1)
            nxt = nxt[:, sp_i * L:(sp_i + 1) * L]
        else:
            logits = logits[:, :-1]
        if tp > 1:
            from ..parallel.tp_layers import vocab_parallel_ce
            loss = vocab_parallel_ce(logits, nxt, ignore_index, count)
        else:
            loss = _MaskedSoftmaxCE.apply(logits, nxt, ignore_index, count)
        if sp > 1:
            from ..parallel import collective as C
            loss = C.all_reduce(loss, group="sp")
        return loss

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wte.weight.dtype

    def raw_parameters(self) -> Params:
        """Flat {name: tensor} view of the weights (detached, storage
        shared)."""
        return {k: p.detach() for k, p in self.named_parameters()}

    def raw_buffers(self) -> Params:
        """Flat {name: tensor} view of the buffers: the int8 codes and
        scales of `quantization.Int8Linear` layers (`<prefix>.qweight`,
        `.w_scale`, `.act_scale`, `.bias`) after a PTQ or QAT
        conversion; empty for a float model."""
        return dict(self.named_buffers())

    def serving_params(self) -> Params:
        """Parameters and buffers in one dict — what the functional
        decode path consumes (`_apply_linear` dispatches on
        `.weight` / `.qweight`)."""
        return {**self.raw_parameters(), **self.raw_buffers()}

    @torch.no_grad()
    def logits(self, input_ids) -> torch.Tensor:
        """Inference logits (b, s, vocab) of a causal forward over
        `input_ids` (b, s), through the serving decode wiring."""
        ids = torch.as_tensor(input_ids, device=self.device)
        b, s = ids.shape
        cfg = self.cfg
        k = torch.zeros((cfg.num_layers, b, s, cfg.num_heads, cfg.head_dim),
                        dtype=self.dtype, device=self.device)
        v = torch.zeros_like(k)
        return _decode_forward(cfg, self.serving_params(), ids, 0, k, v)[0]


def gpt_tiny(seed: int = 0, device: DeviceLike = None, dtype=None, **kw):
    """4L/128h config for tests."""
    return GPT(GPTConfig(vocab_size=1024, max_seq_len=256, hidden_size=128,
                         num_layers=4, num_heads=4, **kw),
               seed=seed, device=device, dtype=dtype)


def gpt_small(seed: int = 0, device: DeviceLike = None, dtype=None, **kw):
    return GPT(GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw),
               seed=seed, device=device, dtype=dtype)


def gpt_medium(seed: int = 0, device: DeviceLike = None, dtype=None, **kw):
    return GPT(GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw),
               seed=seed, device=device, dtype=dtype)


def gpt_1p3b(seed: int = 0, device: DeviceLike = None, dtype=None, **kw):
    """GPT-3 1.3B-ish: 24L, 2048h, 16 heads."""
    return GPT(GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                         max_seq_len=2048, **kw),
               seed=seed, device=device, dtype=dtype)


# --------------------------------------------------------------------------- #
# functional decode wiring (the serving path)
# --------------------------------------------------------------------------- #

def _apply_linear(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """Serving-path linear over either weight format: the fp
    `<prefix>.weight` (in, out), or the `<prefix>.qweight` + scales an
    int8 PTQ conversion leaves (`quantization.Int8Linear`), which go to
    `int8_linear` — the fused GEMV K7 for at most 4 rows."""
    w = p.get(prefix + ".weight")
    if w is not None:
        out = torch.matmul(x, w)
        b = p.get(prefix + ".bias")
        return out if b is None else out + b
    from ..quantization import int8_linear
    return int8_linear(x, p[prefix + ".qweight"], p[prefix + ".w_scale"],
                       p[prefix + ".act_scale"], p.get(prefix + ".bias"))


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    """The decode wiring's LayerNorm: statistics AND affine in fp32,
    one cast at the end, as the JAX `_ln`. Training goes through
    `nn.functional.layer_norm` instead, which casts to the activation
    dtype before the affine, as the JAX `F.layer_norm`; each mirrors
    its own JAX counterpart, so the two round differently in bf16."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def tp_param_specs(cfg: GPTConfig, params: Params) -> Dict[str, tuple]:
    """How a TP group shards each parameter, by name: the trainer's
    layout of the reference (`paddle_tpu/models/gpt.py:358-471`).
    ("qkv", nh): columns, head-aligned (rank r takes the q, k and v
    columns of its heads, not a contiguous third: the columns are laid
    out (3, nh, hd)); ("col",): contiguous column blocks; ("row",):
    contiguous row blocks (attn.out's rows are head-major, so these are
    head-aligned too); ("vocab",): embedding rows; ("vocab_col",): an
    untied head's columns. A name absent replicates: LayerNorms, `wpe`,
    the row-parallel biases, and every linear without an fp `.weight`
    (int8-PTQ codes and scales, as the reference's specs leave them
    out)."""
    specs: Dict[str, tuple] = {}
    if "wte.weight" in params:
        specs["wte.weight"] = ("vocab",)
    if "lm_head.weight" in params:
        specs["lm_head.weight"] = ("vocab_col",)
    kinds = {"attn.qkv": ("qkv", cfg.num_heads), "attn.out": ("row",),
             "mlp.fc1": ("col",), "mlp.fc2": ("row",)}
    for i in range(cfg.num_layers):
        for lin, kind in kinds.items():
            pre = f"blocks.{i}.{lin}"
            if pre + ".weight" in params:
                specs[pre + ".weight"] = kind
                if kind[0] in ("qkv", "col") and pre + ".bias" in params:
                    specs[pre + ".bias"] = kind
    return specs


def tp_collectives_per_step(cfg: GPTConfig, params: Params) -> int:
    """Collectives of one forward through the TP wiring (a decode step,
    or a prefill call): the embedding's all-reduce; per block one for
    attn.out (an all-reduce, or the all-gather of the heads for a
    replicated int8 out) and one for the MLP (an all-reduce when fc2 is
    row-parallel, an all-gather when only fc1 is sharded, none when both
    are replicated); the head's all-gather unless it is int8. With fp
    weights 2 L + 1 all-reduces and 1 all-gather."""
    n = 1
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        n += 1
        if pre + "mlp.fc1.weight" in params or pre + "mlp.fc2.weight" \
                in params:
            n += 1
    return n + (0 if "lm_head.qweight" in params else 1)


def _block_params(params: Params, i: int) -> Params:
    pre = f"blocks.{i}."
    return {k[len(pre):]: v for k, v in params.items()
            if k.startswith(pre)}


def _by_groups(fn: Callable, x: torch.Tensor, groups: int) -> torch.Tensor:
    """`fn` over `groups` equal slices of x's rows, one call each, the
    results stacked back. A row-wise op then sees the row count of one
    group: GEMMs and reductions may pick their kernel (and so their
    summation order) by shape, so this keeps a row's bits those of a
    call with one group's rows."""
    if groups == 1:
        return fn(x)
    return torch.cat([fn(c) for c in x.chunk(groups)])


def _each(x, fn: Callable):
    """`fn` over each rank's tensor of a per-rank list, or on a tensor."""
    return [fn(t) for t in x] if isinstance(x, list) else fn(x)


def _tp_groups(fn: Callable, x, groups: int):
    """`_by_groups` over a tensor or a per-rank list of tensors (each
    rank's rows chunked alike), for `fn` returning either form."""
    if groups == 1:
        return fn(x)
    chunks = list(zip(*[t.chunk(groups) for t in x])) \
        if isinstance(x, list) else x.chunk(groups)
    outs = [fn(list(c) if isinstance(x, list) else c) for c in chunks]
    if isinstance(outs[0], list):
        return [torch.cat(rank) for rank in zip(*outs)]
    return torch.cat(outs)


def _col_linear(p: Params, pr: list, prefix: str, x: torch.Tensor):
    """A column-parallel linear of the TP wiring: per-rank outputs when
    its fp weight is sharded, else the replicated linear's full
    output."""
    if prefix + ".weight" in pr[0]:
        return [_apply_linear(q, prefix, x) for q in pr]
    return _apply_linear(p, prefix, x)


def _row_linear(p: Params, pr: list, prefix: str, x, group):
    """A row-parallel linear of the TP wiring: each rank's partial
    product over its rows of the weight, summed by `all_reduce`, then
    the replicated bias once. A full input is split over the ranks'
    rows first; a replicated (int8) linear takes the full input, the
    ranks' pieces joined by `all_gather` first."""
    if prefix + ".weight" in pr[0]:
        if not isinstance(x, list):
            x = list(torch.split(x, [q[prefix + ".weight"].shape[0]
                                     for q in pr], dim=-1))
        out = all_reduce([torch.matmul(t, q[prefix + ".weight"])
                          for t, q in zip(x, pr)], group)
        b = p.get(prefix + ".bias")
        return out if b is None else out + b
    if isinstance(x, list):
        x = all_gather(x, dim=-1, group=group)
    return _apply_linear(p, prefix, x)


def _tp_body_layers(cfg: GPTConfig, params: ShardedParams,
                    x: torch.Tensor, per_layer_attn: Callable,
                    num_layers: Optional[int], row_groups: int
                    ) -> torch.Tensor:
    """`_body_layers` over a TP group (see the module docstring): the
    residual stream is replicated (one tensor on the group's device),
    each rank computes its heads' q / k / v and its share of the MLP,
    and the attention callback gets per-rank lists and returns per-rank
    outputs. Under `row_groups` every row-wise op, the collectives
    included, runs once per group of rows, as in `_body_layers`."""
    eps, g = cfg.layer_norm_eps, row_groups
    grp = params.group
    nhr, hd = cfg.num_heads // grp.tp, cfg.head_dim
    B, s = x.shape[0], x.shape[1]
    for i in range(num_layers if num_layers is not None
                   else cfg.num_layers):
        p = _block_params(params, i)
        pr = [_block_params(q, i) for q in params.ranks]
        qkv = _tp_groups(lambda t: _col_linear(
            p, pr, "attn.qkv", _ln(t, p["ln1.weight"], p["ln1.bias"], eps)),
            x, g)
        if isinstance(qkv, list):
            qkv = [t.reshape(B, s, 3, nhr, hd) for t in qkv]
        else:                         # replicated (int8): slice the heads
            full = qkv.reshape(B, s, 3, cfg.num_heads, hd)
            qkv = [full[:, :, :, r * nhr:(r + 1) * nhr]
                   for r in range(grp.tp)]
        a = per_layer_attn(i, [t[:, :, 0] for t in qkv],
                           [t[:, :, 1] for t in qkv],
                           [t[:, :, 2] for t in qkv])
        x = x + _tp_groups(lambda t: _row_linear(p, pr, "attn.out", t, grp),
                           [t.reshape(B, s, nhr * hd) for t in a], g)

        def mlp(t):
            m = _col_linear(p, pr, "mlp.fc1",
                            _ln(t, p["ln2.weight"], p["ln2.bias"], eps))
            m = _each(m, lambda u: torch.nn.functional.gelu(
                u, approximate="tanh"))
            return _row_linear(p, pr, "mlp.fc2", m, grp)

        x = x + _tp_groups(mlp, x, g)
    return _by_groups(lambda t: _ln(t, params["ln_f.weight"],
                                    params["ln_f.bias"], eps), x, g)


def _body_layers(cfg: GPTConfig, params: Params, x: torch.Tensor,
                 per_layer_attn: Callable, num_layers: Optional[int] = None,
                 row_groups: int = 1) -> torch.Tensor:
    """The transformer block wiring shared by `_decode_forward` and the
    serving engine: ln1 → fused qkv → per-layer cache-attention
    callback → out proj → residual → ln2 → gelu(tanh) MLP → residual;
    final ln_f. `num_layers` caps the stack at the first N blocks (ln_f
    still applies): the truncated-layer draft of speculative decoding.
    `row_groups` > 1 runs every row-wise op once per group of
    `rows / row_groups` rows (`_by_groups`) while the attention callback
    sees all rows at once: the speculative verify pass, whose k+1
    positions ride the batch axis position-major, so each group is one
    plain decode step's shape. Handed `ShardedParams`, the TP form
    (`_tp_body_layers`)."""
    if isinstance(params, ShardedParams):
        return _tp_body_layers(cfg, params, x, per_layer_attn, num_layers,
                               row_groups)
    eps = cfg.layer_norm_eps
    g = row_groups
    for i in range(num_layers if num_layers is not None
                   else cfg.num_layers):
        p = _block_params(params, i)
        qkv = _by_groups(lambda t: _apply_linear(
            p, "attn.qkv", _ln(t, p["ln1.weight"], p["ln1.bias"], eps)),
            x, g).reshape(x.shape[0], x.shape[1], 3, cfg.num_heads,
                          cfg.head_dim)
        a = per_layer_attn(i, qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + _by_groups(lambda t: _apply_linear(p, "attn.out", t),
                           a.reshape(x.shape), g)
        x = x + _by_groups(lambda t: _apply_linear(
            p, "mlp.fc2", torch.nn.functional.gelu(_apply_linear(
                p, "mlp.fc1", _ln(t, p["ln2.weight"], p["ln2.bias"], eps)),
                approximate="tanh")), x, g)
    return _by_groups(lambda t: _ln(t, params["ln_f.weight"],
                                    params["ln_f.bias"], eps), x, g)


def _head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """LM head: explicit weight or tied embeddings. Over a TP group the
    ranks' vocab-sharded logits are joined by `all_gather` (an int8 head
    is replicated)."""
    if isinstance(params, ShardedParams) and "lm_head.qweight" not in params:
        return all_gather([
            torch.matmul(x, q["lm_head.weight"]) if "lm_head.weight" in q
            else torch.matmul(x, q["wte.weight"].t())
            for q in params.ranks], dim=-1, group=params.group)
    if "lm_head.weight" in params or "lm_head.qweight" in params:
        return _apply_linear(params, "lm_head", x)
    return torch.matmul(x, params["wte.weight"].t())


def _token_embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """The token embedding rows of `ids`. Over a TP group each rank
    looks up the ids inside its vocabulary rows (the others give 0) and
    `all_reduce` adds the ranks' rows: exactly the one rank's row."""
    if not isinstance(params, ShardedParams):
        return params["wte.weight"][ids]
    parts = []
    for q, v0 in zip(params.ranks, params.vocab_starts):
        w = q["wte.weight"]
        loc = ids - v0
        ok = (loc >= 0) & (loc < w.shape[0])
        parts.append(torch.where(ok[..., None],
                                 w[loc.clamp(0, w.shape[0] - 1)], 0))
    return all_reduce(parts, params.group)


def _masked_attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   keep: torch.Tensor) -> torch.Tensor:
    """THE fixed-cache attention numerics (fp32 scores, -1e30 mask):
    q (b, s, nh, hd) against cache rows kc/vc (b, T, nh, hd) with a
    boolean keep mask broadcastable to (b, nh, s, T)."""
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), kc.float())
    scores = scores / math.sqrt(q.shape[-1])
    scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(vc.dtype)
    return torch.einsum("bnqk,bknd->bqnd", w, vc)


def _kernel_scales(kc, vc) -> dict:
    """The scale arguments a decode kernel takes beside the slabs' data:
    a quantized {"q", "s"} slab's scales, none for an fp slab."""
    return dict(k_scale=kc["s"], v_scale=vc["s"]) if is_quantized(kc) \
        else {}


def _check_impl(impl: str):
    if impl not in ("masked", "ragged", "ragged_tp"):
        raise ValueError(f"impl must be 'masked', 'ragged' or 'ragged_tp', "
                         f"got {impl!r}")


def _shard_kernel_args(kc, vc) -> dict:
    """A TP group's slabs as the sharded kernel entries take them: the
    ranks' data tensors, and their scales for int8 slabs."""
    kw = dict(k_cache=[slab_data(p) for p in kc],
              v_cache=[slab_data(p) for p in vc])
    if is_quantized(kc):
        kw.update(k_scale=[p["s"] for p in kc],
                  v_scale=[p["s"] for p in vc])
    return kw


def _per_shard(fn: Callable, q, kc, vc):
    """`fn(q, kc, vc)` once per rank over a TP group's per-rank queries
    and slabs (a list out), or once."""
    if isinstance(kc, HeadShards):
        return [fn(*a) for a in zip(q, kc, vc)]
    return fn(q, kc, vc)


def _slot_attend(q: torch.Tensor, kc, vc, pos: torch.Tensor,
                 impl: str = "masked") -> torch.Tensor:
    """Decode-step attention over a SLOTTED cache: q (S, 1, nh, hd)
    against kc/vc (S, T, nh, hd), slot `s` attending rows
    `[0, pos[s]]` inclusive (the row at `pos` was written this step).

    - impl="masked": the `_masked_attend` full-slab path — compute
      proportional to T; the engine's bitwise numerics reference and
      its CPU path.
    - impl="ragged": the hand-written flash-decode kernel
      (`ops_cuda/decode_attention.py`: K1, or K5 for int8 slabs), which
      reads only the live rows; blockwise online-softmax order makes it
      approximately (not bit-) equal to the masked path.

    kc/vc may be quantized {"q", "s"} slabs: the kernel takes codes and
    scales and widens in fp32; the masked path widens the slab to q's
    dtype first (as the reference's `dequant_slab(kc, q.dtype)`, which
    rounds to bf16 under bf16 weights) and runs the same math.

    A TP group's slabs (`HeadShards`, q a per-rank list) run per rank:
    "ragged" / "ragged_tp" through `sharded_ragged_decode_attention`
    (the unsharded kernel on each rank's heads), "masked" the full-slab
    path on each rank's slab; the output is per rank. "ragged_tp" over
    an unsharded slab is "ragged".
    """
    _check_impl(impl)
    if isinstance(kc, HeadShards) and impl != "masked":
        from ..ops_cuda.decode_attention import \
            sharded_ragged_decode_attention
        return sharded_ragged_decode_attention(
            q, lengths=(pos + 1).to(torch.int32),
            **_shard_kernel_args(kc, vc))
    if isinstance(kc, HeadShards):
        return _per_shard(lambda a, b, c: _slot_attend(a, b, c, pos),
                          q, kc, vc)
    if impl != "masked":
        from ..ops_cuda.decode_attention import ragged_decode_attention
        return ragged_decode_attention(
            q.contiguous(), slab_data(kc), slab_data(vc),
            (pos + 1).to(torch.int32), **_kernel_scales(kc, vc))
    kc, vc = dequant_slab(kc, q.dtype), dequant_slab(vc, q.dtype)
    T = kc.shape[1]
    keep = torch.arange(T, device=pos.device)[None, :] <= pos[:, None]
    return _masked_attend(q, kc, vc, keep[:, None, None])


def _slot_verify_attend(q: torch.Tensor, kc, vc, slot_of: torch.Tensor,
                        q_pos: torch.Tensor, impl: str = "masked"
                        ) -> torch.Tensor:
    """Multi-token VERIFY attention over a slotted cache, the
    speculative-decoding seam beside `_slot_attend`: the k+1 verify
    queries of every lane ride the batch axis as VIRTUAL LANES — q is
    (B, 1, nh, hd), virtual lane b reads slot `slot_of[b]`'s rows and
    attends rows `[0, q_pos[b]]`. Each virtual lane is one plain decode
    step's query, so the result is that step's, row for row.

    - impl="masked": gather each virtual lane's slot view, then the
      `_masked_attend` math of `_slot_attend`;
    - impl="ragged": the flash-decode kernel addressing the cache
      through `slot_map` (K1, or K5 for int8 slabs); each (lane, head)
      runs in its own CTAs with block picks that depend only on the
      cache shape, so a virtual lane gets the plain step's bits.

    A TP group's slabs run per rank, as in `_slot_attend`.
    """
    _check_impl(impl)
    if isinstance(kc, HeadShards) and impl != "masked":
        from ..ops_cuda.decode_attention import \
            sharded_ragged_decode_attention
        return sharded_ragged_decode_attention(
            q, lengths=(q_pos + 1).to(torch.int32),
            slot_map=slot_of.to(torch.int32), **_shard_kernel_args(kc, vc))
    if isinstance(kc, HeadShards):
        return _per_shard(lambda a, b, c: _slot_verify_attend(
            a, b, c, slot_of, q_pos), q, kc, vc)
    if impl != "masked":
        from ..ops_cuda.decode_attention import ragged_decode_attention
        return ragged_decode_attention(
            q.contiguous(), slab_data(kc), slab_data(vc),
            (q_pos + 1).to(torch.int32), slot_map=slot_of.to(torch.int32),
            **_kernel_scales(kc, vc))
    idx = slot_of.long()
    kv = dequant_slab(map_slab(kc, lambda a: a[idx]), q.dtype)
    vv = dequant_slab(map_slab(vc, lambda a: a[idx]), q.dtype)
    T = kv.shape[1]
    keep = torch.arange(T, device=q_pos.device)[None, :] <= q_pos[:, None]
    return _masked_attend(q, kv, vv, keep[:, None, None])


def _paged_verify_attend(q: torch.Tensor, kp, vp, tables: torch.Tensor,
                         q_pos: torch.Tensor, impl: str = "masked"
                         ) -> torch.Tensor:
    """Multi-token VERIFY attention over a paged cache: `_paged_attend`
    on the virtual-lane grid, with `tables` the per-VIRTUAL-lane block
    tables (each lane's row repeated once per verify position) and
    `q_pos` the per-virtual-lane query position. "ragged" is K4 (K6 for
    int8 pools) over the repeated tables."""
    return _paged_attend(q, kp, vp, tables, q_pos, impl)


def _paged_attend(q: torch.Tensor, kp, vp, tables: torch.Tensor,
                  pos: torch.Tensor, impl: str = "masked") -> torch.Tensor:
    """Decode-step attention over a PAGED cache: q (S, 1, nh, hd)
    against the shared page pools kp/vp (num_pages, page, nh, hd), lane
    `s` reading rows through its block-table row `tables[s]` (row r
    lives at (tables[s, r // page], r % page)) and attending rows
    `[0, pos[s]]`. The paged twin of `_slot_attend`, same contract:

    - impl="masked": gather the lane's pages into the exact
      (S, max_seq, nh, hd) view `_slot_attend` reads (pages_per_seq *
      page == max_seq is enforced by `serving.paged_kv.PagedKVCache`),
      then the same `_masked_attend` math — bitwise equal to the slotted
      path on identical rows;
    - impl="ragged": the block-table flash-decode kernel (K4, or K6 for
      int8 pools), which reads only the live rows through the table.

    A TP group's pools run per rank, as in `_slot_attend`
    (`sharded_paged_ragged_decode_attention`).
    """
    _check_impl(impl)
    if isinstance(kp, HeadShards) and impl != "masked":
        from ..ops_cuda.decode_attention import \
            sharded_paged_ragged_decode_attention
        kw = _shard_kernel_args(kp, vp)
        return sharded_paged_ragged_decode_attention(
            q, kw.pop("k_cache"), kw.pop("v_cache"), tables,
            (pos + 1).to(torch.int32), **kw)
    if isinstance(kp, HeadShards):
        return _per_shard(lambda a, b, c: _paged_attend(a, b, c, tables,
                                                        pos), q, kp, vp)
    if impl != "masked":
        from ..ops_cuda.decode_attention import paged_ragged_decode_attention
        return paged_ragged_decode_attention(
            q.contiguous(), slab_data(kp), slab_data(vp), tables,
            (pos + 1).to(torch.int32), **_kernel_scales(kp, vp))
    S, maxp = tables.shape
    _, page, nh, hd = slab_shape(kp)
    T = maxp * page
    kc = take_rows(kp, tables, q.dtype).reshape(S, T, nh, hd)
    vc = take_rows(vp, tables, q.dtype).reshape(S, T, nh, hd)
    keep = torch.arange(T, device=pos.device)[None, :] <= pos[:, None]
    return _masked_attend(q, kc, vc, keep[:, None, None])


def _decode_forward(cfg: GPTConfig, params: Params, ids: torch.Tensor,
                    pos: int, k_cache: torch.Tensor, v_cache: torch.Tensor):
    """Cache-writing forward over `ids` (b, s) starting at absolute
    `pos`; k_cache/v_cache (L, b, T, nh, hd) are written in place (over
    a TP group, `ShardedParams`: per-rank lists of (L, b, T, nh / tp,
    hd) caches). Returns (logits (b, s, vocab), k_cache, v_cache)."""
    b, s = ids.shape
    dev = ids.device
    positions = pos + torch.arange(s, device=dev)
    x = _token_embed(params, ids) + params["wpe.weight"][positions][None]
    sharded = isinstance(k_cache, list)
    T = (k_cache[0] if sharded else k_cache).shape[2]
    keep = (torch.arange(T, device=dev)[None, :]
            <= positions[:, None])[None, None]               # causal

    def one(i, q, kn, vn, kc, vc):
        kc[i, :, pos:pos + s] = kn.to(kc.dtype)
        vc[i, :, pos:pos + s] = vn.to(vc.dtype)
        return _masked_attend(q, kc[i], vc[i], keep)

    def attn(i, q, kn, vn):
        if sharded:
            return [one(i, *a) for a in zip(q, kn, vn, k_cache, v_cache)]
        return one(i, q, kn, vn, k_cache, v_cache)

    x = _body_layers(cfg, params, x, attn)
    return _head(params, x), k_cache, v_cache


def _decode_dims(cfg: GPTConfig, ids: torch.Tensor, max_new_tokens: int):
    """Shared decode-shape validation: (batch, prompt_len, total_len)."""
    b, prompt = ids.shape
    total = prompt + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt+new = {total} exceeds max_seq_len "
                         f"{cfg.max_seq_len}")
    return b, prompt, total


def _fixed_cache(cfg: GPTConfig, dtype, device, rows: int, total: int):
    """The serving wiring's fixed K and V caches, (L, rows, total, nh,
    hd) zeros each."""
    k = torch.zeros((cfg.num_layers, rows, total, cfg.num_heads,
                     cfg.head_dim), dtype=dtype, device=device)
    return k, torch.zeros_like(k)


def _top_k_mask(lg: torch.Tensor, top_k: int) -> torch.Tensor:
    """The reference's top-k rule: every entry below the top_k-th
    largest goes to -inf; entries tied with it stay (so not
    `torch.topk`)."""
    if not top_k:
        return lg
    kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
    return torch.where(lg < kth, float("-inf"), lg)


def _generate_loop(cfg: GPTConfig, params: Params, ids: torch.Tensor,
                   k_cache, v_cache, buf: torch.Tensor,
                   pick: Callable) -> torch.Tensor:
    """Prefill `ids` (b, prompt) into the fixed caches, then one cached
    step per token up to `buf`'s (b, total) width; `pick(t, logits)`
    turns token t's fp32 logits (b, V) into ids (b,). Every position is
    a Python int, so a capture of this loop holds each step's position
    as a constant. Writes and returns `buf`."""
    prompt, total = ids.shape[1], buf.shape[1]
    logits, _, _ = _decode_forward(cfg, params, ids, 0, k_cache, v_cache)
    buf[:, :prompt] = ids
    buf[:, prompt] = pick(0, logits[:, -1].float())
    for t in range(total - prompt - 1):
        pos = prompt + t
        logits, _, _ = _decode_forward(cfg, params, buf[:, pos:pos + 1], pos,
                                       k_cache, v_cache)
        buf[:, pos + 1] = pick(t + 1, logits[:, -1].float())
    return buf


def _graphed_call(model: GPT, attr: str, key, params: Params,
                  build: Callable):
    """The per-signature program cache on the model (the reference's
    `_compiled_for`): `build(graphed, pool)` makes the program's static
    buffers and its `GraphedCall`, returned as (call, buffers). On a
    card it is captured once per signature into the model's one graph
    memory pool, each capture counted in `model._graph_capture_count`
    and timed into the call's `capture_s`; a second call with the same
    signature captures nothing. The program holds the weights it was
    captured over, so new weight storage (a conversion, a move)
    recaptures. On the CPU the program is built for the one call."""
    if model.device.type != "cuda":
        return build(False, None)
    cache = model.__dict__.setdefault(attr, {})
    stamp = tuple((k, t.data_ptr()) for k, t in params.items())
    entry = cache.get(key)
    if entry is None or entry[0] != stamp:
        pool = model.__dict__.get("_graph_pool")
        if pool is None:
            pool = model.__dict__["_graph_pool"] = \
                torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        call, bufs = build(True, pool)
        call.capture_s = time.perf_counter() - t0
        model.__dict__["_graph_capture_count"] = \
            model.__dict__.get("_graph_capture_count", 0) + 1
        entry = cache[key] = (stamp, call, bufs)
    return entry[1], entry[2]


@torch.no_grad()
def generate_compiled(model: GPT, input_ids, max_new_tokens: int = 32,
                      temperature: float = 0.0, top_k: int = 0,
                      seed: int = 0) -> torch.Tensor:
    """The whole generation as one program: on a card ONE CUDA graph
    per (b, prompt, max_new_tokens, temperature, top_k), holding the
    prefill and the max_new_tokens - 1 decode steps over static ids,
    cache and output buffers; a call copies the ids in, replays and
    copies the tokens out. Greedy when temperature == 0; else the
    logits / temperature, top-k masked as the reference masks them,
    pick by Gumbel-max: argmax(logits + g), with g = -log(-log(u)) from
    uniforms u drawn before the replay by `torch.Generator(device)
    .manual_seed(seed)` into a static (b, max_new_tokens, V) buffer.
    That is a categorical draw, and a seed always gives the same
    tokens. On CPU tensors the same function runs eagerly. Returns (b,
    prompt + max_new_tokens) token ids (the prompt alone for
    max_new_tokens < 1)."""
    cfg = model.cfg
    params = model.serving_params()
    ids = torch.as_tensor(input_ids, device=model.device).long()
    if max_new_tokens < 1:
        return ids
    b, prompt, total = _decode_dims(cfg, ids, max_new_tokens)
    sampled = temperature != 0.0
    dev = model.device

    def build(graphed, pool):
        bufs = {"ids": torch.zeros((b, prompt), dtype=torch.int64,
                                   device=dev),
                "out": torch.zeros((b, total), dtype=torch.int64,
                                   device=dev)}
        k, v = _fixed_cache(cfg, model.dtype, dev, b, total)
        if sampled:
            bufs["u"] = torch.zeros((b, max_new_tokens, cfg.vocab_size),
                                    dtype=torch.float32, device=dev)

        def pick(t, last):
            if not sampled:
                return torch.argmax(last, dim=-1)
            lg = _top_k_mask(last / max(temperature, 1e-6), top_k)
            g = bufs["u"][:, t].log().neg().log().neg()
            return torch.argmax(lg + g, dim=-1)

        def fn():
            return (_generate_loop(cfg, params, bufs["ids"], k, v,
                                   bufs["out"], pick),)

        if graphed:
            bufs["ids"].copy_(ids)      # the warm-up runs on real ids
            if sampled:
                bufs["u"].fill_(0.5)
        from ..serving.graphs import GraphedCall
        return GraphedCall(fn, graphed, pool, "generation loop"), bufs

    call, bufs = _graphed_call(
        model, "_compiled_generate",
        (b, prompt, max_new_tokens, float(temperature), int(top_k)),
        params, build)
    bufs["ids"].copy_(ids)
    if sampled:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        bufs["u"].uniform_(generator=gen)
    return call.run()[0]


@torch.no_grad()
def beam_search_compiled(model: GPT, input_ids, beam_size: int = 4,
                         max_new_tokens: int = 32,
                         eos_token_id: Optional[int] = None,
                         length_penalty: float = 0.6):
    """Beam search as one program (the reference's, line for line): on
    a card ONE CUDA graph per (b, prompt, beam_size, max_new_tokens,
    eos_token_id, length_penalty).

    Per step: log-softmax in fp32, the top `beam_size` of the b x K x V
    candidates per batch row, and the token buffer and cache reordered
    along the beam axis (the cache `index_select`ed into a second static
    cache; the unrolled steps alternate between the two). With an
    `eos_token_id`, every hypothesis that finishes is banked in a
    finished pool at its GNMT-normalised score (score / ((5 + len) /
    6) ** length_penalty), frozen beams extend only with EOS at zero
    cost, and the result is the best of the pool and the surviving
    beams under the same normalisation (none without an EOS id: every
    hypothesis has max_new_tokens tokens). Returns (tokens (b, prompt +
    max_new_tokens), scores (b,)). Ties among candidates go to the
    lower index, as the reference's `lax.top_k` orders them."""
    cfg = model.cfg
    params = model.serving_params()
    ids = torch.as_tensor(input_ids, device=model.device).long()
    if max_new_tokens < 1:
        raise ValueError("beam search needs max_new_tokens >= 1")
    b, prompt, total = _decode_dims(cfg, ids, max_new_tokens)
    V, K, eos = cfg.vocab_size, int(beam_size), eos_token_id
    dev = model.device

    def norm_of(length):
        return ((5.0 + length) / 6.0) ** length_penalty

    def build(graphed, pool):
        bufs = {"ids": torch.zeros((b, prompt), dtype=torch.int64,
                                   device=dev)}
        k0, v0 = _fixed_cache(cfg, model.dtype, dev, b, total)
        caches = [_fixed_cache(cfg, model.dtype, dev, b * K, total)
                  for _ in range(2)]

        def fn():
            return _beam_loop(cfg, params, bufs["ids"], k0, v0, caches,
                              K, max_new_tokens, eos, norm_of)

        if graphed:
            bufs["ids"].copy_(ids)
        from ..serving.graphs import GraphedCall
        return GraphedCall(fn, graphed, pool, "beam search"), bufs

    call, bufs = _graphed_call(
        model, "_compiled_beam",
        (b, prompt, K, max_new_tokens, eos, float(length_penalty)),
        params, build)
    bufs["ids"].copy_(ids)
    return tuple(call.run())


def _top_k_first(x: torch.Tensor, k: int):
    """The k largest entries of each row and their indices, largest
    first and, among equal entries, the lower index first: the order of
    the reference's `lax.top_k` (a stable sort; `torch.topk` leaves the
    order of ties to the device), so beam 1 is greedy's argmax."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_loop(cfg: GPTConfig, params: Params, ids: torch.Tensor, k0, v0,
               caches, K: int, max_new: int, eos: Optional[int],
               norm_of: Callable, margins: Optional[list] = None):
    """`beam_search_compiled`'s program: prefill into (k0, v0), the
    beams into caches[0], each step's reorder into the other cache.
    `margins` (a list; eager calls only) collects how decided each
    choice was: per pruning step the gap between the K-th and the next
    candidate score (b,), and last the gap between the chosen
    hypothesis and the best other one (b,)."""
    b, prompt = ids.shape
    total = prompt + max_new
    V = cfg.vocab_size
    dev = ids.device
    rows = torch.arange(b, device=dev)
    ninf = float("-inf")
    logits, _, _ = _decode_forward(cfg, params, ids, 0, k0, v0)
    logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    scores, tok = _top_k_first(logp, K)                          # (b, K)
    (kc, vc), (kn, vn) = caches
    L = cfg.num_layers
    kc.view(L, b, K, *kc.shape[2:]).copy_(k0[:, :, None])
    vc.view(L, b, K, *vc.shape[2:]).copy_(v0[:, :, None])
    buf = torch.zeros((b, K, total), dtype=torch.int64, device=dev)
    buf[:, :, :prompt] = ids[:, None]
    buf[:, :, prompt] = tok
    finished = torch.zeros((b, K), dtype=torch.bool, device=dev) \
        if eos is None else tok == eos
    pool_buf = buf[:, 0].clone()
    pool_score = torch.full((b,), ninf, device=dev)
    if eos is not None:
        fin0 = torch.where(tok == eos, scores / norm_of(1.0), ninf)
        bi = torch.argmax(fin0, dim=1)
        pool_score = fin0[rows, bi]
        pool_buf = buf[rows, bi]
        # (no item assignment: it copies a host scalar, which a CUDA
        # graph capture refuses)
        freeze = torch.full((V,), ninf, device=dev).masked_fill(
            torch.arange(V, device=dev) == eos, 0.0)
    for t in range(max_new - 1):
        pos = prompt + t
        cur = buf[:, :, pos].reshape(b * K, 1)
        logits, _, _ = _decode_forward(cfg, params, cur, pos, kc, vc)
        logp = torch.log_softmax(logits[:, -1].float(),
                                 dim=-1).reshape(b, K, V)
        if eos is not None:
            # bank the best hypothesis finishing at this step (an
            # unfinished beam extending with EOS) before pruning
            fin = torch.where(finished, ninf,
                              scores + logp[:, :, eos]) / norm_of(t + 2.0)
            bi = torch.argmax(fin, dim=1)
            cand_score = fin[rows, bi]
            cand_buf = buf[rows, bi]
            cand_buf[:, pos + 1].fill_(eos)
            better = cand_score > pool_score
            pool_score = torch.where(better, cand_score, pool_score)
            pool_buf = torch.where(better[:, None], cand_buf, pool_buf)
            # frozen beams may only extend with EOS, at zero cost
            logp = torch.where(finished[:, :, None], freeze, logp)
        cand = scores[:, :, None] + logp                         # (b, K, V)
        if margins is not None:
            top = _top_k_first(cand.reshape(b, K * V), K + 1)[0]
            margins.append(top[:, K - 1] - top[:, K])
        scores, idx = _top_k_first(cand.reshape(b, K * V), K)
        src = idx // V
        tok = idx % V
        buf = torch.gather(buf, 1, src[:, :, None].expand(b, K, total))
        buf[:, :, pos + 1] = tok
        flat = (rows[:, None] * K + src).reshape(-1)
        torch.index_select(kc, 1, flat, out=kn)
        torch.index_select(vc, 1, flat, out=vn)
        kc, vc, kn, vn = kn, vn, kc, vc
        if eos is not None:
            finished = torch.gather(finished, 1, src) | (tok == eos)
    if eos is not None:
        is_eos = buf[:, :, prompt:] == eos
        first = torch.argmax(is_eos.to(torch.int32), dim=-1)
        lengths = torch.where(is_eos.any(dim=-1), first + 1, max_new)
        scores = scores / norm_of(lengths.float())
    best = torch.argmax(scores, dim=1)
    out, out_score = buf[rows, best], scores[rows, best]
    if eos is not None:
        use_pool = pool_score > out_score
        out = torch.where(use_pool[:, None], pool_buf, out)
        out_score = torch.where(use_pool, pool_score, out_score)
    if margins is not None:
        final = torch.cat([scores, pool_score[:, None]], dim=1)
        top2 = torch.topk(final, min(2, final.shape[1]), dim=1).values
        margins.append(top2[:, 0] - top2[:, -1])
    return out, out_score


def generate_greedy(model: GPT, input_ids,
                    max_new_tokens: int = 32) -> torch.Tensor:
    """Greedy decoding: `generate_compiled(temperature=0)`, the port's
    one greedy path. Returns (b, prompt + new) token ids."""
    return generate_compiled(model, input_ids, max_new_tokens,
                             temperature=0.0)
