"""GPT decoder-only transformer in PyTorch: the training forward and
loss, and the serving decode wiring.

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..core import DeviceLike, make_generator, resolve_device, resolve_dtype
from ..nn import functional as F
from ..nn.layers import GELU, Dropout, Embedding, LayerNorm, Linear
from ..quantization.kv import (dequant_slab, is_quantized, map_slab,
                               slab_data, slab_shape, take_rows)

__all__ = ["GPTConfig", "GPT", "GPTBlock", "gpt_tiny", "gpt_small",
           "gpt_medium", "gpt_1p3b", "param_shapes", "generate_greedy"]

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
        if self.sequence_parallel != "none":
            raise NotImplementedError(
                f"sequence_parallel={self.sequence_parallel!r} is not "
                f"ported yet (ROADMAP Queue 1, after item 6)")

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

def _ce_fwd_impl(logits, labels, ignore_index: int):
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
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = ((lse - tgt) * mask).sum() / denom
    return loss, lse, mask, denom


class _MaskedSoftmaxCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ignore_index: int):
        loss, lse, mask, denom = _ce_fwd_impl(logits, labels, ignore_index)
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
        return p.to(logits.dtype), None, None


def _masked_softmax_ce(logits, labels, ignore_index: int = -100):
    """Mean next-token cross-entropy over the labels that are not
    `ignore_index` (a label of ignore_index contributes nothing; an
    all-ignored batch gives 0)."""
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

    def forward(self, x):
        b, s, h = x.shape
        cfg = self.cfg
        qkv = self.qkv(x).reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], is_causal=True,
            dropout_p=self.dropout, training=self.training)
        return self.out(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, gen: torch.Generator):
        super().__init__()
        std = cfg.initializer_range
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_size, std, gen)
        self.fc2 = Linear(cfg.ffn_size, cfg.hidden_size,
                          std / math.sqrt(2 * cfg.num_layers), gen)
        self.act = GELU(True)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


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

    def forward(self, x):
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
        self.to(device=dev, dtype=resolve_dtype(dtype))

    def forward(self, input_ids, position_ids=None) -> torch.Tensor:
        """Training forward: logits (b, s, vocab) of a causal pass over
        `input_ids` (b, s), attention through the flash kernels."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        if self.lm_head is not None:
            return self.lm_head(x)
        return torch.matmul(x, self.wte.weight.t())

    def loss(self, logits, labels, ignore_index: int = -100):
        """Next-token cross-entropy: logits[:, :-1] against
        labels[:, 1:], labels equal to `ignore_index` left out."""
        return _masked_softmax_ce(logits[:, :-1], labels[:, 1:],
                                  ignore_index)

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
    plain decode step's shape."""
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
    """LM head: explicit weight or tied embeddings."""
    if "lm_head.weight" in params or "lm_head.qweight" in params:
        return _apply_linear(params, "lm_head", x)
    return torch.matmul(x, params["wte.weight"].t())


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
    if impl not in ("masked", "ragged"):
        raise ValueError(f"impl must be 'masked' or 'ragged', got {impl!r}")


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
    """
    _check_impl(impl)
    if impl == "ragged":
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
    """
    _check_impl(impl)
    if impl == "ragged":
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
    """
    _check_impl(impl)
    if impl == "ragged":
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
    `pos`; k_cache/v_cache (L, b, T, nh, hd) are written in place.
    Returns (logits (b, s, vocab), k_cache, v_cache)."""
    b, s = ids.shape
    dev = ids.device
    positions = pos + torch.arange(s, device=dev)
    x = params["wte.weight"][ids] + params["wpe.weight"][positions][None]
    T = k_cache.shape[2]
    keep = (torch.arange(T, device=dev)[None, :]
            <= positions[:, None])[None, None]               # causal

    def attn(i, q, kn, vn):
        k_cache[i, :, pos:pos + s] = kn.to(k_cache.dtype)
        v_cache[i, :, pos:pos + s] = vn.to(v_cache.dtype)
        return _masked_attend(q, k_cache[i], v_cache[i], keep)

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


@torch.no_grad()
def generate_greedy(model: GPT, input_ids,
                    max_new_tokens: int = 32) -> torch.Tensor:
    """Greedy decoding over a preallocated fixed-shape KV cache — the
    `generate_compiled(temperature=0)` counterpart: prefill the prompt,
    then one cache-writing step per token. Returns (b, prompt + new)."""
    cfg = model.cfg
    params = model.serving_params()
    ids = torch.as_tensor(input_ids, device=model.device)
    if max_new_tokens < 1:
        return ids
    b, prompt, total = _decode_dims(cfg, ids, max_new_tokens)
    k_cache = torch.zeros((cfg.num_layers, b, total, cfg.num_heads,
                           cfg.head_dim), dtype=model.dtype,
                          device=model.device)
    v_cache = torch.zeros_like(k_cache)
    logits, _, _ = _decode_forward(cfg, params, ids, 0, k_cache, v_cache)
    buf = torch.zeros((b, total), dtype=ids.dtype, device=ids.device)
    buf[:, :prompt] = ids
    buf[:, prompt] = torch.argmax(logits[:, -1].float(), dim=-1)
    for t in range(max_new_tokens - 1):
        pos = prompt + t
        logits, _, _ = _decode_forward(cfg, params, buf[:, pos:pos + 1], pos,
                                       k_cache, v_cache)
        buf[:, pos + 1] = torch.argmax(logits[:, -1].float(), dim=-1)
    return buf
