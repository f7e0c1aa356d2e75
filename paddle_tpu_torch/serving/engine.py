"""`LLMEngine`: continuous batching over a slotted KV cache, in PyTorch.

The counterpart of `paddle_tpu/serving/engine.py`'s single-device core:

- ONE decode shape. All `max_slots` lanes step together; per-request
  state (current token, position, sampling knobs, EOS id, remaining
  budget, live flag) is DATA in `[slots]` tensors, so admitting or
  retiring a request never changes a shape.
- FUSED DECODE BLOCKS. A dispatch runs `decode_block_size` decode steps
  back to back on the device: sampling, cache writes, position advance
  and the per-lane EOS / budget / cache-full FREEZE masks all stay on
  the device, and the lane state (cur/pos/rem/act) is handed from one
  block to the next without leaving it. The host syncs ONCE per block
  (`metrics.host_syncs`), to read the block's token and emit matrix,
  and admits/retires at block boundaries. Frozen lanes park their
  (discarded) K/V writes at row max_seq - 1, which no live lane ever
  attends.
- MONOLITHIC BUCKETED PREFILL. A prompt is padded to the smallest
  length bucket (powers of two up to `max_seq`) and written into its
  slot's rows in one forward; the last real position's logits give the
  first token.
- Two KV layouts (`kv_layout`). "slotted": one `max_seq` stripe per
  lane (`kv_cache.KVCacheManager`). "paged": one refcounted page pool
  with per-lane block tables (`paged_kv.PagedKVCache`); admission
  reserves a request's whole span (prompt + budget) in real pages up
  front and WAITS, FIFO, when the pool cannot cover the next request —
  page pressure never fails a request — and frozen lanes park their
  writes on the trash page. `kv_dtype="int8"` stores either layout as
  per-row int8 codes with f32 scales (`quantization/kv.py`).
- SPECULATIVE DECODING (`speculate_k` > 0): each block runs
  `spec_rounds` rounds of k draft steps (the target's first
  `draft_layers` blocks, or an int8 copy of its weights) and one verify
  pass over the k+1 positions as virtual lanes; the accept rule emits
  only the target's own tokens, so streams equal the spec-off engine's
  token for token, with the same one host sync per block.
- Attention goes through `models.gpt._slot_attend` / `_paged_attend`:
  `attend_impl` "ragged" runs the hand-written flash-decode kernels
  (K1 slotted, K4 paged, K5 / K6 their int8 forms), "masked" the
  full-slab `_masked_attend`; "auto" picks "ragged" on a CUDA device
  and "masked" on the CPU.

Numerics: under "masked", a request decoded beside others is bitwise
identical to the same request decoded alone, for any
`decode_block_size` (lanes are row-independent), and the paged layout
gives the slotted layout's streams bitwise (for a fixed kv_dtype). Sampled streams
depend only on (engine seed, the request's salt, position) — see
`serving/sampler.py` — so they too are invariant to block size and lane
assignment; the salt is assigned when a request leaves the queue.

The KV slabs are updated in place (the JAX engine donates them into
each compiled step instead). Features of the JAX engine that are not
ported yet raise `NotImplementedError` when their knob is passed with
any value other than "off"; they are listed in ROADMAP.md.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import DeviceLike, resolve_device
from ..models.gpt import (BLOCK_LINEARS, _block_params, _body_layers,
                          _by_groups, _head, _ln, _masked_attend,
                          _paged_attend, _paged_verify_attend, _slot_attend,
                          _slot_verify_attend)
from ..quantization import abs_max_scale, quantize_tensor
from ..quantization.kv import (dequant_slab, kv_update, map_slab,
                               slab_shape, take_rows)
from .kv_cache import KVCacheManager
from .metrics import ServingMetrics
from .paged_kv import NoFreePages, PagedKVCache, paged_rows
from .sampler import (DOMAIN_FIRST, compact_block, sample_tokens,
                      sample_tokens_per_lane, sample_verify_tokens,
                      speculative_accept)

__all__ = ["SamplingParams", "GenerationResult", "EngineOverloadError",
           "LLMEngine"]

# JAX-engine knobs of features the port does not have yet: the values
# that mean "feature off" (what the port does) are accepted, any other
# value raises, naming the feature's open item of ROADMAP.md.
_UNSUPPORTED_KNOBS = {
    "prefill_chunk": ((None,), "chunked prefill", "Queue 1 item 7"),
    "prefill_budget": ((None,), "prefill_budget interleaving",
                       "Queue 1 item 7"),
    "overlap": ((False,), "overlapped block dispatch", "Queue 1 item 7"),
    "max_retries": ((0,), "dispatch retries", "Queue 1 item 7"),
    "retry_backoff_s": ((), "dispatch retries", "Queue 1 item 7"),
    "retry_backoff_max_s": ((), "dispatch retries", "Queue 1 item 7"),
    "prefix_cache": ((False,), "the prefix cache", "Queue 1 item 7"),
    "prefix_block": ((), "the prefix cache", "Queue 1 item 7"),
    "prefix_pool_pages": ((None, 0), "the prefix cache", "Queue 1 item 7"),
    "mesh": ((None,), "TP-sharded serving", "Queue 1 item 12"),
    "tp": ((1,), "TP-sharded serving", "Queue 1 item 12"),
    "trace": ((False,), "the lifecycle tracer", "Queue 1 item 11"),
    "trace_capacity": ((), "the lifecycle tracer", "Queue 1 item 11"),
    "flight_dir": ((None,), "the flight recorder", "Queue 1 item 11"),
    "name": ((None,), "the profiler stats registry", "Queue 1 item 11"),
    "register_stats": ((False,), "the profiler stats registry",
                       "Queue 1 item 11"),
    "kv_tier": ((None,), "the fleet KV tier", "Queue 1 item 11"),
}


class EngineOverloadError(RuntimeError):
    """Admission rejected: the bounded request queue is full."""


@dataclasses.dataclass
class SamplingParams:
    """Per-request generation knobs (turned into data rows of the one
    decode shape)."""
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    # TTL from submit, checked at block boundaries: on expiry the
    # request finishes with reason "deadline" and keeps its tokens
    deadline_s: Optional[float] = None
    # admission order: highest priority first, FIFO within a level
    priority: int = 0
    # best-of-n continuations; only n = 1 is served by the port yet
    n: int = 1

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, "
                             f"got {self.deadline_s}")
        if not isinstance(self.priority, int) \
                or isinstance(self.priority, bool):
            raise ValueError(f"priority must be an int, "
                             f"got {self.priority!r}")
        if not isinstance(self.n, int) or isinstance(self.n, bool) \
                or self.n < 1:
            raise ValueError(f"n must be an int >= 1, got {self.n!r}")


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: np.ndarray            # (P,) int32
    token_ids: List[int]          # generated tokens (incl. eos if hit)
    finish_reason: str            # "stop" | "length" | "cancelled" |
    #   "deadline"
    ttft_s: float                 # submit → first token wall time
    queue_wait_s: float = 0.0     # submit → prefill start

    @property
    def text_ids(self) -> np.ndarray:
        """prompt + generated, one array."""
        return np.concatenate([self.prompt,
                               np.asarray(self.token_ids, np.int32)])


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    params: SamplingParams
    submit_t: float
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    ttft_s: float = 0.0
    finish_reason: Optional[str] = None
    deadline_t: Optional[float] = None
    # per-request sampling salt, assigned when the request leaves the
    # queue (see sampler.py); None until then
    salt: Optional[int] = None
    queue_wait_s: float = 0.0


@dataclasses.dataclass
class _Inflight:
    """A dispatched, not yet processed decode block."""
    packed: torch.Tensor          # (2, steps, slots): tokens, emit flags
    t0: float                     # dispatch wall time
    steps: int                    # in-program steps (the block capacity)
    # speculative blocks: the (proposed, accepted) tally on the device
    spec: Optional[torch.Tensor] = None


def _default_buckets(max_seq: int) -> List[int]:
    out, b = [], 16
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return out


def _embed(params, ids: torch.Tensor, positions: torch.Tensor):
    pos = torch.clamp(positions, 0, params["wpe.weight"].shape[0] - 1)
    return params["wte.weight"][ids] + params["wpe.weight"][pos]


def _prefill_forward(cfg, params, k_list, v_list, ids: torch.Tensor,
                     slot: int, pos0: int, length: int,
                     table: Optional[torch.Tensor] = None,
                     page_size: int = 0) -> torch.Tensor:
    """Prefill of `ids` (1, L) (a padded bucket) into rows
    [pos0, pos0 + L) of `slot` — of its slab stripe, or through its
    block-table row `table` (device, (pages_per_seq,)) under the paged
    layout — in place; returns the fp32 logits of the last REAL token
    (position pos0 + length - 1). Padded rows past `length` are written
    too and rewritten before they can be attended (paged: those past
    the lane's bound pages land on the trash page). Attention reads the
    CACHE's view of the rows (dequantized for int8), the view later
    decode steps see."""
    L = ids.shape[1]
    T = table.shape[0] * page_size if table is not None \
        else slab_shape(k_list[0])[1]
    dev = ids.device
    q_pos = pos0 + torch.arange(L, device=dev)
    x = _embed(params, ids, q_pos[None])                      # (1, L, h)
    keep = (torch.arange(T, device=dev)[None, :]
            <= q_pos[:, None])[None, None]                    # (1,1,L,T)
    if table is None:
        rows = (slot, slice(pos0, pos0 + L))
    else:
        rows = paged_rows(table, q_pos, page_size)

    def lane_view(slab, dtype):
        if table is None:
            return dequant_slab(map_slab(slab, lambda a: a[slot:slot + 1]),
                                dtype)
        return take_rows(slab, table, dtype).reshape(
            1, T, *slab_shape(slab)[2:])

    def attn(i, q, kn, vn):
        kv_update(k_list[i], rows, kn[0])
        kv_update(v_list[i], rows, vn[0])
        return _masked_attend(q, lane_view(k_list[i], q.dtype),
                              lane_view(v_list[i], q.dtype), keep)

    x = _body_layers(cfg, params, x, attn)
    return _head(params, x[:, length - 1:length])[0, 0].float()


def _decode_block(cfg, params, k_list, v_list, cur, pos, rem, act, salt,
                  temp, topk, topp, eos, *, block: int, attend_impl: str,
                  seed: int, max_seq: int,
                  tables: Optional[torch.Tensor] = None,
                  page_size: int = 0):
    """`block` fused decode steps over every lane, all on the device.
    Per step and lane: embed cur@pos → write K/V at pos (slotted:
    frozen lanes park at row T-1; paged, with `tables` (S,
    pages_per_seq): through the lane's table, frozen lanes park on the
    trash page) → attention over the lane's rows → sample with the
    lane's (seed, salt, pos) key → freeze-mask update (EOS / budget /
    cache full). Returns (tokens (block, S), emits (block, S), cur, pos,
    rem, act); the lane state stays on the device."""
    S, T = cur.shape[0], max_seq
    lanes = torch.arange(S, device=cur.device)
    toks, emits = [], []
    for _ in range(block):
        x = _embed(params, cur, pos)[:, None, :]              # (S, 1, h)
        if tables is None:
            rows = (lanes, torch.where(act, pos, T - 1))
        else:
            rows = paged_rows(tables, pos, page_size, live=act)

        def attn(i, q, kn, vn, rows=rows, pos=pos):
            kv_update(k_list[i], rows, kn[:, 0])
            kv_update(v_list[i], rows, vn[:, 0])
            if tables is None:
                return _slot_attend(q, k_list[i], v_list[i], pos,
                                    attend_impl)
            return _paged_attend(q, k_list[i], v_list[i], tables, pos,
                                 attend_impl)

        x = _body_layers(cfg, params, x, attn)
        logits = _head(params, x)[:, 0].float()
        nxt = sample_tokens_per_lane(logits, seed, salt, pos, temp, topk,
                                     topp)
        emit = act
        toks.append(torch.where(emit, nxt, 0))
        emits.append(emit)
        hit_eos = emit & (eos >= 0) & (nxt == eos)
        stepped = emit.to(pos.dtype)
        pos = pos + stepped
        rem = rem - stepped
        cur = torch.where(emit, nxt, cur)
        # the freeze predicate _check_finished applies on the host
        act = act & ~hit_eos & (rem > 0) & (pos < T - 1)
    return torch.stack(toks), torch.stack(emits), cur, pos, rem, act


# --------------------------------------------------------------------------- #
# speculative decoding: the int8 draft and the draft-and-verify block
# --------------------------------------------------------------------------- #

@torch.no_grad()
def _int8_draft_params(cfg, params, num_layers: int):
    """The INT8 DRAFT's parameter dict, derived from the target's own
    weights: every block linear of the first `num_layers` blocks, and
    the LM head (the tied head quantizes `wte.T`), gets symmetric
    per-output-channel int8 weights (`w_scale` computed in the weight's
    dtype, then stored fp32), with activation scales from ONE fixed
    calibration forward over deterministic tokens (the PTQ abs-max rule:
    each observed max a host float, `max(m, 1e-8) / 127` in Python
    double, stored fp32). The forward runs in the target's dtype with
    `_masked_attend` and the tanh GELU. Embeddings, LayerNorms and
    biases are shared. A pure function of the checkpoint, so every
    engine derives the same draft.

    Raises for an int8 target: it has no fp weights to quantize (use
    draft='trunc')."""
    L = min(32, cfg.max_seq_len)
    ids = ((np.arange(L, dtype=np.int64) * 2654435761)
           % cfg.vocab_size).astype(np.int64)[None]
    prefixes = [f"blocks.{i}.{t}" for i in range(num_layers)
                for t in BLOCK_LINEARS]
    for p in prefixes:
        if p + ".weight" not in params:
            raise ValueError(
                f"draft='int8' needs an fp-weight target ({p}.weight "
                f"missing — an int8-PTQ target is already its own cheap "
                f"path; use draft='trunc')")
    nh, hd, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
    scales: Dict[str, float] = {}

    def observe(prefix, x):
        scales[prefix] = max(scales.get(prefix, 0.0),
                             float(x.abs().max()))

    dev = params["wte.weight"].device
    x = params["wte.weight"][torch.from_numpy(ids).to(dev)] \
        + params["wpe.weight"][torch.arange(L, device=dev)][None]
    ar = torch.arange(L, device=dev)
    keep = (ar[None, :] <= ar[:, None])[None, None]
    for i in range(num_layers):
        p = _block_params(params, i)
        h = _ln(x, p["ln1.weight"], p["ln1.bias"], eps)
        observe(f"blocks.{i}.attn.qkv", h)
        qkv = (h @ p["attn.qkv.weight"] + p["attn.qkv.bias"]).reshape(
            1, L, 3, nh, hd)
        a = _masked_attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           keep).reshape(1, L, -1)
        observe(f"blocks.{i}.attn.out", a)
        x = x + a @ p["attn.out.weight"] + p["attn.out.bias"]
        h = _ln(x, p["ln2.weight"], p["ln2.bias"], eps)
        observe(f"blocks.{i}.mlp.fc1", h)
        m = torch.nn.functional.gelu(
            h @ p["mlp.fc1.weight"] + p["mlp.fc1.bias"], approximate="tanh")
        observe(f"blocks.{i}.mlp.fc2", m)
        x = x + m @ p["mlp.fc2.weight"] + p["mlp.fc2.bias"]
    observe("lm_head", _ln(x, params["ln_f.weight"], params["ln_f.bias"],
                           eps))
    out = dict(params)
    head_w = params.get("lm_head.weight")
    if head_w is None:
        head_w = params["wte.weight"].t()                  # tied head
    for prefix in prefixes + ["lm_head"]:
        w = head_w if prefix == "lm_head" else params[prefix + ".weight"]
        ws = abs_max_scale(w, dim=0)                      # per out channel
        out[prefix + ".qweight"] = quantize_tensor(w, ws).contiguous()
        out[prefix + ".w_scale"] = ws.float()
        out[prefix + ".act_scale"] = torch.tensor(
            max(scales[prefix], 1e-8) / 127.0, dtype=torch.float32,
            device=dev)
        out.pop(prefix + ".weight", None)      # force the int8 dispatch
    return out


def _spec_decode_block(cfg, params, draft_params, k_list, v_list, cur, pos,
                       rem, act, salt, temp, topk, topp, eos, *,
                       rounds: int, k: int, draft_layers: int,
                       attend_impl: str, seed: int, max_seq: int,
                       tables: Optional[torch.Tensor] = None,
                       page_size: int = 0):
    """`rounds` draft-and-verify rounds over every lane, all on the
    device, emitting up to rounds * (k+1) tokens per lane.

    Draft: k sequential steps of the cheap model — the target's first
    `draft_layers` blocks (trunc: `draft_params` None; its K/V for those
    layers are the target's own rows) or the int8 dict. Proposals draw
    with the keys the target uses at the same positions.

    Verify: the k+1 positions of every lane run as VIRTUAL LANES on the
    batch axis, position-major (row j*S + s is lane s at position
    pos[s] + j). Every row-wise op runs once per position on exactly S
    rows (`_body_layers(row_groups=k+1)`, the head, the draws), the
    plain step's shapes, while the K/V writes and the attention kernel
    run once over all rows; so the verify logits, rows and draws are the
    plain steps' bitwise. `speculative_accept` then emits the longest
    matching drafted prefix plus the target's token at the first
    mismatch.

    Writes: frozen lanes park every draft and verify write at row T-1
    (slotted) or on the trash page (paged, with `tables`), and so do
    verify rows past the lane's reservation (paged: past the table's
    bound pages, whose filler is the trash page). A write at a rejected
    position lands in the lane's own rows past its new `pos`, and is
    rewritten (by the next round or block) before any length reaches it.

    Returns (tokens (steps, S), emits (steps, S) compacted to a prefix
    per lane, cur, pos, rem, act, tally (2,) = proposed, accepted)."""
    S, T, W = cur.shape[0], max_seq, k + 1
    dev = cur.device
    lanes = torch.arange(S, device=dev)
    dp = params if draft_params is None else draft_params
    # virtual lane j*S + s is lane s at position pos[s] + j: its slot,
    # or its lane's block-table row
    slot_of = lanes.repeat(W)
    vtab = None if tables is None else tables.repeat(W, 1)
    toks_all, emits_all = [], []
    tally = torch.zeros(2, dtype=torch.int64, device=dev)
    for _ in range(rounds):
        # --- draft: k cheap sequential proposal steps ------------------ #
        dcur, dpos, drafted = cur, pos, []
        for _j in range(k):
            apos = torch.clamp(dpos, max=T - 1)
            ok = act & (dpos < T - 1)
            if tables is None:
                rows = (lanes, torch.where(ok, dpos, T - 1))
            else:
                rows = paged_rows(tables, apos, page_size, live=ok)

            def dattn(i, q, kn, vn, rows=rows, apos=apos):
                kv_update(k_list[i], rows, kn[:, 0])
                kv_update(v_list[i], rows, vn[:, 0])
                if tables is None:
                    return _slot_attend(q, k_list[i], v_list[i], apos,
                                        attend_impl)
                return _paged_attend(q, k_list[i], v_list[i], tables, apos,
                                     attend_impl)

            h = _body_layers(cfg, dp, _embed(dp, dcur, apos)[:, None],
                             dattn, num_layers=draft_layers)
            nxt = sample_tokens_per_lane(_head(dp, h)[:, 0].float(), seed,
                                         salt, apos, temp, topk, topp)
            drafted.append(nxt)
            dcur = torch.where(act, nxt, dcur)
            dpos = dpos + act.to(dpos.dtype)
        # --- verify: k+1 positions as virtual lanes -------------------- #
        drafted_m = torch.stack(drafted, dim=1)                   # (S, k)
        ins = torch.cat([cur[:, None], drafted_m], dim=1)         # (S, W)
        q_pos = pos[:, None] + torch.arange(W, device=dev)[None]  # (S, W)
        q_flat = q_pos.t().reshape(-1)                  # position-major
        a_flat = torch.clamp(q_flat, max=T - 1)
        act_flat = act.repeat(W)
        if tables is None:
            vrows = (slot_of, torch.where(act_flat, a_flat, T - 1))
        else:
            vrows = paged_rows(vtab, a_flat, page_size,
                               live=act_flat & (q_flat < T))

        def vattn(i, q, kn, vn):
            kv_update(k_list[i], vrows, kn[:, 0])
            kv_update(v_list[i], vrows, vn[:, 0])
            if tables is None:
                return _slot_verify_attend(q, k_list[i], v_list[i],
                                           slot_of, a_flat, attend_impl)
            return _paged_verify_attend(q, k_list[i], v_list[i], vtab,
                                        a_flat, attend_impl)

        x = _embed(params, ins.t().reshape(-1), a_flat)[:, None]
        h = _body_layers(cfg, params, x, vattn, row_groups=W)
        logits = _by_groups(lambda t: _head(params, t)[:, 0].float(), h, W)
        tgt = sample_verify_tokens(logits.reshape(W, S, -1).transpose(0, 1),
                                   seed, salt, q_pos, temp, topk, topp)
        emit, toks, cur, pos, rem, act2, accepted = speculative_accept(
            drafted_m, tgt, cur, act, pos, rem, eos, T)
        tally += torch.stack([torch.where(act, k, 0).sum(),
                              accepted.sum()])
        act = act2
        toks_all.append(toks.t())
        emits_all.append(emit.t())
    toks, emits = compact_block(torch.cat(toks_all), torch.cat(emits_all))
    return toks, emits, cur, pos, rem, act, tally


class LLMEngine:
    """Continuous-batching generation engine over a `GPT` model.

    >>> eng = LLMEngine(model, max_slots=8, device="cuda")
    >>> rid = eng.submit(prompt_tokens, SamplingParams(max_new_tokens=64))
    >>> while eng.has_work():
    ...     eng.step()
    >>> out = eng.result(rid)

    or the batch convenience `eng.generate([p1, p2, ...], params)`.
    `device` defaults to "cuda" and raises without a card; the model's
    weights are used on that device (copied there if they live
    elsewhere).

    KV memory: `kv_layout` "slotted" (default) or "paged"; under
    "paged", `page_size` (default the largest power of two <= 64 that
    divides `max_seq`) and `kv_pages` (default `2 * max_slots *
    pages_per_seq + 1`, the trash page included). `kv_dtype` None keeps
    the weights' dtype; "int8" stores per-row int8 codes and f32 scales.

    Int8 weights: a model converted by `quantization.PTQ` / `QAT` (its
    Linears `Int8Linear`s) serves as it is; the engine takes the
    model's parameters and buffers, and each quantized linear of at most
    4 rows runs the fused GEMV K7.

    Speculative decoding: `speculate_k` = k > 0 runs each decode block
    as `spec_rounds = max(1, decode_block_size // (k+1))` rounds of k
    draft steps and one verify pass; `draft` "trunc" (the target's first
    `draft_layers` blocks, default max(1, L // 6)) or "int8" (an int8
    copy of the target's weights, default depth L). Streams equal the
    spec-off engine's token for token.
    """

    def __init__(self, model, max_slots: int = 8, max_queue: int = 64,
                 max_seq: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 seed: int = 0, decode_block_size: int = 8,
                 attend_impl: str = "auto", device: DeviceLike = None,
                 kv_layout: str = "slotted", page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None, speculate_k: int = 0,
                 draft: str = "trunc", draft_layers: Optional[int] = None,
                 **knobs):
        for knob, value in knobs.items():
            if knob not in _UNSUPPORTED_KNOBS:
                raise TypeError(f"LLMEngine got an unexpected keyword "
                                f"argument {knob!r}")
            off, feature, item = _UNSUPPORTED_KNOBS[knob]
            if not any(value is o or value == o for o in off):
                raise NotImplementedError(
                    f"{knob}={value!r}: {feature} is not ported to the "
                    f"PyTorch engine yet (ROADMAP.md, {item})")
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_seq = int(max_seq or cfg.max_seq_len)
        if not 1 <= self.max_seq <= cfg.max_seq_len:
            raise ValueError(f"max_seq {self.max_seq} outside [1, "
                             f"{cfg.max_seq_len}] (model max_seq_len)")
        self.max_slots = int(max_slots)
        self.max_queue = int(max_queue)
        if decode_block_size < 1:
            raise ValueError("decode_block_size must be >= 1")
        self.decode_block_size = int(decode_block_size)
        if attend_impl not in ("auto", "masked", "ragged"):
            raise ValueError(f"attend_impl must be 'auto', 'masked' or "
                             f"'ragged', got {attend_impl!r}")
        if attend_impl == "auto":
            attend_impl = "ragged" if self.device.type == "cuda" \
                else "masked"
        self.attend_impl = attend_impl
        self.seed = int(seed)
        # parameters AND buffers: an int8-converted model keeps its codes
        # and scales in buffers; _apply_linear dispatches on the keys
        self._params = {k: v.to(self.device)
                        for k, v in model.serving_params().items()}
        dtype = self._params["wte.weight"].dtype
        if speculate_k < 0:
            raise ValueError("speculate_k must be >= 0")
        self.speculate_k = int(speculate_k)
        self.draft = str(draft)
        self.draft_layers = 0
        self.spec_rounds = 0
        self._draft_params = None
        if self.speculate_k:
            if self.draft not in ("trunc", "int8"):
                raise ValueError(f"draft must be 'trunc' or 'int8', "
                                 f"got {draft!r}")
            if draft_layers is None:
                # trunc: a ~6x cheaper draft; int8: full depth, its
                # cheapness is the weight bytes
                dl = max(1, cfg.num_layers // 6) \
                    if self.draft == "trunc" else cfg.num_layers
            else:
                dl = int(draft_layers)
            if not 1 <= dl <= cfg.num_layers:
                raise ValueError(f"draft_layers {dl} outside [1, "
                                 f"{cfg.num_layers}]")
            self.draft_layers = dl
            self.spec_rounds = max(
                1, self.decode_block_size // (self.speculate_k + 1))
            if self.draft == "int8":
                self._draft_params = _int8_draft_params(cfg, self._params,
                                                        dl)
        elif draft_layers is not None:
            raise ValueError("draft_layers needs speculate_k > 0")
        if kv_layout not in ("slotted", "paged"):
            raise ValueError(f"kv_layout must be 'slotted' or 'paged', "
                             f"got {kv_layout!r}")
        self.paged = kv_layout == "paged"
        dims = (cfg.num_layers, self.max_slots, self.max_seq,
                cfg.num_heads, cfg.head_dim, dtype, self.device)
        if self.paged:
            if page_size is None:
                page_size = 64
                while page_size > 1 and self.max_seq % page_size:
                    page_size //= 2
            self.cache = PagedKVCache(*dims, page_size=int(page_size),
                                      num_pages=kv_pages,
                                      kv_dtype=kv_dtype)
            self.page_size = self.cache.page_size
            self.kv_pages = self.cache.num_pages
        else:
            if page_size is not None or kv_pages is not None:
                raise ValueError("page_size/kv_pages need "
                                 "kv_layout='paged'")
            self.cache = KVCacheManager(*dims, kv_dtype=kv_dtype)
            self.page_size = self.kv_pages = 0
        self.kv_dtype = self.cache.kv_dtype
        if attend_impl == "ragged" and not self.cache.quantized \
                and self.cache.slab_dtype != dtype:
            raise ValueError(f"attend_impl='ragged' needs the cache in the "
                             f"weights' dtype ({dtype}) or int8, got "
                             f"kv_dtype={self.kv_dtype!r}")
        self.metrics = ServingMetrics(self.max_slots)
        self.metrics.kv_cache_bytes = self.cache.nbytes()
        self.metrics.kv_bytes_per_token = self.cache.bytes_per_token()
        self.metrics.kv_dtype = self.kv_dtype
        self._set_page_gauges()
        self._queue: collections.deque = collections.deque()
        self._active: Dict[int, _Request] = {}      # slot -> request
        self._results: Dict[int, GenerationResult] = {}
        self._next_id = 0
        self._next_salt = 0
        bk = sorted({int(b) for b in prefill_buckets}) if prefill_buckets \
            else _default_buckets(self.max_seq)
        self._buckets = [min(b, self.max_seq) for b in bk]
        if self._buckets[-1] < self.max_seq:
            self._buckets.append(self.max_seq)
        # per-slot scheduler state. The HOST MIRRORS are authoritative
        # at admission; between blocks the decode block hands its lane
        # state straight to the next dispatch on the device, and the
        # mirrors are refreshed from each block's token/emit matrix.
        # `_dirty` marks mirror edits that must be uploaded first.
        S = self.max_slots
        self._cur = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._salt = np.zeros(S, np.int64)
        self._temp = np.zeros(S, np.float32)
        self._topk = np.zeros(S, np.int64)
        self._topp = np.ones(S, np.float32)
        self._eos = np.full(S, -1, np.int64)     # -1 = no eos id
        self._rem = np.zeros(S, np.int64)        # decode budget left
        self._act = np.zeros(S, bool)            # lane live (not frozen)
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._dirty = True

    # ------------------------------------------------------------------ #
    # submission / results
    # ------------------------------------------------------------------ #
    def _validate(self, prompt, params: SamplingParams) -> np.ndarray:
        """Raises `ValueError` (an INVALID reject) for a request that
        can never be served; returns the normalised prompt."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            self.metrics.on_reject("invalid")
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            self.metrics.on_reject("invalid")
            raise ValueError(f"prompt token ids outside [0, "
                             f"{self.cfg.vocab_size})")
        total = prompt.size + params.max_new_tokens
        if total > self.max_seq:
            self.metrics.on_reject("invalid")
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({params.max_new_tokens}) = {total} exceeds the engine "
                f"max_seq {self.max_seq}")
        if params.n != 1:
            raise NotImplementedError(
                f"n={params.n}: best-of-n forking is not ported to the "
                f"PyTorch engine yet (see ROADMAP.md)")
        return prompt

    def submit(self, prompt, params: Optional[SamplingParams] = None) -> int:
        """Enqueue a request; returns its id. Raises `ValueError` for a
        request that can never be served and `EngineOverloadError` when
        the bounded queue is full."""
        params = params or SamplingParams()
        return self._enqueue(self._validate(prompt, params), params)

    def _enqueue(self, prompt: np.ndarray, params: SamplingParams) -> int:
        if len(self._queue) >= self.max_queue:
            self.metrics.on_reject("overload")
            raise EngineOverloadError(
                f"request queue full ({self.max_queue} pending, "
                f"{self.cache.num_active}/{self.max_slots} slots busy) — "
                f"retry after in-flight requests drain")
        rid = self._next_id
        self._next_id += 1
        now = time.perf_counter()
        req = _Request(rid, prompt, params, now)
        if params.deadline_s is not None:
            req.deadline_t = now + params.deadline_s
        self._queue.append(req)
        self.metrics.on_submit()
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or generating request. Returns True iff it
        was live. A generating request keeps its emitted tokens; its
        lane freezes at the next dispatch and its slot frees at the
        next block boundary. Other lanes are unaffected."""
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                self._finish_early(req, "cancelled")
                self.metrics.on_cancel()
                return True
        for slot, req in self._active.items():
            if req.rid == rid and req.finish_reason is None:
                req.finish_reason = "cancelled"
                self._freeze_slot(slot)
                self.metrics.on_cancel()
                return True
        return False

    def result(self, rid: int) -> GenerationResult:
        """Fetch-and-evict a finished request's result."""
        if rid not in self._results:
            raise KeyError(f"request {rid} not finished (or unknown, "
                           f"or already collected)")
        return self._results.pop(rid)

    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def stats(self) -> Dict[str, float]:
        return self.metrics.snapshot()

    # ------------------------------------------------------------------ #
    # scheduler
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def step(self) -> int:
        """One scheduler iteration: expire deadlines, admit queued
        requests into free slots (prefill + first token), run one
        decode block, retire finished requests. Returns the number of
        requests completed."""
        self._expire_deadlines()
        while self._queue and self.cache.num_free > 0 \
                and self._pages_admit_ok():
            if not self._admit_next():
                break            # page pressure: the head waits
        if any(r.finish_reason is None for r in self._active.values()):
            self._process_block(self._dispatch_block())
        done = self._retire_finished()
        self.metrics.set_gauges(len(self._queue), self.cache.num_active)
        self._set_page_gauges()
        return done

    def _set_page_gauges(self):
        if self.paged:
            pool = self.cache.pool
            self.metrics.set_page_gauges(pool.pages_used, self.kv_pages,
                                         pool.peak_used)

    def run_until_complete(self, max_steps: Optional[int] = None):
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine not drained after {steps} steps "
                    f"({len(self._queue)} queued, {len(self._active)} "
                    f"active)")

    def generate(self, prompts: Sequence,
                 params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None) -> List[GenerationResult]:
        """Submit a batch and run to completion; results in input
        order. Every request is validated before any is enqueued."""
        if isinstance(params, SamplingParams) or params is None:
            params = [params] * len(prompts)
        if len(params) != len(prompts):
            raise ValueError(f"got {len(prompts)} prompts but "
                             f"{len(params)} SamplingParams")
        params = [sp or SamplingParams() for sp in params]
        prompts = [self._validate(p, sp) for p, sp in zip(prompts, params)]
        rids = []
        for p, sp in zip(prompts, params):
            # a batch larger than max_queue drains with scheduler steps
            while len(self._queue) >= self.max_queue and self.has_work():
                self.step()
            rids.append(self._enqueue(p, sp))
        self.run_until_complete()
        return [self.result(r) for r in rids]

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def _select_next(self) -> _Request:
        """The request the next pop takes (no mutation): highest
        `priority`, FIFO within a level. Shared by the pop and the paged
        admission gate, so the gate prices exactly what would admit."""
        best = self._queue[0]
        for req in self._queue:
            if req.params.priority > best.params.priority:
                best = req
        return best

    def _pop_highest_priority(self) -> _Request:
        """Pop `_select_next()`. The sampling salt is assigned here,
        when the request leaves the queue."""
        best = self._select_next()
        self._queue.remove(best)
        if best.salt is None:
            best.salt = self._next_salt
            self._next_salt = (self._next_salt + 1) & 0x7FFFFFFF
        return best

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self.max_seq

    # --- the paged admission gate: a request is priced in real pages ---- #
    def _span_rows(self, req: _Request) -> int:
        """Worst-case resident rows of a request: prompt + decode budget.
        Admission reserves this many rows' pages up front, so decode
        never runs out of pages mid-stream."""
        return int(req.prompt.size) + req.params.max_new_tokens

    def _pages_needed(self, req: _Request) -> int:
        return self.cache.span_pages(self._span_rows(req))

    def _pages_admit_ok(self) -> bool:
        """True when the pool can cover the NEXT request's pages (always
        under the slotted layout). When it cannot, admission waits: no
        skipping to a smaller request behind it."""
        if not self.paged or not self._queue:
            return True
        return self._pages_needed(self._select_next()) \
            <= self.cache.pool.num_free

    def _alloc_pages(self, n: int) -> List[int]:
        """`n` fresh pages; raises `NoFreePages` past the pool (the gate
        prices the need first)."""
        return self.cache.pool.alloc(n)

    def _admit_next(self) -> bool:
        """Pop the next request and prefill it into a free slot. Returns
        False when page pressure sent it back to the queue head (stop
        admitting this round); any other failure leaves the engine
        consistent the same way and re-raises."""
        req = self._pop_highest_priority()
        slot = self.cache.allocate()
        try:
            self._admit_one(req, slot)
        except BaseException as err:
            # the slot (and any pages bound to it) frees and the request
            # returns to the head of the queue, salt kept
            self.cache.release(slot)
            self._queue.appendleft(req)
            if isinstance(err, NoFreePages):
                return False
            raise
        return True

    def _admit_one(self, req: _Request, slot: int):
        self.cache.reset_length(slot)      # an attempt starts from row 0
        t0 = time.perf_counter()
        if self.paged:
            self.cache.bind_owned(slot, self._alloc_pages(
                self._pages_needed(req)))
        logits = self._prefill_tokens(slot, req.prompt)
        self.cache.advance(slot, int(req.prompt.size))
        p = req.params
        first = int(sample_tokens(
            logits[None], self.seed, req.salt, int(req.prompt.size) - 1,
            p.temperature, p.top_k, p.top_p, DOMAIN_FIRST)[0])
        t1 = time.perf_counter()
        req.queue_wait_s = t0 - req.submit_t
        self.metrics.on_admit(int(req.prompt.size), t1 - t0,
                              queue_wait_s=req.queue_wait_s)
        req.ttft_s = t1 - req.submit_t
        self.metrics.on_first_token(req.ttft_s)
        req.generated.append(first)
        self._install_slot(req, slot, pos=int(req.prompt.size))

    def _prefill_tokens(self, slot: int, tokens: np.ndarray) -> torch.Tensor:
        """Bucketed prefill of `tokens` into rows [0, len) of `slot`;
        returns the last real token's fp32 logits."""
        n = int(tokens.size)
        bucket = min(self._bucket_for(n), self.max_seq)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = tokens
        table = torch.from_numpy(self.cache.block_tables[slot]).to(
            self.device) if self.paged else None
        return _prefill_forward(self.cfg, self._params, self.cache.k,
                                self.cache.v,
                                torch.from_numpy(ids).to(self.device),
                                slot, 0, n, table=table,
                                page_size=self.page_size)

    def _install_slot(self, req: _Request, slot: int, pos: int):
        """Wire a request into its lane's mirrors."""
        req.slot = slot
        self._active[slot] = req
        p = req.params
        self._cur[slot] = req.generated[-1]
        self._pos[slot] = pos
        self._salt[slot] = req.salt or 0
        self._temp[slot] = p.temperature
        self._topk[slot] = p.top_k
        self._topp[slot] = p.top_p
        self._eos[slot] = -1 if p.eos_token_id is None else p.eos_token_id
        self._rem[slot] = p.max_new_tokens - len(req.generated)
        self._check_finished(req, req.generated[-1])
        self._act[slot] = req.finish_reason is None
        self._dirty = True

    # ------------------------------------------------------------------ #
    # request lifecycle
    # ------------------------------------------------------------------ #
    def _freeze_slot(self, slot: int):
        self._act[slot] = False
        self._dirty = True

    def _finish_early(self, req: _Request, reason: str):
        req.finish_reason = reason
        self._record_result(req)

    def _record_result(self, req: _Request):
        self._results[req.rid] = GenerationResult(
            req.rid, req.prompt, req.generated, req.finish_reason,
            req.ttft_s, queue_wait_s=req.queue_wait_s)
        if req.finish_reason in ("stop", "length"):
            self.metrics.on_complete()

    def _expire_deadlines(self):
        now = time.perf_counter()
        for req in [r for r in self._queue
                    if r.deadline_t is not None and now >= r.deadline_t]:
            self._queue.remove(req)
            req.queue_wait_s = now - req.submit_t
            self.metrics.queue_wait.observe(req.queue_wait_s)
            self._finish_early(req, "deadline")
            self.metrics.on_deadline()
        for slot, req in self._active.items():
            if (req.finish_reason is None and req.deadline_t is not None
                    and now >= req.deadline_t):
                req.finish_reason = "deadline"
                self._freeze_slot(slot)
                self.metrics.on_deadline()

    def _check_finished(self, req: _Request, tok: int):
        p = req.params
        if p.eos_token_id is not None and tok == p.eos_token_id:
            req.finish_reason = "stop"
        elif len(req.generated) >= p.max_new_tokens:
            req.finish_reason = "length"
        elif int(self._pos[req.slot]) >= self.max_seq - 1:
            req.finish_reason = "length"  # cache exhausted

    def _retire_finished(self) -> int:
        done = 0
        for slot in [s for s, r in self._active.items()
                     if r.finish_reason is not None]:
            req = self._active.pop(slot)
            self.cache.release(slot)
            self._record_result(req)
            done += 1
        return done

    # ------------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------------ #
    def _upload_mirrors(self) -> Dict[str, torch.Tensor]:
        def dev(a):
            return torch.from_numpy(a).to(self.device)
        out = {"cur": dev(self._cur), "pos": dev(self._pos),
               "rem": dev(self._rem), "act": dev(self._act),
               "salt": dev(self._salt), "temp": dev(self._temp),
               "topk": dev(self._topk), "topp": dev(self._topp),
               "eos": dev(self._eos)}
        if self.paged:
            # admission changes the tables and always marks the mirrors
            # dirty; a retired lane is frozen, so its stale row only
            # parks writes on the trash page until the next upload
            out["tables"] = dev(self.cache.block_tables)
        return out

    @property
    def _block_capacity(self) -> int:
        """Most tokens one dispatched block can emit per lane: the block
        size plain, rounds * (k+1) speculative."""
        return self.spec_rounds * (self.speculate_k + 1) \
            if self.speculate_k else self.decode_block_size

    def _dispatch_block(self) -> _Inflight:
        if self._dirty or self._dev is None:
            self._dev = self._upload_mirrors()
            self._dirty = False
        d = self._dev
        t0 = time.perf_counter()
        lane_state = (self.cache.k, self.cache.v, d["cur"], d["pos"],
                      d["rem"], d["act"], d["salt"], d["temp"], d["topk"],
                      d["topp"], d["eos"])
        common = dict(attend_impl=self.attend_impl, seed=self.seed,
                      max_seq=self.max_seq, tables=d.get("tables"),
                      page_size=self.page_size)
        spec = None
        if self.speculate_k:
            toks, emits, cur, pos, rem, act, spec = _spec_decode_block(
                self.cfg, self._params, self._draft_params, *lane_state,
                rounds=self.spec_rounds, k=self.speculate_k,
                draft_layers=self.draft_layers, **common)
        else:
            toks, emits, cur, pos, rem, act = _decode_block(
                self.cfg, self._params, *lane_state,
                block=self.decode_block_size, **common)
        self._dev = {**d, "cur": cur, "pos": pos, "rem": rem, "act": act}
        return _Inflight(torch.stack([toks, emits.to(toks.dtype)]), t0,
                         self._block_capacity, spec)

    def _process_block(self, blk: _Inflight):
        """Distribute one block's tokens to their requests. The copy to
        the host is the block's single sync (counted); a speculative
        block's (proposed, accepted) tally rides the same copy."""
        flat = blk.packed.reshape(-1)
        if blk.spec is not None:
            flat = torch.cat([flat, blk.spec])
        flat = flat.cpu().numpy()               # host sync (the only one)
        packed = flat[:blk.packed.numel()].reshape(blk.packed.shape)
        toks, emits = packed[0], packed[1].astype(bool)
        if blk.spec is not None:
            self.metrics.on_spec(int(flat[-2]), int(flat[-1]))
        produced = 0
        for slot, req in self._active.items():
            if req.finish_reason is not None:
                continue  # finished at admission or an earlier block
            emitted = 0
            for j in range(blk.steps):
                if not emits[j, slot]:
                    break  # the device froze the lane at step j
                tok = int(toks[j, slot])
                req.generated.append(tok)
                self.cache.advance(slot)
                self._cur[slot] = tok
                self._pos[slot] += 1
                self._rem[slot] -= 1
                emitted += 1
                self._check_finished(req, tok)
                if req.finish_reason is not None:
                    break
            produced += emitted
            self._act[slot] = req.finish_reason is None
        now = time.perf_counter()
        self.metrics.on_decode_step(now - blk.t0, produced, steps=blk.steps)
