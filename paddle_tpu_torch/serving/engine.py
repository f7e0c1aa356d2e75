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
- ONE GRAPH PER PROGRAM. On a CUDA device each block program (plain,
  and speculative) and each prefill row count is captured once into a
  CUDA graph and every block or prefill piece is one replay
  (`serving/graphs.py`), as the JAX engine compiles each block and each
  prefill bucket into one executable; on the CPU the same runners call
  the functions directly.
- OVERLAP (`overlap=True`, the default): block N+1 is dispatched off
  block N's device-resident state before block N's tokens are read,
  when no admission is pending and some lane outlives block N on
  budget, so the host's processing of block N runs while block N+1
  executes.
- RECOVERY. Every dispatch, sync and prefill runs under the reference's
  contract: a failed attempt is retried up to `max_retries` times with
  capped exponential backoff, in-flight blocks are discarded and the
  lane state re-uploaded from the host mirrors (so a retry replays the
  exact key stream, and recovery is bit-invisible); on exhaustion the
  active requests fail ("error") and the engine keeps serving, and a
  request whose prefill is exhausted fails alone. A failing draft
  (`draft_dispatch`) degrades its block to the plain graph. Fault
  points: `testing/faults.py`.
- BUCKETED, OPTIONALLY CHUNKED PREFILL. A prompt (or its uncached
  suffix) is split into `prefill_chunk`-sized pieces, each padded to
  the smallest length bucket (powers of two up to `max_seq`, and at
  least `PREFILL_MIN_ROWS` rows: rows past `max_seq` are computed and
  their writes parked) and written into its slot's rows in one forward; the
  last real position's logits give the first token. Every per-call
  value (ids, slot, first position, length, block-table row) is a
  device value, so one program serves each row count. The floor keeps a
  row's bits independent of the bucket or chunk it was computed in (on
  the card a GEMM's row bits change below it), so chunk boundaries are
  exact and a prefix-cache hit is a cold prefill's bits.
- CHUNKED-PREFILL INTERLEAVING (`prefill_budget`). A popped request
  parks in the PREFILLING state (slot held, prompt partly ingested) and
  each scheduler round computes at most `prefill_budget` tokens of
  prefill (shortest remaining first, one chunk per lane per pass, plus
  one aging chunk for the oldest lane) before dispatching decode, so a
  long prompt stalls the decode lanes by a round's budget, not by its
  whole prefill. `prefill_budget=None` keeps monolithic admission.
- AUTOMATIC PREFIX CACHING (`prefix_cache`, on by default). A radix
  tree over `prefix_block`-token chunks (`serving/prefix_cache.py`)
  maps shared prompt prefixes to pages: of a prefix pool beside the
  slot slabs (slotted: a hit COPIES the pages into the slot with index
  copies, an insert copies the freshly computed chunks back), or of the
  one page pool (paged: `prefix_block` is the page size, a hit binds
  the tree's pages into the lane's table and an insert references the
  lane's pages, no copy either way). Only the uncached suffix is
  prefilled.
- SNAPSHOT / RESUME / ADOPT. `snapshot()` serializes the request state
  (no slabs); `LLMEngine.resume()` re-ingests every active request into
  its original slot: the prompt through prefill, the emitted tokens
  through teacher-forced decode steps (`_replay`).
  `adopt()` / `extract()` / `unqueue()` move single requests between
  engines, and `salt_clock()` / `advance_salt_clock()` carry the
  sampling-salt counter with them. Under the paged layout `extract()`
  carries the request's pages (`kv_pages`), which the adopter uploads
  instead of re-ingesting.
- HOST SWAP (paged). `swap_out(rid)` gathers a decoding request's
  pages to host memory and frees its lane and pages; the request parks
  outside the scheduler (`swapped_rids`) until `swap_in(rid)` re-queues
  it at the head, where admission uploads its pages
  (`_admit_pages`) and decode continues bitwise. Parked requests and
  their pages ride `snapshot()` (`swapped`).
- FLEET KV TIER (`kv_tier`, or `attach_kv_tier`; paged only, a slotted
  engine holds the tier inertly). After a prefill the engine PUBLISHES
  the prompt's full pages the tier lacks (one gather, one host sync
  booked in `metrics.swap_host_syncs`); at admission it BINDS the
  published chunks past its local prefix hit (scattered into fresh
  pages) and prefills only the rest. Swap-out parks the pages in the
  tier as a single-use parcel and keeps a stub (`tier_key`), which
  admission redeems; a tier fault (`tier_fetch`) or a parcel of the
  other kv_dtype degrades to a prefill. A bound chunk's rows are the
  publisher's prefill rows, and the suffix prefills under the row
  floor, so a tier bind is bitwise where a local paged prefix hit is.
- STREAMS. `attach_stream()` delivers a request's tokens at its first
  token and at each block boundary, then its finish, from host data
  the scheduler already has; `has_result()` / `peek_result()` poll
  without collecting; `close()` (or the context manager) ends the
  engine's intake and stepping.
- BEST-OF-N (`SamplingParams.n` > 1): the group's rids are assigned at
  submit (`fork_rids()`); the siblings materialise at the parent's
  queue pop, each with the next salt, and go to the queue front, so a
  group samples as n submissions of the same prompt would. Paged, a
  sibling forks off its parent's stash (prompt pages pinned, prompt
  logits kept): it binds the full prompt pages shared, copies the
  partial boundary page (`metrics.pages_cow_copied`) and runs no
  prefill. Slotted siblings prefill like independent requests.
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
- OBSERVABILITY (`paddle_tpu_torch/obs`). A bounded ring of lifecycle
  events (`self.tracer`; `trace=False` turns it off): one host tuple
  per event, one per decode BLOCK, no device contact; the capture
  watchdog (`self.watchdog`) over the engine's per-program build
  counts; a flight recorder (`self.flight`, `flight_dir` writes JSON)
  that dumps a redacted post-mortem at every terminal failure; the
  engine's stats provider in `profiler.custom_stats()` under
  `self.name` (`register_stats`). `to_prometheus()` renders the metrics
  and watchdog as exposition text, `export_trace()` the ring as a
  Perfetto trace.
- Attention goes through `models.gpt._slot_attend` / `_paged_attend`:
  `attend_impl` "ragged" runs the hand-written flash-decode kernels
  (K1 slotted, K4 paged, K5 / K6 their int8 forms), "masked" the
  full-slab `_masked_attend`; "auto" picks "ragged" on a CUDA device
  and "masked" on the CPU.
- TP-SHARDED SERVING (`tp=k`, or `mesh=serving.make_tp_mesh(k)`): a
  group of k ranks in this process, all on the engine's device
  (`nn/tp.py`). The weights are placed by the trainer's layout
  (`sharded_kv.shard_serving_params` over `models.gpt.tp_param_specs`:
  qkv head-aligned and fc1 by columns, out and fc2 by rows, the
  embedding by vocabulary rows), the KV slabs per rank over each
  rank's heads (`sharded_kv.ShardedKVCacheManager` /
  `ShardedPagedKVCache`), and every rank runs the decode kernel on its
  own heads ("ragged" resolves to "ragged_tp":
  `sharded_ragged_decode_attention`, tp launches a layer). Ranks meet
  only in `nn.tp.all_reduce` / `all_gather`, 2 L + 2 per decode step
  and per prefill call with fp weights (`stats()["tp_collectives"]`).
  The scheduler, its mirrors and every payload are the unsharded
  engine's; program keys end in the group's fingerprint. Inside one
  degree the invariants below hold bitwise; across degrees the
  logits differ by the partial sums' rounding and the greedy streams
  agree wherever the top-2 margin exceeds it.

Numerics: under "masked", a request decoded beside others is bitwise
identical to the same request decoded alone, for any
`decode_block_size` (lanes are row-independent), and the paged layout
gives the slotted layout's streams bitwise (for a fixed kv_dtype).
Chunked, interleaved and prefix-cached admission give monolithic
admission's streams bitwise (the prefill's row floor). Sampled streams
depend only on (engine seed, the request's salt, position) — see
`serving/sampler.py` — so they too are invariant to block size, lane
assignment and admission schedule; the salt is assigned when a request
leaves the queue. A resumed or adopted continuation gets its prompt
rows from the prefill and its emitted tokens' rows from teacher-forced
decode steps (`_replay`), the kernels that first wrote them, so it
continues bitwise on every device.

The KV slabs and the prefix pool are updated in place (the JAX engine
donates them into each compiled step instead), so a failed step never
loses them and the reference's slab and pool healing
(`_heal_cache`, `_pool_healthy`) has nothing to do here (nor has the
tracer's `heal` event an emitter). Every knob of the JAX engine is
ported; the one refusal left is a TP group whose ranks name several
devices (`nn.tp.make_tp_mesh`: ROADMAP Queue 1, item 18).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import DeviceLike, resolve_device
from .. import profiler
from ..models.gpt import (BLOCK_LINEARS, _block_params, _body_layers,
                          _by_groups, _each, _head, _ln, _masked_attend,
                          _paged_attend, _paged_verify_attend, _per_shard,
                          _slot_attend, _slot_verify_attend, _token_embed,
                          tp_collectives_per_step, tp_param_specs)
from ..nn.tp import TPGroup, make_tp_mesh, mesh_fingerprint, \
    require_tp_heads
from ..obs import CompileWatchdog, FlightRecorder, LifecycleTracer
from ..quantization import abs_max_scale, quantize_tensor
from ..quantization.kv import (dequant_slab, kv_update, map_slab,
                               slab_shape, take_rows)
from ..testing import faults
from .graphs import (BlockResult, BlockRunner, GraphCaptureError,
                     LaneState, PrefillRunner)
from .metrics import ServingMetrics
from .paged_kv import NoFreePages, TreePageAllocator, paged_rows
from .prefix_cache import PrefixCache
from .sampler import (DOMAIN_FIRST, compact_block, sample_tokens,
                      sample_tokens_per_lane, sample_verify_tokens,
                      speculative_accept)
from .sharded_kv import make_kv_manager, shard_serving_params

__all__ = ["SamplingParams", "GenerationResult", "EngineOverloadError",
           "LLMEngine"]

# monotonic default engine names (an id() can be reused after gc, which
# would let a new engine take a live one's stats-provider slot)
_ENGINE_IDS = itertools.count()


# every prefill call runs on at least this many rows (a bucket padded
# further; rows past max_seq are computed and not written). On the card
# a bf16 GEMM's row bits depend on the row count of its call below it:
# `scripts/prefill_row_probe.py` measured GPT-small's 3072 x 768 GEMM
# giving other bits at 16-64 rows than at 128-1024, and every prefill
# op giving the same bits at every row count from 128 to 1024. With the
# floor, a prompt row computed in a 64-token chunk or a cache-hit
# suffix has the bits of the same row in a monolithic bucket (PERF.md,
# the row probe)
PREFILL_MIN_ROWS = 128
# the sampling-salt counter wraps here (the reference's int32 lanes)
SALT_MASK = 0x7FFFFFFF


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
    # best-of-n continuations: n - 1 siblings fork off the request at
    # its queue pop, each sampled with its own salt
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
    #   "deadline" | "error" (failed after retry exhaustion)
    ttft_s: float                 # submit → first token wall time
    error: Optional[str] = None   # set iff finish_reason == "error"
    queue_wait_s: float = 0.0     # submit → prefill start
    # best-of-n: continuations 1..n-1 of this request's fork group, set
    # by `LLMEngine.generate()` (the step-driven API collects each rid
    # of `fork_rids()` itself)
    siblings: Optional[List["GenerationResult"]] = None

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
    error: Optional[str] = None
    # prefix-cache nodes the request pins while it holds its slot, and
    # the pages the last ingestion took from the cache
    prefix_nodes: Optional[List] = None
    pages_copied: int = 0
    # set when the request entered through adopt(): its queue wait runs
    # from adoption, not from the backdated submit
    adopted_t: Optional[float] = None
    # the PREFILLING state of interleaved admission: the prompt rows
    # written so far, and the wall time spent computing them (the rest
    # of the wait books as queue wait)
    pf_filled: int = 0
    pf_compute_s: float = 0.0
    # best-of-n: a parent carries its group's rids ([own] + siblings,
    # assigned at submit) and a sibling the parent's rid. Parent side,
    # the siblings not yet admitted (they keep the fork stash alive);
    # sibling side, parked PREFILLING while the parent is mid-prefill
    fork_rids: Optional[List[int]] = None
    fork_of: Optional[int] = None
    fork_pending: Optional[set] = None
    pf_wait_fork: bool = False
    # host pages (swap, page handoff): per-layer K/V row stacks and the
    # row count they cover; a queued request that has them re-enters by
    # page upload, not by re-ingest
    kv_host: Optional[Dict] = None
    # wall clock of the stream's last token delivery: the TBT sample's
    # start, one gap per processed block
    last_emit_t: float = 0.0


@dataclasses.dataclass
class _Inflight:
    """A dispatched, not yet processed decode block."""
    result: BlockResult           # its outputs, on their way to the host
    t0: float                     # dispatch wall time
    steps: int                    # in-program steps (the block capacity)
    spec: bool                    # a draft-and-verify block (with tally)


def _restore_request(r: Dict, now: float) -> _Request:
    """Rebuild a `_Request` from its snapshot dict (the port's or the
    JAX engine's). `submit_t` is backdated by the recorded elapsed time,
    so TTFT, queue wait and the remaining `deadline_s` carry across.
    The JAX dicts' `first_key` (a JAX RNG key) is read and ignored: the
    port keys a first token by (seed, salt, position, DOMAIN_FIRST), so
    the salt alone carries it. A `kv_pages` payload (host swap, page
    handoff: per-layer row stacks, numpy or torch, plain or int8
    {"q", "s"}, and the row count) becomes the request's host pages,
    which admission uploads instead of re-ingesting; a fleet-tier stub
    (`tier_key`: the rows live in the shared `KVTier`) is kept as it is
    and redeemed at admission (`_resolve_tier_stub`). A best-of-n
    parent's `fork_rids` and a sibling's `fork_of` carry the group."""
    params = SamplingParams(**r["params"])
    req = _Request(int(r["rid"]), np.asarray(r["prompt"], np.int32),
                   params, now - float(r.get("elapsed_s", 0.0)))
    req.generated = [int(t) for t in r["generated"]]
    req.ttft_s = float(r.get("ttft_s", 0.0))
    if r.get("salt") is not None:
        req.salt = int(r["salt"])
    if r.get("fork_rids") is not None:
        req.fork_rids = [int(x) for x in r["fork_rids"]]
    if r.get("fork_of") is not None:
        req.fork_of = int(r["fork_of"])
    kv = r.get("kv_pages")
    if kv is not None and "tier_key" in kv:
        req.kv_host = dict(kv)
    elif kv is not None:
        req.kv_host = {"k": list(kv["k"]), "v": list(kv["v"]),
                       "rows": int(kv["rows"]),
                       "origin": kv.get("origin", "handoff")}
    if params.deadline_s is not None:
        req.deadline_t = req.submit_t + params.deadline_s
    return req


def _default_buckets(max_seq: int) -> List[int]:
    out, b = [], 16
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return out


def _embed(params, ids: torch.Tensor, positions: torch.Tensor):
    pos = torch.clamp(positions, 0, params["wpe.weight"].shape[0] - 1)
    return _token_embed(params, ids) + params["wpe.weight"][pos]


def _prefill_rows(k0, slot: torch.Tensor, q_pos: torch.Tensor,
                  table: Optional[torch.Tensor] = None, page_size: int = 0):
    """The cache side of a prefill of positions `q_pos` (L,) into lane
    `slot` ((1,) int64), all device values: (T, the index the L rows'
    K/V are written at, `lane_view(slab, dtype)` = the lane's (1, T, nh,
    hd) rows as later decode steps read them). Slotted: the lane's
    stripe of the slabs; paged (`table`, the lane's (pages_per_seq,)
    block-table row): through the table. A row at or past T parks:
    slotted at row T-1 of its own slot, where decode parks a frozen
    lane's write; paged on the trash page (the table index clamped).
    `k0` is any layer's K slab (its shape gives the slotted T)."""
    if table is None:
        T = slab_shape(k0)[1]
        rows = (slot.expand(q_pos.shape[0]), torch.clamp(q_pos, max=T - 1))

        def lane_view(slab, dtype):
            return dequant_slab(map_slab(
                slab, lambda a: a.index_select(0, slot)), dtype)
    else:
        T = table.shape[0] * page_size
        rows = paged_rows(table, torch.clamp(q_pos, max=T - 1), page_size,
                          live=q_pos < T)

        def lane_view(slab, dtype):
            return take_rows(slab, table, dtype).reshape(
                1, T, *slab_shape(slab)[2:])
    return T, rows, lane_view


def _prefill_forward(cfg, params, k_list, v_list, ids: torch.Tensor,
                     slot: torch.Tensor, pos0: torch.Tensor,
                     length: torch.Tensor,
                     table: Optional[torch.Tensor] = None,
                     page_size: int = 0) -> torch.Tensor:
    """Prefill of `ids` (1, L) (a padded bucket) into positions
    [pos0, pos0 + L) of lane `slot` — its slab stripe, or through its
    block-table row `table` (pages_per_seq,) under the paged layout — in
    place; returns the fp32 logits (V,) of the last REAL token (position
    pos0 + length - 1). Every per-call value is a device tensor (slot,
    pos0, length: (1,) int64), and nothing depends on a host value but
    L, the cache's T rows and the layout: one function serves the CPU,
    the eager card path and the CUDA graph of `graphs.PrefillRunner`.

    Padded rows past `length` are written too and rewritten before they
    can be attended (paged: those past the lane's bound pages land on
    the trash page); rows at or past T park (`_prefill_rows`). Slotted,
    every parked row writes row T-1 of the slot, in no defined order:
    `_validate` keeps prompt + max_new_tokens <= max_seq, so no real
    prefill row is T-1 or attends it, and the order of these duplicate
    writes cannot matter. Attention reads the CACHE's view of the rows
    (dequantized for int8), the view later decode steps see."""
    L = ids.shape[1]
    dev = ids.device
    q_pos = pos0 + torch.arange(L, device=dev)
    T, rows, lane_view = _prefill_rows(k_list[0], slot, q_pos, table,
                                       page_size)
    x = _embed(params, ids, q_pos[None])                      # (1, L, h)
    keep = (torch.arange(T, device=dev)[None, :]
            <= q_pos[:, None])[None, None]                    # (1,1,L,T)

    def attn(i, q, kn, vn):
        kv_update(k_list[i], rows, _each(kn, lambda t: t[0]))
        kv_update(v_list[i], rows, _each(vn, lambda t: t[0]))
        return _per_shard(lambda qr, kc, vc: _masked_attend(
            qr, lane_view(kc, qr.dtype), lane_view(vc, qr.dtype), keep),
            q, k_list[i], v_list[i])

    x = _body_layers(cfg, params, x, attn)
    return _head(params, x.index_select(1, length - 1))[0, 0].float()


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
            kv_update(k_list[i], rows, _each(kn, lambda t: t[:, 0]))
            kv_update(v_list[i], rows, _each(vn, lambda t: t[:, 0]))
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
                kv_update(k_list[i], rows, _each(kn, lambda t: t[:, 0]))
                kv_update(v_list[i], rows, _each(vn, lambda t: t[:, 0]))
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
            kv_update(k_list[i], vrows, _each(kn, lambda t: t[:, 0]))
            kv_update(v_list[i], vrows, _each(vn, lambda t: t[:, 0]))
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

    Dispatch: `overlap` (default True) dispatches the next block before
    reading this one's tokens; `max_retries` (default 2) retries a
    failed dispatch, sync, prefill or prefix copy with a backoff of
    `retry_backoff_s * 2^n` seconds capped at `retry_backoff_max_s`.
    Streams are the same with overlap on or off, and with or without
    recovered faults.

    Admission: `prefill_chunk` (default None: one piece) splits a
    prefill into pieces of that many tokens; `prefill_budget` (default
    None: monolithic admission) interleaves chunked prefill with decode,
    at most that many prefill tokens per round while decode lanes are
    live (the chunk defaults to the budget). `prefix_cache` (default
    True) reuses cached prompt prefixes at a grain of `prefix_block`
    tokens (default 64; the page size under "paged"); the slotted pool
    holds `prefix_pool_pages` pages (default `max_slots * (max_seq //
    prefix_block)`, 0 turns the cache off).

    Fleet KV tier: `kv_tier` (default None), a `serving.KVTier` of the
    engine's page size, shared with other engines (`attach_kv_tier`).

    Tensor parallelism: `tp` (default 1) serves over a group of `tp`
    ranks on this engine's device (`make_tp_mesh(tp)`); `mesh` a group
    of one's own (`serving.make_tp_mesh(k, ranks=...)`), whose degree a
    `tp` other than 1 must equal. The heads must divide by the degree.

    Observability: `trace` (default True) records lifecycle events into
    a ring of `trace_capacity` (4096) events; `flight_dir` (default
    None: reports kept in memory only) is where post-mortems are
    written; `name` (default `llm_engine_<n>`) names the stats provider
    that `register_stats` (default True) registers with `profiler`,
    unregistered by `close()` or at garbage collection.
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
                 overlap: bool = True, max_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 retry_backoff_max_s: float = 1.0,
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = True, prefix_block: int = 64,
                 prefix_pool_pages: Optional[int] = None,
                 trace: bool = True, trace_capacity: int = 4096,
                 flight_dir: Optional[str] = None,
                 name: Optional[str] = None, register_stats: bool = True,
                 kv_tier=None, mesh: Optional[TPGroup] = None, tp: int = 1):
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        # the TP group (`paddle_tpu/serving/engine.py:511-530`): `tp`
        # alone builds one over the engine's device; a group of one rank
        # serves the unsharded path under its own fingerprint
        if int(tp) < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if mesh is not None:
            if not isinstance(mesh, TPGroup):
                raise TypeError(f"mesh must be a TP group "
                                f"(serving.make_tp_mesh), got "
                                f"{type(mesh).__name__}")
            if int(tp) not in (1, mesh.tp):
                raise ValueError(f"tp={tp} disagrees with the mesh's "
                                 f"degree ({mesh.tp})")
        elif int(tp) > 1:
            mesh = make_tp_mesh(int(tp))
        if mesh is not None:
            require_tp_heads(cfg.num_heads, mesh.tp)
            mesh = mesh.bind(self.device)
        self.mesh = mesh
        self.tp = mesh.tp if mesh is not None else 1
        self._mesh_fp = mesh_fingerprint(mesh)
        self.max_seq = int(max_seq or cfg.max_seq_len)
        if not 1 <= self.max_seq <= cfg.max_seq_len:
            raise ValueError(f"max_seq {self.max_seq} outside [1, "
                             f"{cfg.max_seq_len}] (model max_seq_len)")
        self.max_slots = int(max_slots)
        self.max_queue = int(max_queue)
        if decode_block_size < 1:
            raise ValueError("decode_block_size must be >= 1")
        self.decode_block_size = int(decode_block_size)
        self.overlap = bool(overlap)
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if retry_backoff_s < 0 or retry_backoff_max_s < 0:
            raise ValueError("retry backoffs must be >= 0")
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        if attend_impl not in ("auto", "masked", "ragged", "ragged_tp"):
            raise ValueError(f"attend_impl must be 'auto', 'masked', "
                             f"'ragged' or 'ragged_tp', got {attend_impl!r}")
        if attend_impl == "auto":
            attend_impl = "ragged" if self.device.type == "cuda" \
                else "masked"
        if attend_impl == "ragged" and self.tp > 1:
            # the kernel per rank over its heads; the masked path runs
            # the full-slab math per rank the same way
            attend_impl = "ragged_tp"
        self.attend_impl = attend_impl
        self.seed = int(seed)
        # parameters AND buffers: an int8-converted model keeps its codes
        # and scales in buffers; _apply_linear dispatches on the keys
        full = {k: v.to(self.device)
                for k, v in model.serving_params().items()}
        dtype = full["wte.weight"].dtype
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
                self._draft_params = _int8_draft_params(cfg, full, dl)
        elif draft_layers is not None:
            raise ValueError("draft_layers needs speculate_k > 0")
        self._params = full
        # collectives of one forward (decode step or prefill call)
        self._tp_per_step = 0
        if self.tp > 1:
            self._tp_per_step = tp_collectives_per_step(cfg, full)
            # the weights placed by the trainer's layout (the int8
            # draft's replicated linears stay whole)
            self._params = shard_serving_params(
                full, tp_param_specs(cfg, full), self.mesh)
            if self._draft_params is not None:
                self._draft_params = shard_serving_params(
                    self._draft_params,
                    tp_param_specs(cfg, self._draft_params), self.mesh)
        del full
        if kv_layout not in ("slotted", "paged"):
            raise ValueError(f"kv_layout must be 'slotted' or 'paged', "
                             f"got {kv_layout!r}")
        self.paged = kv_layout == "paged"
        if prefix_block < 1:
            raise ValueError("prefix_block must be >= 1")
        dims = dict(num_layers=cfg.num_layers, max_slots=self.max_slots,
                    max_seq=self.max_seq, num_heads=cfg.num_heads,
                    head_dim=cfg.head_dim, dtype=dtype, device=self.device,
                    kv_dtype=kv_dtype)
        if self.paged:
            if page_size is None:
                page_size = 64
                while page_size > 1 and self.max_seq % page_size:
                    page_size //= 2
            self.cache = make_kv_manager("paged", self.mesh, **dims,
                                         page_size=int(page_size),
                                         num_pages=kv_pages)
            self.page_size = self.cache.page_size
            self.kv_pages = self.cache.num_pages
            # the prefix chunk IS the page: a hit binds the tree's pages
            # into the lane's table, an insert references the lane's
            self.prefix_block = self.page_size
            self.prefix_pool_pages = 0
            self.prefix = PrefixCache(
                self.page_size, self.kv_pages,
                allocator=TreePageAllocator(self.cache.pool)) \
                if prefix_cache and self.max_seq >= self.page_size \
                else None
        else:
            if page_size is not None or kv_pages is not None:
                raise ValueError("page_size/kv_pages need "
                                 "kv_layout='paged'")
            self.page_size = self.kv_pages = 0
            self.prefix_block = int(prefix_block)
            if prefix_pool_pages is None:
                # 0 when max_seq cannot span one chunk: no dead slabs
                prefix_pool_pages = \
                    self.max_slots * (self.max_seq // self.prefix_block)
            if prefix_pool_pages < 0:
                raise ValueError("prefix_pool_pages must be >= 0")
            self.prefix_pool_pages = int(prefix_pool_pages) \
                if prefix_cache else 0
            self.cache = make_kv_manager(
                "slotted", self.mesh, **dims,
                prefix_pool_pages=self.prefix_pool_pages,
                prefix_block=self.prefix_block)
            self.prefix = PrefixCache(self.prefix_block,
                                      self.prefix_pool_pages) \
                if self.prefix_pool_pages > 0 else None
        self.kv_dtype = self.cache.kv_dtype
        if attend_impl != "masked" and not self.cache.quantized \
                and self.cache.slab_dtype != dtype:
            raise ValueError(f"attend_impl='ragged' needs the cache in the "
                             f"weights' dtype ({dtype}) or int8, got "
                             f"kv_dtype={self.kv_dtype!r}")
        self.metrics = ServingMetrics(self.max_slots)
        self.metrics.kv_cache_bytes = self.cache.nbytes()
        self.metrics.kv_bytes_per_token = self.cache.bytes_per_token()
        self.metrics.kv_dtype = self.kv_dtype
        self.metrics.prefix_pool_bytes = self.cache.pool_nbytes()
        self.metrics.set_prefix_gauges(0, self.prefix_pool_pages)
        self._set_page_gauges()
        self._queue: collections.deque = collections.deque()
        self._active: Dict[int, _Request] = {}      # slot -> request
        self._results: Dict[int, GenerationResult] = {}
        self._next_id = 0
        self._next_salt = 0
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1")
        self.prefill_budget = int(prefill_budget) \
            if prefill_budget is not None else None
        if self.prefill_budget is not None and prefill_chunk is None:
            # one lane's slice per round fills the budget
            prefill_chunk = self.prefill_budget
        self.prefill_chunk = int(prefill_chunk) \
            if prefill_chunk is not None else None
        # slot -> half-prefilled request (the PREFILLING lanes); the
        # insertion order is the prefill-start order
        self._prefilling: Dict[int, _Request] = {}
        bk = sorted({int(b) for b in prefill_buckets}) if prefill_buckets \
            else _default_buckets(self.max_seq)
        self._buckets = [min(b, self.max_seq) for b in bk]
        if self._buckets[-1] < self.max_seq:
            self._buckets.append(self.max_seq)
        # per-slot scheduler state. The HOST MIRRORS are authoritative
        # at admission; between blocks the decode block hands its lane
        # state straight to the next dispatch on the device (in the
        # static buffers of `_lanes`), and the mirrors are refreshed
        # from each block's token/emit matrix. `_dirty` marks mirror
        # edits that must be uploaded first.
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
        self._dirty = True
        self._lanes = LaneState(self._mirrors(), self.device)
        # block programs by speculation on/off, built at first dispatch;
        # graphs on a card (a private switch turns them off, decode and
        # prefill, for an on-card graph == eager check only)
        self._runners: Dict[bool, BlockRunner] = {}
        self._use_graphs = self.device.type == "cuda"
        # prefill programs by row count, built at their first use, and
        # the one graph memory pool their graphs share (made with the
        # first)
        self._prefill_runners: Dict[int, PrefillRunner] = {}
        self._prefill_pool = None
        # rid -> stream sink (`attach_stream`)
        self._streams: Dict[int, Callable] = {}
        self._closed = False
        # best-of-n: parent rid -> its group's rids (from submit until
        # the parent's result is collected), and parent rid -> the fork
        # stash (prompt logits, pinned prompt pages, pending siblings)
        self._fork_groups: Dict[int, List[int]] = {}
        self._fork_src: Dict[int, Dict] = {}
        self._inflight: Optional[_Inflight] = None
        self._ahead: Optional[_Inflight] = None     # the overlap lookahead
        self._last_proc_t = 0.0   # decode-time attribution watermark
        # rid -> request parked by swap_out (host pages, no device state)
        self._swapped: Dict[int, _Request] = {}
        # the fleet KV tier (publish / bind prefix chunks, swap and
        # handoff parcels); None until attached
        self._kv_tier = None
        if kv_tier is not None:
            self.attach_kv_tier(kv_tier)
        # program keys, shaped like the JAX engine's trace-counter keys
        # (ending in the group's fingerprint, () without one), and
        # the builds of each program (on a card: its CUDA graph
        # capture), which the watchdog budgets at one per program
        self._dtype_key = (f"{str(dtype).replace('torch.', '')}:"
                           f"{self.kv_dtype}")
        paged_head = (self.page_size, self.kv_pages) if self.paged else ()
        self._decode_key = (
            "paged_decode" if self.paged else "decode", self.max_slots,
            self.max_seq, self.decode_block_size, self.attend_impl,
            *paged_head, self._dtype_key, self._mesh_fp)
        self._spec_key = (
            "paged_spec_decode" if self.paged else "spec_decode",
            self.max_slots, self.max_seq, self.spec_rounds,
            self.speculate_k, self.draft, self.draft_layers,
            self.attend_impl, *paged_head, self._dtype_key,
            self._mesh_fp) if self.speculate_k else None
        self._captures: Dict[tuple, int] = {}
        # observability: the lifecycle ring, the capture watchdog (over
        # the dict above, never the engine) and the flight recorder;
        # all host-side, none adds a device sync
        self.tracer = LifecycleTracer(capacity=trace_capacity,
                                      enabled=trace)
        self.watchdog = CompileWatchdog.for_engine(self)
        self.flight = FlightRecorder(dir=flight_dir)
        self.name = name or f"llm_engine_{next(_ENGINE_IDS)}"
        self._finalizer = None
        if register_stats:
            # the provider holds the metrics and watchdog objects, not
            # the engine, so the gc-time unregister can run
            metrics, watchdog = self.metrics, self.watchdog

            def _provider(m=metrics, w=watchdog):
                out = m.snapshot()
                out.update(w.snapshot())
                return out

            profiler.register_stats_provider(self.name, _provider)
            self._finalizer = weakref.finalize(
                self, profiler.unregister_stats_provider, self.name)

    def _prefill_key(self, rows: int) -> tuple:
        """The program key of the prefill of `rows` rows (the JAX
        engine's prefill key, with the row count for its bucket)."""
        head = ("paged_prefill", self.max_seq, self.page_size,
                self.kv_pages) if self.paged else \
            ("prefill", self.max_slots, self.max_seq)
        return head + (rows, self._dtype_key, self._mesh_fp)

    def _count_build(self, key: tuple):
        self._captures[key] = self._captures.get(key, 0) + 1

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
        if params.n > self.max_slots:
            # every continuation holds a decode lane while it lives: a
            # group wider than the grid could never fork whole
            self.metrics.on_reject("invalid")
            raise ValueError(
                f"n ({params.n}) exceeds max_slots ({self.max_slots}): "
                f"best-of-n continuations each hold a decode lane")
        return prompt

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               rid: Optional[int] = None) -> int:
        """Enqueue a request; returns its id. Raises `ValueError` for a
        request that can never be served and `EngineOverloadError` when
        the bounded queue is full. `rid` lets an outside scheduler (the
        replica fleet) assign the id from its own space; the engine's
        counter moves past it, so the two spaces never collide."""
        self._ensure_open()
        params = params or SamplingParams()
        return self._enqueue(self._validate(prompt, params), params, rid)

    def _enqueue(self, prompt: np.ndarray, params: SamplingParams,
                 rid: Optional[int] = None) -> int:
        if len(self._queue) >= self.max_queue:
            self.metrics.on_reject("overload")
            raise EngineOverloadError(
                f"request queue full ({self.max_queue} pending, "
                f"{self.cache.num_active}/{self.max_slots} slots busy) — "
                f"retry after in-flight requests drain")
        if rid is None:
            rid = self._next_id
        self._next_id = max(self._next_id, int(rid) + 1)
        now = time.perf_counter()
        req = _Request(rid, prompt, params, now)
        if params.n > 1:
            # the whole group's rids now, so a caller can attach one
            # stream per continuation before anything pops; the
            # siblings materialise at the parent's pop (_expand_forks)
            kids = list(range(self._next_id, self._next_id + params.n - 1))
            self._next_id += params.n - 1
            req.fork_rids = [rid] + kids
            self._fork_groups[rid] = list(req.fork_rids)
        if params.deadline_s is not None:
            req.deadline_t = now + params.deadline_s
        self._queue.append(req)
        self.metrics.on_submit()
        self.tracer.record("submitted", rid, ts=now)
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a queued, prefilling, generating or parked request.
        Returns True iff it was live. A generating request keeps its
        emitted tokens; its lane freezes at the next dispatch and its
        slot frees at the next block boundary. A prefilling request
        never entered the decode grid: its slot and prefix pins free at
        once. A parked (swapped-out) request holds no device state:
        dropping its host pages is the cancel. Other lanes are
        unaffected."""
        self._ensure_open()
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                self.tracer.record("cancel", rid)
                self._finish_early(req, "cancelled")
                self.metrics.on_cancel()
                return True
        for slot, req in self._active.items():
            if req.rid == rid and req.finish_reason is None:
                req.finish_reason = "cancelled"
                self.tracer.record("cancel", rid, slot)
                self._freeze_slot(slot)
                self.metrics.on_cancel()
                return True
        for slot, req in list(self._prefilling.items()):
            if req.rid == rid:
                self.tracer.record("cancel", rid, slot)
                self._abort_prefill(slot, req, "cancelled")
                self.metrics.on_cancel()
                return True
        if rid in self._swapped:
            req = self._swapped.pop(rid)
            self.tracer.record("cancel", rid)
            self._finish_early(req, "cancelled")
            self.metrics.on_cancel()
            return True
        return False

    # ------------------------------------------------------------------ #
    # moving requests between engines
    # ------------------------------------------------------------------ #
    def adopt(self, req: Dict, keep_salt: bool = False) -> int:
        """Admit ONE request dict of another engine's `snapshot()`
        (`active` or `queued` entry) or `extract()` / `unqueue()`: a
        request with emitted tokens re-enters as a CONTINUATION
        (admission re-ingests prompt + emitted tokens through prefill,
        decode picks up after the last emitted token; greedy streams
        equal an undisturbed run), a request without re-enters as a new
        admission. It keeps its id, its recorded TTFT and its remaining
        `deadline_s`. Raises `EngineOverloadError` when the queue is
        full. A dict with host pages (`kv_pages`: a paged `extract()`, a
        parked request) re-enters by page upload, with no prefill, when
        this engine's pool takes the payload (`_kv_host_compat`: paged,
        the same kv_dtype structure); otherwise it re-ingests.

        The request re-salts at this engine's queue pop (the origin's
        salt could collide with one this engine assigned), unless
        `keep_salt=True` (also read from the dict's `"keep_salt"` key, as
        a fleet drain marks its moves): then the imported salt is kept
        and this engine's salt counter moves past it, so a sampled
        stream continues exactly as on the origin."""
        self._ensure_open()
        now = time.perf_counter()
        r = _restore_request(req, now)
        if keep_salt or req.get("keep_salt"):
            if r.salt is not None:
                self._next_salt = max(self._next_salt,
                                      (r.salt + 1) & SALT_MASK)
        else:
            r.salt = None
        if r.kv_host is not None and not self._kv_host_compat(r):
            r.kv_host = None      # layout or kv_dtype differs: re-ingest
        self._validate(r.prompt, r.params)
        if len(self._queue) >= self.max_queue:
            self.metrics.on_reject("overload")
            raise EngineOverloadError(
                f"request queue full ({self.max_queue} pending) — adopt "
                f"{r.rid} on another engine")
        self._next_id = max(self._next_id, max(r.fork_rids) + 1
                            if r.fork_rids else r.rid + 1)
        if r.fork_rids:
            self._fork_groups[r.rid] = list(r.fork_rids)
        r.adopted_t = now
        self._queue.append(r)
        self.metrics.on_submit()
        self.tracer.record("submitted", r.rid, ts=now)
        return r.rid

    def _adoption_dict(self, r: _Request, now: float) -> Dict:
        """A request as `adopt()` takes it: the one serialization shared
        by `snapshot()`, `extract()` and `unqueue()`. A request's host
        pages (parked, or queued for reactivation) ride as `kv_pages`."""
        d = {"rid": r.rid, "prompt": np.asarray(r.prompt, np.int32),
             "params": dataclasses.asdict(r.params),
             "generated": list(r.generated), "slot": r.slot,
             "ttft_s": r.ttft_s, "salt": r.salt,
             "elapsed_s": now - r.submit_t}
        if r.fork_rids:
            d["fork_rids"] = list(r.fork_rids)
        if r.fork_of is not None:
            d["fork_of"] = r.fork_of
        if r.kv_host is not None and "tier_key" in r.kv_host:
            # a tier stub: only the single-use parcel key crosses
            d["kv_pages"] = dict(r.kv_host)
        elif r.kv_host is not None:
            d["kv_pages"] = {"k": list(r.kv_host["k"]),
                             "v": list(r.kv_host["v"]),
                             "rows": int(r.kv_host["rows"]),
                             "origin": r.kv_host.get("origin", "swap")}
        return d

    def _kv_host_compat(self, r: _Request) -> bool:
        """True when a request's host pages can upload into THIS
        engine's pool: the paged layout and the same slab structure
        (int8 {"q", "s"} rows for an int8 pool, plain stacks for an fp
        one). Otherwise the request re-ingests: requantization goes
        through the normal write path, never by reinterpreting foreign
        bytes."""
        if not self.paged or r.kv_host is None:
            return False
        if "tier_key" in r.kv_host:
            # a tier stub: redeemable iff a tier is attached here and
            # the parcel's kv_dtype is this pool's
            return self._kv_tier is not None and \
                bool(r.kv_host.get("quantized", False)) \
                == self.cache.quantized
        ks = r.kv_host.get("k") or ()
        return bool(len(ks)) and isinstance(ks[0], dict) \
            == self.cache.quantized

    def salt_clock(self) -> int:
        """The next salt this engine's queue pop assigns."""
        return int(self._next_salt)

    def advance_salt_clock(self, value: int) -> None:
        """Move the salt counter to at least `value` (never back): a
        drain carries the origin's clock to the adopter before any
        drained request pops there, so requests without a salt yet draw
        the salts the origin would have assigned."""
        self._next_salt = max(self._next_salt, int(value) & SALT_MASK)

    def decoding_rids(self) -> List[int]:
        """Active requests past prefill with at least one emitted token,
        by slot: the prefill-to-decode HANDOFF set (what `extract()`
        takes)."""
        return [req.rid for _, req in sorted(self._active.items())
                if req.finish_reason is None and req.generated]

    def extract(self, rid: int) -> Optional[Dict]:
        """Take a DECODING request (active, at least one token emitted)
        out of this engine and return its `adopt()` dict; None for any
        other rid. No result is recorded here. Under the paged layout
        the dict carries the request's pages (`kv_pages`, gathered under
        the recovery contract, one host sync booked in
        `metrics.swap_host_syncs`), so the adopter uploads them instead
        of re-ingesting; a gather that exhausts its retries leaves them
        out (the adopter then re-ingests). The lane freezes like a
        cancel's and its slot frees at the next block boundary, not
        now: a block already dispatched still has the lane live, and a
        new occupant must not be credited with its tokens. Its stream is
        dropped silently: the adopter's attach replays from zero."""
        self._ensure_open()
        for slot, req in self._active.items():
            if req.rid != rid:
                continue
            if req.finish_reason is not None or not req.generated:
                return None
            now = time.perf_counter()
            d = self._adoption_dict(req, now)
            if self.paged:
                # the rows of every token but the last (`cur`, which
                # the adopter's first decode step writes); a dispatched
                # block only writes rows past them
                rows = self.cache.length(slot)
                pages = self.cache.lane_pages(slot)[
                    :self.cache.span_pages(rows)]

                def gather(d=d, pages=pages, rows=rows):
                    k_host, v_host = self._gather_pages(pages)
                    d["kv_pages"] = {"k": k_host, "v": v_host,
                                     "rows": rows, "n_pages": len(pages),
                                     "origin": "handoff"}

                if self._run_with_retries(gather) is None:
                    self.metrics.swap_host_syncs += 1
                else:
                    d.pop("kv_pages", None)
            req.finish_reason = "handoff"
            self._freeze_slot(slot)
            self._streams.pop(rid, None)
            self.tracer.record("handoff", rid, slot, ts=now)
            return d
        return None

    def unqueue(self, rid: int) -> Optional[Dict]:
        """Take a request that holds NO device state out of this engine
        (QUEUED, or PARKED by `swap_out`, its host pages riding the
        dict) and return its `adopt()` dict (None otherwise). A queued
        request that has no salt yet gets the one its pop here would
        have drawn, so an adopter with `keep_salt=True` continues the
        very stream this engine would have produced (unqueue in pop
        order). No stream event fires: the new owner's attach replays
        from zero. A fork parent leaves without a salt: its group's
        salts are drawn at the adopter's pop, where the siblings
        materialise. A sibling that leaves lets go of its parent's fork
        stash here."""
        self._ensure_open()
        now = time.perf_counter()
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                if req.salt is None and not req.fork_rids:
                    req.salt = self._next_salt
                    self._next_salt = (self._next_salt + 1) & SALT_MASK
                self._fork_done(req)
                self._streams.pop(rid, None)
                self.tracer.record("handoff", rid, ts=now)
                return self._adoption_dict(req, now)
        if rid in self._swapped:
            req = self._swapped.pop(rid)
            self._streams.pop(rid, None)
            self.tracer.record("handoff", rid, ts=now)
            return self._adoption_dict(req, now)
        return None

    def result(self, rid: int) -> GenerationResult:
        """Fetch-and-evict a finished request's result."""
        if rid not in self._results:
            raise KeyError(f"request {rid} not finished (or unknown, "
                           f"or already collected)")
        self._fork_groups.pop(rid, None)   # dies with the parent's result
        return self._results.pop(rid)

    def fork_rids(self, rid: int) -> List[int]:
        """The best-of-n group `rid` heads: `[rid, sibling rids...]`
        (empty for an n = 1 request, or once the parent's result was
        collected). Every listed rid yields its own result and stream."""
        return list(self._fork_groups.get(rid, []))

    def has_result(self, rid: int) -> bool:
        """True iff `rid` has finished and its result is still
        uncollected (a poll that pays no KeyError per live request)."""
        return rid in self._results

    def peek_result(self, rid: int) -> Optional[GenerationResult]:
        """A finished, uncollected result without evicting it (None when
        unknown, unfinished or collected)."""
        return self._results.get(rid)

    # ------------------------------------------------------------------ #
    # incremental token streaming
    # ------------------------------------------------------------------ #
    def attach_stream(self, rid: int, sink: Callable) -> bool:
        """Register `sink` for incremental delivery: the engine calls
        `sink(kind, *payload)` on the scheduling thread with
        `("tokens", start_index, [ids...])` at the first token and at
        every decode-block boundary that emitted for the request, then
        once `("finished", reason, error)`. The events carry host data
        the scheduler already has: no per-token work, no host sync. An
        attach replays the tokens emitted so far as one `("tokens", 0,
        ...)` event (the consumer dedups by start index); one sink per
        rid, the latest wins. Returns False for an unknown rid, True
        otherwise, also for a finished, uncollected request, whose
        replay and `finished` event fire at once."""
        g = self._results.get(rid)
        if g is not None:
            if g.token_ids:
                sink("tokens", 0, list(g.token_ids))
            sink("finished", g.finish_reason, g.error)
            return True
        req = self._find_request(rid)
        if req is None:
            if rid in self._swapped:
                # a parked request streams again at reactivation; the
                # replay below covers what it emitted so far
                req = self._swapped[rid]
            elif any(rid in group[1:]
                     for group in self._fork_groups.values()):
                # a PROMISED fork sibling (its parent has not popped):
                # the sink registers now and gets the first token
                self._streams[rid] = sink
                return True
            else:
                return False
        if req.generated:
            sink("tokens", 0, list(req.generated))
        self._streams[rid] = sink
        return True

    def detach_stream(self, rid: int):
        """Forget a sink; the request itself is untouched (pair with
        `cancel(rid)` to free its slot too)."""
        self._streams.pop(rid, None)

    def _find_request(self, rid: int) -> Optional[_Request]:
        for req in self._active.values():
            if req.rid == rid:
                return req
        for req in self._prefilling.values():
            if req.rid == rid:
                return req
        for req in self._queue:
            if req.rid == rid:
                return req
        return None

    def _emit_stream(self, rid: int, kind: str, *payload):
        sink = self._streams.get(rid)
        if sink is None:
            return
        try:
            sink(kind, *payload)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:  # noqa: BLE001 — a broken sink must not take
            # the scheduler down: the request goes on and its result
            # stays collectable, only the live feed is lost
            self._streams.pop(rid, None)

    def close(self):
        """Terminal: `submit()`, `step()`, `generate()` and the other
        calls that feed or drive the engine raise `RuntimeError("engine
        closed")` afterwards; `result()`, `stats()` and `snapshot()`
        keep working, so a shutting-down server can still collect
        results and take a resume snapshot. The stats provider is
        unregistered (once)."""
        self._closed = True
        if self._finalizer is not None:
            self._finalizer()
            self._finalizer = None

    @torch.no_grad()
    def warm_up(self, prompt_lengths: Sequence[int] = (1,)) -> int:
        """Build (on a card: capture) the programs traffic will run, now
        rather than inside the first requests' TTFTs: the plain decode
        block program (which a continuation's replay steps run too: a
        failover adoption, a resume), the speculative one when
        `speculate_k` > 0, and the prefill program of every row count a
        prompt of one of `prompt_lengths` tokens is prefilled at (its
        `prefill_chunk` pieces, each at least `PREFILL_MIN_ROWS` rows).
        Each program is built once per engine, whenever it is built, so
        the watchdog's budget is unchanged; the captures run with every
        lane frozen and every prefill write parked, so live requests
        are untouched. The JAX engine shares compiled programs through
        the model; the port's graphs belong to each engine (a resumed or
        rebuilt engine warms its own). Returns the number of programs
        built."""
        self._ensure_open()

        def built():
            return len(self._runners) + len(self._prefill_runners)

        before = built()
        self._runner(False)
        if self.speculate_k:
            self._runner(True)
        rows = set()
        for n in prompt_lengths:
            n = min(max(int(n), 1), self.max_seq)
            chunk = self.prefill_chunk or n
            pieces = [chunk] * (n // chunk) + ([n % chunk] if n % chunk
                                               else [])
            rows.update(max(self._bucket_for(p), PREFILL_MIN_ROWS)
                        for p in pieces)
        for r in sorted(rows):
            self._prefill_runner(r)
        return built() - before

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _ensure_open(self):
        if self._closed:
            raise RuntimeError("engine closed")

    def has_work(self) -> bool:
        """Whether `step()` has anything to do (parked requests are
        outside the scheduler until `swap_in`)."""
        return bool(self._queue or self._active or self._prefilling
                    or self._inflight is not None
                    or self._ahead is not None)

    @property
    def pending(self) -> int:
        """Requests waiting in the bounded queue."""
        return len(self._queue)

    @property
    def prefilling(self) -> int:
        """Requests parked in the PREFILLING state (slot held, prompt
        partly ingested, first token not sampled yet)."""
        return len(self._prefilling)

    @property
    def kv_pages_free(self) -> int:
        """Free pages of the pool (0 under the slotted layout)."""
        return self.cache.pool.num_free if self.paged else 0

    def page_load(self) -> Optional[int]:
        """Outstanding work PRICED IN PAGES: pages held (the trash page
        aside) plus the queue's reserved spans, minus what eviction
        could reclaim now (idle cached prefixes are capacity, not
        load). What admission will charge, so a least-work router ranks
        replicas by memory pressure, not by request count. None under
        the slotted layout."""
        if not self.paged:
            return None
        demand = sum(self.cache.span_pages(self._span_rows(r))
                     for r in self._queue)
        reclaimable = self.prefix.reclaimable_pages() \
            if self.prefix is not None else 0
        pool = self.cache.pool
        held = pool.pages_used - pool.reserved
        return max(0, held - reclaimable) + demand

    def stats(self) -> Dict[str, float]:
        """The metrics snapshot, plus the TP degree, the collectives the
        engine's forwards ran (`tp_collectives`: all-reduces and
        all-gathers, counted per replay on a card; 0 at tp 1) and the
        collectives of one forward (`tp_collectives_per_step`)."""
        out = self.metrics.snapshot()
        out.update(tp=self.tp, tp_collectives=self.mesh.collectives
                   if self.mesh is not None else 0,
                   tp_collectives_per_step=self._tp_per_step)
        return out

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def to_prometheus(self) -> str:
        """Prometheus text exposition of this engine's metrics and its
        capture watchdog's families (what a front door serves at
        /metrics)."""
        return self.metrics.to_prometheus(
            extra_families=self.watchdog.families())

    def export_trace(self, path: Optional[str] = None) -> Dict:
        """Chrome/Perfetto trace of the lifecycle ring (one track per KV
        slot lane, the queue and engine tracks); written as JSON to
        `path` when given. For a snapshot / resume pair concatenate the
        two rings and call `obs.export_chrome_trace` (request ids never
        overlap)."""
        return self.tracer.export(path)

    # ------------------------------------------------------------------ #
    # scheduler
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def step(self) -> int:
        """One scheduler iteration at block granularity: expire
        deadlines, admit queued requests into free slots (prefill +
        first token; with `prefill_budget`, one round of interleaved
        chunks instead), dispatch a decode block (plus, with overlap,
        the NEXT block before this one's host processing), process one
        block's tokens, retire finished requests. Dispatch, sync,
        prefill and prefix copies all run under the recovery contract.
        Returns the number of requests completed."""
        self._ensure_open()
        self._expire_deadlines()
        if self.prefill_budget is None:
            while self._queue and self.cache.num_free > 0 \
                    and self._pages_admit_ok():
                if not self._admit_next():
                    break        # page pressure: the head waits
        else:
            self._interleave_admission()
        self._decode_round()
        done = self._retire_finished()
        self.metrics.set_gauges(len(self._queue), self.cache.num_active,
                                len(self._prefilling))
        if self.prefix is not None:
            self.metrics.set_prefix_gauges(self.prefix.pages_used,
                                           self.prefix.num_pages,
                                           self.prefix.evictions)
        self._set_page_gauges()
        return done

    def _set_page_gauges(self):
        if self.paged:
            pool = self.cache.pool
            self.metrics.set_page_gauges(pool.pages_used, self.kv_pages,
                                         pool.peak_used)

    def run_until_complete(self, max_steps: Optional[int] = None):
        self._ensure_open()
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
        order (a best-of-n request's continuations 1..n-1 ride its
        result as `siblings`). Every request is validated before any is
        enqueued."""
        self._ensure_open()
        if isinstance(params, SamplingParams) or params is None:
            params = [params] * len(prompts)
        if len(params) != len(prompts):
            raise ValueError(f"got {len(prompts)} prompts but "
                             f"{len(params)} SamplingParams")
        params = [sp or SamplingParams() for sp in params]
        prompts = [self._validate(p, sp) for p, sp in zip(prompts, params)]
        rids, groups = [], {}
        for p, sp in zip(prompts, params):
            # a batch larger than max_queue drains with scheduler steps
            while len(self._queue) >= self.max_queue and self.has_work():
                self.step()
            rid = self._enqueue(p, sp)
            rids.append(rid)
            groups[rid] = self.fork_rids(rid)
        self.run_until_complete()
        out = []
        for rid in rids:
            g = self.result(rid)
            if groups[rid]:
                g.siblings = [self.result(k) for k in groups[rid][1:]]
            out.append(g)
        return out

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
        when the request leaves the queue: the one point monolithic and
        interleaved admission share, so the salts, and with them every
        sampled stream, do not depend on the admission mode. A best-of-n
        parent's siblings materialise here (`_expand_forks`)."""
        best = self._select_next()
        self._queue.remove(best)
        if best.salt is None:
            best.salt = self._next_salt
            self._next_salt = (self._next_salt + 1) & SALT_MASK
        if best.fork_rids and best.fork_of is None \
                and not best.generated and best.params.n > 1:
            self._expand_forks(best)
        return best

    def _expand_forks(self, parent: _Request):
        """Materialise a best-of-n parent's siblings at its pop, the one
        point every admission mode and layout shares: each takes the
        next salt, right after the parent's, so a group draws the salts
        n submissions of its prompt would, in every mode. They go to
        the queue FRONT, where those submissions would pop next. The
        reference also draws a first-token key per sibling here; the
        port keys a first token by (seed, salt, position, DOMAIN_FIRST),
        so the salt is the whole draw. A resumed parent whose siblings
        rode the snapshot makes none."""
        kids = []
        for krid in parent.fork_rids[1:]:
            if self._find_request(krid) is not None \
                    or krid in self._results or krid in self._swapped:
                continue
            k = _Request(krid, parent.prompt,
                         dataclasses.replace(parent.params, n=1),
                         parent.submit_t)
            k.fork_of = parent.rid
            k.deadline_t = parent.deadline_t
            k.adopted_t = parent.adopted_t
            k.salt = self._next_salt
            self._next_salt = (self._next_salt + 1) & SALT_MASK
            kids.append(k)
            self.metrics.on_submit()
            self.tracer.record("submitted", krid)
        if not kids:
            return
        for k in reversed(kids):
            self._queue.appendleft(k)
        parent.fork_pending = {k.rid for k in kids}
        self.tracer.record("fork", parent.rid, args=(len(kids),))

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

    def _matchable(self, req: _Request) -> np.ndarray:
        """The part of the prompt a cache hit may cover: a fresh request
        keeps its last token for the prefill whose logits give the
        first token; a continuation needs no logits."""
        p = req.prompt
        return p if req.generated else p[:p.size - 1]

    def _pages_needed(self, req: _Request) -> int:
        """Fresh pages the request would allocate: its span minus the
        pages it can share (a fork parent's full prompt pages, or the
        prefix tree's)."""
        span = self.cache.span_pages(self._span_rows(req))
        if req.kv_host is not None:
            return span                  # a page upload shares nothing
        src = self._fork_src.get(req.fork_of)
        if src is not None:
            return span - src["prompt_len"] // self.page_size
        if self.prefix is None:
            return span
        _, pages = self.prefix.match(self._matchable(req))
        return span - len(pages)

    def _pages_available(self, need: int) -> bool:
        """True when the pool can cover `need` fresh pages, evicting
        unreferenced prefix pages to make room."""
        pool = self.cache.pool
        if need > pool.num_free and self.prefix is not None:
            self.prefix.evict(need - pool.num_free)
        return need <= pool.num_free

    def _pages_admit_ok(self) -> bool:
        """True when the pool can cover the NEXT request's pages (always
        under the slotted layout). When it cannot, admission waits: no
        skipping to a smaller request behind it."""
        if not self.paged or not self._queue:
            return True
        return self._pages_available(self._pages_needed(self._select_next()))

    def _alloc_pages(self, n: int) -> List[int]:
        """`n` fresh pages, evicting unreferenced prefix pages under
        pressure; raises `NoFreePages` past that (the gate prices the
        need first)."""
        if n <= 0:
            return []
        pool = self.cache.pool
        if n > pool.num_free and self.prefix is not None:
            self.prefix.evict(n - pool.num_free)
        return pool.alloc(n)

    def _admit_failed(self, req: _Request, err: BaseException):
        """A request whose admission exhausted its retries fails alone."""
        msg = f"{type(err).__name__}: {err}"
        self._finish_early(req, "error", error=msg)
        self.metrics.on_failed()
        self._postmortem("admission_failed",
                         {"failed_rids": [req.rid], "error": msg})

    def _admit_next(self) -> bool:
        """Pop the next request and prefill it into a free slot under
        the recovery contract: a failed prefill or prefix copy re-runs
        the SAME slot from row 0 (the first token's key depends only on
        the salt and position, so the retry is bit-identical); after
        `max_retries` the request fails ALONE. Returns False only when
        page pressure sent the request back to the queue head (stop
        admitting this round)."""
        req = self._pop_highest_priority()
        slot = self.cache.allocate()
        err = self._run_with_retries(lambda: self._admit_one(req, slot))
        if err is None:
            return True
        self.cache.release(slot)      # drops any pages bound to it
        if isinstance(err, NoFreePages):
            # page pressure means WAIT, never fail: back to the queue
            # head, salt kept
            self._release_prefix(req)
            self._queue.appendleft(req)
            return False
        self._admit_failed(req, err)
        return True

    def _admit_one(self, req: _Request, slot: int):
        if self.paged and req.kv_host is not None \
                and self._resolve_tier_stub(req):
            # a page upload (swap-in, page handoff, a parcel redeemed
            # from the tier): no prefill at all. An unredeemable stub
            # dropped kv_host and falls through to the prefill
            self._admit_pages(req, slot)
            return
        if self.paged and req.fork_of in self._fork_src:
            # a COW fork: no prefill compute at all
            self._fork_install(req, slot, self._fork_src[req.fork_of])
            return
        self.cache.reset_length(slot)      # an attempt starts from row 0
        t0 = time.perf_counter()
        logits = self._ingest_tokens(slot, req, req.prompt,
                                     need_logits=not req.generated)
        self.cache.advance(slot, int(req.prompt.size))
        if req.generated:
            self._replay([(slot, req)])
        first = None if req.generated else self._sample_first(req, logits)
        t1 = time.perf_counter()
        req.queue_wait_s = t0 - (req.adopted_t or req.submit_t)
        self.metrics.on_admit(int(req.prompt.size), t1 - t0,
                              queue_wait_s=req.queue_wait_s)
        self.tracer.record("admitted", req.rid, slot, dur=t1 - t0, ts=t1,
                           args=(int(req.prompt.size), req.pages_copied,
                                 bool(req.generated)))
        if req.generated:
            # a continuation: decode resumes after the last emitted
            # token; its TTFT was recorded where it started
            self._install_slot(req, slot, pos=self.cache.length(slot))
        else:
            self._stash_fork_src(req, slot, logits)
            self._first_token_install(req, slot, first, t1)

    def _sample_first(self, req: _Request, logits: torch.Tensor) -> int:
        """The first token, from the last prompt position's logits,
        keyed by (seed, salt, position, DOMAIN_FIRST)."""
        p = req.params
        return int(sample_tokens(
            logits[None], self.seed, req.salt, int(req.prompt.size) - 1,
            p.temperature, p.top_k, p.top_p, DOMAIN_FIRST)[0])

    def _first_token_install(self, req: _Request, slot: int, first: int,
                             now: float):
        """Decode entry of a FRESH request, shared by monolithic and
        interleaved admission: record TTFT, take the first token, wire
        the lane."""
        req.ttft_s = now - req.submit_t
        self.metrics.on_first_token(req.ttft_s)
        req.generated.append(first)
        req.last_emit_t = now               # the first TBT gap's start
        self._emit_stream(req.rid, "tokens", 0, [first])
        self._fork_done(req)            # a no-op but for a fork sibling
        self._install_slot(req, slot, pos=int(req.prompt.size))

    # ------------------------------------------------------------------ #
    # best-of-n: copy-on-write forks (paged layout)
    # ------------------------------------------------------------------ #
    def _stash_fork_src(self, req: _Request, slot: int,
                        logits: torch.Tensor):
        """A fork parent at decode entry: pin its prompt pages (one
        reference each, so they outlive the parent) and keep its
        prompt's last-position logits, from which every sibling samples
        its own first token. Released when the last pending sibling
        leaves the group (`_fork_done`)."""
        if not self.paged or not req.fork_pending:
            return
        P = int(req.prompt.size)
        pages = self.cache.lane_pages(slot)[:self.cache.span_pages(P)]
        for p in pages:
            self.cache.pool.ref(p)
        self._fork_src[req.rid] = {"logits": logits, "pages": pages,
                                   "prompt_len": P,
                                   "pending": set(req.fork_pending)}

    def _fork_done(self, kid: _Request):
        """A sibling left the pending set (admitted, forked or not, or
        finished before admission): drop it from the parent's
        bookkeeping, and release the stash's page pins after the last.
        The port has no caller of the reference's `_drop_fork_srcs`: it
        never heals its pool, so a stash never outlives its pages."""
        if kid.fork_of is None:
            return
        parent = self._find_request(kid.fork_of)
        if parent is not None and parent.fork_pending:
            parent.fork_pending.discard(kid.rid)
        src = self._fork_src.get(kid.fork_of)
        if src is not None:
            src["pending"].discard(kid.rid)
            if not src["pending"]:
                for p in src["pages"]:
                    self.cache.pool.unref(p)
                del self._fork_src[kid.fork_of]

    def _fork_install(self, req: _Request, slot: int, src: Dict):
        """Fork one sibling off its parent's stash: bind the parent's
        FULL prompt pages (references, no copy), bind the owned pages of
        the rest of its span, copy the partial boundary page (the one
        its first decode write changes), and sample the first token
        from the stashed logits with the sibling's own salt: the
        group's streams are n independent admissions' (the slotted
        path's). Owned pages are bound before the copy, so a retry's
        `reset_length` drops them; the copy is booked after the
        attempt's last fallible step, so a retry never counts twice."""
        self.cache.reset_length(slot)
        P = src["prompt_len"]
        full = P // self.page_size
        self.cache.bind_shared(slot, src["pages"][:full])
        span = self.cache.span_pages(self._span_rows(req))
        owned = self._alloc_pages(span - full)
        self.cache.bind_owned(slot, owned)
        copied = bool(P % self.page_size)
        if copied:
            self.cache.copy_page(src["pages"][full], owned[0])
        self.cache.advance(slot, P)
        first = self._sample_first(req, src["logits"])
        now = time.perf_counter()
        wait_t0 = req.adopted_t or req.submit_t
        req.queue_wait_s = max(0.0, (now - wait_t0) - req.pf_compute_s)
        if copied:
            self.metrics.on_cow_copy()
        self.metrics.on_admit(P, req.pf_compute_s,
                              queue_wait_s=req.queue_wait_s)
        self.tracer.record("admitted", req.rid, slot, ts=now,
                           args=(P, full, False))
        self._first_token_install(req, slot, first, now)

    # ------------------------------------------------------------------ #
    # page transfer and host swap (paged layout)
    # ------------------------------------------------------------------ #
    def _admit_pages(self, req: _Request, slot: int):
        """Re-enter a request whose K/V rows arrived as host pages
        (swap-in, or a page handoff): reserve its span in fresh pages,
        scatter the rows into the first of them, and install the lane
        after the last emitted token (its row is `cur`, written by the
        next decode step) with the request's salt: no prefill, and
        bitwise because the rows are the rows. The parked gap is no TBT
        sample: the stream restarts here."""
        self.cache.reset_length(slot)            # retry-safe
        rows = int(req.kv_host["rows"])
        npages = self.cache.span_pages(rows)
        pages = self._alloc_pages(
            self.cache.span_pages(self._span_rows(req)))
        self.cache.bind_owned(slot, pages)       # before the scatter: a
        # retry's reset_length drops them
        self._scatter_pages(pages[:npages], req.kv_host["k"],
                            req.kv_host["v"])
        self.cache.advance(slot, rows)
        now = time.perf_counter()
        req.queue_wait_s = max(0.0, now - (req.adopted_t or req.submit_t))
        if req.kv_host.get("origin") == "swap":
            self.metrics.on_swap_in(npages)
            self.tracer.record("swap_in", req.rid, slot, args=(npages,))
        self.metrics.on_admit(int(req.prompt.size), 0.0,
                              queue_wait_s=req.queue_wait_s)
        self.tracer.record("admitted", req.rid, slot, ts=now,
                           args=(int(req.prompt.size), npages, True))
        req.kv_host = None
        req.last_emit_t = 0.0
        self._install_slot(
            req, slot, pos=int(req.prompt.size) + len(req.generated) - 1)

    def _gather_pages(self, pages: List[int]):
        """`pages` of every layer to host memory (one device buffer, one
        copy, one sync: `PagedKVCache.gather_pages`); fires the
        `page_swap` fault point first."""
        faults.fire("page_swap")
        return self.cache.gather_pages(pages)

    def _scatter_pages(self, pages: List[int], k_rows, v_rows):
        """Host row stacks into `pages` of every layer
        (`PagedKVCache.scatter_pages`); fires the `page_swap` fault
        point first."""
        faults.fire("page_swap")
        self.cache.scatter_pages(pages, k_rows, v_rows)

    # ------------------------------------------------------------------ #
    # the fleet KV tier: cross-replica prefix reuse and parked pages
    # ------------------------------------------------------------------ #
    def attach_kv_tier(self, tier) -> None:
        """Attach the fleet-shared host KV tier (`serving/kv_tier.py`).
        A paged engine publishes page-aligned prefix chunks after
        prefill, binds published chunks at admission instead of
        prefilling them, and parks swapped-out pages in the tier. A
        slotted engine holds the reference inertly: nothing slotted
        crosses engines. Raises `ValueError` for a tier of another page
        size."""
        if self.paged and int(tier.page_size) != self.page_size:
            raise ValueError(
                f"kv tier page_size {tier.page_size} != engine "
                f"page_size {self.page_size}")
        self._kv_tier = tier

    @staticmethod
    def _tier_payload_nbytes(layers) -> int:
        return sum(a.numel() * a.element_size()
                   for lay in layers
                   for a in (lay.values() if isinstance(lay, dict)
                             else (lay,)))

    @staticmethod
    def _cat_rows(payloads, side: str, layer: int):
        """Layer `layer`'s `side` rows of several one-page payloads, as
        one `[n, ...]` stack (both leaves of an int8 layer)."""
        rows = [p[side][layer] for p in payloads]
        if isinstance(rows[0], dict):
            return {key: torch.cat([r[key] for r in rows])
                    for key in ("q", "s")}
        return torch.cat(rows)

    def _tier_bind(self, slot: int, req: _Request, tokens: np.ndarray,
                   ncached: int, limit: int) -> int:
        """Bind tier-published chunks PAST the local prefix hit into
        `slot`'s block table: probe consecutive chunk keys from row
        `ncached` (up to `limit` rows: a fresh request keeps its last
        token for the prefill whose logits give the first token), fetch
        every hit and scatter the rows into freshly allocated pages.
        Returns the rows bound (a multiple of the page size). A tier
        fault (`tier_fetch`) or a payload of the other kv_dtype stops
        the probe: the rest just prefills."""
        tier = self._kv_tier
        if tier is None or not self.paged:
            return 0
        ps = self.page_size
        ci = ncached // ps
        if (ci + 1) * ps > limit:
            return 0
        t0 = time.perf_counter()
        payloads = []
        try:
            while (ci + 1) * ps <= limit:
                key = tier.chunk_key(tokens[:(ci + 1) * ps])
                if not tier.has_chunk(key):
                    break
                faults.fire("tier_fetch")
                p = tier.fetch_chunk(key)
                if p is None or bool(p.get("quantized", False)) \
                        != self.cache.quantized:
                    break      # foreign bytes never reinterpret
                payloads.append(p)
                ci += 1
        except faults.InjectedFault:
            pass               # a lost tier: keep what was fetched
        if not payloads:
            self.metrics.kv_tier_misses += 1
            return 0
        n, L = len(payloads), self.cfg.num_layers
        k_rows = [self._cat_rows(payloads, "k", j) for j in range(L)]
        v_rows = [self._cat_rows(payloads, "v", j) for j in range(L)]
        pages = self._alloc_pages(n)
        self.cache.bind_owned(slot, pages)   # before the scatter: a
        # retry's reset drops them
        self._scatter_pages(pages, k_rows, v_rows)
        rows = n * ps
        req.pages_copied += n
        self.metrics.kv_tier_hits += n
        self.metrics.kv_tier_bytes += self._tier_payload_nbytes(k_rows) \
            + self._tier_payload_nbytes(v_rows)
        self.tracer.record("tier_bind", req.rid, slot,
                           dur=time.perf_counter() - t0, args=(rows, n))
        return rows

    def _tier_publish(self, slot: int, tokens: np.ndarray, rid: int):
        """Publish `slot`'s full prompt pages the tier does not hold
        yet: one gather to host memory (one host sync, booked in
        `metrics.swap_host_syncs` like every swap-path sync), then one
        tier put per missing chunk, each chunk's own bytes. Best effort:
        a failed publish never fails the admission that computed the
        rows."""
        tier = self._kv_tier
        if tier is None or not self.paged:
            return
        try:
            ps = self.page_size
            want = []
            for ci in range(int(tokens.size) // ps):
                key = tier.chunk_key(tokens[:(ci + 1) * ps])
                if not tier.has_chunk(key):
                    want.append((ci, key))
            if not want:
                return
            t0 = time.perf_counter()
            pages = [self.cache.lane_page(slot, ci) for ci, _ in want]
            k_host, v_host = self._gather_pages(pages)
            self.metrics.swap_host_syncs += 1

            def one(lay, j):
                if isinstance(lay, dict):
                    return {key: a[j:j + 1] for key, a in lay.items()}
                return lay[j:j + 1]

            nbytes = 0
            for j, (_, key) in enumerate(want):
                nbytes += tier.publish_chunk(key, {
                    "k": [one(lay, j) for lay in k_host],
                    "v": [one(lay, j) for lay in v_host],
                    "rows": ps, "quantized": self.cache.quantized})
            self.metrics.kv_tier_bytes += nbytes
            self.tracer.record("tier_publish", rid, slot,
                               dur=time.perf_counter() - t0,
                               args=(len(want) * ps, len(want), nbytes))
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:  # noqa: BLE001 — publishing is best effort
            pass

    def _resolve_tier_stub(self, req: _Request) -> bool:
        """True when `req.kv_host` holds (or now holds) uploadable rows.
        A tier stub is redeemed here, a single-use pop, so a retried
        admission sees the resolved payload and never asks the tier
        twice. A stub that cannot be redeemed (a `tier_fetch` fault, a
        lost parcel, the other kv_dtype) degrades to a prefill: kv_host
        drops to None and admission re-ingests, bitwise."""
        kv = req.kv_host
        if kv is None:
            return False
        if "tier_key" not in kv:
            return True
        tier = self._kv_tier
        payload = None
        try:
            faults.fire("tier_fetch")
            if tier is not None:
                payload = tier.take_handoff(kv["tier_key"])
        except faults.InjectedFault:
            if tier is not None:      # unreachable by contract: drop it
                tier.drop_handoff(kv["tier_key"])
        if payload is None or bool(payload.get("quantized", False)) \
                != self.cache.quantized:
            self.metrics.kv_tier_misses += 1
            req.kv_host = None
            return False
        rows = int(payload["rows"])
        req.kv_host = {"k": payload["k"], "v": payload["v"],
                       "rows": rows, "origin": kv.get("origin", "handoff")}
        self.metrics.kv_tier_hits += 1
        self.metrics.kv_tier_bytes += \
            self._tier_payload_nbytes(payload["k"]) \
            + self._tier_payload_nbytes(payload["v"])
        self.tracer.record("tier_bind", req.rid,
                           args=(rows, self.cache.span_pages(rows)))
        return True

    def swap_out(self, rid: int) -> bool:
        """Move a DECODING request's resident K/V pages to host memory
        and free its lane and pages: a parked request holds no device
        memory. Returns True iff `rid` was decoding and is now parked
        (`swapped_rids`); False for any other rid, and for a swap whose
        gather exhausted its retries (the request stays resident and
        decoding, nothing leaks). Raises `RuntimeError` on the slotted
        layout. In-flight blocks are discarded first (they replay from
        the mirrors), so the gathered rows are exactly the mirrors'.
        Lane, prefix pins and page references are released at once:
        nothing is in flight after the discard. A parked request is
        outside the scheduler: `has_work()` ignores it, its deadline
        still runs, `cancel`, `unqueue` and `attach_stream` work on it,
        and `snapshot()` carries it with its pages; `swap_in(rid)`
        re-queues it."""
        self._ensure_open()
        if not self.paged:
            raise RuntimeError("host swap needs kv_layout='paged'")
        for slot, req in list(self._active.items()):
            if req.rid != rid:
                continue
            if req.finish_reason is not None or not req.generated:
                return False
            self._discard_inflight()
            rows = self.cache.length(slot)
            pages = self.cache.lane_pages(slot)[
                :self.cache.span_pages(rows)]

            def gather(req=req, pages=pages, rows=rows):
                k_host, v_host = self._gather_pages(pages)
                req.kv_host = {"k": k_host, "v": v_host, "rows": rows,
                               "origin": "swap"}

            if self._run_with_retries(gather) is not None:
                req.kv_host = None
                return False
            if self._kv_tier is not None:
                # pool swap capacity fleet-wide: park the pages in the
                # tier and keep a single-use stub, which any engine of
                # the tier (this one too) redeems at admission; on a
                # tier error the local payload stays
                try:
                    kv = req.kv_host
                    key = self._kv_tier.put_handoff(
                        {"k": kv["k"], "v": kv["v"], "rows": kv["rows"],
                         "quantized": self.cache.quantized})
                    req.kv_host = {"tier_key": key, "rows": kv["rows"],
                                   "n_pages": len(pages), "origin": "swap",
                                   "quantized": self.cache.quantized}
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception:  # noqa: BLE001 — keep the local pages
                    pass
            del self._active[slot]
            self._release_prefix(req)
            self.cache.release(slot)   # page references drop; pages the
            # tree shares stay cached
            self._act[slot] = False
            self._dirty = True
            self._swapped[rid] = req
            self.metrics.on_swap_out(len(pages))
            self.tracer.record("swap_out", rid, slot, args=(len(pages),))
            return True
        return False

    def swap_in(self, rid: int) -> bool:
        """Reactivate a parked request: it re-enters at the queue HEAD,
        and its admission uploads its host pages into fresh pages
        (`_admit_pages`); decode continues after its last emitted
        token, bitwise. False for a rid that is not parked."""
        self._ensure_open()
        req = self._swapped.pop(rid, None)
        if req is None:
            return False
        self._queue.appendleft(req)
        return True

    @property
    def swapped_rids(self) -> List[int]:
        """The parked (swapped-out) requests' ids, sorted."""
        return sorted(self._swapped)

    # ------------------------------------------------------------------ #
    # chunked-prefill interleaving (prefill_budget set)
    # ------------------------------------------------------------------ #
    def _interleave_admission(self):
        """One round of schedulable prefill: (1) move queued requests
        into free slots as PREFILLING lanes (slot, prefix-cache hit and
        page reservation only, no prompt compute); (2) one AGING chunk
        for the oldest lane, outside the budget, so shorter arrivals
        cannot starve a long prompt; (3) spend `prefill_budget` tokens
        over the lanes shortest-remaining-first, one chunk per lane per
        pass, a lane entering decode when its last row lands. With no
        live decode lane the stall costs nothing, and the round runs one
        unthrottled chunk-per-lane pass instead."""
        while self._queue and self.cache.num_free > 0 \
                and self._pages_admit_ok():
            if not self._begin_prefill():
                break            # page pressure: the head waits
        spent = 0
        if self._prefilling:
            head = next(iter(self._prefilling))
            self._prefill_step(head, self._prefilling[head])
        while self._prefilling:
            ordered = sorted(
                self._prefilling.items(),
                key=lambda kv: kv[1].prompt.size - kv[1].pf_filled)
            before = (spent, len(self._prefilling))
            for slot, req in ordered:
                if self._has_live_lane() \
                        and spent >= self.prefill_budget:
                    break
                if self._prefilling.get(slot) is not req:
                    continue     # completed or failed earlier this pass
                spent += self._prefill_step(slot, req)
            if not self._has_live_lane() or spent >= self.prefill_budget:
                break
            if (spent, len(self._prefilling)) == before:
                # no token computed and no lane done: every parked lane
                # is a fork sibling waiting for its parent's pages
                break
        if self._queue or self._prefilling:
            # an engine-scope counter event per round with admission
            # work: the queue-depth track of the Perfetto export
            self.tracer.record("prefill_interleave",
                               args=(len(self._queue),
                                     len(self._prefilling), spent))

    def _begin_prefill(self) -> bool:
        """Pop the next request into a PREFILLING lane (slot, cached
        prefix, pages) under the recovery contract; exhaustion fails
        this request alone. Returns False only when page pressure
        requeued it. A page upload or a COW fork installs at once (it
        has no prompt to compute); a paged sibling whose parent is
        mid-prefill parks WAITING, with no pages, until the parent's
        stash exists."""
        req = self._pop_highest_priority()
        slot = self.cache.allocate()
        if self.paged and (req.kv_host is not None
                           or req.fork_of in self._fork_src):
            err = self._run_with_retries(lambda: self._admit_one(req, slot))
            if err is not None:
                self.cache.release(slot)
                if isinstance(err, NoFreePages):
                    self._queue.appendleft(req)
                    return False
                self._admit_failed(req, err)
            return True
        req.pf_filled = 0
        req.pf_compute_s = 0.0
        if self.paged and req.fork_of is not None \
                and self._fork_parent_prefilling(req.fork_of):
            req.pf_wait_fork = True
            self.tracer.record("admitted", req.rid, slot,
                               args=(int(req.prompt.size), 0, False))
            self._prefilling[slot] = req
            return True
        t0 = time.perf_counter()
        err = self._run_with_retries(
            lambda: self._start_prefill_lane(slot, req))
        t1 = time.perf_counter()
        req.pf_compute_s += t1 - t0
        if err is None:
            # the admitted event marks PREFILL START here (the chunks
            # are spans of their own)
            self.tracer.record("admitted", req.rid, slot, dur=t1 - t0,
                               ts=t1, args=(int(req.prompt.size),
                                            req.pages_copied,
                                            bool(req.generated)))
        if err is not None:
            self.cache.release(slot)
            if isinstance(err, NoFreePages):
                self._release_prefix(req)
                self._queue.appendleft(req)
                return False
            self._admit_failed(req, err)
            return True
        self._prefilling[slot] = req
        return True

    def _start_prefill_lane(self, slot: int, req: _Request):
        """(Re)initialize a PREFILLING lane: take the cached prefix
        (paged: bind the tree's pages; slotted: copy them into the slot)
        and, paged, reserve the request's whole page span, so page
        pressure gates admission, never a half-prefilled lane."""
        self.cache.reset_length(slot)
        req.pf_filled = 0
        self._release_prefix(req)
        req.pages_copied = 0
        if self.prefix is not None:
            nodes, pages = self.prefix.match(self._matchable(req))
            if pages:
                self.prefix.acquire(nodes)
                req.prefix_nodes = nodes
                if self.paged:
                    self.cache.bind_shared(slot, pages)
                else:
                    self._copy_prefix(slot, pages)
                req.pages_copied = len(pages)
                req.pf_filled = len(pages) * self.prefix_block
                self.cache.advance(slot, req.pf_filled)
        # the fleet tier extends the local hit with published chunks;
        # the rest prefills chunk by chunk
        got = self._tier_bind(
            slot, req, req.prompt, req.pf_filled,
            int(req.prompt.size) - (0 if req.generated else 1))
        if got:
            req.pf_filled += got
            self.cache.advance(slot, got)
        if self.paged:
            span = self.cache.span_pages(self._span_rows(req))
            self.cache.bind_owned(slot, self._alloc_pages(
                span - self.cache.lane_page_count(slot)))

    def _fork_parent_prefilling(self, rid: int) -> bool:
        return any(r.rid == rid for r in self._prefilling.values())

    def _waiting_fork_step(self, slot: int, req: _Request) -> Optional[int]:
        """One visit to a WAITING fork sibling: fork as soon as the
        parent's stash and the pages exist (0 tokens charged), keep
        waiting while the parent prefills (0), or, when the parent left
        without a stash (it failed or was cancelled before decode),
        turn into a plain prefill lane and return None: the caller
        goes on into its first chunk."""
        if req.fork_of in self._fork_src:
            if not self._pages_available(self._pages_needed(req)):
                return 0
            del self._prefilling[slot]
            err = self._run_with_retries(lambda: self._admit_one(req, slot))
            if err is not None:
                self.cache.release(slot)
                self._admit_failed(req, err)
            return 0
        if self._fork_parent_prefilling(req.fork_of):
            return 0
        req.pf_wait_fork = False
        err = self._run_with_retries(
            lambda: self._start_prefill_lane(slot, req))
        if err is not None:
            self._prefilling.pop(slot, None)
            self.cache.release(slot)
            self._admit_failed(req, err)
            return 0
        return None

    def _prefill_step(self, slot: int, req: _Request) -> int:
        """Advance one PREFILLING lane by at most one chunk; returns the
        tokens computed. The last chunk enters the lane into decode. A
        chunk failure retries at the same pos0 under the recovery
        contract; exhaustion fails this request alone."""
        if req.pf_wait_fork:
            charged = self._waiting_fork_step(slot, req)
            if charged is not None:
                return charged
        total = int(req.prompt.size)
        piece = req.prompt[req.pf_filled:
                              req.pf_filled + self.prefill_chunk]
        logits = [None]

        def chunk():
            logits[0] = self._prefill_tokens(slot, piece, pos0=req.pf_filled,
                                             rid=req.rid)

        if piece.size:
            if not self._prefill_attempt(slot, req, chunk):
                return int(piece.size)
            req.pf_filled += int(piece.size)
            self.cache.advance(slot, int(piece.size))
        if req.pf_filled < total:
            return int(piece.size)
        # --- the last row landed: enter decode ------------------------- #
        if req.generated and not self._prefill_attempt(
                slot, req, lambda: self._replay([(slot, req)])):
            return int(piece.size)
        del self._prefilling[slot]
        self._try_insert_prefix(slot, req.prompt)
        self._tier_publish(slot, req.prompt, req.rid)
        ncached = req.pages_copied * self.prefix_block
        self.metrics.on_prefix(ncached, total - ncached,
                               lookup=self.prefix is not None)
        now = time.perf_counter()
        # queue wait: everything between submit and decode entry that
        # was not this request's own prefill compute
        wait_t0 = req.adopted_t or req.submit_t
        req.queue_wait_s = max(0.0, (now - wait_t0) - req.pf_compute_s)
        self.metrics.on_admit(int(req.prompt.size), req.pf_compute_s,
                              queue_wait_s=req.queue_wait_s)
        if req.generated:
            self._install_slot(req, slot, pos=self.cache.length(slot))
        else:
            first = self._sample_first(req, logits[0])
            # the interleaved twin of _admit_one's stash: the waiting
            # siblings fork off it
            self._stash_fork_src(req, slot, logits[0])
            self._first_token_install(req, slot, first, now)
        return int(piece.size)

    def _prefill_attempt(self, slot: int, req: _Request, fn) -> bool:
        """Run one piece of a PREFILLING lane's work (a chunk, or a
        continuation's replay) under the recovery contract, its time
        booked as the request's own compute. Exhaustion fails this
        request alone and frees its lane; returns whether it ran."""
        t0 = time.perf_counter()
        err = self._run_with_retries(fn)
        req.pf_compute_s += time.perf_counter() - t0
        if err is None:
            return True
        self._prefilling.pop(slot, None)
        self.cache.release(slot)
        self._admit_failed(req, err)
        return False

    def _abort_prefill(self, slot: int, req: _Request, reason: str):
        """Terminal exit from the PREFILLING state (cancel, deadline):
        the lane never entered the decode grid, so its slot and pins
        free at once."""
        self._prefilling.pop(slot, None)
        self.cache.release(slot)
        self._finish_early(req, reason)

    # ------------------------------------------------------------------ #
    # prompt ingestion: prefix-cache hit + suffix prefill + insert
    # ------------------------------------------------------------------ #
    def _ingest_tokens(self, slot: int, req: _Request, tokens: np.ndarray,
                       need_logits: bool) -> Optional[torch.Tensor]:
        """Write `tokens`' K/V rows into rows [0, len) of `slot`: take
        the longest cached prefix from the prefix cache, prefill only
        the uncached suffix, then insert the new full chunks into the
        tree. `need_logits` (a fresh request) keeps at least the last
        token out of the hit, so its logits exist to sample from.
        Retry-safe: an attempt releases the previous attempt's pins and
        matches again. Length bookkeeping is the caller's."""
        self._release_prefix(req)
        ncached = 0
        req.pages_copied = 0
        if self.paged:
            self.cache.clear_lane_pages(slot)
        if self.prefix is not None:
            nodes, pages = self.prefix.match(
                tokens[:tokens.size - 1] if need_logits else tokens)
            if pages:
                self.prefix.acquire(nodes)
                req.prefix_nodes = nodes
                if self.paged:
                    self.cache.bind_shared(slot, pages)
                else:
                    self._copy_prefix(slot, pages)
                ncached = len(pages) * self.prefix_block
                req.pages_copied = len(pages)
        # the fleet tier: continue past the local hit with chunks another
        # engine published (booked as reused tokens)
        ncached += self._tier_bind(slot, req, tokens, ncached,
                                   int(tokens.size) - int(need_logits))
        if self.paged:
            span = self.cache.span_pages(self._span_rows(req))
            self.cache.bind_owned(slot, self._alloc_pages(
                span - self.cache.lane_page_count(slot)))
        logits = self._prefill_tokens(slot, tokens[ncached:], pos0=ncached,
                                      rid=req.rid)
        self._try_insert_prefix(slot, tokens)
        self._tier_publish(slot, tokens, req.rid)
        self.metrics.on_prefix(ncached, int(tokens.size) - ncached,
                               lookup=self.prefix is not None)
        return logits

    def _replay(self, lanes: List):
        """Rebuild the K/V rows of continuations' emitted tokens but the
        last (which is `cur`), rows [P, P + g - 1) of each (slot,
        request) of `lanes`, as decode wrote them: teacher-forced decode
        steps over the whole lane grid, each feeding every listed lane
        its next emitted token at its next position while every other
        lane is frozen (its write parks at row T-1 or on the trash
        page). The products run on the lane grid's rows as decode's do,
        and the attention kernel reads each lane's own rows, so the
        rows are decode's bits on every device; a prefill of the same
        tokens (the reference's re-ingest) computes other bits on a
        card. Each step is one run of the plain block's one-step program
        (on a card one graph replay) on the block's static lane buffers,
        every sampling knob neutral (its token is discarded); the lane
        state is re-uploaded from the mirrors at the next dispatch.
        Advances each slot's length by g - 1; a retry replays from the
        start."""
        todo = [(slot, int(req.prompt.size), req.generated[:-1])
                for slot, req in lanes if len(req.generated) > 1]
        if not todo:
            return
        runner = self._runner(False)
        self._dirty = True
        S = self.max_slots
        state = {"cur": np.zeros(S, np.int64), "pos": np.zeros(S, np.int64),
                 "rem": np.ones(S, np.int64), "act": np.zeros(S, bool),
                 "salt": np.zeros(S, np.int64),
                 "temp": np.zeros(S, np.float32),
                 "topk": np.zeros(S, np.int64),
                 "topp": np.ones(S, np.float32),
                 "eos": np.full(S, -1, np.int64)}
        if self.paged:
            state["tables"] = self.cache.block_tables
        for j in range(max(len(t) for _, _, t in todo)):
            state["cur"][:] = 0
            state["pos"][:] = 0
            state["act"][:] = False
            for slot, p0, toks in todo:
                if j < len(toks):
                    state["cur"][slot] = toks[j]
                    state["pos"][slot] = p0 + j
                    state["act"][slot] = True
            self._lanes.upload(state)
            runner.run_once()
            self.metrics.replay_steps += 1
        for slot, _, toks in todo:
            self.cache.advance(slot, len(toks))

    def _copy_prefix(self, slot: int, pages: List[int]):
        """A slotted cache HIT: pool `pages` become the slot's rows
        [0, len(pages) * prefix_block), one index copy per layer slab.
        The exact page list is copied: an eager copy needs no padding to
        a bucket of page counts (the reference's `_page_bucket_for`
        bounds its number of compiled programs)."""
        faults.fire("prefix_copy")
        self.cache.copy_pool_to_slot(pages, slot)

    def _insert_prefix(self, slot: int, tokens: np.ndarray):
        """Insert `tokens`' not yet cached full chunks into the tree.
        Paged: the tree references the lane's freshly prefilled pages
        (host bookkeeping only). Slotted: allocate pool pages (LRU
        eviction under pressure) and copy the slot's rows into them; a
        failed copy rolls the tree back, so no node points at a page
        that was not written."""
        if self.paged:
            self.prefix.insert_mapped(
                tokens, lambda i: self.cache.lane_page(slot, i))
            return
        created = self.prefix.insert(tokens)
        if not created:
            return
        try:
            # one contiguous run of chunks: in a trie every chunk after
            # a missing one is missing too
            self.cache.copy_slot_to_pool(slot, created[0][1],
                                         [n.page for n, _ in created])
        except Exception:
            self.prefix.drop(created)
            raise

    def _try_insert_prefix(self, slot: int, tokens: np.ndarray):
        """Populate the cache, best effort: the slot's rows are complete
        already, so a failed insert never fails the admission (it
        degrades the hit rate; `_insert_prefix` rolled the tree back).
        The pool is written in place, and only the dropped pages were
        touched, so nothing else needs rebuilding."""
        if self.prefix is None:
            return
        try:
            self._insert_prefix(slot, tokens)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:  # noqa: BLE001 — population is optional
            pass

    def _release_prefix(self, req: _Request):
        if req.prefix_nodes is not None:
            if self.prefix is not None:
                self.prefix.release(req.prefix_nodes)
            req.prefix_nodes = None

    def _prefill_tokens(self, slot: int, tokens: np.ndarray,
                        pos0: int = 0, rid: int = -1
                        ) -> Optional[torch.Tensor]:
        """Bucketed, optionally chunked prefill of `tokens` into rows
        [pos0, pos0 + len) of `slot` (through its block-table row when
        paged); returns the last real token's fp32 logits (None for no
        tokens: a fully cached re-ingest). Each piece fires the
        `prefill` fault point once, then runs as the prefill program of
        its bucket's rows, at least `PREFILL_MIN_ROWS` (on a card one
        CUDA graph replay); rows past max_seq park. Each piece records
        one `prefill_chunk` event for request `rid`."""
        chunk = self.prefill_chunk or max(int(tokens.size), 1)
        table = self.cache.block_tables[slot] if self.paged else None
        logits = None
        for ofs in range(0, int(tokens.size), chunk):
            faults.fire("prefill")
            c0 = time.perf_counter()
            piece = tokens[ofs:ofs + chunk]
            rows = max(self._bucket_for(piece.size), PREFILL_MIN_ROWS)
            logits = self._prefill_runner(rows).run(piece, slot,
                                                    pos0 + ofs, table)
            self.tracer.record("prefill_chunk", rid, slot,
                               dur=time.perf_counter() - c0,
                               args=(int(piece.size), pos0 + ofs))
        return logits

    def _prefill_runner(self, rows: int) -> PrefillRunner:
        """The prefill program of `rows` rows, built (on a card:
        captured, into the engine's one prefill graph pool) at its
        first use; its capture is booked apart from the decode
        programs' (`metrics.prefill_graph_*`)."""
        runner = self._prefill_runners.get(rows)
        if runner is None:
            graphed = self._use_graphs
            if graphed and self._prefill_pool is None:
                self._prefill_pool = torch.cuda.graph_pool_handle()
            body = functools.partial(_prefill_forward, self.cfg,
                                     self._params, self.cache.k,
                                     self.cache.v, page_size=self.page_size)
            table_len = self.cache.block_tables.shape[1] if self.paged \
                else 0
            cache_rows = table_len * self.page_size if self.paged \
                else self.max_seq
            t0 = time.perf_counter()
            runner = PrefillRunner(body, rows, cache_rows, table_len,
                                   self.device, graphed=graphed,
                                   pool=self._prefill_pool)
            self._count_build(self._prefill_key(rows))
            if runner.graph is not None:
                self.metrics.on_prefill_graph_capture(
                    time.perf_counter() - t0, runner.pool_bytes)
            self._prefill_runners[rows] = runner
        return runner

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

    def _finish_early(self, req: _Request, reason: str,
                      error: Optional[str] = None):
        """Terminal state for a request that never got (or no longer
        holds) a slot: record its result directly. A sibling dying
        before admission leaves its group's pending set; a parent dying
        before its pop resolves every promised sibling rid with the
        same reason, so no stream of the group is stranded."""
        req.finish_reason = reason
        req.error = error
        if req.kv_host is not None and "tier_key" in req.kv_host \
                and self._kv_tier is not None:
            # a parked request dying with an unredeemed parcel must not
            # leave it in the shared store
            self._kv_tier.drop_handoff(req.kv_host["tier_key"])
            req.kv_host = None
        self._release_prefix(req)   # a failed admission may hold pins
        self._fork_done(req)
        if req.fork_rids and req.fork_of is None:
            for krid in req.fork_rids[1:]:
                if self._find_request(krid) is None \
                        and krid not in self._results \
                        and krid not in self._swapped:
                    kid = _Request(krid, req.prompt, req.params,
                                   req.submit_t)
                    kid.finish_reason, kid.error = reason, error
                    self._record_result(kid)
        self._record_result(req)

    def _record_result(self, req: _Request):
        self.tracer.record("finished", req.rid, req.slot,
                           args=(req.finish_reason,))
        self._emit_stream(req.rid, "finished", req.finish_reason, req.error)
        self._streams.pop(req.rid, None)
        self._results[req.rid] = GenerationResult(
            req.rid, req.prompt, req.generated, req.finish_reason,
            req.ttft_s, req.error, queue_wait_s=req.queue_wait_s)
        if req.finish_reason in ("stop", "length"):
            self.metrics.on_complete()

    def _expire_deadlines(self):
        """Block-boundary deadline sweep. A request that expires queued
        or PREFILLING books its wait into queue_wait (prefilling: minus
        its own chunk compute) and leaves with its (empty) result at
        once; an active one freezes and retires at the boundary,
        keeping its tokens; a parked one leaves with its tokens (parking
        never outlives a deadline)."""
        now = time.perf_counter()
        for req in [r for r in self._queue
                    if r.deadline_t is not None and now >= r.deadline_t]:
            self._queue.remove(req)
            self.tracer.record("deadline", req.rid, ts=now)
            req.queue_wait_s = now - (req.adopted_t or req.submit_t)
            self.metrics.queue_wait.observe(req.queue_wait_s)
            self._finish_early(req, "deadline")
            self.metrics.on_deadline()
        for slot, req in list(self._prefilling.items()):
            if req.deadline_t is not None and now >= req.deadline_t:
                self.tracer.record("deadline", req.rid, slot, ts=now)
                req.queue_wait_s = max(
                    0.0, (now - (req.adopted_t or req.submit_t))
                    - req.pf_compute_s)
                self.metrics.queue_wait.observe(req.queue_wait_s)
                self._abort_prefill(slot, req, "deadline")
                self.metrics.on_deadline()
        for slot, req in self._active.items():
            if (req.finish_reason is None and req.deadline_t is not None
                    and now >= req.deadline_t):
                req.finish_reason = "deadline"
                self.tracer.record("deadline", req.rid, slot, ts=now)
                self._freeze_slot(slot)
                self.metrics.on_deadline()
        for rid, req in list(self._swapped.items()):
            if req.deadline_t is not None and now >= req.deadline_t:
                del self._swapped[rid]
                self.tracer.record("deadline", rid, ts=now)
                self._finish_early(req, "deadline")
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
        """Free the slots of finished lanes and unpin their prefix
        paths (every exit route retires through here). An extracted
        ("handoff") request records no result: it goes on elsewhere."""
        done = 0
        for slot in [s for s, r in self._active.items()
                     if r.finish_reason is not None]:
            req = self._active.pop(slot)
            self.cache.release(slot)
            self._release_prefix(req)
            if req.finish_reason == "handoff":
                continue
            self._record_result(req)
            done += 1
        return done

    # ------------------------------------------------------------------ #
    # recovery
    # ------------------------------------------------------------------ #
    def _run_with_retries(self, attempt_fn,
                          on_failure=None) -> Optional[BaseException]:
        """THE recovery boundary, shared by decode and admission: run
        `attempt_fn`, retrying up to `max_retries` times with capped
        exponential backoff; `on_failure` runs after each failed attempt
        (state rollback). Returns None on success, or the last exception
        when retries are exhausted (the caller decides what fails). A
        failed graph capture is not transient and goes straight out."""
        last = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.metrics.on_retry()
                self.tracer.record("retry", args=(attempt,))
                self._backoff(attempt - 1)
            try:
                attempt_fn()
                if attempt:
                    self.metrics.on_recovery()
                return None
            except (KeyboardInterrupt, SystemExit, GraphCaptureError):
                raise
            except Exception as e:  # noqa: BLE001 — recovery boundary
                last = e
                if on_failure is not None:
                    on_failure()
        return last

    def _backoff(self, n: int):
        delay = min(self.retry_backoff_s * (2.0 ** n),
                    self.retry_backoff_max_s)
        if delay > 0:
            time.sleep(delay)

    def _engine_config(self) -> Dict:
        """The constructor keywords `snapshot()["engine"]` records and
        `resume()` feeds back (the prefix tree and pool, like the KV
        slabs, are not serialized: re-ingest repopulates them)."""
        return {"max_slots": self.max_slots, "max_queue": self.max_queue,
                "max_seq": self.max_seq,
                "prefill_buckets": list(self._buckets),
                "prefill_chunk": self.prefill_chunk,
                "prefill_budget": self.prefill_budget,
                "prefix_cache": self.prefix is not None,
                "prefix_block": self.prefix_block,
                "prefix_pool_pages": None if self.paged
                else self.prefix_pool_pages,
                "seed": self.seed,
                "decode_block_size": self.decode_block_size,
                "overlap": self.overlap, "attend_impl": self.attend_impl,
                "max_retries": self.max_retries,
                "retry_backoff_s": self.retry_backoff_s,
                "retry_backoff_max_s": self.retry_backoff_max_s,
                "kv_layout": "paged" if self.paged else "slotted",
                "page_size": self.page_size if self.paged else None,
                "kv_pages": self.kv_pages if self.paged else None,
                "kv_dtype": self.kv_dtype, "speculate_k": self.speculate_k,
                "draft": self.draft,
                "draft_layers": self.draft_layers or None,
                "device": str(self.device),
                # the degree only: resume() builds a group of it over its
                # device (overrides may pin one: `mesh=`)
                "tp": self.tp,
                # the observability settings ride along, so a resumed
                # engine keeps the deployment's tracing and flight dir
                "trace": self.tracer.enabled,
                "trace_capacity": self.tracer.capacity,
                "flight_dir": self.flight.dir}

    # ------------------------------------------------------------------ #
    # snapshot and resume
    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict:
        """The engine's request state as a picklable dict of primitives,
        numpy arrays and (host pages) CPU tensors: the engine config,
        the id and salt counters, the free-slot order, every active,
        queued and parked request and the uncollected results. The KV
        slabs are not serialized: `resume()` re-ingests each active
        request's prompt and emitted tokens; a parked request's pages
        are host state already and ride its dict (`swapped`,
        `kv_pages`), so it reactivates without a prefill. It is the
        host state as of the last processed block: a dispatched,
        unprocessed block keeps running, and a continuation of the
        snapshot replays what it emits, since sampling keys by (seed,
        salt, position) and not by a step index the block would advance
        (the JAX engine discards such blocks, whose step index rolls
        back; a fleet's periodic snapshot would waste one block in
        three). PREFILLING requests serialize as queued at the head of
        the queue (they have emitted nothing, so nothing re-emits),
        their slots on top of the free stack so they get their lanes
        back. The engine keeps serving afterwards."""
        self._retire_finished()
        now = time.perf_counter()
        pf_slots = list(self._prefilling)
        return {
            "version": 1,
            "engine": self._engine_config(),
            "next_id": self._next_id,
            "next_salt": self._next_salt,
            "free_slots": self.cache.free_slots()
            + list(reversed(pf_slots)),
            "active": [self._adoption_dict(r, now)
                       for _, r in sorted(self._active.items())],
            "queued": [self._adoption_dict(r, now)
                       for r in self._prefilling.values()]
            + [self._adoption_dict(r, now) for r in self._queue],
            "swapped": [self._adoption_dict(r, now)
                        for _, r in sorted(self._swapped.items())],
            "results": [{"rid": g.request_id, "prompt": g.prompt,
                         "token_ids": list(g.token_ids),
                         "finish_reason": g.finish_reason,
                         "ttft_s": g.ttft_s, "error": g.error,
                         "queue_wait_s": g.queue_wait_s}
                        for g in self._results.values()],
        }

    @classmethod
    @torch.no_grad()
    def resume(cls, model, snap: Dict, **overrides) -> "LLMEngine":
        """Rebuild an engine from a `snapshot()` (of this engine or of
        the JAX engine) and continue every request. Active requests
        re-enter their ORIGINAL slots with their prompt and emitted
        tokens re-ingested through prefill (under the recovery contract;
        exhaustion fails that request alone); the free-slot order, the
        id and salt counters and the remaining `deadline_s` carry over;
        queued requests re-enter the queue in order. Parked requests
        (`swapped`) park again with their host pages where this engine's
        pool takes them (`_kv_host_compat`), and re-enter the queue to
        re-ingest where it does not (a layout or kv_dtype override); a
        queued request's pages are dropped the same way. `overrides` go
        to the constructor (e.g. `device="cpu"`).

        A JAX snapshot's `step_no` and `gen_state` (JAX RNG state) and
        its requests' `first_key` are read and ignored: the port keys
        sampling by (seed, salt, position), so the salts carry the
        streams. Each continuation's prompt is re-ingested through the
        prefill (and the prefix cache) and its emitted tokens through
        teacher-forced decode steps (`_replay`), so the continuation is
        bitwise that of an uninterrupted run of this engine."""
        if snap.get("version") != 1:
            raise ValueError(
                f"unknown snapshot version {snap.get('version')!r}")
        kw = dict(snap["engine"])
        kw.update(overrides)
        eng = cls(model, **kw)
        eng._next_id = int(snap["next_id"])
        eng._next_salt = int(snap.get("next_salt", 0))
        now = time.perf_counter()
        for g in snap.get("results", ()):
            eng._results[g["rid"]] = GenerationResult(
                g["rid"], np.asarray(g["prompt"], np.int32),
                list(g["token_ids"]), g["finish_reason"],
                float(g["ttft_s"]), g.get("error"),
                queue_wait_s=float(g.get("queue_wait_s", 0.0)))
        restored = []
        for r in snap.get("active", ()):
            req = _restore_request(r, now)
            if req.fork_rids:
                eng._fork_groups[req.rid] = list(req.fork_rids)
            if not req.generated:
                raise ValueError(f"snapshot: active request {req.rid} "
                                 f"has no emitted tokens")
            slot = eng.cache.allocate(int(r["slot"]))

            def ingest(slot=slot, req=req):
                eng.cache.reset_length(slot)     # a retry starts over
                eng._ingest_tokens(slot, req, req.prompt,
                                   need_logits=False)
                eng.cache.advance(slot, int(req.prompt.size))

            eng.metrics.on_submit()
            t0 = time.perf_counter()
            err = eng._run_with_retries(ingest)
            if err is not None:
                eng.cache.release(slot)
                eng._admit_failed(req, err)
                continue
            restored.append((slot, req, time.perf_counter() - t0))
        # the emitted tokens' rows of every restored lane, in one replay
        # over the lane grid
        lanes = [(slot, req) for slot, req, _ in restored]
        t0 = time.perf_counter()
        err = eng._run_with_retries(lambda: eng._replay(lanes))
        replay_s = time.perf_counter() - t0
        for slot, req, ingest_s in restored:
            if err is not None:
                eng.cache.release(slot)
                eng._admit_failed(req, err)
                continue
            eng.metrics.on_admit(int(req.prompt.size), ingest_s + replay_s)
            t1 = time.perf_counter()
            eng.tracer.record("admitted", req.rid, slot,
                              dur=ingest_s + replay_s, ts=t1,
                              args=(int(req.prompt.size), req.pages_copied,
                                    True))
            eng._install_slot(req, slot, pos=eng.cache.length(slot))
        if "free_slots" in snap:
            eng.cache.restore_free_order(snap["free_slots"])
        for r in snap.get("queued", ()):
            req = _restore_request(r, now)
            if req.fork_rids:
                eng._fork_groups[req.rid] = list(req.fork_rids)
            if not eng._kv_host_compat(req):
                req.kv_host = None
            eng._queue.append(req)
            eng.metrics.on_submit()
        for r in snap.get("swapped", ()):
            req = _restore_request(r, now)
            if req.fork_rids:
                eng._fork_groups[req.rid] = list(req.fork_rids)
            if eng._kv_host_compat(req):
                eng._swapped[req.rid] = req
            else:
                req.kv_host = None       # re-ingests as a continuation
                eng._queue.append(req)
            eng.metrics.on_submit()
        return eng

    def _postmortem(self, reason: str, detail: Optional[Dict] = None
                    ) -> Optional[Dict]:
        """One flight-recorder dump of a terminal failure: the reason,
        the detail, the lifecycle ring's tail, a metrics snapshot and
        the engine config, redacted, kept, written to `flight_dir` when
        set, and announced to an armed fault plan
        (`faults.note_postmortem`, inside `FlightRecorder.dump`). Called
        only on terminal paths, never per block."""
        return self.flight.dump(
            reason, events=self.tracer.tail(self.flight.last_n),
            metrics=self.metrics.snapshot(),
            config=self._engine_config(), detail=detail)

    # ------------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------------ #
    def _has_live_lane(self) -> bool:
        return any(r.finish_reason is None for r in self._active.values())

    @property
    def _block_capacity(self) -> int:
        """Most tokens one dispatched block can emit per lane: the block
        size plain, rounds * (k+1) speculative."""
        return self.spec_rounds * (self.speculate_k + 1) \
            if self.speculate_k else self.decode_block_size

    def _lookahead_worthwhile(self) -> bool:
        """Dispatch a second block only when some lane is sure to
        outlive the in-flight one on budget (EOS can still cut it short:
        the lookahead then runs frozen, which wastes a block of device
        time but never corrupts state)."""
        return any(self._rem[s] > self._block_capacity
                   for s, r in self._active.items()
                   if r.finish_reason is None)

    def _decode_round(self):
        """Dispatch + process one block (and the overlap lookahead)
        under the recovery contract: an exception out of a dispatch or
        the device-to-host sync discards the in-flight blocks and
        re-uploads the lane state from the host mirrors (decode keys are
        per-lane (salt, position), both mirror-restored, so the retry
        REPLAYS the exact key stream and recovery is bit-invisible),
        then retries with capped exponential backoff. After
        `max_retries` consecutive failures the active requests, which
        cannot make progress while decode is down, fail and the engine
        keeps serving the queue."""
        err = self._run_with_retries(self._decode_once,
                                     on_failure=self._discard_inflight)
        if err is not None:
            self._fail_active(err)

    def _decode_once(self):
        if self._inflight is None and self._has_live_lane():
            self._inflight = self._dispatch_block()
        if (self._inflight is not None and self._ahead is None
                and self.overlap and not self._dirty and not self._queue
                and not self._prefilling
                and self._lookahead_worthwhile()):
            # block N+1 chains off block N's device-resident state; the
            # host sync below then overlaps its device time. The freeze
            # masks make this safe: if every lane finishes in block N,
            # block N+1 just emits nothing.
            self._ahead = self._dispatch_block()
        if self._inflight is not None:
            self._process_block(self._inflight)
            self._inflight, self._ahead = self._ahead, None

    def _discard_inflight(self):
        """Drop dispatched-but-unprocessed blocks and fall back to the
        host mirrors, which are consistent as of the last PROCESSED
        block (mirror writes happen only after a successful sync): the
        next dispatch re-uploads them into the static buffers. Cache
        rows a discarded block wrote past the mirror positions are
        rewritten by the retry before they can become attendable."""
        self._inflight = None
        self._ahead = None
        self._dirty = True

    def _fail_active(self, err: Optional[BaseException]):
        """Graceful degradation after retry exhaustion: fail the
        requests that cannot make progress (the active lanes), keep the
        engine and its queue serving."""
        msg = f"{type(err).__name__}: {err}" if err is not None \
            else "decode failed"
        failed = []
        for slot, req in self._active.items():
            if req.finish_reason is None:
                req.finish_reason = "error"
                req.error = msg
                self._freeze_slot(slot)
                self.metrics.on_failed()
                failed.append(req.rid)
        if failed:
            self._postmortem("decode_retry_exhausted",
                             {"failed_rids": failed, "error": msg})

    def _mirrors(self) -> Dict[str, np.ndarray]:
        out = {"cur": self._cur, "pos": self._pos, "rem": self._rem,
               "act": self._act, "salt": self._salt, "temp": self._temp,
               "topk": self._topk, "topp": self._topp, "eos": self._eos}
        if self.paged:
            # admission changes the tables and always marks the mirrors
            # dirty; a retired lane is frozen, so its stale row only
            # parks writes on the trash page until the next upload
            out["tables"] = self.cache.block_tables
        return out

    def _runner(self, spec: bool) -> BlockRunner:
        """The block program (plain or speculative), built (on a card:
        captured) at its first dispatch."""
        runner = self._runners.get(spec)
        if runner is None:
            common = dict(attend_impl=self.attend_impl, seed=self.seed,
                          max_seq=self.max_seq, page_size=self.page_size)
            if spec:
                body = functools.partial(
                    _spec_decode_block, self.cfg, self._params,
                    self._draft_params, self.cache.k, self.cache.v,
                    rounds=self.spec_rounds, k=self.speculate_k,
                    draft_layers=self.draft_layers, **common)
            else:
                # one step, run decode_block_size times a block
                body = functools.partial(
                    _decode_block, self.cfg, self._params, self.cache.k,
                    self.cache.v, block=1, **common)
            steps = self._block_capacity if spec else self.decode_block_size
            t0 = time.perf_counter()
            runner = BlockRunner(body, self._lanes, steps, spec,
                                 graphed=self._use_graphs)
            self._count_build(self._spec_key if spec else self._decode_key)
            if runner.graph is not None:
                self.metrics.on_graph_capture(time.perf_counter() - t0)
            self._runners[spec] = runner
        return runner

    def _draft_ok(self) -> bool:
        """The `draft_dispatch` contract: a failing draft DEGRADES this
        block to the plain graph (`metrics.spec_fallbacks`), never fails
        a request or a lane and never consumes a retry (the
        `decode_dispatch` point already fired, so retry coverage of
        every decode dispatch is unchanged). The streams are identical
        either way: the accept rule emits only the target's tokens."""
        try:
            faults.fire("draft_dispatch")
        except faults.InjectedFault:
            self.metrics.on_spec_fallback()
            return False
        return True

    def _dispatch_block(self) -> _Inflight:
        if self._dirty:
            self._lanes.upload(self._mirrors())
            self._dirty = False
        faults.fire("decode_dispatch")
        runner = self._runner(bool(self.speculate_k) and self._draft_ok())
        # after a first dispatch's capture, a one-time cost that
        # `metrics.graph_capture_s` books apart from the decode time
        t0 = time.perf_counter()
        return _Inflight(runner.run(), t0, runner.steps, runner.spec)

    def _process_block(self, blk: _Inflight):
        """Distribute one block's tokens to their requests. Waiting for
        the block's outputs on the host is its single sync (counted); a
        speculative block's (proposed, accepted) tally rides the same
        copy. Everything after is host bookkeeping that, with overlap,
        runs while the next block executes on the device."""
        faults.fire("host_sync")
        flat = blk.result.wait()                # host sync (the only one)
        S = self.max_slots
        n = blk.steps * S
        toks = flat[:n].reshape(blk.steps, S)
        emits = flat[n:2 * n].reshape(blk.steps, S).astype(bool)
        if blk.spec:
            nprop, nacc = int(flat[2 * n]), int(flat[2 * n + 1])
            self.metrics.on_spec(nprop, nacc)
            self.tracer.record("spec", args=(nprop, nacc))
        produced = 0
        # per-lane token counts ride the block's ONE decode_block event;
        # the list is built only with tracing on
        lanes = [] if self.tracer.enabled else None
        delivered = []           # streams that advanced (TBT samples)
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
            if emitted:
                delivered.append(req)
            if lanes is not None:
                lanes.append((slot, req.rid, emitted))
            if emitted and req.rid in self._streams:
                # one event per streamed request per block, from the
                # tokens just distributed
                self._emit_stream(req.rid, "tokens",
                                  len(req.generated) - emitted,
                                  req.generated[-emitted:])
        now = time.perf_counter()
        # attribute only the wall time not already charged to the
        # previous block: with overlap, block N+1's dispatch t0 lies
        # before block N's sync completed
        dur = now - max(blk.t0, self._last_proc_t)
        self.metrics.on_decode_step(dur, produced, steps=blk.steps,
                                    lanes=self.max_slots)
        for req in delivered:
            # tokens reach the client at the block's host sync: the gap
            # between two deliveries of one stream is its TBT
            if req.last_emit_t:
                self.metrics.on_tbt(now - req.last_emit_t)
            req.last_emit_t = now
        self._last_proc_t = now
        if lanes is not None:
            self.tracer.record("decode_block", dur=dur, ts=now,
                               args=(blk.steps, produced, tuple(lanes)))
