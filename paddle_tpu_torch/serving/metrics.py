"""Serving metrics: TTFT, queue wait, decode time per token, tokens/s,
host syncs and dispatches, the recovery counters, graph captures, the
KV memory gauges, the prefix-cache counters and gauges, the prefilling
gauge and the speculative decoding counters.

A copy of the subset of `paddle_tpu/serving/metrics.py` that the port's
engine feeds. Aggregates are O(1) online (count/total/min/max); TTFT
and queue-wait quantiles come from a bounded reservoir with a
deterministic private RNG, so two identical runs report identical
quantiles and a long run never grows host memory.
"""
from __future__ import annotations

import random
import time
from typing import Dict

__all__ = ["OnlineStat", "ServingMetrics", "nearest_rank_p99"]


def nearest_rank_p99(values) -> float:
    """Nearest-rank p99 over a plain list: the formula
    `OnlineStat.quantile` applies to its reservoir, and the one the
    open-loop serving bench reports its tail quantiles with."""
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(len(s) - 1, max(0, int(0.99 * len(s) + 0.5) - 1))]


class OnlineStat:
    """count/total/min/max/avg in O(1), plus nearest-rank quantiles from
    a bounded uniform reservoir (Vitter's algorithm R; exact until
    `reservoir` samples have been observed)."""

    __slots__ = ("count", "total", "min", "max", "_res", "_cap", "_rng")

    def __init__(self, reservoir: int = 256):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._cap = int(reservoir)
        self._res = []
        self._rng = random.Random(0x5EED)

    def observe(self, value: float):
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if self._cap > 0:
            if len(self._res) < self._cap:
                self._res.append(value)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._res[j] = value

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the reservoir (0 when empty)."""
        if not self._res:
            return 0.0
        s = sorted(self._res)
        idx = min(len(s) - 1, max(0, int(q * len(s) + 0.5) - 1)) \
            if q < 1.0 else len(s) - 1
        return s[idx]

    def as_dict(self, prefix: str,
                quantiles: bool = False) -> Dict[str, float]:
        out = {f"{prefix}_count": self.count,
               f"{prefix}_avg_s": self.avg,
               f"{prefix}_max_s": self.max if self.count else 0.0,
               f"{prefix}_min_s": self.min if self.count else 0.0}
        if quantiles:
            out[f"{prefix}_p50_s"] = self.quantile(0.50)
            out[f"{prefix}_p99_s"] = self.quantile(0.99)
        return out


class ServingMetrics:
    """Counter/gauge surface for one `LLMEngine`.

    Counters: requests submitted/admitted/completed/rejected (rejects
    split `invalid` vs `overload`), cancelled, deadline-expired and
    failed requests, retries and recoveries, prompt and generated
    tokens, decode steps / dispatches / host syncs, CUDA graph
    captures (decode programs, and prefill programs apart). Latency: TTFT (submit → first token on host), queue
    wait (submit → prefill start), per-dispatch decode wall time.
    `tokens_per_sec` is generated tokens over the busy window (first
    submit → last activity); `decode_ms_per_token` is decode wall time
    per in-program decode step — the gap between two tokens of one
    stream.
    """

    def __init__(self, slots_total: int = 0):
        self.slots_total = slots_total
        self.requests_submitted = 0
        self.requests_admitted = 0
        self.requests_completed = 0
        self.requests_rejected = 0
        self.rejected_invalid = 0
        self.rejected_overload = 0
        self.requests_cancelled = 0
        self.deadline_expired = 0
        self.failed_requests = 0     # failed after retry exhaustion
        self.retries = 0             # failed attempts re-run
        self.recoveries = 0          # retry rounds that then succeeded
        # decode block programs captured into CUDA graphs: one per
        # runner (plain, speculative) of an engine on a card, 0 on the
        # CPU; the counterpart of the JAX engine's trace counter. Their
        # wall time (warm-up included) is booked here, not as decode
        # time
        self.graph_captures = 0
        self.graph_capture_s = 0.0
        # prefill programs captured into CUDA graphs: one per prefill
        # row count an engine on a card has used (0 on the CPU), booked
        # apart from the decode programs above and from the prefill
        # time; the pool is the bytes the captures added to the one
        # graph memory pool the engine's prefill graphs share
        self.prefill_graph_captures = 0
        self.prefill_graph_capture_s = 0.0
        self.prefill_graph_pool_bytes = 0
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self.decode_steps = 0        # in-program steps, frozen lanes too
        self.decode_dispatches = 0   # decode blocks run
        self.decode_tokens = 0       # decode-emitted (excl. first token)
        self.host_syncs = 0          # device→host barriers, decode path
        self.kv_cache_bytes = 0      # preallocated slab footprint (gauge)
        # K+V bytes per cache row, all layers (scales included): what
        # the storage dtype buys, a constant per configuration
        self.kv_bytes_per_token = 0.0
        self.kv_dtype = ""
        # the prefix cache: every prompt ingestion splits into rows
        # copied or shared from the cache (prefix_tokens_reused) and
        # rows computed by prefill (prefill_tokens_computed); lookups
        # and hits count ingestions with the cache on
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.prefill_tokens_computed = 0
        self.prefix_pool_bytes = 0        # pool slab footprint (gauge)
        self.prefix_pool_pages_total = 0  # gauges, pushed per step
        self.prefix_pool_pages_used = 0
        self.prefix_evictions = 0
        # decode steps run to rebuild a resumed or adopted continuation's
        # emitted-token rows (`LLMEngine._replay`): they launch the decode
        # kernels like decode steps, and emit nothing
        self.replay_steps = 0
        # paged layout: what admission prices (0 under the slotted one)
        self.kv_pages_total = 0      # pool size in pages
        self.kv_pages_used = 0       # pages held, the trash page included
        self.kv_pages_peak = 0       # high-water mark
        # best-of-n forks: the partial boundary page each sibling of a
        # fork group copies when the prompt is no multiple of the page
        self.pages_cow_copied = 0
        # speculative decoding (all 0 with speculate_k=0): proposed
        # counts every drafted token offered to a verify pass, accepted
        # the ones that matched the target's own draw. Correction and
        # bonus tokens are decode_tokens like any other. spec_fallbacks
        # counts blocks degraded to plain decode by a failing draft (the
        # `draft_dispatch` fault point).
        self.spec_blocks = 0         # speculative blocks processed
        self.spec_proposed = 0       # drafted tokens verified
        self.spec_accepted = 0       # drafted tokens accepted
        self.spec_fallbacks = 0      # blocks degraded to plain decode
        self.ttft = OnlineStat()
        self.queue_wait = OnlineStat()
        self.decode_step_time = OnlineStat(reservoir=0)
        self.prefill_time = OnlineStat(reservoir=0)
        self.queue_depth = 0
        self.slots_active = 0
        # requests parked mid chunked prefill (slot held, first token
        # not sampled yet): the PREFILLING lanes of interleaved
        # admission; their wait still books into queue_wait
        self.prefilling = 0
        self._t_first = 0.0
        self._t_last = 0.0

    # --- recorders (engine-internal) --------------------------------------- #
    def _touch(self):
        now = time.perf_counter()
        if not self._t_first:
            self._t_first = now
        self._t_last = now

    def on_submit(self):
        self.requests_submitted += 1
        self._touch()

    def on_reject(self, reason: str = "overload"):
        if reason not in ("invalid", "overload"):
            raise ValueError(f"unknown reject reason {reason!r}")
        self.requests_rejected += 1
        if reason == "invalid":
            self.rejected_invalid += 1
        else:
            self.rejected_overload += 1

    def on_cancel(self):
        self.requests_cancelled += 1
        self._touch()

    def on_deadline(self):
        self.deadline_expired += 1
        self._touch()

    def on_failed(self):
        self.failed_requests += 1
        self._touch()

    def on_retry(self):
        self.retries += 1

    def on_recovery(self):
        self.recoveries += 1

    def on_graph_capture(self, seconds: float):
        self.graph_captures += 1
        self.graph_capture_s += seconds

    def on_prefill_graph_capture(self, seconds: float, pool_bytes: int):
        self.prefill_graph_captures += 1
        self.prefill_graph_capture_s += seconds
        self.prefill_graph_pool_bytes += pool_bytes

    def on_admit(self, prompt_tokens: int, prefill_s: float,
                 queue_wait_s: float = 0.0):
        self.requests_admitted += 1
        self.prompt_tokens += prompt_tokens
        self.prefill_time.observe(prefill_s)
        self.queue_wait.observe(queue_wait_s)

    def on_first_token(self, ttft_s: float):
        self.ttft.observe(ttft_s)
        self.generated_tokens += 1  # the prefill-sampled token

    def on_decode_step(self, step_s: float, tokens: int, steps: int = 1):
        """One processed decode dispatch of `steps` in-program steps
        producing `tokens`, with its one host sync."""
        self.decode_dispatches += 1
        self.decode_steps += steps
        self.decode_tokens += tokens
        self.host_syncs += 1
        self.generated_tokens += tokens
        self.decode_step_time.observe(step_s)
        self._touch()

    def on_complete(self):
        self.requests_completed += 1
        self._touch()

    def on_cow_copy(self, pages: int = 1):
        self.pages_cow_copied += pages

    def on_spec(self, proposed: int, accepted: int):
        """One processed speculative block: `proposed` drafted tokens
        went through the verify pass, `accepted` matched the target's
        own draws (read with the block's one host sync)."""
        self.spec_blocks += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted

    def on_spec_fallback(self):
        """One block degraded to plain decode (a failing draft): the
        request-facing contract is untouched, only the speedup is lost
        for that block."""
        self.spec_fallbacks += 1

    def on_prefix(self, tokens_reused: int, tokens_computed: int,
                  lookup: bool = True):
        """One prompt ingestion: `tokens_reused` rows came from the
        prefix cache, `tokens_computed` went through prefill. With the
        cache off the computed side is still booked (`lookup=False`),
        so prefill volume compares across configurations."""
        if lookup:
            self.prefix_lookups += 1
            if tokens_reused > 0:
                self.prefix_hits += 1
        self.prefix_tokens_reused += tokens_reused
        self.prefill_tokens_computed += tokens_computed

    def set_prefix_gauges(self, pages_used: int, pages_total: int,
                          evictions: int = 0):
        self.prefix_pool_pages_used = pages_used
        self.prefix_pool_pages_total = pages_total
        self.prefix_evictions = evictions

    def set_gauges(self, queue_depth: int, slots_active: int,
                   prefilling: int = 0):
        self.queue_depth = queue_depth
        self.slots_active = slots_active
        self.prefilling = prefilling

    def set_page_gauges(self, used: int, total: int, peak: int = 0):
        self.kv_pages_used = used
        self.kv_pages_total = total
        self.kv_pages_peak = peak

    # --- read side ---------------------------------------------------------- #
    @property
    def slot_occupancy(self) -> float:
        return self.slots_active / self.slots_total if self.slots_total \
            else 0.0

    @property
    def tokens_per_sec(self) -> float:
        span = self._t_last - self._t_first
        return self.generated_tokens / span if span > 0 else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Ingestions that reused any cached chunk over lookups (a
        request-level rate: read prefix_tokens_reused against
        prefill_tokens_computed for the compute saved)."""
        return self.prefix_hits / self.prefix_lookups \
            if self.prefix_lookups else 0.0

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted over proposed drafted tokens: whether speculation
        pays (the emitted stream never depends on it)."""
        return self.spec_accepted / self.spec_proposed \
            if self.spec_proposed else 0.0

    @property
    def decode_ms_per_token(self) -> float:
        return 1e3 * self.decode_step_time.total / self.decode_steps \
            if self.decode_steps else 0.0

    def snapshot(self) -> Dict[str, float]:
        """Flat numeric dict of every counter, gauge and latency."""
        out = {
            "requests_submitted": self.requests_submitted,
            "requests_admitted": self.requests_admitted,
            "requests_completed": self.requests_completed,
            "requests_rejected": self.requests_rejected,
            "rejected_invalid": self.rejected_invalid,
            "rejected_overload": self.rejected_overload,
            "requests_cancelled": self.requests_cancelled,
            "deadline_expired": self.deadline_expired,
            "failed_requests": self.failed_requests,
            "retries": self.retries,
            "recoveries": self.recoveries,
            "graph_captures": self.graph_captures,
            "graph_capture_s": self.graph_capture_s,
            "prefill_graph_captures": self.prefill_graph_captures,
            "prefill_graph_capture_s": self.prefill_graph_capture_s,
            "prefill_graph_pool_bytes": self.prefill_graph_pool_bytes,
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "decode_steps": self.decode_steps,
            "decode_dispatches": self.decode_dispatches,
            "decode_tokens": self.decode_tokens,
            "replay_steps": self.replay_steps,
            "host_syncs": self.host_syncs,
            "kv_cache_bytes": self.kv_cache_bytes,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "kv_quantized": 1.0 if self.kv_dtype == "int8" else 0.0,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": self.prefix_hit_rate,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefix_pool_bytes": self.prefix_pool_bytes,
            "prefix_pool_pages_total": self.prefix_pool_pages_total,
            "prefix_pool_pages_used": self.prefix_pool_pages_used,
            "prefix_pool_occupancy": (
                self.prefix_pool_pages_used / self.prefix_pool_pages_total
                if self.prefix_pool_pages_total else 0.0),
            "prefix_evictions": self.prefix_evictions,
            "kv_pages_total": self.kv_pages_total,
            "kv_pages_used": self.kv_pages_used,
            "kv_pages_peak": self.kv_pages_peak,
            "pages_cow_copied": self.pages_cow_copied,
            "kv_page_occupancy": (self.kv_pages_used / self.kv_pages_total
                                  if self.kv_pages_total else 0.0),
            "queue_depth": self.queue_depth,
            "slots_active": self.slots_active,
            "prefilling": self.prefilling,
            "slots_total": self.slots_total,
            "slot_occupancy": self.slot_occupancy,
            "tokens_per_sec": self.tokens_per_sec,
            "decode_ms_per_token": self.decode_ms_per_token,
            "spec_blocks": self.spec_blocks,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_fallbacks": self.spec_fallbacks,
            "spec_acceptance_rate": self.spec_acceptance_rate,
        }
        out.update(self.ttft.as_dict("ttft", quantiles=True))
        out.update(self.queue_wait.as_dict("queue_wait", quantiles=True))
        out.update(self.decode_step_time.as_dict("decode_step"))
        out.update(self.prefill_time.as_dict("prefill"))
        return out
