"""Serving metrics: TTFT, queue wait, time between tokens, decode time
per token, tokens/s, host syncs and dispatches, the recovery counters,
graph captures, the KV memory gauges, the prefix-cache counters and
gauges, the prefilling gauge, the host-swap counters and the
speculative decoding counters, and their Prometheus exposition.

The counterpart of `paddle_tpu/serving/metrics.py`. Aggregates are O(1)
online (count/total/min/max); TTFT, queue-wait and TBT quantiles come
from a bounded reservoir with a deterministic private RNG, so two
identical runs report identical quantiles and a long run never grows
host memory. `to_prometheus` renders the reference's families under the
same namespace, so a dashboard carries across, plus the port's own
(graph captures, their seconds, the prefill graph pool, replay steps).
"""
from __future__ import annotations

import random
import time
from typing import Dict, Optional, Sequence

__all__ = ["OnlineStat", "ServingMetrics", "PROM_NAMESPACE",
           "nearest_rank_p99"]

# metric-name prefix of the exposition (the reference's); the provider
# registry (`obs.prometheus.registry_exposition`) uses "paddle_tpu", so
# the two surfaces never collide in one scrape file
PROM_NAMESPACE = "paddle_tpu_serving"


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
    captures (decode programs, and prefill programs apart), host swaps.
    Latency: TTFT (submit → first token on host), queue wait (submit →
    prefill start), time between tokens (one gap per request per
    processed block), per-dispatch decode wall time.
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
        self.lane_steps = 0          # slots x in-program steps, frozen too
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
        # host swap (paged): pages moved device -> host and back, the
        # requests parked and reactivated, and the device-to-host
        # barriers of the swap and page-handoff gathers (apart from the
        # per-block decode host_syncs)
        self.pages_swapped_out = 0
        self.pages_swapped_in = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.swap_host_syncs = 0
        # the fleet KV tier (`kv_tier=`, serving/kv_tier.py): pages
        # bound from the tier, admissions that found none, and the
        # payload bytes bound or published
        self.kv_tier_hits = 0
        self.kv_tier_misses = 0
        self.kv_tier_bytes = 0
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
        # time between tokens of an active stream: one gap per request
        # per processed block, the client-visible stutter TTFT misses
        self.tbt = OnlineStat()
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

    def on_decode_step(self, step_s: float, tokens: int, steps: int = 1,
                       lanes: int = 0):
        """One processed decode dispatch of `steps` in-program steps
        over `lanes` slots (frozen lanes included) producing `tokens`,
        with its one host sync."""
        self.decode_dispatches += 1
        self.decode_steps += steps
        self.decode_tokens += tokens
        self.lane_steps += steps * max(lanes, 0)
        self.host_syncs += 1
        self.generated_tokens += tokens
        self.decode_step_time.observe(step_s)
        self._touch()

    def on_complete(self):
        self.requests_completed += 1
        self._touch()

    def on_cow_copy(self, pages: int = 1):
        self.pages_cow_copied += pages

    def on_tbt(self, gap_s: float):
        """One inter-delivery gap of one active stream (per request per
        processed block, never per token)."""
        self.tbt.observe(gap_s)

    def on_swap_out(self, pages: int):
        """One request parked to host RAM: `pages` gathered with one
        device-to-host barrier."""
        self.swap_outs += 1
        self.pages_swapped_out += pages
        self.swap_host_syncs += 1
        self._touch()

    def on_swap_in(self, pages: int):
        self.swap_ins += 1
        self.pages_swapped_in += pages
        self._touch()

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
    def slot_lane_efficiency(self) -> float:
        """Decode tokens over (slots x in-program steps): how much of the
        fixed decode grid carried live tokens."""
        return self.decode_tokens / self.lane_steps if self.lane_steps \
            else 0.0

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
            "pages_swapped_out": self.pages_swapped_out,
            "pages_swapped_in": self.pages_swapped_in,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swap_host_syncs": self.swap_host_syncs,
            "kv_tier_hits": self.kv_tier_hits,
            "kv_tier_misses": self.kv_tier_misses,
            "kv_tier_bytes": self.kv_tier_bytes,
            "slot_lane_efficiency": self.slot_lane_efficiency,
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
        out.update(self.tbt.as_dict("tbt", quantiles=True))
        out.update(self.decode_step_time.as_dict("decode_step"))
        out.update(self.prefill_time.as_dict("prefill"))
        return out

    def to_prometheus(self, namespace: str = PROM_NAMESPACE,
                      extra_families: Optional[Sequence] = None) -> str:
        """Valid Prometheus text exposition (v0.0.4) of this surface:
        the reference's families, names and types (counters end in
        `_total`, seconds carry `_seconds`, bytes `_bytes`, ratios
        `_ratio`; TTFT, queue wait and TBT as summaries with p50/p99,
        the per-block and per-admission timers sum/count only), then the
        port's own families. `extra_families` appends pre-built
        `obs.prometheus.Family` objects (the engine passes its capture
        watchdog's); `LLMEngine.to_prometheus()` is the one-call
        wrapper. The output round-trips `obs.prometheus.parse_exposition`."""
        from ..obs.prometheus import Family, render_families
        ns = namespace
        fams = []

        def counter(key: str, value: float, help_text: str):
            fams.append(Family(f"{ns}_{key}_total", "counter",
                               help_text).add(value))

        def gauge(key: str, value: float, help_text: str):
            fams.append(Family(f"{ns}_{key}", "gauge",
                               help_text).add(value))

        def summary(key: str, stat: OnlineStat, help_text: str):
            fams.append(Family(f"{ns}_{key}", "summary",
                               help_text).add_summary(stat))

        counter("requests_submitted", self.requests_submitted,
                "requests accepted into the bounded queue")
        counter("requests_admitted", self.requests_admitted,
                "requests granted a KV slot (prefill ran)")
        counter("requests_completed", self.requests_completed,
                "requests finished with stop/length (successes only)")
        rej = Family(f"{ns}_requests_rejected_total", "counter",
                     "admission rejects by reason (invalid = can never "
                     "be served; overload = bounded queue full)")
        rej.add(self.rejected_invalid, {"reason": "invalid"})
        rej.add(self.rejected_overload, {"reason": "overload"})
        fams.append(rej)
        counter("requests_cancelled", self.requests_cancelled,
                "requests ended early by cancel()")
        counter("requests_deadline_expired", self.deadline_expired,
                "requests ended by deadline_s TTL expiry")
        counter("requests_failed", self.failed_requests,
                "requests failed after retry exhaustion "
                "(graceful-degradation counter)")
        counter("retries", self.retries,
                "failed decode/prefill attempts re-run")
        counter("recoveries", self.recoveries,
                "retry rounds that then succeeded")
        counter("prompt_tokens", self.prompt_tokens,
                "prompt tokens ingested")
        counter("generated_tokens", self.generated_tokens,
                "tokens emitted (prefill-sampled + decode)")
        counter("decode_steps", self.decode_steps,
                "in-program decode steps dispatched")
        counter("decode_dispatches", self.decode_dispatches,
                "decode block programs run")
        counter("decode_tokens", self.decode_tokens,
                "decode-emitted tokens (excl. prefill first token)")
        counter("lane_steps", self.lane_steps,
                "slots x in-program steps, frozen lanes included")
        counter("host_syncs", self.host_syncs,
                "device-to-host barriers in the decode path "
                "(one per processed block)")
        counter("prefix_lookups", self.prefix_lookups,
                "prefix-cache lookups (one per prompt ingestion)")
        counter("prefix_hits", self.prefix_hits,
                "ingestions that reused at least one cached chunk")
        counter("prefix_tokens_reused", self.prefix_tokens_reused,
                "prompt tokens copied from the prefix pool")
        counter("prefill_tokens_computed", self.prefill_tokens_computed,
                "prompt tokens that went through real prefill")
        counter("prefix_evictions", self.prefix_evictions,
                "prefix pool pages LRU-evicted under pressure")
        counter("pages_cow_copied", self.pages_cow_copied,
                "fork boundary pages copied on divergence (COW)")
        counter("pages_swapped_out", self.pages_swapped_out,
                "KV pages moved device to host (swap-out)")
        counter("pages_swapped_in", self.pages_swapped_in,
                "KV pages moved host to device (swap-in)")
        counter("swap_outs", self.swap_outs,
                "requests parked to host RAM")
        counter("swap_ins", self.swap_ins,
                "parked requests reactivated on device")
        counter("swap_host_syncs", self.swap_host_syncs,
                "D2H barriers on the swap path (apart from the "
                "per-block decode budget)")
        counter("kv_tier_hits", self.kv_tier_hits,
                "fleet KV tier chunks bound into the block table "
                "instead of re-prefilling")
        counter("kv_tier_misses", self.kv_tier_misses,
                "fleet KV tier probes that fell back to real prefill")
        counter("kv_tier_bytes", self.kv_tier_bytes,
                "payload bytes published to or fetched from the "
                "fleet KV tier")
        counter("spec_blocks", self.spec_blocks,
                "speculative decode blocks processed (draft + "
                "batched verify in one dispatch)")
        counter("spec_tokens_proposed", self.spec_proposed,
                "drafted tokens offered to a verify pass")
        counter("spec_tokens_accepted", self.spec_accepted,
                "drafted tokens that matched the target's own draw")
        counter("spec_fallbacks", self.spec_fallbacks,
                "blocks degraded to plain decode by a failing draft")
        gauge("spec_acceptance_ratio", self.spec_acceptance_rate,
              "accepted / proposed drafted tokens (draft quality; "
              "the emitted stream never depends on it)")
        gauge("kv_pages", self.kv_pages_total,
              "paged KV pool size in pages (0 under slotted layout)")
        gauge("kv_pages_used", self.kv_pages_used,
              "pages currently held (block tables + prefix tree)")
        gauge("kv_pages_peak", self.kv_pages_peak,
              "page high-water mark since engine build")
        gauge("kv_cache_bytes", self.kv_cache_bytes,
              "preallocated KV slab footprint")
        gauge("kv_bytes_per_token", self.kv_bytes_per_token,
              "KV slab bytes per cache row, all layers K+V (scale "
              "rows included for quantized pools)")
        if self.kv_dtype:
            # info-style gauge: the label carries the pool storage
            # dtype, the constant 1 makes it a valid sample
            info = Family(f"{ns}_kv_pool_dtype", "gauge",
                          "KV pool storage dtype (info-style: value "
                          "is always 1, the dtype rides the label)")
            info.add(1, {"dtype": self.kv_dtype})
            fams.append(info)
        gauge("prefix_pool_bytes", self.prefix_pool_bytes,
              "prefix page-pool slab footprint")
        gauge("prefix_pool_pages", self.prefix_pool_pages_total,
              "prefix pool size in pages")
        gauge("prefix_pool_pages_used", self.prefix_pool_pages_used,
              "prefix pool pages currently holding cached chunks")
        gauge("prefix_hit_rate_ratio", self.prefix_hit_rate,
              "request-level hit rate (token counters are the "
              "compute-savings truth)")
        gauge("queue_depth", self.queue_depth,
              "requests waiting for a slot")
        gauge("prefilling", self.prefilling,
              "requests parked mid chunked prefill (slot held, "
              "not yet decoding; their wait books into queue_wait)")
        gauge("slots_active", self.slots_active,
              "KV slots currently serving a request")
        gauge("slots", self.slots_total, "KV slots configured")
        gauge("slot_occupancy_ratio", self.slot_occupancy,
              "slots_active / slots")
        gauge("slot_lane_efficiency_ratio", self.slot_lane_efficiency,
              "decode tokens / (slots x in-program steps)")
        gauge("tokens_per_second", self.tokens_per_sec,
              "generated tokens over the busy window")
        summary("ttft_seconds", self.ttft,
                "submit to first token on host")
        summary("queue_wait_seconds", self.queue_wait,
                "time a request spent waiting before decode entry "
                "(queued + parked mid-prefill, excl. its own prefill "
                "compute; split out from TTFT)")
        summary("tbt_seconds", self.tbt,
                "time between consecutive token deliveries of one "
                "active stream (one sample per request per processed "
                "block)")
        summary("decode_step_seconds", self.decode_step_time,
                "per-processed-block wall time (sum/count only: the "
                "hot path keeps no reservoir)")
        summary("prefill_seconds", self.prefill_time,
                "per-admission prefill wall time (sum/count only)")
        # the port's own families: CUDA graph captures of the decode
        # and prefill programs, their wall time, the prefill graph pool
        # and the teacher-forced replay steps of continuations
        counter("graph_captures", self.graph_captures,
                "decode block programs captured into CUDA graphs")
        counter("graph_capture_seconds", self.graph_capture_s,
                "wall time of the decode graph captures (warm-up "
                "included), booked apart from decode time")
        counter("prefill_graph_captures", self.prefill_graph_captures,
                "prefill programs captured into CUDA graphs (one per "
                "row count used)")
        counter("prefill_graph_capture_seconds",
                self.prefill_graph_capture_s,
                "wall time of the prefill graph captures")
        gauge("prefill_graph_pool_bytes", self.prefill_graph_pool_bytes,
              "bytes the prefill captures added to their graph pool")
        counter("replay_steps", self.replay_steps,
                "teacher-forced decode steps rebuilding a resumed or "
                "adopted continuation's rows")
        if extra_families:
            fams.extend(extra_families)
        return render_families(fams)
