"""`paddle_tpu_torch.obs`: the serving observability layer, the
counterpart of `paddle_tpu/obs`.

Four pieces, all host-side (nothing here touches the device, launches
a kernel or takes a host sync, so `metrics.host_syncs` is the same with
any of it on):

- `trace`: a bounded ring of structured request-lifecycle events
  (`LifecycleTracer`) recorded inside `serving.LLMEngine`, per-request
  span reconstruction (`request_spans`) and a Chrome/Perfetto
  `trace.json` exporter (`export_chrome_trace`) with one track per KV
  slot lane beside the queue and engine tracks. A record is one tuple
  appended to a deque, one per decode BLOCK, never per token;
  `LLMEngine(trace=False)` makes it a no-op.
- `prometheus`: text exposition (`render_families`,
  `registry_exposition`) behind `engine.to_prometheus()`, and the
  strict parser (`parse_exposition`) the artifact is checked with.
- `watchdog`: `CompileWatchdog`, one build per engine program (on a
  card, one CUDA graph capture) and one nvcc build per kernel source,
  checked against the configuration's budget at read time.
- `flight`: `FlightRecorder`, a redacted JSON post-mortem at every
  terminal failure (retry exhaustion, a failed admission or resume),
  announced to an armed `testing.faults.FaultPlan`.
"""
from __future__ import annotations

from typing import Dict

from .flight import FlightRecorder, redact
from .prometheus import (ExpositionError, Family, parse_exposition,
                         registry_exposition, render_families,
                         sanitize_label_value, sanitize_metric_name)
from .trace import (EVENT_KINDS, RESERVED_KINDS, LifecycleTracer,
                    export_chrome_trace, request_spans, serialize_events)
from .watchdog import CompileWatchdog

__all__ = ["LifecycleTracer", "EVENT_KINDS", "RESERVED_KINDS",
           "request_spans", "serialize_events", "export_chrome_trace",
           "CompileWatchdog", "FlightRecorder", "redact", "Family",
           "render_families", "registry_exposition", "parse_exposition",
           "sanitize_metric_name", "sanitize_label_value",
           "ExpositionError", "digest"]


def digest(snap: Dict[str, float]) -> str:
    """One-line human digest of an engine's flat snapshot
    (`metrics.snapshot()`, optionally merged with
    `watchdog.snapshot()`); tolerates missing keys."""
    g = lambda k: snap.get(k, 0)  # noqa: E731 — tiny local accessor
    parts = [
        f"reqs {g('requests_completed'):.0f}/"
        f"{g('requests_submitted'):.0f} done"
        f" ({g('failed_requests'):.0f} failed)",
        f"{g('tokens_per_sec'):.0f} tok/s",
        f"q={g('queue_depth'):.0f} "
        f"slots {g('slots_active'):.0f}/{g('slots_total'):.0f}",
        f"syncs {g('host_syncs'):.0f}",
        f"ttft p50/p99 {g('ttft_p50_s') * 1e3:.1f}/"
        f"{g('ttft_p99_s') * 1e3:.1f}ms",
        f"prefix {g('prefix_hits'):.0f}/{g('prefix_lookups'):.0f} hits",
        f"retries {g('retries'):.0f}",
    ]
    if g("kv_bytes_per_token"):
        parts.append(
            f"kv {g('kv_bytes_per_token'):.0f} B/tok"
            + (" [int8]" if g("kv_quantized") else ""))
    if g("spec_blocks"):
        parts.append(
            f"spec {g('spec_accepted'):.0f}/{g('spec_proposed'):.0f} "
            f"accepted ({g('spec_acceptance_rate') * 100:.0f}%, "
            f"{g('spec_fallbacks'):.0f} fallbacks)")
    if "compiles_total" in snap:
        parts.append(f"compiles {g('compiles_total'):.0f}"
                     f" ({g('compiles_unexpected'):.0f} unexpected)")
    return " | ".join(parts)
