"""Crash flight recorder: a redacted JSON post-mortem at every
terminal serving failure.

A copy of `paddle_tpu/obs/flight.py` (the report keys and the redaction
rule are the reference's; the port has no slab heal, so its triggers are
retry exhaustion and terminal admission or resume failures).

When the engine gives up on work — dispatch retries exhaust and active
requests fail, or an admission or resume re-ingest fails terminally —
the flight recorder dumps
what a responder needs to reconstruct the crash without attaching a
debugger to a card that has already moved on:

- the tail of the lifecycle event ring (the last `last_n` structured
  events — what every request was doing in the seconds before);
- a full metrics snapshot (counters/gauges at the moment of failure);
- the engine configuration (the `snapshot()["engine"]` dict);
- the trigger (`reason`) and a per-failure `detail` payload naming the
  failed request ids and the exception.

REDACTION is structural, not best-effort: before anything is stored or
written, `redact()` replaces every numpy array and every int sequence
under a token-ish key (`prompt`, `*token*`, `generated`, `ids`) with a
`{"len", "crc32"}` summary. A post-mortem can prove two crashes saw
the same prompt (equal crc) without containing anyone's tokens —
lengths and hashes only, never content. Lifecycle events are safe by
construction (they carry counts, slots and ids, never token values)
but pass through the same serializer.

Reports are kept in a bounded in-memory deque (`reports`) and, when
the recorder has a `dir`, written as
`postmortem_<n>_<reason>.json`. Every dump is also announced to an
armed `testing.faults.FaultPlan` (`faults.note_postmortem`), which is
how the chaos soak asserts A POST-MORTEM EXISTS FOR EVERY INJECTED
TERMINAL FAILURE — the recorder is part of the recovery contract, not
an optional log line.
"""
from __future__ import annotations

import collections
import json
import os
import re
import time
import zlib
from typing import Dict, Optional, Sequence, Tuple

from .trace import serialize_events

__all__ = ["FlightRecorder", "redact"]

_TOKENISH_KEY = re.compile(r"prompt|token|generated|\bids?\b|text",
                           re.IGNORECASE)


def _summary(values) -> Dict[str, int]:
    """`{"len", "crc32"}` of an int sequence — comparable, not
    recoverable."""
    vals = [int(v) for v in values]
    data = ",".join(str(v) for v in vals).encode()
    return {"len": len(vals), "crc32": zlib.crc32(data)}


def _is_int_seq(v) -> bool:
    return (isinstance(v, (list, tuple)) and len(v) > 0
            and all(isinstance(x, (int,)) and not isinstance(x, bool)
                    for x in v))


def redact(obj, key_hint: str = ""):
    """Deep-copy `obj` into JSON-safe form with token content removed:
    numpy arrays ALWAYS summarize (no raw array belongs in a
    post-mortem); int lists/tuples summarize when their dict key looks
    token-ish; everything else recurses. Scalars pass through."""
    import numpy as np
    if isinstance(obj, np.ndarray):
        if obj.ndim == 1 and obj.dtype.kind in "iu":
            return _summary(obj.tolist())
        return {"shape": list(obj.shape), "dtype": str(obj.dtype)}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): redact(v, key_hint=str(k))
                for k, v in obj.items()}
    if _is_int_seq(obj) and _TOKENISH_KEY.search(key_hint):
        return _summary(obj)
    if isinstance(obj, (list, tuple)):
        return [redact(v, key_hint=key_hint) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


class FlightRecorder:
    """Bounded post-mortem sink for one engine.

    `dump()` is called only on recovery/terminal paths (never per
    block), so it may afford a metrics snapshot and a JSON write; with
    `enabled=False` it is a no-op returning None.
    """

    def __init__(self, dir: Optional[str] = None, last_n: int = 256,
                 max_reports: int = 32, enabled: bool = True):
        if last_n < 1:
            raise ValueError(f"last_n must be >= 1, got {last_n}")
        self.dir = dir
        self.last_n = int(last_n)
        self.enabled = bool(enabled)
        self.reports: collections.deque = collections.deque(
            maxlen=int(max_reports))
        self.dumps = 0
        # dump listeners: callables invoked with every report as it is
        # recorded — the event-driven sibling of polling `reports`
        # (which is a bounded deque and can drop under a dump storm).
        # The fleet's health scorer subscribes one per replica engine:
        # a post-mortem IS a health signal (retry exhaustion, slab
        # heal, admission failure), and the listener sees every one.
        # A raising listener is isolated: observability must never
        # take down the recovery path it observes.
        self.listeners: list = []

    def dump(self, reason: str, *, events: Sequence[Tuple] = (),
             metrics: Optional[Dict] = None,
             config: Optional[Dict] = None,
             detail: Optional[Dict] = None) -> Optional[Dict]:
        """Record one post-mortem; returns the report dict (also kept
        in `reports`, written to `dir` when set, and announced to an
        armed FaultPlan)."""
        if not self.enabled:
            return None
        self.dumps += 1
        report = {
            "kind": "paddle_tpu.obs.postmortem",
            "version": 1,
            "seq": self.dumps,
            "reason": str(reason),
            "wall_time": time.time(),
            "detail": redact(detail) if detail is not None else None,
            "events": serialize_events(events),
            "metrics": redact(dict(metrics or {})),
            "config": redact(dict(config or {})),
        }
        if self.dir:
            # the write is best-effort: dump() runs on the engine's
            # failure-CONTAINMENT paths ("an admission failure never
            # takes down neighbors") — a full disk or unwritable dir
            # must cost the on-disk copy, not the engine; the report
            # still lands in `reports` and reaches the armed plan
            try:
                os.makedirs(self.dir, exist_ok=True)
                slug = re.sub(r"[^A-Za-z0-9_.-]", "_", str(reason))[:48]
                path = os.path.join(
                    self.dir, f"postmortem_{self.dumps:04d}_{slug}.json")
                with open(path, "w") as f:
                    json.dump(report, f, indent=1, default=repr)
                report["path"] = path
            except OSError as e:
                report["write_error"] = f"{type(e).__name__}: {e}"
        self.reports.append(report)
        # the chaos contract: an armed FaultPlan collects every
        # post-mortem so tests can assert one exists per injected
        # terminal failure (no-op when nothing is armed)
        from ..testing import faults
        faults.note_postmortem(report)
        for cb in list(self.listeners):
            try:
                cb(report)
            except Exception:  # noqa: BLE001 — observer isolation
                pass
        return report

    def failed_rids(self):
        """Union of request ids named `failed_rids` across retained
        reports — the 'which requests have a post-mortem' view."""
        out = set()
        for r in self.reports:
            d = r.get("detail") or {}
            out.update(int(x) for x in d.get("failed_rids", ()))
        return out
