"""Request-lifecycle tracing: bounded event ring + Perfetto export.

A copy of `paddle_tpu/obs/trace.py`: the same event kinds, the same
span reconstruction and the same Chrome/Perfetto rendering, so a ring
recorded by the port's engine and one recorded by the JAX engine export
to the same tracks.

The engine answers "where did request 17 spend its 400 ms" with a
structured event stream instead of print statements:

    submitted -> queued -> admitted(slot, prefix_hit, pages_copied)
      -> prefill_chunk* -> decode_block*(block_size, host_sync)
      -> retry / cancel / deadline / heal -> finished(reason)

Design constraints (the same ones the per-block stats follow):

- RECORD IS HOT-PATH SAFE. One event is one tuple appended to a
  bounded `collections.deque` — O(1), no sorting, no quantiles, no
  reservoir draws, no string formatting. Per decode BLOCK the engine
  records exactly one event (carrying per-lane token counts it already
  computed while distributing the block), never per token. A disabled
  tracer (`LLMEngine(trace=False)`) short-circuits to a no-op.
- NO DEVICE CONTACT. Recording reads the host clock and host ints; it
  can never add a host sync (`metrics.host_syncs` is bit-for-bit
  unchanged by tracing).
- BOUNDED. The ring holds the last `capacity` events; a soak run never
  grows host memory. The flight recorder snapshots the tail of the
  same ring for its post-mortems.

Events are plain tuples `(ts, dur, kind, rid, slot, args)` (seconds on
the `time.perf_counter` clock; `dur == 0.0` for instants; `rid`/`slot`
are -1 when not applicable). `request_spans()` reconstructs one span
tree per request from any event list — including a MERGED list from a
pre-snapshot engine and its post-`resume()` successor, whose request
ids never overlap because `snapshot()` carries `next_id` — and
`export_chrome_trace()` renders Chrome/Perfetto trace JSON with one
track per KV slot lane plus queue and engine (retry/heal) tracks.

Events carry `time.perf_counter` stamps, the host clock that
`torch.profiler` traces also use, so a lifecycle trace and a profiler
trace of the same run can be read side by side.
"""
from __future__ import annotations

import collections
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["EVENT_KINDS", "RESERVED_KINDS", "LifecycleTracer",
           "request_spans", "export_chrome_trace"]

# the closed vocabulary of lifecycle event kinds; record() rejects
# unknown kinds so a typo'd instrumentation point fails loudly in tests
# instead of producing spans no exporter draws. "queued" is reserved
# for a front door whose enqueue is a real handoff (the in-process
# engine's submit IS the enqueue, so it records "submitted" only; the
# queue span derives from submitted -> first admission either way).
# "shed"/"disconnect"/"drain"/"reattach" are the HTTP front door's
# kinds (serving/server.py keeps its own ring): a request turned away
# with 429, a client abandoning a live stream, the SIGTERM drain
# starting, and a stream re-binding to an in-flight request by id.
# "prefill_interleave" is an engine-scope COUNTER event, one per
# interleaved-admission round with work (args = (queued, prefilling,
# tokens_this_round)) — the exporter draws it as a queue-depth counter
# track so per-request stalls are visible against admission pressure.
# "handoff" marks a request extracted from this engine for adoption by
# a peer (prefill/decode disaggregation) — no `finished` follows here.
# "spec" is an engine-scope counter event, one per processed
# SPECULATIVE decode block (args = (proposed, accepted)) — the
# acceptance trajectory stays legible per block without per-token
# work; the exporter draws it on the engine track.
# "swap_out"/"swap_in" mark a request's KV pages moved to host RAM and
# back (paged layout; the request parks between them, holding zero
# HBM); "fork" marks a best-of-n parent spawning COW continuations
# (args = (n_siblings,)).
# "tier_bind"/"tier_publish" mark the fleet KV tier's two data moves
# for one request: tier pages scattered into this engine's block table
# at admission instead of re-prefilling (args = (rows, chunks)), and
# this engine publishing a freshly prefilled page-aligned prefix for
# the rest of the fleet (args = (rows, chunks, nbytes)).
# "scale_out"/"scale_in"/"preempt" are FLEET-scope instants (rid -1):
# a replica spawned by the autoscaler, gracefully drained out of the
# fleet, or declared preempted by the heartbeat watchdog — args carry
# (replica_idx, detail). They ride whichever engine tracer the caller
# stamps (the fleet's own event ring mirrors them onto the Perfetto
# fleet track), so a single-engine trace of a scaled serve still shows
# the resize timeline.
EVENT_KINDS = ("swap_out", "swap_in", "fork",
               "submitted", "queued", "admitted", "prefill_chunk",
               "decode_block", "retry", "cancel", "deadline", "heal",
               "finished", "shed", "disconnect", "drain", "reattach",
               "prefill_interleave", "handoff", "spec",
               "scale_out", "scale_in", "preempt",
               "tier_bind", "tier_publish")

# Kinds registered (and drawn) for front doors that do not exist in
# this process model yet: "queued" awaits an out-of-process enqueue
# (see above — the in-process submit IS the enqueue). The EVENT_KINDS
# round-trip test exempts exactly this tuple from the every-kind-has-
# a-production-emitter requirement, so the reservation is code, not
# prose: growing it is a reviewed act, and an entry that gains a real
# emitter must leave it.
RESERVED_KINDS = ("queued",)

_KIND_SET = frozenset(EVENT_KINDS)


class LifecycleTracer:
    """Bounded, allocation-light ring of lifecycle events.

    `record()` is the only write path and is called from the engine's
    scheduler thread (the tracer inherits the engine's not-thread-safe
    contract). `events()` snapshots the ring for export/merge; the
    flight recorder reads `tail(n)`.
    """

    __slots__ = ("enabled", "capacity", "_buf", "dropped")

    def __init__(self, capacity: int = 2048, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        # ring overwrites are silent by design; the counter keeps the
        # truncation auditable (exported into trace metadata)
        self.dropped = 0

    def record(self, kind: str, rid: int = -1, slot: int = -1,
               dur: float = 0.0, args: Tuple = (),
               ts: Optional[float] = None):
        """Append one event; `ts` is the event END time (defaults to
        now) and `dur` reaches back from it. O(1), no device contact."""
        if not self.enabled:
            return
        if kind not in _KIND_SET:
            raise ValueError(f"unknown lifecycle event kind {kind!r} "
                             f"(known: {', '.join(EVENT_KINDS)})")
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append((ts if ts is not None else time.perf_counter(),
                          dur, kind, rid, slot, args))

    def __len__(self) -> int:
        return len(self._buf)

    def events(self) -> List[Tuple]:
        """Snapshot copy of the ring, oldest first."""
        return list(self._buf)

    def tail(self, n: int) -> List[Tuple]:
        """The last `n` events (the flight-recorder view)."""
        if n <= 0:
            return []
        buf = self._buf
        return list(buf)[-n:] if n < len(buf) else list(buf)

    def clear(self):
        self._buf.clear()
        self.dropped = 0

    def export(self, path: Optional[str] = None) -> Dict:
        """Convenience: Chrome/Perfetto trace of this ring alone."""
        return export_chrome_trace(self.events(), path)


def _serializable_args(args) -> list:
    out = []
    for a in args:
        out.append(list(a) if isinstance(a, (tuple, list)) else a)
    return out


def serialize_events(events: Sequence[Tuple]) -> List[list]:
    """JSON-safe form of an event list (tuples -> lists, recursively
    one level — args never nest deeper). Used by the flight recorder."""
    return [[ts, dur, kind, rid, slot, _serializable_args(args)]
            for ts, dur, kind, rid, slot, args in events]


def request_spans(events: Sequence[Tuple]) -> Dict[int, Dict]:
    """Reconstruct one span tree per request id from an event list
    (from one tracer, or several CONCATENATED — e.g. a pre-snapshot
    engine's ring plus its resumed successor's; request ids never
    collide because `snapshot()` carries `next_id` forward).

    Returns `{rid: tree}` where tree is:

        {"rid": int,
         "submitted": ts | None,          # None for post-resume rings
         "queue": (t0, t1) | None,        # submit -> admission start
         "admissions": [{"t0","t1","slot","prompt_len",
                         "pages_copied","prefix_hit","resumed"}],
         "prefill_chunks": [{"t0","t1","slot","tokens","pos0"}],
         "decode_blocks": [{"t0","t1","slot","steps","tokens"}],
         "lifecycle": [(ts, kind)],       # cancel/deadline instants
         "finished": (ts, reason) | None,
         "slots": sorted slot ids the request occupied}

    Engine-scope events (`retry`, `heal`, rid == -1) are not part of
    any request tree; `export_chrome_trace` draws them on the engine
    track.
    """
    reqs: Dict[int, Dict] = {}

    def tree(rid: int) -> Dict:
        t = reqs.get(rid)
        if t is None:
            t = reqs[rid] = {"rid": rid, "submitted": None, "queue": None,
                             "admissions": [], "prefill_chunks": [],
                             "decode_blocks": [], "lifecycle": [],
                             "finished": None, "slots": set()}
        return t

    for ts, dur, kind, rid, slot, args in sorted(
            events, key=lambda e: e[0]):
        if kind in ("retry", "heal", "shed", "drain",
                    "prefill_interleave", "spec",
                    "scale_out", "scale_in", "preempt"):
            continue
        if kind == "decode_block":
            # one event per block; args = (steps, produced, lanes) with
            # lanes = ((slot, rid, tokens), ...) for every live lane
            steps = args[0] if args else 0
            lanes = args[2] if len(args) > 2 else ()
            for lslot, lrid, ltok in lanes:
                t = tree(lrid)
                t["decode_blocks"].append(
                    {"t0": ts - dur, "t1": ts, "slot": lslot,
                     "steps": steps, "tokens": ltok})
                t["slots"].add(lslot)
            continue
        if rid < 0:
            continue
        t = tree(rid)
        if kind == "submitted":
            t["submitted"] = ts
        elif kind == "queued":
            pass  # the queue span closes at the first admission
        elif kind == "admitted":
            # args = (prompt_len, pages_copied, resumed)
            plen = args[0] if args else 0
            pages = args[1] if len(args) > 1 else 0
            resumed = bool(args[2]) if len(args) > 2 else False
            t["admissions"].append(
                {"t0": ts - dur, "t1": ts, "slot": slot,
                 "prompt_len": plen, "pages_copied": pages,
                 "prefix_hit": pages > 0, "resumed": resumed})
            t["slots"].add(slot)
            if t["queue"] is None and t["submitted"] is not None \
                    and not resumed:
                t["queue"] = (t["submitted"], ts - dur)
        elif kind == "prefill_chunk":
            # args = (tokens, pos0)
            t["prefill_chunks"].append(
                {"t0": ts - dur, "t1": ts, "slot": slot,
                 "tokens": args[0] if args else 0,
                 "pos0": args[1] if len(args) > 1 else 0})
            t["slots"].add(slot)
        elif kind in ("cancel", "deadline", "disconnect", "reattach",
                      "handoff", "swap_out", "swap_in", "fork",
                      "tier_bind", "tier_publish"):
            t["lifecycle"].append((ts, kind))
        elif kind == "finished":
            t["finished"] = (ts, args[0] if args else "")
            if slot >= 0:
                t["slots"].add(slot)
    for t in reqs.values():
        t["slots"] = sorted(t["slots"])
    return reqs


# --------------------------------------------------------------------------- #
# Chrome/Perfetto export
# --------------------------------------------------------------------------- #

_QUEUE_TID = 0          # track 0: the bounded request queue
_SLOT_TID0 = 1          # tracks 1..S: one per KV slot lane
# the engine track (retries, heals, block boundaries) sits after the
# last slot track; its tid is computed from the max slot seen


def _us(t: float) -> float:
    return t * 1e6


def export_chrome_trace(events: Sequence[Tuple],
                        path: Optional[str] = None) -> Dict:
    """Render lifecycle events as a Chrome-trace / Perfetto-loadable
    JSON object: one complete span tree per request — queue wait on the
    queue track; admission, each prefill chunk and each decode block on
    the request's KV-slot track — plus retry/heal instants on the
    engine track. Pass the CONCATENATED rings of a snapshotted engine
    and its resumed successor to get coherent merged spans across the
    restart. Writes to `path` when given; returns the trace dict."""
    spans = request_spans(events)
    max_slot = -1
    for t in spans.values():
        if t["slots"]:
            max_slot = max(max_slot, t["slots"][-1])
    for _, _, kind, _, slot, _ in events:
        if slot > max_slot:
            max_slot = slot
    engine_tid = _SLOT_TID0 + max_slot + 1

    out: List[Dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": "paddle_tpu serving"}},
        {"ph": "M", "pid": 1, "tid": _QUEUE_TID, "name": "thread_name",
         "args": {"name": "queue"}},
        {"ph": "M", "pid": 1, "tid": engine_tid, "name": "thread_name",
         "args": {"name": "engine (retry/heal)"}},
    ]
    for s in range(max_slot + 1):
        out.append({"ph": "M", "pid": 1, "tid": _SLOT_TID0 + s,
                    "name": "thread_name",
                    "args": {"name": f"kv slot {s}"}})

    def span(name, tid, t0, t1, args=None):
        ev = {"ph": "X", "pid": 1, "tid": tid, "ts": _us(t0),
              "dur": max(_us(t1 - t0), 0.0), "name": name}
        if args:
            ev["args"] = args
        out.append(ev)

    def instant(name, tid, ts, args=None):
        ev = {"ph": "i", "s": "t", "pid": 1, "tid": tid, "ts": _us(ts),
              "name": name}
        if args:
            ev["args"] = args
        out.append(ev)

    for rid in sorted(spans):
        t = spans[rid]
        if t["queue"] is not None:
            span(f"queued rid={rid}", _QUEUE_TID, *t["queue"])
        for a in t["admissions"]:
            span(f"admit rid={rid}", _SLOT_TID0 + a["slot"],
                 a["t0"], a["t1"],
                 {"rid": rid, "prompt_len": a["prompt_len"],
                  "pages_copied": a["pages_copied"],
                  "prefix_hit": a["prefix_hit"],
                  "resumed": a["resumed"]})
        for c in t["prefill_chunks"]:
            span(f"prefill_chunk rid={rid}", _SLOT_TID0 + c["slot"],
                 c["t0"], c["t1"],
                 {"rid": rid, "tokens": c["tokens"], "pos0": c["pos0"]})
        for b in t["decode_blocks"]:
            # no host_syncs stamp here: one BLOCK = one sync, but a
            # block fans out to one span per live lane — a per-span
            # count would overstate the budget by the lane count
            # (METRICS.prom carries the authoritative counter)
            span(f"decode_block rid={rid}", _SLOT_TID0 + b["slot"],
                 b["t0"], b["t1"],
                 {"rid": rid, "steps": b["steps"],
                  "tokens": b["tokens"]})
        for ts_i, kind in t["lifecycle"]:
            tid = _SLOT_TID0 + t["slots"][-1] if t["slots"] \
                else _QUEUE_TID
            instant(f"{kind} rid={rid}", tid, ts_i)
        if t["finished"] is not None:
            ts_f, reason = t["finished"]
            tid = _SLOT_TID0 + t["slots"][-1] if t["slots"] \
                else _QUEUE_TID
            instant(f"finished rid={rid}", tid, ts_f,
                    {"rid": rid, "reason": reason})

    for ts_e, _, kind, _, _, args in events:
        if kind in ("retry", "heal"):
            instant(kind, engine_tid, ts_e,
                    {"attempt": args[0]} if args else None)
        elif kind in ("shed", "drain",
                      "scale_out", "scale_in", "preempt"):
            # front-door / fleet instants (rid -1): tenant, reason or
            # (replica, detail) ride in args
            instant(kind, engine_tid, ts_e,
                    {"detail": [str(a) for a in args]} if args else None)
        elif kind == "prefill_interleave":
            # queue-depth COUNTER track on the queue tid: queued vs
            # parked-prefilling per interleaved-admission round, the
            # backdrop that makes per-request stalls legible
            out.append({"ph": "C", "pid": 1, "tid": _QUEUE_TID,
                        "ts": _us(ts_e), "name": "admission_depth",
                        "args": {"queued": args[0] if args else 0,
                                 "prefilling": args[1]
                                 if len(args) > 1 else 0}})
        elif kind == "spec":
            # speculative-acceptance COUNTER track on the engine tid:
            # drafted-vs-accepted per block — the acceptance
            # trajectory without per-token events
            out.append({"ph": "C", "pid": 1, "tid": engine_tid,
                        "ts": _us(ts_e), "name": "spec_accept",
                        "args": {"proposed": args[0] if args else 0,
                                 "accepted": args[1]
                                 if len(args) > 1 else 0}})

    trace = {"traceEvents": out, "displayTimeUnit": "ms",
             "otherData": {"source": "paddle_tpu.obs",
                           "requests": len(spans),
                           "events": len(events)}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
