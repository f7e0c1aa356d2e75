"""Deterministic fault injection: the chaos harness behind the serving
engine's recovery paths.

A copy of `paddle_tpu/testing/faults.py` (the port imports nothing of
the JAX package): the same `POINTS`, the same `FaultPlan` triggers and
the same crc32-keyed `fail_rate` streams, so one plan fires at the same
call numbers in both packages.

Production code declares named INJECTION POINTS by calling
`fire("point")` at the places where real infrastructure fails. With no
plan armed, `fire()` is one module-global read and a branch: the hot
paths pay effectively nothing.

Points fired by the port's `serving.LLMEngine`:

- ``decode_dispatch`` -- `_dispatch_block`, immediately before the
  decode block's graph is replayed (a failed launch);
- ``host_sync``       -- `_process_block`, before the block's
  device-to-host token sync (where asynchronous launch errors surface);
- ``prefill``         -- once per prefill piece during admission,
  before the piece's prefill program runs (on a card, its graph
  replay);
- ``prefix_copy``     -- `_copy_prefix`, before a slotted prefix-cache
  hit's index copy from the prefix pool into the slot;
- ``draft_dispatch``  -- `_dispatch_block` of a speculative engine,
  after ``decode_dispatch`` and before the draft-and-verify graph is
  replayed: firing here DEGRADES that block to the plain graph
  (`metrics.spec_fallbacks`); every request keeps its bit-identical
  stream, and a draft failure never fails a request, never strands a
  lane and never consumes a retry;
- ``page_swap``       -- `_gather_pages` / `_scatter_pages`, before a
  paged engine moves pages to or from host memory (swap, page handoff,
  a tier publish or bind);
- ``tier_fetch``      -- before a paged engine fetches a published
  chunk from the fleet KV tier (`_tier_bind`) or redeems a parcel
  (`_resolve_tier_stub`): firing here degrades to a prefill.

Points fired by `serving.EngineFleet`:

- ``replica_dispatch``  -- before each replica's `step()` (a crash of
  the replica process: it quarantines and its work fails over);
- ``replica_heartbeat`` -- before a replica's liveness beat (a fault
  suppresses the beat: the autoscaler's watchdog preempts the replica);
- ``replica_spawn``     -- in `add_replica`, before the engine is built
  (a failed spawn degrades to the current size);
- ``replica_health``    -- before a canary request is submitted (a
  failed canary re-quarantines with a doubled backoff).

Points fired by the HTTP front door (`serving.server.LLMServer`):

- ``http_write``        -- before each SSE event is written to a
  client: a fault is a write failure, handled as a disconnect (the
  request is cancelled, its slot and prefix pins freed);
- ``client_disconnect`` -- after each stream event is taken off a
  request's relay, before it is handled: a fault is a client that went
  away (the same cancel path).

Point fired by `framework.auto_checkpoint.AutoCheckpoint.save`:

- ``checkpoint_io``     -- at the JAX package's two sites: the step
  directory backend fires before it writes anything; the pickle
  backend fires between the complete `.tmp` write and the atomic
  publish (a fault there is a kill in the torn-write window: the
  previous checkpoint stays the newest, and restore sweeps the `.tmp`).

Triggers are deterministic so a failing run replays exactly:

- schedule-driven: `plan.fail_at("decode_dispatch", 2)` fails the 2nd
  call of that point (1-based, counted per plan);
- seeded Bernoulli: `plan.fail_rate("host_sync", 0.1, seed=7)` draws
  from a per-point PRNG stream (independent of how calls to different
  points interleave), for randomized chaos soaks.

Usage:

    from paddle_tpu_torch.testing import faults
    plan = faults.FaultPlan().fail_at("decode_dispatch", 2)
    with faults.inject(plan):
        engine.generate(prompts, params)   # 2nd dispatch raises
    assert plan.injected["decode_dispatch"] == 1

Faults raise `InjectedFault` (a RuntimeError), a type no real code path
raises, so tests can assert an error's provenance.

The plan is also the chaos harness's POST-MORTEM COLLECTOR: when the
engine builds a post-mortem report on a terminal failure while a plan
is armed, `note_postmortem` appends it to `plan.postmortems`, so a soak
can assert that every injected terminal failure produced a report
naming the failed requests, not just that the engine survived.
"""
from __future__ import annotations

import contextlib
import zlib
from typing import Dict, Optional, Set, Tuple

import numpy as np

__all__ = ["POINTS", "InjectedFault", "FaultPlan", "fire", "inject",
           "active_plan", "note_postmortem"]

# the registry of compiled-in points; fail_at/fail_rate reject unknown
# names so a typo'd plan fails loudly instead of injecting nothing.
# Alphabetical by contract (the registry coverage test asserts it):
# a new point has exactly one place to go, so merges never conflict
# and review diffs stay one-line. Order is never semantic —
# fail_rate's per-point stream is keyed by crc32(name), not index.
POINTS = ("checkpoint_io", "client_disconnect", "decode_dispatch",
          "draft_dispatch", "host_sync", "http_write", "page_swap",
          "prefill", "prefix_copy", "replica_dispatch",
          "replica_health", "replica_heartbeat", "replica_spawn",
          "tier_fetch")


class InjectedFault(RuntimeError):
    """Raised by a fired injection point (and by nothing else)."""

    def __init__(self, point: str, call_no: int):
        super().__init__(f"injected fault: {point!r} call #{call_no}")
        self.point = point
        self.call_no = call_no


class FaultPlan:
    """A deterministic injection schedule over the named points.

    Observability: `calls[point]` counts every `fire()` that reached
    this plan, `injected[point]` counts the faults it raised — tests
    assert both to prove the instrumented path actually ran — and
    `postmortems` collects every post-mortem report built while
    this plan was armed (the chaos acceptance surface: a terminal
    failure with no post-mortem is a bug even if the engine survived).
    """

    def __init__(self):
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self.postmortems: list = []
        self._at: Dict[str, Set[int]] = {}
        self._rate: Dict[str, Tuple[np.random.RandomState, float]] = {}

    @staticmethod
    def _check_point(point: str):
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r} "
                             f"(known: {', '.join(POINTS)})")

    def fail_at(self, point: str, *call_nos: int) -> "FaultPlan":
        """Fail the given 1-based call numbers of `point`."""
        self._check_point(point)
        if not call_nos:
            raise ValueError("fail_at needs at least one call number")
        if any(int(c) < 1 for c in call_nos):
            raise ValueError(f"call numbers are 1-based, got {call_nos}")
        self._at.setdefault(point, set()).update(int(c) for c in call_nos)
        return self

    def fail_rate(self, point: str, rate: float,
                  seed: int = 0) -> "FaultPlan":
        """Fail each call of `point` with probability `rate`, drawn from
        a per-point seeded stream (crc32(point) folded into `seed`), so
        the schedule for one point never shifts when another point's
        call count changes."""
        self._check_point(point)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        point_seed = (int(seed) * 1000003 + zlib.crc32(point.encode())) \
            % (2 ** 31)
        self._rate[point] = (np.random.RandomState(point_seed),
                             float(rate))
        return self

    def on_call(self, point: str):
        """Count one `fire(point)`; raise `InjectedFault` if scheduled."""
        n = self.calls.get(point, 0) + 1
        self.calls[point] = n
        hit = n in self._at.get(point, ())
        if not hit and point in self._rate:
            rng, rate = self._rate[point]
            hit = bool(rng.random_sample() < rate)
        if hit:
            self.injected[point] = self.injected.get(point, 0) + 1
            raise InjectedFault(point, n)


_plan: Optional[FaultPlan] = None


def fire(point: str):
    """The hook production code compiles in. No-op unless a plan is
    armed via `inject(...)`; otherwise counts the call and raises if
    the plan scheduled a fault here."""
    plan = _plan
    if plan is not None:
        plan.on_call(point)


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm `plan` for the duration of the with-block (the previous plan,
    if any, is restored on exit — nesting replaces, not merges)."""
    global _plan
    prev = _plan
    _plan = plan
    try:
        yield plan
    finally:
        _plan = prev


def active_plan() -> Optional[FaultPlan]:
    return _plan


def note_postmortem(report: Dict):
    """Announce a post-mortem report to the armed plan (no-op when none
    is). Called by the engine's `_postmortem`; tests read
    `plan.postmortems` to pair injected terminal failures with the
    reports they must have produced."""
    plan = _plan
    if plan is not None:
        plan.postmortems.append(report)
