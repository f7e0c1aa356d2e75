"""Replica fleet serving: N `LLMEngine` replicas behind a health-scored
router with drain-and-re-admit failover.

The port of `paddle_tpu/serving/fleet.py` onto the port's engine. One
engine is a single point of failure and one process's blast radius;
`EngineFleet` supervises several replicas, built from contracts the
engine already keeps (`adopt` / `extract` / `unqueue`, `snapshot`,
`salt_clock`, `flight.listeners`, the capture watchdog):

- ROLES (`roles=`): prefill/decode disaggregation. Fresh requests route
  to prefill-capable replicas; once a request on a "prefill" replica
  emits its first token the fleet hands it to a decode-capable peer
  (`extract()` -> `adopt()`; paged, its pages travel, through the KV
  tier when one is attached). Role preferences spill rather than
  block, and a handoff with no decode capacity stays where it is.
- ROUTING: `submit()` assigns a FLEET-GLOBAL id and routes the request:
  least outstanding work (paged replicas priced in pages,
  `LLMEngine.page_load()`), or `routing="prefix_affinity"`, which
  prefers the replica whose prefix tree holds the longest cached
  prefix of the prompt while its backlog stays within `affinity_slack`
  of the least-loaded peer, and spills to the least-loaded otherwise.
  A prompt whose first page is published in the KV tier neutralizes
  affinity: every replica binds it equally well.
- HEALTH: each replica carries a `ReplicaHealth` machine (HEALTHY ->
  SUSPECT -> QUARANTINED -> RECOVERING -> HEALTHY) fed by signals the
  engine already emits: every flight-recorder post-mortem (through a
  `FlightRecorder` listener), growth of the watchdog's
  `compiles_unexpected`, and runs of steps that expire deadlines. At
  `quarantine_after` consecutive signals the replica is drained and
  routed around with a capped exponential backoff; when it elapses ONE
  canary request probes a fresh engine, and only a completed canary
  re-admits traffic. An exception out of a replica's `step()` (the
  `replica_dispatch` fault point) quarantines it directly.
- FAILOVER: a quarantined replica's `snapshot()` (after a `kill()`, its
  last PERIODIC snapshot, taken every `snapshot_every` rounds) is split
  per request and re-admitted into healthy peers through `adopt()`;
  requests submitted after that snapshot restart from the fleet's own
  record. What no peer can hold waits in the fleet's pending queue, so
  no request is ever stranded.
- ELASTICITY: `add_replica()` spawns a replica that enters through the
  canary gate (a `replica_spawn` fault degrades to the current size);
  `retire_replica()` drains one gracefully (`unqueue` / `extract` with
  `keep_salt`, so sampled streams continue bitwise); replica ids are
  stable across resizes. Every live replica beats once per round (the
  `replica_heartbeat` fault point suppresses it), which an attached
  `serving.autoscale.FleetAutoscaler` turns into preemption-replaces.

Bit identity: greedy streams, adopted continuations included, equal
one undisturbed engine's (the port's continuation re-ingests the prompt
through the prefill and replays the emitted tokens through decode
steps, or uploads the pages, so its rows are decode's bits). Sampled
streams are bitwise per replica; an adopted sampled continuation
re-draws with the peer's salts unless the move keeps the salt (drain).

CUDA graphs belong to each engine: a replica built at start, at
failover or at scale-out captures its own decode and prefill graphs
(the JAX package instead caches its compiled programs on the shared
model). Each engine's watchdog budgets its own captures, so they are
expected (`compiles_unexpected` stays 0), and the canary (a 4-token
prompt) warms a new replica before it takes traffic. There is no
graph cache across engines.

Observability: a stats provider (`stats()`), `to_prometheus()` with
per-replica-labelled engine families and fleet counters (strict-parser
clean), the fleet's own `FlightRecorder` (a failover dumps a post-mortem
naming every re-admitted and re-submitted rid), and `export_trace()`
with one Perfetto process per replica plus a fleet track.

TP groups (`tp=k` in the engine kwargs): a replica is a TP group of k
ranks (`paddle_tpu/serving/fleet.py:604-621`). Replica i serves on the
logical ranks `[i*k, (i+1)*k)` (`_build_engine`), every group on the
fleet's one device; the health machine, the router, the failover and
the autoscaler see one engine per group, so a kill takes out the whole
group and its requests drain onto the surviving groups through the
group-agnostic adoption payloads.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..obs import FlightRecorder
from ..testing import faults
from .engine import (EngineOverloadError, GenerationResult, LLMEngine,
                     SamplingParams)
from .kv_tier import KVTier
from .sharded_kv import make_tp_mesh

__all__ = ["REPLICA_STATES", "ReplicaHealth", "EngineFleet"]

# the closed vocabulary of replica states; transitions are recorded so
# tests (and post-mortems) can assert the exact path a replica took.
# DRAINING is scale-in's terminal approach: routed around like
# quarantine but still stepping, while the fleet moves its work to
# peers — the slot is removed (never re-admitted) once empty.
REPLICA_STATES = ("healthy", "suspect", "quarantined", "recovering",
                  "draining", "dead")

_FLEET_IDS = itertools.count()

# The fleet-ring kinds that are ALSO registered lifecycle EVENT_KINDS
# (obs/trace.py documents them as fleet-scope instants, rid -1):
# `_fleet_event` mirrors exactly these onto a live replica's engine
# tracer so the resize timeline survives into single-engine traces and
# flight recordings. The rest of the fleet vocabulary (quarantine/
# kill/canary/...) is deliberately ring-only. The EVENT_KINDS
# round-trip test unions this tuple with the literal record() sites
# when it checks every kind has an emitter — keep it a literal tuple
# (record() below passes `kind` as a variable, invisible to AST scans).
_TRACE_MIRROR_KINDS = ("scale_out", "scale_in", "preempt")


class ReplicaHealth:
    """Per-replica health state machine.

    HEALTHY serves traffic. SUSPECT still serves but is one failure
    streak from quarantine (a clean productive step clears it).
    QUARANTINED serves nothing and waits out a capped exponential
    backoff. RECOVERING is the half-open state: exactly one canary
    request is in flight, and its outcome decides HEALTHY (backoff
    level decays) vs re-QUARANTINED (level doubles). DEAD is a killed
    process — only `revive()` leaves it, and a revived replica still
    has to pass the canary before re-admitting traffic.

    Pure host state with an injectable clock (`now` parameters), so the
    machine is unit-testable without sleeping.
    """

    def __init__(self, quarantine_after: int = 2,
                 backoff_s: float = 0.25, backoff_max_s: float = 8.0):
        if quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")
        if backoff_s < 0 or backoff_max_s < 0:
            raise ValueError("backoffs must be >= 0")
        self.quarantine_after = int(quarantine_after)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.state = "healthy"
        self.fail_streak = 0        # consecutive failure signals
        self.level = 0              # backoff exponent
        self.quarantined_t = 0.0    # when the current quarantine began
        self.probe_asap = False     # revive(): canary without backoff
        self.signals: Dict[str, int] = {}   # lifetime signal counts
        self.transitions: collections.deque = collections.deque(
            maxlen=64)              # (ts, from, to, why) — bounded

    def _goto(self, state: str, now: float, why: str):
        if state == self.state:
            return
        self.transitions.append((now, self.state, state, why))
        self.state = state

    @property
    def accepts_traffic(self) -> bool:
        """May the router send client requests here? HEALTHY and
        SUSPECT do (suspect is a watch state, not a drain); the
        half-open RECOVERING replica carries ONLY its canary."""
        return self.state in ("healthy", "suspect")

    def backoff(self) -> float:
        """Current quarantine duration (capped exponential)."""
        return min(self.backoff_s * (2.0 ** self.level),
                   self.backoff_max_s)

    # ---- signal side ------------------------------------------------- #
    def note_failure(self, kind: str, now: float) -> bool:
        """One failure signal (a post-mortem reason, an unexpected
        compile, a deadline-miss streak). Returns True when the signal
        tipped the replica into QUARANTINED — the caller then drains
        it."""
        self.signals[kind] = self.signals.get(kind, 0) + 1
        if self.state in ("quarantined", "recovering", "dead",
                          "draining"):
            # draining is terminal-approach: signals are counted but
            # never transition it — a crash out of step() mid-drain is
            # handled by the fleet (failover + slot removal), not here
            return False
        self.fail_streak += 1
        if self.fail_streak >= self.quarantine_after:
            self.quarantine(now, why=kind)
            return True
        self._goto("suspect", now, kind)
        return False

    def note_success(self, now: float):
        """A clean productive step: the streak resets and SUSPECT
        clears (quarantine exit goes through the canary, never through
        here)."""
        self.fail_streak = 0
        if self.state == "suspect":
            self._goto("healthy", now, "clean_step")

    def quarantine(self, now: float, why: str = "hard_failure"):
        """Direct to QUARANTINED — hard failures (an exception out of
        the replica's step, a `replica_dispatch` injection) skip
        SUSPECT entirely."""
        self.fail_streak = 0
        self.quarantined_t = now
        self.probe_asap = False
        self._goto("quarantined", now, why)

    # ---- recovery side ----------------------------------------------- #
    def ready_for_probe(self, now: float) -> bool:
        return self.state == "quarantined" and (
            self.probe_asap or now - self.quarantined_t >= self.backoff())

    def begin_probe(self, now: float):
        if self.state != "quarantined":
            raise RuntimeError(f"canary from state {self.state!r}")
        self.probe_asap = False
        self._goto("recovering", now, "canary")

    def probe_result(self, ok: bool, now: float):
        """Half-open outcome: success re-admits (and decays the backoff
        level), failure re-quarantines with doubled backoff."""
        if self.state != "recovering":
            return
        if ok:
            self.level = max(0, self.level - 1)
            self.fail_streak = 0
            self._goto("healthy", now, "canary_ok")
        else:
            self.level += 1
            self.quarantined_t = now
            self._goto("quarantined", now, "canary_failed")

    def kill(self, now: float):
        self._goto("dead", now, "killed")

    # ---- elasticity side --------------------------------------------- #
    def await_canary(self, now: float, why: str = "spawned"):
        """A brand-new engine (scale-out spawn) enters through the
        canary gate: QUARANTINED with the probe due immediately, so the
        replica captures its programs on the canary and only
        a completed probe admits client traffic — a cold replica never
        pays its first dispatch on a real request's TTFT."""
        if self.state == "dead":
            raise RuntimeError("await_canary on a dead replica")
        self.fail_streak = 0
        self.quarantined_t = now
        self.probe_asap = True
        self._goto("quarantined", now, why)

    def begin_drain(self, now: float, why: str = "scale_in"):
        """Enter DRAINING (scale-in): stops accepting routes; the fleet
        keeps stepping the replica while it moves the work out, then
        removes the slot. One-way — a draining replica never
        re-admits."""
        if self.state == "dead":
            raise RuntimeError("begin_drain on a dead replica")
        self.fail_streak = 0
        self.probe_asap = False
        self._goto("draining", now, why)

    def revive(self, now: float):
        """A restarted process: quarantined with the canary due
        immediately — re-admission still requires the probe."""
        if self.state != "dead":
            raise RuntimeError(f"revive from state {self.state!r}")
        self.fail_streak = 0
        self.quarantined_t = now
        self.probe_asap = True
        self._goto("quarantined", now, "revived")


class _Tracked:
    """The fleet's own durable record of one client request — what
    failover falls back on when a replica dies in its snapshot gap."""

    __slots__ = ("rid", "prompt", "params", "submit_t", "replica",
                 "readmitted", "resubmitted", "fork_rids")

    def __init__(self, rid: int, prompt: np.ndarray,
                 params: SamplingParams, submit_t: float):
        self.rid = rid
        self.prompt = prompt
        self.params = params
        self.submit_t = submit_t    # fleet-submit time: the TTL clock
        self.replica = -1           # current owner (-1 = fleet pending)
        self.readmitted = 0         # failovers that preserved tokens
        self.resubmitted = 0        # failovers that restarted it
        # best-of-n: the group rids this parent heads (fleet-global,
        # assigned at submit). The whole group CO-LOCATES on one
        # replica — the engine's COW fork machinery does the sharing,
        # and same-engine salting keeps the sampled streams distinct
        # (split across replicas, identical-context continuations
        # could collide on (seed, salt) and collapse). After a
        # failover the group degrades to independent per-rid requests
        # (the fleet's per-kid _Tracked records cover every member).
        self.fork_rids: Optional[List[int]] = None


class _Replica:
    """One engine plus its health machine and signal watermarks."""

    __slots__ = ("idx", "engine", "health", "role", "last_snapshot",
                 "snapshot_round", "outstanding", "probe_rid",
                 "last_beat", "archived_events", "_signal_reports",
                 "_wd_mark", "_deadline_mark", "_deadline_streak",
                 "_tokens_mark")

    def __init__(self, idx: int, engine: Optional[LLMEngine],
                 health: ReplicaHealth, role: str = "mixed"):
        # STABLE id: survives resize (slots are removed from the list,
        # ids never reuse) — every fleet record that names a replica
        # stores this, and `EngineFleet._by_idx` is the only lookup
        self.idx = idx
        self.engine = engine
        self.health = health
        self.role = role    # "prefill" | "decode" | "mixed"
        self.last_snapshot: Optional[Dict] = None
        self.snapshot_round = 0
        # fleet rids currently owned by this replica (client requests
        # only — the canary rides in `probe_rid`)
        self.outstanding: set = set()
        self.probe_rid: Optional[int] = None
        # liveness beat (the serving-side elastic.Heartbeat analog):
        # refreshed every fleet step the replica participates in; the
        # autoscaler's watchdog reads staleness off it
        self.last_beat = time.perf_counter()
        # lifecycle rings of engines this replica already retired
        # (quarantine drains build a fresh engine) — export_trace
        # stitches them with the live ring. BOUNDED: a flapping
        # replica retires engines indefinitely, and an unbounded
        # archive would leak a full ring per failover
        self.archived_events: collections.deque = collections.deque(
            maxlen=4096)
        self._signal_reports: List[str] = []   # listener inbox
        self._wd_mark = 0
        self._deadline_mark = 0
        self._deadline_streak = 0
        self._tokens_mark = 0


class EngineFleet:
    """N `LLMEngine` replicas behind a health-scored router.

    >>> fleet = EngineFleet(model, replicas=3, max_slots=4)
    >>> results = fleet.generate(prompts, params)

    or the incremental surface mirroring `LLMEngine`: `submit()` /
    `step()` / `has_work()` / `result(rid)`. `kill(i)` / `revive(i)`
    are the chaos/ops controls (simulated process death and restart);
    `quarantine(i)` force-drains a replica (the ops "cordon" verb).

    `engine_kwargs` pass through to every replica's `LLMEngine`
    (`max_slots`, `max_seq`, `decode_block_size`, ...). Replicas are
    homogeneous by construction — failover re-ingest requires it
    (bit-identity of a continuation needs the same `max_seq`/`seed`
    geometry on the peer). With `tp=k` each replica is a TP group of k
    ranks (`_build_engine`).

    `snapshot_every` trades failover freshness against host work: a
    snapshot reads the engine's host state and leaves its dispatched
    blocks running (the JAX engine discards them, one extra block
    dispatch per snapshot). The default is 4; the demos use 2 because
    they kill replicas on purpose and want small snapshot gaps.
    """

    def __init__(self, model, replicas: int = 2,
                 routing: str = "least_loaded",
                 roles: Optional[Sequence[str]] = None,
                 affinity_slack: Optional[int] = None,
                 snapshot_every: int = 4,
                 quarantine_after: int = 2,
                 quarantine_backoff_s: float = 0.25,
                 quarantine_backoff_max_s: float = 8.0,
                 deadline_miss_streak: int = 3,
                 max_pending: int = 256,
                 name: Optional[str] = None,
                 register_stats: bool = True,
                 flight_dir: Optional[str] = None,
                 kv_tier=None,
                 **engine_kwargs):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if routing not in ("least_loaded", "prefix_affinity"):
            raise ValueError(f"routing must be 'least_loaded' or "
                             f"'prefix_affinity', got {routing!r}")
        if snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        if deadline_miss_streak < 1:
            raise ValueError("deadline_miss_streak must be >= 1")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        # prefill/decode DISAGGREGATION: roles[i] pins replica i to one
        # side of the split ("mixed" = both, the default everywhere).
        # Fresh requests route to prefill-capable replicas; once a
        # request on a "prefill" replica emits its first token (KV
        # built, TTFT done) the fleet HANDS IT OFF to a decode-capable
        # replica via LLMEngine.extract() -> adopt() — the decode side
        # re-ingests context (re-prefill today; a device page transfer
        # lands with the paged allocator), so long-prompt prefill load
        # and latency-critical decode stop competing for the same
        # replica's scheduler rounds. Role preferences SPILL rather
        # than block: when no role-matching replica can take a request
        # it goes to any serving replica (counted in
        # routed_role_spill), and a handoff with no decode capacity
        # simply stays where it is — disaggregation is an optimization,
        # never a correctness gate.
        if roles is not None:
            roles = tuple(str(x) for x in roles)
            if len(roles) != int(replicas):
                raise ValueError(f"roles must name every replica: got "
                                 f"{len(roles)} roles for "
                                 f"{replicas} replicas")
            bad = [x for x in roles
                   if x not in ("prefill", "decode", "mixed")]
            if bad:
                raise ValueError(f"unknown role(s) {bad}; valid: "
                                 f"'prefill', 'decode', 'mixed'")
            if not any(x in ("decode", "mixed") for x in roles):
                raise ValueError("at least one replica must be "
                                 "decode-capable ('decode' or 'mixed')")
        self.roles = roles
        self.model = model
        self.routing = routing
        self.snapshot_every = int(snapshot_every)
        self.deadline_miss_streak = int(deadline_miss_streak)
        self.max_pending = int(max_pending)
        self._quarantine_after = int(quarantine_after)
        self._backoff_s = float(quarantine_backoff_s)
        self._backoff_max_s = float(quarantine_backoff_max_s)
        self._register_stats = bool(register_stats)
        self._engine_kwargs = dict(engine_kwargs)
        # monotonic default name, like the engine's (provider slots are
        # keyed by name — two anonymous fleets must never collide)
        self.name = name or f"engine_fleet_{next(_FLEET_IDS)}"
        self._replicas: List[_Replica] = []
        # stable-id source for resize: ids only ever grow; a retired
        # or removed slot's id is never reused, so `_Tracked.replica`
        # stays unambiguous across any add/retire interleaving
        self._next_ridx = int(replicas)
        self._autoscaler = None
        # fleet-global KV tier (serving/kv_tier.py): one shared host store
        # every replica publishes page-aligned prefix chunks into and
        # binds them back from, so a popular prompt prefills once per
        # FLEET. `kv_tier=True` builds one sized to the engines' page
        # geometry; pass a KVTier instance to share a store (or a
        # spill_dir) across fleets. _build_engine attaches it, which
        # also covers autoscale spawns and post-failover rebuilds.
        self._kv_tier = kv_tier if isinstance(kv_tier, KVTier) else None
        self._kv_tier_auto = kv_tier is True
        for i in range(int(replicas)):
            r = _Replica(i, None, self._new_health(),
                         role=roles[i] if roles else "mixed")
            self._replicas.append(r)  # before _build_engine: the
            # flight-listener subscription looks the replica up
            r.engine = self._build_engine(i)
        eng0 = self._replicas[0].engine
        if self._kv_tier_auto and self._kv_tier is None and eng0.paged:
            # sized after the replicas exist: the tier must match the
            # engines' page geometry (attach_kv_tier enforces it)
            self._kv_tier = KVTier(page_size=eng0.page_size)
        if self._kv_tier is not None:
            for r in self._replicas:
                r.engine.attach_kv_tier(self._kv_tier)
        self.max_seq = eng0.max_seq
        self.max_slots = eng0.max_slots
        # the half-open canary must fit the fleet's geometry: prompt +
        # new tokens <= max_seq, or every probe would fail at submit
        # and a quarantined replica could never re-admit
        n = max(1, min(4, self.max_seq - 1))
        self._probe_prompt = np.arange(1, n + 1, dtype=np.int32)
        self._probe_new = max(1, min(2, self.max_seq - n))
        # affinity may overload its pick by at most one engine-batch of
        # outstanding work before spilling to the least-loaded peer
        self.affinity_slack = int(affinity_slack) \
            if affinity_slack is not None else self.max_slots
        if self.affinity_slack < 0:
            raise ValueError("affinity_slack must be >= 0")
        self._next_rid = 0
        self._tracked: Dict[int, _Tracked] = {}
        # ("fresh", rid) | ("adopt", rid, reqdict): requests no replica
        # can hold right now — flushed every step as capacity returns
        self._pending: collections.deque = collections.deque()
        self._results: Dict[int, GenerationResult] = {}
        # rid -> sink: fleet-level stream registry (the HTTP front
        # door's feed). The fleet re-attaches the sink to whichever
        # replica owns the request — across failovers too, where the
        # peer's replay-from-zero plus the caller's start-index dedup
        # keeps the client's cumulative stream gapless.
        self._streams: Dict[int, object] = {}
        self._round = 0
        self._closed = False
        # fleet lifecycle ring: (ts, kind, replica, detail) — the
        # Perfetto fleet track and the post-mortem context
        self._events: collections.deque = collections.deque(maxlen=1024)
        self.flight = FlightRecorder(dir=flight_dir)
        # counters (the stats()/to_prometheus() surface)
        self.failovers = 0
        self.kills = 0
        self.revives = 0
        self.quarantines = 0
        self.canary_probes = 0
        self.canary_ok = 0
        self.canary_failed = 0
        self.requests_readmitted = 0    # token-preserving re-admissions
        self.requests_resubmitted = 0   # snapshot-gap full restarts
        self.routed_affinity = 0        # prefix-affinity picks taken
        self.routed_spill = 0           # affinity overridden by load
        self.handoffs = 0               # prefill→decode extractions
        self.handoff_pages_moved = 0    # KV pages carried by handoffs
        #   (device-page transfer, paged layout; 0 = re-prefill path)
        self.routed_role_spill = 0      # role preference unsatisfiable,
        #   request placed on an off-role replica instead of pending
        self.replicas_added = 0         # scale-out spawns completed
        self.replicas_retired = 0       # scale-in drains completed
        self.scale_failures = 0         # spawns that failed (size kept)
        self.requests_drained = 0       # scale-in keep-salt moves
        self.routed_tier = 0            # affinity neutralized by a
        #   tier prefix hit (any replica binds it; least-loaded wins)
        self.tier_handoffs = 0          # handoff/drain payloads staged
        #   through the KV tier instead of riding the adoption dict
        self._finalizer = None
        if self._register_stats:
            import weakref

            from .. import profiler
            # weakly bound, like the engine's provider: the registry
            # must never keep a dropped fleet alive (the finalizer
            # unregisters at gc for fleets dropped without close())
            ref = weakref.ref(self)

            def _provider(ref=ref):
                fleet = ref()
                return fleet.stats() if fleet is not None else {}

            profiler.register_stats_provider(self.name, _provider)
            self._finalizer = weakref.finalize(
                self, profiler.unregister_stats_provider, self.name)

    # ------------------------------------------------------------------ #
    # construction / lifecycle
    # ------------------------------------------------------------------ #
    def _new_health(self) -> ReplicaHealth:
        return ReplicaHealth(quarantine_after=self._quarantine_after,
                             backoff_s=self._backoff_s,
                             backoff_max_s=self._backoff_max_s)

    def _by_idx(self, idx: int) -> Optional[_Replica]:
        """Stable-id lookup — the ONLY way a replica id resolves to a
        slot. After a resize the list index and the id diverge, so
        positional indexing would silently hit the wrong replica;
        None means the id was retired/removed (callers treat that as
        'no longer owned here')."""
        for r in self._replicas:
            if r.idx == idx:
                return r
        return None

    def _build_engine(self, idx: int) -> LLMEngine:
        """A fresh replica engine over the shared model. It captures its
        own CUDA graphs at its first decode block and prefill (on the
        canary, for a spawned or revived replica), budgeted by its own
        watchdog. With `tp=k` (and no `mesh`) in the engine kwargs,
        replica `idx` is the TP group of logical ranks `[idx*k,
        (idx+1)*k)`, as the reference gives it devices `[idx*k,
        (idx+1)*k)`: its program keys end in that group's fingerprint,
        apart from every other replica's."""
        kw = dict(self._engine_kwargs)
        tp = int(kw.get("tp", 1) or 1)
        if tp > 1 and kw.get("mesh") is None:
            kw["mesh"] = make_tp_mesh(tp, ranks=range(idx * tp,
                                                      (idx + 1) * tp))
        eng = LLMEngine(self.model, name=f"{self.name}_r{idx}",
                        register_stats=self._register_stats, **kw)
        if self._kv_tier is not None:
            # spawns and rebuilds join the shared tier too — a scaled-
            # out replica binds fleet-published prefixes from step one
            eng.attach_kv_tier(self._kv_tier)
        r = self._by_idx(idx)
        if r is not None:
            self._subscribe(r, eng)
        return eng

    def _subscribe(self, r: _Replica, eng: LLMEngine):
        """Post-mortems ARE health signals: every flight-recorder dump
        lands in the replica's inbox and is scored next step."""
        inbox = r._signal_reports

        def _listener(report, inbox=inbox):
            inbox.append(str(report.get("reason", "postmortem")))

        eng.flight.listeners.append(_listener)

    def _ensure_open(self):
        if self._closed:
            raise RuntimeError("fleet closed")

    def close(self):
        """Terminal, like `LLMEngine.close()`: submit/step raise
        afterwards; `result()` and `stats()` keep working so a
        shutting-down server can drain what finished."""
        self._closed = True
        for r in self._replicas:
            if r.engine is not None:
                r.engine.close()
        if self._finalizer is not None:
            self._finalizer()
            self._finalizer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #
    # submission / results
    # ------------------------------------------------------------------ #
    def _validate(self, prompt, params: SamplingParams) -> np.ndarray:
        """Fleet-level validation mirrors the engine's (replicas are
        homogeneous): an unservable request must fail even when every
        replica is quarantined and the request would otherwise sit in
        the pending queue forever."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        total = prompt.size + params.max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({params.max_new_tokens}) = {total} exceeds the fleet "
                f"max_seq {self.max_seq}")
        if params.n > self.max_slots:
            # the engine's bound, checked BEFORE submit() allocates
            # n-1 tracked records and fleet-global rids for the group
            raise ValueError(
                f"n ({params.n}) exceeds max_slots ({self.max_slots}) "
                f"— best-of-n continuations each hold a decode lane")
        return prompt

    def submit(self, prompt,
               params: Optional[SamplingParams] = None) -> int:
        """Route one request to a replica; returns its FLEET-GLOBAL id
        (valid across failovers — the id follows the request wherever
        it is re-admitted). When no healthy replica can hold it the
        request waits in the fleet's bounded pending queue; a full
        pending queue raises `EngineOverloadError` (backpressure is
        preserved, just fleet-wide)."""
        self._ensure_open()
        params = params or SamplingParams()
        prompt = self._validate(prompt, params)
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        t = _Tracked(rid, prompt, params, now)
        self._tracked[rid] = t
        if params.n > 1:
            # preassign fleet-global rids for the whole group and track
            # every member durably; the group is placed as ONE request
            # (the engine forks it via COW pages) but each continuation
            # is a first-class fleet citizen for results, streams,
            # cancel and failover
            kids = list(range(self._next_rid,
                              self._next_rid + params.n - 1))
            self._next_rid += params.n - 1
            t.fork_rids = [rid] + kids
            kid_params = dataclasses.replace(params, n=1)
            for krid in kids:
                self._tracked[krid] = _Tracked(krid, prompt,
                                               kid_params, now)
        # a non-empty pending queue means older requests are waiting:
        # new arrivals line up behind them (placing directly would let
        # fresh traffic starve the pended head under sustained load)
        if self._pending or not self._place_fresh(t):
            if len(self._pending) >= self.max_pending:
                del self._tracked[rid]
                raise EngineOverloadError(
                    f"fleet pending queue full ({self.max_pending}) and "
                    f"no replica can admit — retry after in-flight "
                    f"requests drain")
            self._pending.append(("fresh", rid))
        return rid

    def result(self, rid: int) -> GenerationResult:
        """Fetch-and-evict, like `LLMEngine.result`."""
        if rid not in self._results:
            raise KeyError(f"request {rid} not finished (or unknown, "
                           f"or already collected)")
        return self._results.pop(rid)

    def has_result(self, rid: int) -> bool:
        """True iff `rid` finished and is still uncollected — mirrors
        `LLMEngine.has_result` so a front door can poll either."""
        return rid in self._results

    def fork_rids(self, rid: int) -> List[int]:
        """The best-of-n group a submitted rid heads (`[rid, sibling
        rids...]`; empty for n=1) — mirrors `LLMEngine.fork_rids` so
        the front door fans per-choice relays out of either backend."""
        t = self._tracked.get(rid)
        return list(t.fork_rids) if t is not None and t.fork_rids \
            else []

    def peek_result(self, rid: int) -> Optional[GenerationResult]:
        """Non-evicting read of a finished result (None when unknown)
        — mirrors `LLMEngine.peek_result` for the reattach path."""
        return self._results.get(rid)

    def cancel(self, rid: int) -> bool:
        """Best-effort fleet-wide cancel, mirroring `LLMEngine.cancel`:
        True iff `rid` was live (fleet-pending or owned by a replica)
        and is now cancelled. A pending request finishes immediately
        with reason "cancelled" (keeping any tokens a failed-over
        snapshot recorded); an owned request cancels on its replica and
        its result flows back through the normal collection path. The
        front door funnels client disconnects here so abandoned streams
        free their KV slots instead of decoding to nobody."""
        self._ensure_open()
        t = self._tracked.get(rid)
        if t is None:
            return False
        for item in list(self._pending):
            if item[1] == rid:
                self._pending.remove(item)
                gen = [int(x) for x in item[2].get("generated", ())] \
                    if item[0] == "adopt" else []
                self._tracked.pop(rid, None)
                self._finish_fleetside(
                    rid, GenerationResult(rid, t.prompt, gen,
                                          "cancelled", 0.0))
                self._finish_group_unplaced(t, "cancelled")
                return True
        r = self._by_idx(t.replica) if t.replica >= 0 else None
        if r is not None:
            if r.engine is not None and rid in r.outstanding:
                try:
                    return bool(r.engine.cancel(rid))
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception:  # noqa: BLE001 — a broken replica
                    # is the health machinery's problem, not cancel's
                    return False
        return False

    def _finish_fleetside(self, rid: int, g: GenerationResult):
        """Terminal state reached by the FLEET (pending-queue cancel or
        deadline — no replica ever owned the request at the end):
        record the result and feed the stream, exactly like a replica
        engine's `_record_result` would have."""
        self._results[rid] = g
        sink = self._streams.pop(rid, None)
        if sink is not None:
            try:
                if g.token_ids:
                    sink("tokens", 0, list(g.token_ids))
                sink("finished", g.finish_reason, g.error)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:  # noqa: BLE001 — sink errors never
                pass           # outlive the feed they broke

    # ------------------------------------------------------------------ #
    # incremental token streaming (mirrors LLMEngine.attach_stream)
    # ------------------------------------------------------------------ #
    def attach_stream(self, rid: int, sink) -> bool:
        """Register `sink` for incremental delivery of `rid`'s tokens
        (`("tokens", start, ids)` / `("finished", reason, error)`),
        wherever the request lives now and wherever failover moves it
        next. Replays already-emitted tokens on attach; a finished
        uncollected result replays synchronously. False iff the rid is
        unknown."""
        g = self._results.get(rid)
        if g is not None:
            if g.token_ids:
                sink("tokens", 0, list(g.token_ids))
            sink("finished", g.finish_reason, g.error)
            return True
        t = self._tracked.get(rid)
        if t is None:
            return False
        self._streams[rid] = sink
        r = self._by_idx(t.replica) if t.replica >= 0 else None
        if r is not None:
            if r.engine is not None and rid in r.outstanding:
                r.engine.attach_stream(rid, sink)
                return True
        # fleet-pending: an adopt item may carry snapshot-recorded
        # tokens the client has not necessarily seen — replay them now
        for item in self._pending:
            if item[1] == rid and item[0] == "adopt" \
                    and item[2].get("generated"):
                sink("tokens", 0,
                     [int(x) for x in item[2]["generated"]])
                break
        return True

    def detach_stream(self, rid: int):
        self._streams.pop(rid, None)
        t = self._tracked.get(rid)
        r = self._by_idx(t.replica) \
            if t is not None and t.replica >= 0 else None
        if r is not None and r.engine is not None:
            r.engine.detach_stream(rid)

    def has_work(self) -> bool:
        return bool(self._pending or self._tracked
                    or any(r.probe_rid is not None
                           for r in self._replicas))

    def generate(self, prompts: Sequence,
                 params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None) -> List[GenerationResult]:
        """Submit a batch and run to completion; results in input
        order. The no-strand contract: every submitted request reaches
        a terminal result (check `finish_reason`) even when replicas
        are killed mid-decode — failover re-admits them elsewhere."""
        self._ensure_open()
        if isinstance(params, SamplingParams) or params is None:
            params = [params] * len(prompts)
        if len(params) != len(prompts):
            raise ValueError(f"got {len(prompts)} prompts but "
                             f"{len(params)} SamplingParams")
        params = [sp or SamplingParams() for sp in params]
        prompts = [self._validate(p, sp)
                   for p, sp in zip(prompts, params)]
        rids = []
        groups: Dict[int, List[int]] = {}
        for p, sp in zip(prompts, params):
            while len(self._pending) >= self.max_pending \
                    and self.has_work():
                self._idle_guard(self.step())
            rid = self.submit(p, sp)
            rids.append(rid)
            if sp.n > 1:
                groups[rid] = self.fork_rids(rid)
        self.run_until_complete()
        out = []
        for r in rids:
            g = self.result(r)
            kids = groups.get(r)
            if kids:
                # continuations ride the parent's result, mirroring
                # LLMEngine.generate — and COLLECTING them here keeps
                # the fleet's results dict from accreting one entry
                # per continuation forever
                g.siblings = [self.result(k) for k in kids[1:]]
            out.append(g)
        return out

    def run_until_complete(self, max_steps: Optional[int] = None):
        self._ensure_open()
        steps = 0
        while self.has_work():
            progressed = self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps \
                    and self.has_work():
                # has_work re-checked: finishing the last request on
                # exactly the budgeted step is success, not a hang
                raise RuntimeError(
                    f"fleet not drained after {steps} steps "
                    f"({len(self._pending)} pending, "
                    f"{len(self._tracked)} outstanding)")
            self._idle_guard(progressed)

    def _idle_guard(self, progressed: int):
        """Shared by every drive-to-completion loop: when a step ran
        nothing, either raise (every replica is dead — only an
        operator `revive()` can ever unblock, so spinning would
        livelock the caller) or sleep a slice of the shortest
        quarantine backoff instead of burning the host dry."""
        if progressed or self._any_engine_work():
            return
        if all(r.health.state == "dead" for r in self._replicas):
            if self._autoscaler is not None:
                # the watchdog replaces dead replicas on the next
                # tick — sleeping here is waiting, not livelock
                time.sleep(0.005)
                return
            raise RuntimeError(
                f"every replica is dead with {len(self._tracked)} "
                f"requests outstanding — revive() one to continue "
                f"(work is intact)")
        waits = [r.health.backoff() for r in self._replicas
                 if r.health.state == "quarantined"]
        time.sleep(min(0.005, min(waits) if waits else 0.005))

    # ------------------------------------------------------------------ #
    # routing
    # ------------------------------------------------------------------ #
    def live_engines(self) -> List[LLMEngine]:
        """The replicas' live engine objects (public so soak CLIs and
        examples can run end-of-run assertions — e.g. the paged
        zero-leak check — without reaching into `_replicas`)."""
        return [r.engine for r in self._replicas
                if r.engine is not None]

    def warm_up(self, prompt_lengths: Sequence[int] = (1,)) -> int:
        """`LLMEngine.warm_up` on every live replica (each captures its
        own graphs); a replica built later (revive, failover, a
        scale-out) captures at its canary. Returns the programs built."""
        self._ensure_open()
        return sum(e.warm_up(prompt_lengths) for e in self.live_engines())

    @property
    def paged(self) -> bool:
        """True when the replicas serve the paged KV layout (the front
        door reads this to price SLO debits in pages)."""
        return any(r.engine is not None and r.engine.paged
                   for r in self._replicas)

    @property
    def page_size(self) -> int:
        for r in self._replicas:
            if r.engine is not None and r.engine.paged:
                return r.engine.page_size
        return 0

    def _serving_replicas(self) -> List[_Replica]:
        return [r for r in self._replicas
                if r.engine is not None and r.health.accepts_traffic]

    def _room(self, r: _Replica) -> bool:
        return r.engine.pending < r.engine.max_queue

    @staticmethod
    def _work_score(r: _Replica):
        """Outstanding work for least-work ranking. PAGED replicas are
        priced in PAGES (`LLMEngine.page_load()`: pages held + the
        queue's reserved spans) — the router ranks by real memory
        pressure, so one replica holding a few huge-context requests
        stops looking 'emptier' than a peer holding many short ones.
        Slotted replicas keep the request count (homogeneous fleets
        never mix the two scales)."""
        load = r.engine.page_load() if r.engine is not None else None
        return load if load is not None else len(r.outstanding)

    @staticmethod
    def _role_ok(r: _Replica, want: str) -> bool:
        return r.role == "mixed" or r.role == want

    def _route(self, prompt: np.ndarray,
               want: str = "prefill") -> Optional[_Replica]:
        """Pick the replica for one request; None when nobody can take
        it (the caller pends it). Deterministic: ties break on replica
        index, so a replayed submission order reroutes identically —
        the property the bit-identity tests lean on.

        `want` is the request's current phase under role
        disaggregation: "prefill" for fresh prompts (and re-ingests
        with no emitted tokens), "decode" for mid-generation
        continuations. Role-matching replicas are preferred; when none
        can admit, the request SPILLS to any serving replica rather
        than pend behind a role preference."""
        pool = [r for r in self._serving_replicas() if self._room(r)]
        cands = [r for r in pool if self._role_ok(r, want)]
        role_spill = False
        if not cands and pool and self.roles is not None:
            cands = pool
            role_spill = True
        if not cands:
            return None
        if role_spill:
            self.routed_role_spill += 1
        least = min(cands, key=lambda r: (self._work_score(r), r.idx))
        if self.routing == "prefix_affinity":
            tier = self._kv_tier
            if tier is not None and tier.has_prefix(prompt):
                # a fleet-tier hit NEUTRALIZES affinity: every replica
                # binds the published chunks equally well, so chasing
                # the replica whose local tree saw the prefix would
                # only hotspot it — take the least-loaded pick instead
                self.routed_tier += 1
                return least
            best, best_len = None, 0
            for r in cands:
                tree = r.engine.prefix
                if tree is None:
                    continue
                nodes, _ = tree.match(prompt)
                if len(nodes) > best_len:
                    best, best_len = r, len(nodes)
            if best is not None and best is not least:
                if len(best.outstanding) - len(least.outstanding) \
                        <= self.affinity_slack:
                    self.routed_affinity += 1
                    return best
                # overloaded favorite: spill to the least-loaded peer,
                # whose admission warms its own tree (the anti-hotspot
                # half of the affinity policy)
                self.routed_spill += 1
                return least
            if best is not None:
                self.routed_affinity += 1
        return least

    def _req_dict(self, t: _Tracked) -> Dict:
        """Adoption-shaped dict for a from-scratch placement: no
        emitted tokens, but the ORIGINAL fleet-submit clock — a
        `deadline_s` budget keeps burning across pending waits and
        failover restarts instead of resetting with each placement."""
        d = {"rid": t.rid, "prompt": t.prompt,
             "params": dataclasses.asdict(t.params),
             "generated": [], "slot": -1, "ttft_s": 0.0,
             "elapsed_s": time.perf_counter() - t.submit_t}
        if t.fork_rids and t.resubmitted == 0:
            # first placement of a best-of-n group: the dict carries
            # the group rids so the ENGINE forks it (COW pages). A
            # failover RESUBMISSION never re-carries them — by then
            # every member has its own fleet record and re-expansion
            # would duplicate continuations
            d["fork_rids"] = list(t.fork_rids)
        return d

    def _place_fresh(self, t: _Tracked) -> bool:
        r = self._route(t.prompt)
        if r is None:
            t.replica = -1
            return False
        d = self._req_dict(t)
        r.engine.adopt(d)
        r.outstanding.add(t.rid)
        t.replica = r.idx
        self._reattach_stream(r, t.rid)
        if "fork_rids" in d:
            # the engine will materialize the continuations: own them
            # on the same replica so results/streams/failover see them
            for krid in d["fork_rids"][1:]:
                kt = self._tracked.get(krid)
                if kt is not None and kt.replica < 0:
                    r.outstanding.add(krid)
                    kt.replica = r.idx
                    self._reattach_stream(r, krid)
        return True

    def _place_adopt(self, rid: int, req: Dict) -> bool:
        t = self._tracked.get(rid)
        if t is None:
            return True  # collected/cancelled since: nothing to place
        r = self._route(np.asarray(req["prompt"], np.int32),
                        want="decode" if req.get("generated")
                        else "prefill")
        if r is None:
            t.replica = -1
            return False
        # the snapshot's elapsed_s is stale by the snapshot's age plus
        # any time spent in the fleet pending queue — the fleet's own
        # submit clock is the authoritative TTL: a deadline_s budget
        # burns continuously from the ORIGINAL submit, never pausing
        # while the request is between replicas
        req = dict(req)
        req["elapsed_s"] = time.perf_counter() - t.submit_t
        # failover re-placement: never re-expand a fork group — every
        # member (materialized or not) has its own fleet record and is
        # re-placed / resubmitted individually by _failover
        req.pop("fork_rids", None)
        r.engine.adopt(req)
        r.outstanding.add(rid)
        t.replica = r.idx
        self._reattach_stream(r, rid)
        return True

    def _finish_group_unplaced(self, t: _Tracked, reason: str):
        """A best-of-n parent dying in the fleet-pending queue takes
        its UNPLACED continuations with it: they were promised rids
        but never reached an engine — each must still resolve to a
        result or its stream strands forever."""
        if not t.fork_rids:
            return
        for krid in t.fork_rids[1:]:
            kt = self._tracked.get(krid)
            if kt is not None and kt.replica < 0:
                self._tracked.pop(krid, None)
                self._finish_fleetside(
                    krid, GenerationResult(krid, t.prompt, [],
                                           reason, 0.0))

    def _reattach_stream(self, r: _Replica, rid: int):
        """Every placement re-binds the request's sink (if any) to the
        new owner: the engine's attach replays tokens from zero and
        the consumer dedups by start index, so a stream survives
        failover without gaps or duplicates."""
        sink = self._streams.get(rid)
        if sink is not None:
            r.engine.attach_stream(rid, sink)

    def _expire_pending(self, now: float):
        """Deadline sweep over the FLEET's own pending queue: a
        request every replica turned away still burns its TTL, and
        expiring it here (with whatever tokens a failed-over snapshot
        recorded) beats paying a placement just to expire it on a
        replica's next block boundary."""
        for item in [i for i in self._pending
                     if i[1] in self._tracked]:
            t = self._tracked[item[1]]
            if t.params.deadline_s is None \
                    or now - t.submit_t < t.params.deadline_s:
                continue
            self._pending.remove(item)
            gen = [int(x) for x in item[2].get("generated", ())] \
                if item[0] == "adopt" else []
            self._tracked.pop(item[1], None)
            self._finish_fleetside(
                item[1], GenerationResult(item[1], t.prompt, gen,
                                          "deadline", 0.0))
            self._finish_group_unplaced(t, "deadline")

    def _item_priority(self, item) -> int:
        if item[0] == "adopt":
            return int(item[2].get("params", {}).get("priority", 0))
        t = self._tracked.get(item[1])
        return t.params.priority if t is not None else 0

    def _flush_pending(self):
        # priority shapes who leaves the pending queue first: a stable
        # sort keeps FIFO within a level (the all-zero default is
        # exactly the old order), and the head-blocks rule below then
        # applies per the highest class — an over-budget burst of
        # low-priority work can no longer head-of-line-block a
        # high-priority tenant's admission
        if len(self._pending) > 1 \
                and any(self._item_priority(i) for i in self._pending):
            self._pending = collections.deque(
                sorted(self._pending,
                       key=lambda i: -self._item_priority(i)))
        for _ in range(len(self._pending)):
            item = self._pending.popleft()
            placed = self._place_fresh(self._tracked[item[1]]) \
                if item[0] == "fresh" and item[1] in self._tracked \
                else (self._place_adopt(item[1], item[2])
                      if item[0] == "adopt" else True)
            if not placed:
                self._pending.appendleft(item)
                break  # FIFO: nobody can take the head, stop trying

    # ------------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """One fleet round: flush pending work, advance every health
        machine (elapsed backoffs launch canaries), step every serving
        replica under the `replica_dispatch` injection point, score
        the signals each step surfaced, collect finished results, and
        refresh periodic snapshots. Returns #requests completed."""
        self._ensure_open()
        self._round += 1
        now = time.perf_counter()
        done = 0
        self._expire_pending(now)
        for r in list(self._replicas):
            self._advance_recovery(r, now)
        self._flush_pending()
        # a COPY: a draining replica that crashes mid-step removes its
        # slot from the list (crash-during-drain completes the retire)
        for r in list(self._replicas):
            if r.engine is None \
                    or r.health.state in ("quarantined", "dead"):
                continue
            if r.engine.has_work():
                try:
                    faults.fire("replica_dispatch")
                    r.engine.step()
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:  # noqa: BLE001 — replica crash
                    self._on_replica_failure(r, e)
                    continue
                self._collect_signals(r)
            # the liveness beat (elastic.Heartbeat's serving analog):
            # every participating replica refreshes it once per round;
            # an injected `replica_heartbeat` fault SUPPRESSES the
            # beat — the replica looks wedged and the autoscaler's
            # watchdog declares it preempted after its timeout
            try:
                faults.fire("replica_heartbeat")
                r.last_beat = now
            except faults.InjectedFault:
                pass
            # results are swept even from a replica whose engine went
            # idle: a cancel (e.g. a mid-prefill disconnect) records
            # its result IMMEDIATELY and may leave the engine with no
            # work — gating collection on has_work would strand that
            # result until unrelated traffic landed on the replica
            done += self._collect_results(r)
            if r.engine.has_work() and r.health.accepts_traffic \
                    and r.outstanding \
                    and self._round - r.snapshot_round \
                    >= self.snapshot_every:
                # the periodic snapshot is what failover falls back on
                # when the process dies without a chance to drain
                r.last_snapshot = r.engine.snapshot()
                r.snapshot_round = self._round
        done += self._drain_sweep(now)
        if self.roles is not None:
            self._handoff_sweep()
        if self._autoscaler is not None:
            # same thread as everything above (the worker owns the
            # backend): the controller reads signals, runs the
            # watchdog, and may add/retire/kill replicas — all between
            # replica steps, exactly like the operator verbs
            self._autoscaler.tick()
        return done

    def _handoff_sweep(self):
        """Prefill→decode disaggregation: move every request on a
        "prefill" replica whose first token has landed (KV built, TTFT
        recorded) to a decode-capable peer through the adopt()
        continuation seam. Greedy continuations are bit-identical
        (argmax is context-only and adopt re-ingests context exactly);
        streams re-bind to the new owner and the replay-from-zero +
        start-index dedup keeps them gapless. No decode capacity = no
        handoff: the request keeps decoding where it is until capacity
        appears — the split optimizes, it never strands."""
        now = time.perf_counter()
        for r in self._replicas:
            if r.role != "prefill" or r.engine is None \
                    or not r.health.accepts_traffic:
                continue
            for rid in r.engine.decoding_rids():
                if rid == r.probe_rid or rid not in self._tracked:
                    continue  # the canary decodes where it probes
                target = self._decode_target(exclude_idx=r.idx)
                if target is None:
                    return  # no decode capacity anywhere this round
                req = r.engine.extract(rid)
                if req is None:
                    continue  # finished/retired since the scan
                self._stage_kv_in_tier(req)
                t = self._tracked[rid]
                req["elapsed_s"] = now - t.submit_t
                r.outstanding.discard(rid)
                try:
                    target.engine.adopt(req)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception:  # noqa: BLE001 — a refused adopt
                    # (overload race, broken peer) must not lose the
                    # request: it pends and places as capacity returns
                    t.replica = -1
                    self._pending.append(("adopt", rid, req))
                    continue
                target.outstanding.add(rid)
                t.replica = target.idx
                self.handoffs += 1
                moved = int(req.get("kv_pages", {}).get("n_pages", 0))
                self.handoff_pages_moved += moved
                self._reattach_stream(target, rid)
                self._fleet_event("handoff", r.idx,
                                  f"rid {rid} -> r{target.idx}"
                                  + (f" ({moved} pages)" if moved
                                     else ""))

    def _stage_kv_in_tier(self, d: Dict) -> None:
        """Move an adoption dict's KV-page payload into the shared
        tier, leaving a single-use stub (`tier_key`) in its place: the
        page bytes live in ONE host store instead of riding the dict
        through pending queues, and whichever replica admits the
        request redeems them there (serving/kv_tier.py). No tier, an
        already-staged stub, a payload-free dict, or a tier error all
        leave the dict untouched — the direct page-transfer path keeps
        working."""
        tier = self._kv_tier
        kv = d.get("kv_pages")
        if tier is None or not kv or "k" not in kv:
            return
        try:
            # int8 layers serialize as {"q","s"} pytrees — the stub
            # must carry the dtype so admission can reject a mismatch
            quant = bool(kv["k"]) and isinstance(kv["k"][0], dict)
            key = tier.put_handoff({"k": kv["k"], "v": kv["v"],
                                    "rows": kv["rows"],
                                    "quantized": quant})
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:  # noqa: BLE001 — staging is best-effort;
            return         # the payload rides the dict as before
        d["kv_pages"] = {"tier_key": key, "rows": kv["rows"],
                         "n_pages": int(kv.get("n_pages", 0)),
                         "origin": kv.get("origin", "handoff"),
                         "quantized": quant}
        self.tier_handoffs += 1

    def _decode_target(self, exclude_idx: int) -> Optional[_Replica]:
        """Least-loaded decode-capable replica with queue room — the
        handoff destination (never the source, never a prefill-pinned
        peer: a handoff that lands back on a prefill replica would
        just re-enter the sweep)."""
        cands = [x for x in self._serving_replicas()
                 if self._room(x) and x.idx != exclude_idx
                 and self._role_ok(x, "decode")]
        if not cands:
            return None
        return min(cands, key=lambda x: (self._work_score(x), x.idx))

    def _any_engine_work(self) -> bool:
        return any(r.engine is not None and r.engine.has_work()
                   and r.health.state not in ("quarantined", "dead")
                   for r in self._replicas)

    def _collect_results(self, r: _Replica) -> int:
        done = 0
        eng = r.engine
        for rid in [x for x in r.outstanding if eng.has_result(x)]:
            self._results[rid] = eng.result(rid)
            r.outstanding.discard(rid)
            self._tracked.pop(rid, None)
            # the engine already fed the sink its finished event —
            # the fleet just forgets the registration
            self._streams.pop(rid, None)
            done += 1
        if r.probe_rid is not None and eng.has_result(r.probe_rid):
            res = eng.result(r.probe_rid)
            r.probe_rid = None
            ok = res.finish_reason in ("stop", "length")
            self._finish_probe(r, ok, time.perf_counter())
        return done

    # ------------------------------------------------------------------ #
    # health scoring
    # ------------------------------------------------------------------ #
    def _collect_signals(self, r: _Replica):
        """Score one successful step's signals: post-mortems delivered
        by the flight listener, watchdog `compiles_unexpected` growth,
        and consecutive deadline-expiring steps. A signal-free step
        that produced tokens counts as success (clears SUSPECT)."""
        now = time.perf_counter()
        eng = r.engine
        failed = False
        # drain IN PLACE: the flight listener captured this exact list
        # object, so rebinding the attribute would orphan it
        reports = list(r._signal_reports)
        r._signal_reports.clear()
        for reason in reports:
            failed = True
            if self._note_failure(r, reason, now):
                return  # quarantined mid-scoring: drained, stop
        wd = int(eng.watchdog.compiles_unexpected)
        if wd > r._wd_mark:
            r._wd_mark = wd
            failed = True
            if self._note_failure(r, "compiles_unexpected", now):
                return
        dl = int(eng.metrics.deadline_expired)
        if dl > r._deadline_mark:
            r._deadline_streak += 1
            if r._deadline_streak >= self.deadline_miss_streak:
                r._deadline_streak = 0
                failed = True
                if self._note_failure(r, "deadline_misses", now):
                    return
        else:
            r._deadline_streak = 0
        r._deadline_mark = dl
        tokens = int(eng.metrics.generated_tokens)
        if not failed and tokens > r._tokens_mark:
            r.health.note_success(now)
        r._tokens_mark = tokens

    def _note_failure(self, r: _Replica, kind: str, now: float) -> bool:
        """Route one failure signal into the state machine; a tip into
        QUARANTINED drains the replica (clean snapshot) and fails its
        work over."""
        self._fleet_event("signal", r.idx, kind)
        if r.health.note_failure(kind, now):
            self._drain(r, why=kind)
            return True
        return False

    def _on_replica_failure(self, r: _Replica, err: BaseException):
        """An exception out of the replica's own `step()` — the
        process-crash shape (`replica_dispatch` faults land here).
        Straight to quarantine; the engine object may still be
        coherent, so a fresh snapshot is attempted before falling back
        to the last periodic one."""
        now = time.perf_counter()
        why = f"{type(err).__name__}: {err}"
        self._fleet_event("replica_failure", r.idx, why)
        r.health.signals["step_exception"] = \
            r.health.signals.get("step_exception", 0) + 1
        if r.health.state == "draining":
            # a crash mid-drain completes the retirement instead of
            # losing it to quarantine: fail the remaining work over
            # (crash semantics — re-salted, like any failover) and
            # remove the slot for good
            snap = self._retire_engine(r, try_snapshot=True)
            self._failover(r, snap, why)
            self._replicas.remove(r)
            self.replicas_retired += 1
            self._fleet_event("scale_in", r.idx, "crash_during_drain")
            return
        r.health.quarantine(now, why="step_exception")
        self._drain(r, why=why)

    # ------------------------------------------------------------------ #
    # drain / failover
    # ------------------------------------------------------------------ #
    def _retire_engine(self, r: _Replica,
                       try_snapshot: bool) -> Optional[Dict]:
        """Take the replica's engine out of service: archive its
        lifecycle ring, capture a final snapshot when the object still
        answers, close it, and stand up a fresh (empty) engine for the
        canary to probe. Returns the freshest snapshot available."""
        snap = r.last_snapshot
        eng, r.engine = r.engine, None
        # a replacement engine's counters start from zero: reset the
        # signal watermarks so its first real signal is not masked by
        # the dead engine's high-water marks — and drop the dead
        # engine's undelivered post-mortems (in place: the listeners
        # captured this list object) so they are never scored against
        # the fresh engine
        r._signal_reports.clear()
        r._wd_mark = 0
        r._deadline_mark = 0
        r._deadline_streak = 0
        r._tokens_mark = 0
        if eng is not None:
            try:
                r.archived_events.extend(eng.tracer.events())
            except Exception:  # noqa: BLE001 — best-effort archive
                pass
            if try_snapshot:
                try:
                    snap = eng.snapshot()
                except Exception:  # noqa: BLE001 — fall back to periodic
                    pass
            try:
                eng.close()
            except Exception:  # noqa: BLE001 — already-broken engine
                pass
        r.last_snapshot = None
        r.probe_rid = None
        return snap

    def _drain(self, r: _Replica, why: str):
        """Quarantine-side failover: snapshot what the replica holds,
        replace its engine with a fresh one, and re-admit every
        outstanding request elsewhere."""
        self.quarantines += 1
        self._fleet_event("quarantine", r.idx, why)
        snap = self._retire_engine(r, try_snapshot=True)
        r.engine = self._build_engine(r.idx)
        self._failover(r, snap, why)

    def kill(self, idx: int):
        """Simulate an unclean replica death (the process is gone: no
        final snapshot, no drain — what a preempted host looks
        like). Outstanding work fails over from the last
        PERIODIC snapshot; requests submitted after it restart from
        the fleet's own record. `revive()` brings the replica back
        through the canary gate."""
        self._ensure_open()
        r = self._by_idx(idx)
        if r is None:
            raise KeyError(f"no replica {idx} (retired or removed)")
        if r.health.state == "dead":
            return
        self.kills += 1
        now = time.perf_counter()
        self._fleet_event("kill", idx, "")
        snap = self._retire_engine(r, try_snapshot=False)
        r.health.kill(now)
        self._failover(r, snap, "killed")

    def revive(self, idx: int):
        """Restart a killed replica: a fresh engine (it captures its own
        graphs, on its canary) that still must pass its half-open
        canary before the router sends it traffic."""
        self._ensure_open()
        r = self._by_idx(idx)
        if r is None:
            raise KeyError(f"no replica {idx} (retired or removed)")
        if r.health.state != "dead":
            raise RuntimeError(f"replica {idx} is {r.health.state}, "
                               f"not dead")
        self.revives += 1
        self._fleet_event("revive", idx, "")
        r.engine = self._build_engine(idx)
        r.health.revive(time.perf_counter())

    def quarantine(self, idx: int):
        """Operator cordon: drain a live replica and route around it
        (it re-admits through the normal canary path)."""
        self._ensure_open()
        r = self._by_idx(idx)
        if r is None:
            raise KeyError(f"no replica {idx} (retired or removed)")
        if r.engine is None or r.health.state in ("quarantined",
                                                  "draining", "dead"):
            return
        r.health.quarantine(time.perf_counter(), why="operator")
        self._drain(r, why="operator")

    # ------------------------------------------------------------------ #
    # elasticity: runtime resize (the autoscaler's verbs — also usable
    # by an operator directly; everything runs on the owning thread
    # between replica steps, like kill/revive/quarantine)
    # ------------------------------------------------------------------ #
    def attach_autoscaler(self, controller) -> None:
        """Bind a `FleetAutoscaler` (serving/autoscale.py): its
        `tick()` runs at the end of every `step()` on the thread that
        owns the fleet — the controller reads signals and calls the
        resize verbs with no locking, because it only ever executes
        between replica steps. Duck-typed (anything with `tick()` and
        `prom_families()`) so fleet.py never imports autoscale.py."""
        self._autoscaler = controller

    @property
    def autoscaler(self):
        """The attached controller, or None — read-only surface for
        /healthz and the soak harness (same owning-thread rule as the
        rest of the fleet state: read it from the worker thread)."""
        return self._autoscaler

    def add_replica(self, role: str = "mixed") -> int:
        """Scale out by one replica (one TP GROUP when `tp=k` rides
        the engine kwargs — `_build_engine` pins the next device
        group, so the scale unit is a group, never a lone chip).
        Returns the new replica's stable id, or -1 when the engine
        build failed — a failed spawn DEGRADES to the current size
        (`scale_failures` counts it, routing is untouched, no caller
        ever sees an error from it).

        The new replica takes no traffic yet: it enters through the
        half-open canary (`ReplicaHealth.await_canary`), and the probe
        that admits it is also what captures its programs — by the
        time the router sees it, the capture cost is already paid."""
        self._ensure_open()
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"unknown role {role!r}; valid: "
                             f"'prefill', 'decode', 'mixed'")
        if self.roles is None and role != "mixed":
            # a role-less fleet routes every want to every replica —
            # a pinned replica would silently starve its off-role half
            raise ValueError("this fleet was built without roles — "
                             "new replicas must be 'mixed'")
        idx = self._next_ridx
        self._next_ridx += 1
        r = _Replica(idx, None, self._new_health(), role=role)
        self._replicas.append(r)  # before _build_engine: the
        # flight-listener subscription looks the replica up
        now = time.perf_counter()
        try:
            faults.fire("replica_spawn")
            r.engine = self._build_engine(idx)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — degrade, never wedge
            self._replicas.remove(r)
            self.scale_failures += 1
            self._fleet_event("scale_failure", idx,
                              f"{type(e).__name__}: {e}")
            return -1
        r.health.await_canary(now)
        self.replicas_added += 1
        self._fleet_event("scale_out", idx, f"role={role}")
        return idx

    def retire_replica(self, idx: int) -> bool:
        """Scale in by one replica, GRACEFULLY: the replica stops
        taking routes immediately (DRAINING is not accepts_traffic)
        and subsequent `step()`s move its work to peers — queued and
        host-swapped requests via `unqueue()`, decoding requests via
        `extract()` — all salt-preserving (`keep_salt`), so every
        live stream continues bit-identically on its adopter. Only
        when nothing is owned is the engine torn down and the slot
        removed. Returns True once the drain is underway (completion
        is asynchronous; watch `replicas_retired` or the `scale_in`
        fleet event). Retiring a dead replica just removes it."""
        self._ensure_open()
        r = self._by_idx(idx)
        if r is None:
            raise KeyError(f"no replica {idx} (retired or removed)")
        if r.health.state == "draining":
            return True
        if r.health.state == "dead":
            self.remove_dead(idx)
            return True
        if not any(x is not r and x.health.state != "dead"
                   for x in self._replicas):
            raise RuntimeError("cannot retire the last live replica")
        r.health.begin_drain(time.perf_counter())
        self._fleet_event("scale_in_begin", idx, "")
        return True

    def remove_dead(self, idx: int) -> None:
        """Drop a DEAD replica's slot (the autoscaler's preemption
        path: the watchdog `kill()`s a stale replica — which fails
        its work over — then removes the slot and `add_replica()`s a
        replacement, instead of `revive()`-ing hardware that is
        gone). Anything still owned re-pends from the fleet record."""
        self._ensure_open()
        r = self._by_idx(idx)
        if r is None:
            raise KeyError(f"no replica {idx} (retired or removed)")
        if r.health.state != "dead":
            raise RuntimeError(f"replica {idx} is {r.health.state}, "
                               f"not dead — retire_replica() drains "
                               f"live replicas")
        for rid in sorted(r.outstanding):
            t = self._tracked.get(rid)
            if t is not None:
                t.replica = -1
                t.resubmitted += 1
                self._pending.append(("fresh", rid))
        r.outstanding.clear()
        self._replicas.remove(r)
        self.replicas_retired += 1
        self._fleet_event("remove_dead", idx, "")

    def _drain_sweep(self, now: float) -> int:
        """One step's worth of graceful scale-in: move every movable
        request off each DRAINING replica, then finish the ones that
        emptied. Draining replicas still step (mid-prefill requests
        must reach their first token to become extractable), so a
        drain converges in a handful of rounds even under load."""
        done = 0
        for r in [x for x in self._replicas
                  if x.health.state == "draining"]:
            if r.engine is not None:
                # the victim's salt clock travels with its work: an
                # adopter's clock advances to it BEFORE any moved
                # salt-None request can pop there, so those requests
                # draw exactly the salts the victim would have — the
                # other half of the keep_salt bit-identity contract
                # (keep_salt alone races: a queued move can pop on
                # the adopter a round before the first extract lands)
                vsalt = r.engine.salt_clock()
                # pre-admission half: queued / host-swapped requests
                # hold no device state and move unconditionally
                for rid in sorted(r.outstanding):
                    d = r.engine.unqueue(rid)
                    if d is None:
                        continue
                    t = self._tracked.get(rid)
                    if t is None:
                        continue  # cancelled since: dict dies here
                    if d.get("fork_rids"):
                        # a still-QUEUED best-of-n parent: its
                        # continuations were never materialized on
                        # the victim, so re-place the whole group as
                        # a first placement (the adopter forks it —
                        # _req_dict re-carries the group; the engine
                        # dict, whose fork_rids _place_adopt strips
                        # by contract, is dropped)
                        r.outstanding.discard(rid)
                        for krid in d["fork_rids"][1:]:
                            r.outstanding.discard(krid)
                            kt = self._tracked.get(krid)
                            if kt is not None:
                                kt.replica = -1
                        self.requests_drained += 1
                        if not self._place_fresh(t):
                            self._pending.append(("fresh", rid))
                        continue
                    d["keep_salt"] = True  # cooperative drain: the
                    # adopter preserves the salt (and with it the
                    # sampled stream), unlike crash failover
                    self._stage_kv_in_tier(d)  # host-swapped KV moves
                    # through the tier, not the pending queue
                    r.outstanding.discard(rid)
                    self.requests_drained += 1
                    if self._place_adopt(rid, d):
                        self._sync_salt_clock(t.replica, vsalt)
                    else:
                        self._pending.append(("adopt", rid, d))
                # decode half: extract() only while some peer can
                # actually queue work — an extraction with no adopter
                # would just park device-resident KV in the pending
                # queue for nothing; retry next step instead
                for rid in list(r.engine.decoding_rids()):
                    if rid == r.probe_rid or rid not in r.outstanding:
                        continue
                    if not any(self._room(x)
                               for x in self._serving_replicas()):
                        break
                    d = r.engine.extract(rid)
                    if d is None:
                        continue
                    d["keep_salt"] = True
                    self._stage_kv_in_tier(d)
                    r.outstanding.discard(rid)
                    self.requests_drained += 1
                    t = self._tracked.get(rid)
                    if self._place_adopt(rid, d):
                        if t is not None:
                            self._sync_salt_clock(t.replica, vsalt)
                    else:
                        self._pending.append(("adopt", rid, d))
            done += self._finish_retire(r)
        return done

    def _sync_salt_clock(self, idx: int, vsalt: int):
        """Advance one adopter's salt clock to the drain victim's."""
        tr = self._by_idx(idx)
        if tr is not None and tr.engine is not None:
            tr.engine.advance_salt_clock(vsalt)

    def _finish_retire(self, r: _Replica) -> int:
        """Complete a graceful retirement once the replica owns
        nothing. Results are swept ONE more time first — a result
        recorded during this very round (a cancel fast-path, a
        block-boundary finish) must route to its caller BEFORE
        teardown, the same sweep discipline as an idle replica's.
        Returns the number of results that sweep surfaced."""
        done = self._collect_results(r) if r.engine is not None else 0
        if r.outstanding or r.probe_rid is not None:
            return done  # still owns work: keep draining next step
        self._retire_engine(r, try_snapshot=False)
        self._replicas.remove(r)
        self.replicas_retired += 1
        self._fleet_event("scale_in", r.idx, "drained")
        return done

    def _failover(self, r: _Replica, snap: Optional[Dict], why: str):
        """Split a snapshot per-request and re-admit: finished results
        surface directly, active/queued requests adopt into peers
        (token-preserving), and outstanding rids the snapshot predates
        restart from the fleet record. Nothing is ever dropped — what
        no peer can hold right now pends."""
        self.failovers += 1
        readmitted, resubmitted = [], []
        recovered: set = set()
        snap_reqs: List[Dict] = []
        if snap:
            for g in snap.get("results", ()):
                rid = int(g["rid"])
                if rid in r.outstanding and rid in self._tracked:
                    self._tracked.pop(rid, None)
                    self._finish_fleetside(rid, GenerationResult(
                        rid, np.asarray(g["prompt"], np.int32),
                        list(g["token_ids"]), g["finish_reason"],
                        float(g["ttft_s"]), g.get("error"),
                        queue_wait_s=float(
                            g.get("queue_wait_s", 0.0))))
                    recovered.add(rid)
            for req in list(snap.get("active", ())) \
                    + list(snap.get("queued", ())) \
                    + list(snap.get("swapped", ())):
                # host-SWAPPED requests fail over like queued ones:
                # their dicts carry the host page payload, so the
                # adopting replica uploads instead of re-prefilling
                rid = int(req["rid"])
                if rid in r.outstanding and rid in self._tracked \
                        and rid not in recovered:
                    snap_reqs.append(req)
                    recovered.add(rid)
        lost = sorted(rid for rid in r.outstanding
                      if rid not in recovered and rid in self._tracked)
        r.outstanding.clear()
        for req in snap_reqs:
            rid = int(req["rid"])
            self._tracked[rid].readmitted += 1
            readmitted.append(rid)
            if not self._place_adopt(rid, req):
                self._pending.append(("adopt", rid, req))
        for rid in lost:
            t = self._tracked[rid]
            t.resubmitted += 1
            resubmitted.append(rid)
            if not self._place_fresh(t):
                self._pending.append(("fresh", rid))
        self.requests_readmitted += len(readmitted)
        self.requests_resubmitted += len(resubmitted)
        self._fleet_event("failover", r.idx,
                          f"{len(readmitted)}+{len(resubmitted)} reqs")
        # the failover post-mortem names every displaced rid — the
        # fleet-level analog of the engine's decode_retry_exhausted
        # dump, announced to an armed FaultPlan the same way
        self.flight.dump(
            "replica_failover",
            metrics=self.stats(),
            config={"replicas": len(self._replicas),
                    "routing": self.routing,
                    "snapshot_every": self.snapshot_every},
            detail={"replica": r.idx, "why": why,
                    "snapshot": snap is not None,
                    "readmitted_rids": readmitted,
                    "resubmitted_rids": resubmitted,
                    # fleet events are 4-tuples, not engine lifecycle
                    # events — they ride in detail, not `events`
                    "fleet_events": [list(e) for e in
                                     list(self._events)[-32:]]})

    # ------------------------------------------------------------------ #
    # half-open canary
    # ------------------------------------------------------------------ #
    def _advance_recovery(self, r: _Replica, now: float):
        if r.engine is None or not r.health.ready_for_probe(now):
            return
        r.health.begin_probe(now)
        self.canary_probes += 1
        self._fleet_event("canary", r.idx, "")
        try:
            faults.fire("replica_health")
            rid = self._next_rid
            self._next_rid += 1
            r.probe_rid = rid
            r.engine.submit(
                self._probe_prompt,
                SamplingParams(max_new_tokens=self._probe_new),
                rid=rid)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:  # noqa: BLE001 — a failed probe IS the signal
            r.probe_rid = None
            self._finish_probe(r, False, now)

    def _finish_probe(self, r: _Replica, ok: bool, now: float):
        if ok:
            self.canary_ok += 1
        else:
            self.canary_failed += 1
        self._fleet_event("canary_ok" if ok else "canary_failed",
                          r.idx, "")
        r.health.probe_result(ok, now)

    # ------------------------------------------------------------------ #
    # drain-and-resume (the front door's SIGTERM path, fleet edition)
    # ------------------------------------------------------------------ #
    def _fleet_config(self) -> Dict:
        """Constructor kwargs for `resume()` — primitives only, like
        `LLMEngine._engine_config` (engine kwargs ride along since the
        ctor forwards them to every replica)."""
        return {
            "replicas": len(self._replicas),
            "routing": self.routing,
            # roles are rebuilt from the LIVE replicas, not the ctor
            # tuple — resize adds/removes slots, and a stale-length
            # roles list would fail resume()'s ctor validation
            "roles": [r.role for r in self._replicas]
            if self.roles is not None else None,
            "affinity_slack": self.affinity_slack,
            "snapshot_every": self.snapshot_every,
            "quarantine_after": self._quarantine_after,
            "quarantine_backoff_s": self._backoff_s,
            "quarantine_backoff_max_s": self._backoff_max_s,
            "deadline_miss_streak": self.deadline_miss_streak,
            "max_pending": self.max_pending,
            "flight_dir": self.flight.dir,
            # recorded as a bool: blobs are process-local, so resume()
            # rebuilds an EMPTY tier that refills as replicas publish
            "kv_tier": True if self._kv_tier is not None else None,
            **self._engine_kwargs,
        }

    def snapshot(self) -> Dict:
        """Serialize the fleet's request state for drain-and-resume: a
        picklable dict of the fleet config, every outstanding request
        as an adoption-shaped dict (tokens emitted so far, remaining
        TTL budget measured on the FLEET's submit clock) and the
        collected-but-unread results. Per-replica topology is NOT
        recorded — `resume()` re-routes every request fresh, which is
        exactly failover's drain-and-re-admit applied to all replicas
        at once, so greedy continuations stay bit-identical for the
        same reason adopted continuations do. Non-destructive."""
        self._ensure_open()
        now = time.perf_counter()
        reqs: Dict[int, Dict] = {}
        results: List[Dict] = [
            {"rid": g.request_id, "prompt": g.prompt,
             "token_ids": list(g.token_ids),
             "finish_reason": g.finish_reason,
             "ttft_s": g.ttft_s, "error": g.error,
             "queue_wait_s": g.queue_wait_s}
            for g in self._results.values()]
        finished: set = set(self._results)
        for r in self._replicas:
            if r.engine is None or not r.outstanding:
                continue
            try:
                snap = r.engine.snapshot()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:  # noqa: BLE001 — fall back to periodic
                snap = r.last_snapshot
            if not snap:
                continue  # fleet-record fallback below covers them
            for g in snap.get("results", ()):
                rid = int(g["rid"])
                if rid in r.outstanding and rid in self._tracked:
                    results.append(dict(g))
                    finished.add(rid)
            for req in list(snap.get("active", ())) \
                    + list(snap.get("queued", ())) \
                    + list(snap.get("swapped", ())):
                rid = int(req["rid"])
                if rid in r.outstanding and rid in self._tracked \
                        and rid not in finished:
                    d = dict(req)
                    # the fleet submit clock is the TTL authority,
                    # same as _place_adopt
                    d["elapsed_s"] = \
                        now - self._tracked[rid].submit_t
                    reqs[rid] = d
        for item in self._pending:
            rid = item[1]
            if rid in self._tracked and rid not in reqs \
                    and rid not in finished:
                if item[0] == "adopt":
                    d = dict(item[2])
                    d["elapsed_s"] = \
                        now - self._tracked[rid].submit_t
                    reqs[rid] = d
                else:
                    reqs[rid] = self._req_dict(self._tracked[rid])
        # anything tracked but not covered (a replica whose snapshot
        # failed AND whose periodic snapshot predates the request):
        # restart from the fleet's own record, like snapshot-gap
        # failover
        for rid, t in self._tracked.items():
            if rid not in reqs and rid not in finished:
                reqs[rid] = self._req_dict(t)
        return {
            "version": 1,
            "fleet": self._fleet_config(),
            "next_rid": self._next_rid,
            "requests": [reqs[rid] for rid in sorted(reqs)],
            "results": results,
        }

    @classmethod
    def resume(cls, model, snap: Dict, **overrides) -> "EngineFleet":
        """Rebuild a fleet from a `snapshot()` and continue every
        outstanding request: each re-enters through the normal adopt
        routing (mid-generation continuations keep their tokens; the
        fleet bit-identity contract for adopted continuations applies),
        unread results carry over, and every pre-snapshot rid resolves
        on the resumed fleet — streams reattach by request id."""
        if snap.get("version") != 1:
            raise ValueError(
                f"unknown fleet snapshot version {snap.get('version')!r}")
        kw = dict(snap["fleet"])
        kw.update(overrides)
        fleet = cls(model, **kw)
        fleet._next_rid = int(snap["next_rid"])
        now = time.perf_counter()
        for g in snap.get("results", ()):
            fleet._results[int(g["rid"])] = GenerationResult(
                int(g["rid"]), np.asarray(g["prompt"], np.int32),
                list(g["token_ids"]), g["finish_reason"],
                float(g["ttft_s"]), g.get("error"),
                queue_wait_s=float(g.get("queue_wait_s", 0.0)))
        for req in snap.get("requests", ()):
            rid = int(req["rid"])
            params = SamplingParams(**req["params"])
            t = _Tracked(rid, np.asarray(req["prompt"], np.int32),
                         params, now - float(req.get("elapsed_s", 0.0)))
            fleet._tracked[rid] = t
            d = dict(req)
            if not fleet._place_adopt(rid, d):
                fleet._pending.append(("adopt", rid, d))
        return fleet

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def _fleet_event(self, kind: str, replica: int, detail: str):
        self._events.append((time.perf_counter(), kind, replica,
                             str(detail)))
        if kind in _TRACE_MIRROR_KINDS:
            # the resize kinds are registered EVENT_KINDS (fleet-scope
            # instants, rid -1): stamp them onto the first live
            # replica's lifecycle ring too, so a single-engine trace
            # of a scaled serve still shows the resize timeline (the
            # fleet's own ring above is merged only by the fleet-level
            # chrome export). Runs on the fleet worker thread — the
            # same thread that owns every replica tracer.
            for r in self._replicas:
                if r.engine is not None \
                        and r.health.state not in ("dead",
                                                   "quarantined"):
                    r.engine.tracer.record(kind,
                                           args=(replica, str(detail)))
                    break

    def events(self) -> List[Tuple]:
        """Snapshot of the fleet lifecycle ring (oldest first)."""
        return list(self._events)

    def replica_states(self) -> List[str]:
        return [r.health.state for r in self._replicas]

    def busiest(self) -> int:
        """Index of the replica owning the most outstanding work
        (pages for paged replicas, requests otherwise; ties break low)
        — the worst-case `kill()` target the chaos demos and soaks
        use."""
        return max(self._replicas,
                   key=lambda r: (self._work_score(r), -r.idx)).idx

    def replica_digests(self) -> List[str]:
        """One `obs.digest` line per replica, prefixed with its index
        and health state — what `python -m paddle_tpu_torch.serving`
        prints."""
        from ..obs import digest
        out = []
        for r in self._replicas:
            if r.engine is None:
                out.append(f"replica {r.idx} [{r.health.state}]: (down)")
                continue
            snap = r.engine.stats()
            snap.update(r.engine.watchdog.snapshot())
            out.append(f"replica {r.idx} [{r.health.state}]: "
                       f"{digest(snap)}")
        return out

    def stats(self) -> Dict[str, float]:
        """Flat numeric dict — the fleet's stats-provider payload
        (replica engines register their own providers beside it)."""
        out: Dict[str, float] = {
            "replicas": len(self._replicas),
            "fleet_pending": len(self._pending),
            "fleet_outstanding": len(self._tracked),
            "failovers": self.failovers,
            "kills": self.kills,
            "revives": self.revives,
            "quarantines": self.quarantines,
            "canary_probes": self.canary_probes,
            "canary_ok": self.canary_ok,
            "canary_failed": self.canary_failed,
            "requests_readmitted": self.requests_readmitted,
            "requests_resubmitted": self.requests_resubmitted,
            "routed_affinity": self.routed_affinity,
            "routed_spill": self.routed_spill,
            "handoffs": self.handoffs,
            "handoff_pages_moved": self.handoff_pages_moved,
            "routed_role_spill": self.routed_role_spill,
            "replicas_added": self.replicas_added,
            "replicas_retired": self.replicas_retired,
            "scale_failures": self.scale_failures,
            "requests_drained": self.requests_drained,
            "routed_tier": self.routed_tier,
            "tier_handoffs": self.tier_handoffs,
        }
        if self._kv_tier is not None:
            for k, v in self._kv_tier.stats().items():
                out[f"kv_tier_{k}"] = v
        for state in REPLICA_STATES:
            out[f"replicas_{state}"] = sum(
                1 for r in self._replicas if r.health.state == state)
        for role in ("prefill", "decode", "mixed"):
            out[f"replicas_role_{role}"] = sum(
                1 for r in self._replicas if r.role == role)
        return out

    def to_prometheus(self) -> str:
        """One scrape for the whole fleet: fleet-level typed families
        (`paddle_tpu_fleet_*`) plus every live replica's engine metrics
        re-rendered as `paddle_tpu_replica_*{replica="i"}` gauges (the
        same always-gauge rationale as `registry_exposition` — a
        snapshot dict carries no type metadata). Round-trips the strict
        parser; `python -m paddle_tpu_torch.serving` asserts it before
        FLEET.json lands."""
        from ..obs.prometheus import (Family, render_families,
                                      sanitize_metric_name)
        ns = "paddle_tpu_fleet"
        fams: List[Family] = []

        def counter(key, value, help_text):
            fams.append(Family(f"{ns}_{key}_total", "counter",
                               help_text).add(value))

        counter("failovers", self.failovers,
                "replica drains that re-admitted work to peers")
        counter("kills", self.kills, "unclean replica deaths")
        counter("revives", self.revives, "replica restarts")
        counter("quarantines", self.quarantines,
                "replicas taken out of rotation by health scoring")
        counter("canary_probes", self.canary_probes,
                "half-open canary requests launched")
        counter("canary_failures", self.canary_failed,
                "canaries that re-quarantined their replica")
        counter("requests_readmitted", self.requests_readmitted,
                "failover re-admissions that preserved emitted tokens")
        counter("requests_resubmitted", self.requests_resubmitted,
                "failover restarts (request postdated the snapshot)")
        counter("routed_affinity", self.routed_affinity,
                "requests routed by prefix affinity")
        counter("routed_spill", self.routed_spill,
                "affinity picks overridden by load (spilled to "
                "least-loaded)")
        counter("handoffs", self.handoffs,
                "prefill->decode request handoffs (role "
                "disaggregation)")
        counter("handoff_pages_moved", self.handoff_pages_moved,
                "KV pages carried by device-page handoffs (paged "
                "layout; 0 means the re-prefill path)")
        counter("routed_role_spill", self.routed_role_spill,
                "requests placed on an off-role replica because no "
                "role-matching replica could admit")
        counter("replicas_added", self.replicas_added,
                "scale-out spawns that completed (canary admitted)")
        counter("replicas_retired", self.replicas_retired,
                "scale-in drains completed (slot removed)")
        counter("scale_failures", self.scale_failures,
                "replica spawns that failed (size kept, no client "
                "impact)")
        counter("requests_drained", self.requests_drained,
                "salt-preserving scale-in moves (unqueue/extract -> "
                "adopt)")
        counter("routed_tier", self.routed_tier,
                "affinity picks neutralized by a fleet KV-tier "
                "prefix hit (least-loaded placement instead)")
        counter("tier_handoffs", self.tier_handoffs,
                "handoff/drain KV payloads staged through the fleet "
                "KV tier instead of riding the adoption dict")
        if self._kv_tier is not None:
            ts = self._kv_tier.stats()
            for key in ("publishes", "evictions", "spills",
                        "handoffs_in", "handoffs_out"):
                counter(f"kv_tier_{key}", ts[key],
                        "fleet KV tier lifetime counter")
            for key in ("chunks_ram", "chunks_disk", "bytes_ram",
                        "bytes_disk", "handoffs_open"):
                fams.append(Family(f"{ns}_kv_tier_{key}", "gauge",
                                   "fleet KV tier occupancy")
                        .add(ts[key]))
        fams.append(Family(f"{ns}_replicas", "gauge",
                           "current replica slots (any state)")
                    .add(len(self._replicas)))
        fams.append(Family(f"{ns}_pending", "gauge",
                           "requests waiting for any replica")
                    .add(len(self._pending)))
        if self._autoscaler is not None:
            # the controller contributes its own families to the same
            # scrape (duck-typed: fleet.py never imports autoscale.py)
            fams.extend(self._autoscaler.prom_families())
        state = Family(f"{ns}_replica_state", "gauge",
                       "one-hot replica health state")
        outst = Family(f"{ns}_replica_outstanding", "gauge",
                       "fleet-tracked requests owned by the replica")
        for r in self._replicas:
            lab = {"replica": str(r.idx)}
            for s in REPLICA_STATES:
                state.add(1.0 if r.health.state == s else 0.0,
                          {**lab, "state": s})
            outst.add(len(r.outstanding), lab)
        fams.extend([state, outst])
        per_key: Dict[str, Family] = {}
        for r in self._replicas:
            if r.engine is None:
                continue
            snap = r.engine.stats()
            snap.update(r.engine.watchdog.snapshot())
            for key in sorted(snap):
                val = snap[key]
                if not isinstance(val, (int, float)) \
                        or isinstance(val, bool):
                    continue
                name = f"paddle_tpu_replica_{sanitize_metric_name(key)}"
                fam = per_key.get(name)
                if fam is None:
                    fam = per_key[name] = Family(
                        name, "gauge",
                        "replica engine metric (see replica label)")
                fam.add(float(val), {"replica": str(r.idx)})
        fams.extend(per_key[n] for n in sorted(per_key))
        return render_families(fams)

    def export_trace(self, path: Optional[str] = None) -> Dict:
        """Perfetto trace of the whole fleet: one PROCESS per replica
        (its engine's slot/queue tracks, archived rings from retired
        engines merged in) plus a fleet process whose track carries
        kill/revive/quarantine/canary/failover instants — the timeline
        that shows a failover as: instants on the fleet track, spans
        stopping on the dead replica's tracks, and the same rids'
        spans resuming on a peer's."""
        import json as _json

        from ..obs.trace import export_chrome_trace
        events: List[Dict] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "fleet (health/failover)"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
             "args": {"name": "fleet events"}},
        ]
        for ts, kind, replica, detail in self._events:
            ev = {"ph": "i", "s": "t", "pid": 1, "tid": 0,
                  "ts": ts * 1e6,
                  "name": f"{kind} r{replica}" if replica >= 0 else kind}
            if detail:
                ev["args"] = {"detail": detail}
            events.append(ev)
        for r in self._replicas:
            ring = list(r.archived_events)
            if r.engine is not None:
                ring.extend(r.engine.tracer.events())
            sub = export_chrome_trace(ring)
            for ev in sub["traceEvents"]:
                ev = dict(ev)
                ev["pid"] = 2 + r.idx
                if ev.get("name") == "process_name":
                    ev["args"] = {"name": f"replica {r.idx}"}
                events.append(ev)
        trace = {"traceEvents": events, "displayTimeUnit": "ms",
                 "otherData": {"source": "paddle_tpu_torch.serving.fleet",
                               "replicas": len(self._replicas),
                               "fleet_events": len(self._events)}}
        if path is not None:
            with open(path, "w") as f:
                _json.dump(trace, f)
        return trace
