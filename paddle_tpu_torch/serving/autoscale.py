"""SLO-driven fleet autoscaling: elastic replica counts on
preemptible capacity.

The port of `paddle_tpu/serving/autoscale.py`, duck-typed against the
port's `EngineFleet` (neither module imports the other). The unit of
scale is a replica, which under `tp=k` is a TP group of k ranks
(`EngineFleet._build_engine` gives a new replica the next group's
ranks), so the policy's `min_replicas` / `max_replicas` count groups
(the reference's `--max-replicas`, `paddle_tpu/serving/server.py:1722`).
Three pieces, smallest-surface-first:

- `ScaleSignals` — one frozen reading of the fleet's load: backlog per
  serving replica (fleet pending + engine queues), occupancy (KV page
  pressure under the paged layout, slot occupancy otherwise, 0..1),
  and the lifetime queue-wait / TTFT p99s. Everything the controller
  acts on is already emitted by the serving stack — the autoscaler
  adds no new instrumentation to the hot path.

- `AutoscalePolicy` — the pure decision function. `decide(signals)`
  returns "out", "in", or None under HOLD-TIME HYSTERESIS: a breach
  must persist for `out_hold_s`/`in_hold_s` of wall time before it
  acts, each action opens a per-direction cooldown, and min/max
  replica bounds clamp everything. The clock is injectable so the
  policy unit-tests run on a fake clock with zero sleeps. The policy
  never touches the fleet — it sees numbers, returns a word.

- `FleetAutoscaler` — binds a policy to an `EngineFleet`. The fleet
  calls `tick()` at the end of every `step()` ON THE THREAD THAT OWNS
  THE FLEET (see `EngineFleet.attach_autoscaler`), so the controller
  reads signals, runs the heartbeat watchdog, and applies resize
  verbs with no locking — it only ever executes between replica
  steps, exactly like an operator calling `kill()`/`revive()` from
  the worker. The watchdog is the JAX package's stale-rank detection
  (`parallel/elastic.py`) at serving scale: every live replica refreshes
  `last_beat` once per fleet round (suppressed by the
  `replica_heartbeat` fault point); a beat staler than
  `heartbeat_timeout_s` declares the replica PREEMPTED — `kill()`
  fails its work over through the standard adoption path,
  `remove_dead()` drops the slot, and `add_replica()` spawns the
  replacement (which re-admits through the half-open canary, warming
  its CUDA graphs before it takes traffic).

Signal → action contract:

    backlog/replica >= out_backlog  ─┐ either, held out_hold_s,
    occupancy      >= out_pressure  ─┘ size < max  → scale OUT
    backlog/replica <= in_backlog   ─┐ both, held in_hold_s,
    occupancy      <= in_pressure   ─┘ serving > min → scale IN
    stale heartbeat / dead replica  → kill + replace (no hysteresis:
                                      preemption is not load)

Scale-in picks the least-loaded serving replica and retires it
through `EngineFleet.retire_replica` — the graceful drain whose moved
streams stay bit-identical (`keep_salt`); a failed scale-out spawn
(`replica_spawn` fault) degrades to the current size and retries
after the cooldown, never surfacing to a client.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["ScaleSignals", "AutoscalePolicy", "FleetAutoscaler"]


@dataclasses.dataclass(frozen=True)
class ScaleSignals:
    """One reading of the fleet, in the units the policy thinks in."""
    replicas_serving: int      # taking traffic (healthy | suspect)
    replicas_total: int        # every slot, any state
    backlog: float             # waiting requests per serving replica
    occupancy: float           # 0..1 memory/slot pressure (peak over
    #                            serving replicas — one full replica
    #                            is a capacity problem even if a peer
    #                            idles; the router already levels what
    #                            can be leveled)
    queue_wait_p99_s: float = 0.0   # lifetime tails: secondary,
    ttft_p99_s: float = 0.0         # logged with every decision


class AutoscalePolicy:
    """Hysteresis'd threshold policy over `ScaleSignals`.

    Deliberately boring: thresholds + hold times + cooldowns + bounds.
    The flap-suppression story is structural, not tuned — a breach
    must HOLD for `*_hold_s` (a one-round spike does nothing), any
    action opens that direction's cooldown, and the opposite signal
    resets the hold timer, so oscillating load lands in the dead band
    between `in_*` and `out_*` thresholds and the size stays put."""

    def __init__(self,
                 min_replicas: int = 1,
                 max_replicas: int = 4,
                 out_backlog: float = 2.0,
                 in_backlog: float = 0.25,
                 out_pressure: float = 0.85,
                 in_pressure: float = 0.30,
                 out_hold_s: float = 0.5,
                 in_hold_s: float = 2.0,
                 out_cooldown_s: float = 1.0,
                 in_cooldown_s: float = 3.0,
                 clock=time.monotonic):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas ({max_replicas}) < "
                             f"min_replicas ({min_replicas})")
        if in_backlog > out_backlog or in_pressure > out_pressure:
            # an inverted dead band scales in and out on the SAME
            # reading — the flap the hysteresis exists to prevent
            raise ValueError("scale-in thresholds must sit at or "
                             "below scale-out thresholds")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.out_backlog = float(out_backlog)
        self.in_backlog = float(in_backlog)
        self.out_pressure = float(out_pressure)
        self.in_pressure = float(in_pressure)
        self.out_hold_s = float(out_hold_s)
        self.in_hold_s = float(in_hold_s)
        self.out_cooldown_s = float(out_cooldown_s)
        self.in_cooldown_s = float(in_cooldown_s)
        self._clock = clock
        self._out_since: Optional[float] = None
        self._in_since: Optional[float] = None
        self._last_out_t: Optional[float] = None
        self._last_in_t: Optional[float] = None

    # ------------------------------------------------------------------ #
    def _wants_out(self, s: ScaleSignals) -> bool:
        return (s.backlog >= self.out_backlog
                or s.occupancy >= self.out_pressure)

    def _wants_in(self, s: ScaleSignals) -> bool:
        # BOTH low: a drained queue with packed KV is not idle
        return (s.backlog <= self.in_backlog
                and s.occupancy <= self.in_pressure)

    def decide(self, s: ScaleSignals) -> Optional[str]:
        """"out", "in", or None. Pure w.r.t. the fleet; stateful only
        in its own hold/cooldown clocks. Call `note_action()` after
        actually applying (or attempting) a decision — `decide()`
        itself never starts a cooldown, so a caller that could not
        act (e.g. no drainable victim) is not locked out."""
        now = self._clock()
        out_ok = s.replicas_total < self.max_replicas
        in_ok = s.replicas_serving > self.min_replicas
        if self._wants_out(s):
            self._in_since = None
            if not out_ok:
                self._out_since = None
                return None
            if self._out_since is None:
                self._out_since = now
            if now - self._out_since < self.out_hold_s:
                return None
            if self._last_out_t is not None \
                    and now - self._last_out_t < self.out_cooldown_s:
                return None
            return "out"
        if self._wants_in(s):
            self._out_since = None
            if not in_ok:
                self._in_since = None
                return None
            if self._in_since is None:
                self._in_since = now
            if now - self._in_since < self.in_hold_s:
                return None
            if self._last_in_t is not None \
                    and now - self._last_in_t < self.in_cooldown_s:
                return None
            return "in"
        # dead band: neither side holds, both timers reset
        self._out_since = None
        self._in_since = None
        return None

    def note_action(self, direction: str):
        """Record that a decision was applied (or attempted — a failed
        spawn still burns the cooldown, which is what rate-limits
        retries against a persistently failing capacity grant)."""
        now = self._clock()
        if direction == "out":
            self._last_out_t = now
            self._out_since = None
        else:
            self._last_in_t = now
            self._in_since = None


class FleetAutoscaler:
    """The controller: signals in, resize verbs out, on the fleet's
    own thread (every `tick()` happens inside `EngineFleet.step()` —
    see `attach_autoscaler`). Construct it AFTER the fleet and attach:

        fleet = EngineFleet(model, replicas=1, ...)
        scaler = FleetAutoscaler(fleet,
                                 AutoscalePolicy(min_replicas=1,
                                                 max_replicas=4))

    `attach=False` leaves the binding to the caller (tests drive
    `tick()` by hand)."""

    def __init__(self, fleet,
                 policy: Optional[AutoscalePolicy] = None,
                 heartbeat_timeout_s: float = 2.0,
                 clock=time.monotonic,
                 attach: bool = True):
        if heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be > 0")
        self.fleet = fleet
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._clock = clock
        self.ticks = 0
        self.scale_outs = 0            # add_replica calls that spawned
        self.scale_ins = 0             # retire_replica drains begun
        self.scale_out_failures = 0    # spawns that degraded (size kept)
        self.preemptions_detected = 0  # watchdog kills + replacements
        # (ts, kind, detail) — the controller's own decision log;
        # kinds: scale_out / scale_in / preempt / scale_failure
        self._events: collections.deque = collections.deque(maxlen=256)
        self._last_signals: Optional[ScaleSignals] = None
        if attach:
            fleet.attach_autoscaler(self)

    # ------------------------------------------------------------------ #
    # signal ingestion
    # ------------------------------------------------------------------ #
    def read_signals(self) -> ScaleSignals:
        """One fleet reading. Backlog counts everything WAITING (the
        fleet's pending queue plus every serving replica's bounded
        queue) per serving replica; occupancy is the PEAK serving
        replica's memory pressure — pages held over pool size under
        the paged layout, active slots over max_slots otherwise."""
        fleet = self.fleet
        serving = fleet._serving_replicas()
        waiting = len(fleet._pending)
        occ = 0.0
        qw = p99 = 0.0
        for r in serving:
            eng = r.engine
            waiting += eng.pending
            # admission needs BOTH a free decode lane and (paged) real
            # pages, so pressure is the max of the two. Lane pressure
            # is `slot_occupancy` for every layout; paged page
            # pressure is pages actually HELD over the pool (minus
            # the reserved trash page) — not `page_load()`, which
            # adds the queue's reserved spans (can exceed the pool,
            # and is already what `backlog` measures). Idle cached
            # prefixes are reclaimable on demand: an asset, not
            # pressure — counting them would pin the occupancy of a
            # drained fleet above the scale-in threshold forever.
            occ = max(occ, eng.metrics.slot_occupancy)
            if eng.paged:
                pool = eng.cache.pool
                total = max(1, pool.num_pages - pool.reserved)
                reclaim = (eng.prefix.reclaimable_pages()
                           if eng.prefix is not None else 0)
                occ = max(occ, max(0, pool.pages_used - pool.reserved
                                   - reclaim) / total)
            qw = max(qw, eng.metrics.queue_wait.quantile(0.99))
            p99 = max(p99, eng.metrics.ttft.quantile(0.99))
        sig = ScaleSignals(
            replicas_serving=len(serving),
            replicas_total=len(fleet._replicas),
            backlog=waiting / max(1, len(serving)),
            occupancy=occ,
            queue_wait_p99_s=qw,
            ttft_p99_s=p99)
        self._last_signals = sig
        return sig

    # ------------------------------------------------------------------ #
    # the per-step hook
    # ------------------------------------------------------------------ #
    def tick(self):
        """Watchdog first (preemption is not load — it bypasses the
        policy entirely), then one policy decision, then apply."""
        self.ticks += 1
        self._watchdog()
        sig = self.read_signals()
        decision = self.policy.decide(sig)
        if decision == "out":
            self._scale_out("policy", sig)
        elif decision == "in":
            self._scale_in(sig)

    def _watchdog(self):
        """Stale-beat / dead-replica detection, elastic.py style: a
        replica that should be beating (it steps every round) but has
        not for `heartbeat_timeout_s` is preempted-but-not-crashed —
        `kill()` it so its work fails over from the last periodic
        snapshot. Either way the dead slot is removed and a
        replacement spawned, without operator input.

        Staleness is PEER-RELATIVE (elastic.py's stale-rank idiom):
        a beat counts as stale only against the NEWEST beat in the
        fleet, so a slow round (a step that captures graphs can take
        a second)
        ages every beat equally and flags nobody — only a replica
        falling behind peers that ARE beating is preempted. The
        degenerate all-suppressed case is indistinguishable from a
        slow loop by design; a truly hung fleet never returns from
        `step()` at all."""
        fleet = self.fleet
        live = [r for r in fleet._replicas
                if r.health.state not in ("quarantined", "dead")]
        if len(live) > 1:
            ref = max(r.last_beat for r in live)
            for r in live:
                if ref - r.last_beat >= self.heartbeat_timeout_s:
                    self.preemptions_detected += 1
                    self._note("preempt", f"r{r.idx} beat stale "
                                          f"{ref - r.last_beat:.2f}s")
                    fleet._fleet_event("preempt", r.idx,
                                       "stale_heartbeat")
                    fleet.kill(r.idx)
        for r in [x for x in list(fleet._replicas)
                  if x.health.state == "dead"]:
            # replace rather than revive: on preemptible capacity the
            # hardware behind a dead replica is gone — the replacement
            # builds on whatever device group comes next
            role = r.role
            fleet.remove_dead(r.idx)
            self._scale_out(f"replace r{r.idx}", None, role=role)

    def _scale_out(self, why: str, sig: Optional[ScaleSignals],
                   role: str = "mixed"):
        idx = self.fleet.add_replica(role=role)
        self.policy.note_action("out")
        if idx < 0:
            self.scale_out_failures += 1
            self._note("scale_failure", why)
            return
        self.scale_outs += 1
        self._note("scale_out", f"r{idx} ({why})"
                   + (f" backlog={sig.backlog:.1f}"
                      f" occ={sig.occupancy:.2f}" if sig else ""))

    def _scale_in(self, sig: ScaleSignals):
        fleet = self.fleet
        serving = fleet._serving_replicas()
        if len(serving) <= self.policy.min_replicas:
            return
        # least-loaded victim: cheapest drain, and its requests land
        # on peers that were already busier — the router would have
        # kept starving it anyway
        victim = min(serving, key=lambda r: (fleet._work_score(r),
                                             -r.idx))
        fleet.retire_replica(victim.idx)
        self.policy.note_action("in")
        self.scale_ins += 1
        self._note("scale_in", f"r{victim.idx} backlog={sig.backlog:.2f}"
                               f" occ={sig.occupancy:.2f}")

    def _note(self, kind: str, detail: str):
        self._events.append((self._clock(), kind, detail))

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def events(self) -> List[Tuple]:
        """Decision log, oldest first: (ts, kind, detail)."""
        return list(self._events)

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "autoscaler_ticks": self.ticks,
            "autoscaler_scale_outs": self.scale_outs,
            "autoscaler_scale_ins": self.scale_ins,
            "autoscaler_scale_out_failures": self.scale_out_failures,
            "autoscaler_preemptions": self.preemptions_detected,
            "autoscaler_min_replicas": self.policy.min_replicas,
            "autoscaler_max_replicas": self.policy.max_replicas,
        }
        if self._last_signals is not None:
            s = self._last_signals
            out["autoscaler_backlog"] = s.backlog
            out["autoscaler_occupancy"] = s.occupancy
        return out

    def prom_families(self):
        """Typed families for the fleet's `/metrics` scrape —
        `EngineFleet.to_prometheus` appends these (duck-typed, so this
        module imports nothing from fleet.py and vice versa)."""
        from ..obs.prometheus import Family
        ns = "paddle_tpu_autoscaler"
        fams = [
            Family(f"{ns}_scale_outs_total", "counter",
                   "replicas spawned by the controller").add(
                self.scale_outs),
            Family(f"{ns}_scale_ins_total", "counter",
                   "graceful drains begun by the controller").add(
                self.scale_ins),
            Family(f"{ns}_scale_out_failures_total", "counter",
                   "spawns that failed and degraded to current size"
                   ).add(self.scale_out_failures),
            Family(f"{ns}_preemptions_total", "counter",
                   "replicas declared preempted by the heartbeat "
                   "watchdog").add(self.preemptions_detected),
            Family(f"{ns}_replicas_min", "gauge",
                   "policy lower bound").add(self.policy.min_replicas),
            Family(f"{ns}_replicas_max", "gauge",
                   "policy upper bound").add(self.policy.max_replicas),
        ]
        if self._last_signals is not None:
            s = self._last_signals
            fams.append(Family(f"{ns}_backlog", "gauge",
                               "waiting requests per serving replica "
                               "(last reading)").add(s.backlog))
            fams.append(Family(f"{ns}_occupancy", "gauge",
                               "peak serving-replica memory pressure "
                               "(last reading)").add(s.occupancy))
        return fams
