"""Elastic job supervision: heartbeats, failure detection, gang relaunch.
The counterpart of `paddle_tpu/parallel/elastic.py`, a copy over the
standard library.

Reference: `python/paddle/distributed/fleet/elastic/manager.py:130`
(ElasticManager: etcd membership + heartbeats, watch for scale/fault,
endpoint rewrite, relaunch) and `elastic/__init__.py` (enter/exit loop).

Design: collective jobs cannot survive a member loss mid-step (the
reference relaunches the whole collective gang too), so elasticity =
fast failure DETECTION + gang RESTART + checkpoint RESUME:

- Workers run a `Heartbeat` thread writing `{dir}/hb.{rank}` (mtime is
  the liveness signal — a shared filesystem replaces etcd).
- The `ElasticController` (parent of the gang, the elastic-manager
  analog) polls child exit codes and heartbeat freshness. A non-zero
  exit, a stale heartbeat, or a hung rendezvous kills the gang and
  relaunches it with REWRITTEN ENDPOINTS — a fresh coordinator port per
  incarnation so TIME_WAIT/half-open sockets from the dead gang can't
  poison the new one (the gloo store of `parallel.env`).
  PTPU_ELASTIC_INCARNATION tells workers which attempt they are.
  Workers spawn through `launch.build_worker_env`; with `timeout` set
  the whole supervision gives up (the gang killed, 124) after that
  many seconds.
- Training resumes from the last `AutoCheckpoint` step
  (framework/auto_checkpoint.py), giving loss-continuous recovery.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Heartbeat", "ElasticController"]


class Heartbeat:
    """Worker-side liveness beacon: touches `{dir}/hb.{rank}` every
    `interval` seconds from a daemon thread (reference ElasticManager
    heartbeat thread, manager.py)."""

    def __init__(self, directory: Optional[str] = None,
                 rank: Optional[int] = None, interval: float = 2.0,
                 progress_timeout: Optional[float] = None):
        self.directory = directory or os.environ.get("PTPU_HEARTBEAT_DIR")
        self.rank = rank if rank is not None else int(
            os.environ.get("PTPU_PROCESS_ID", "0"))
        self.interval = interval
        # progress watchdog: with progress_timeout set, the beacon thread
        # stops beating when notify() hasn't been called for that long —
        # so a hung MAIN thread (deadlocked collective) goes stale even
        # though this daemon thread is alive. Without it, beats attest
        # process liveness only (exit-code detection covers deaths).
        self.progress_timeout = progress_timeout
        self._last_notify = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def path(self) -> Optional[str]:
        if not self.directory:
            return None
        return os.path.join(self.directory, f"hb.{self.rank}")

    def beat_once(self):
        if not self.directory:
            return
        os.makedirs(self.directory, exist_ok=True)
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    def start(self) -> "Heartbeat":
        if not self.directory:
            return self  # not under elastic supervision: no-op
        self.beat_once()

        def loop():
            while not self._stop.wait(self.interval):
                if self.progress_timeout is not None and \
                        time.time() - self._last_notify > \
                        self.progress_timeout:
                    continue  # main thread stopped progressing: go stale
                try:
                    self.beat_once()
                except OSError:
                    pass  # fs hiccup: missing a beat is survivable

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="ptpu-heartbeat")
        self._thread.start()
        return self

    def notify(self):
        """Mark training progress (call once per step when using the
        progress watchdog)."""
        self._last_notify = time.time()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.interval + 1)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ElasticController:
    """Gang supervisor: spawn N ranks, watch, relaunch on failure.

    Detection signals (any one triggers a gang restart):
    - a rank exits non-zero
    - a rank's heartbeat file goes stale for > heartbeat_timeout
      (hang/livelock detection — exit codes can't catch those)

    Endpoint rewrite: incarnation i uses coordinator port base+i.

    np-range elasticity (reference elastic/manager.py:465
    `_update_elastic_scale_out` / :486 `_update_elastic_scale_in`): with
    `np_range=(min_np, max_np)` the gang can RESIZE instead of dying:

    - A rank slot that fails `permanent_after` consecutive incarnations
      is declared permanently lost (the dead-host analog: in a real
      deployment rank slots bind to hosts via the hostfile, so the same
      slot failing repeatedly means its host is gone). The controller
      relaunches the gang at `nproc - dead` — down to min_np — and the
      workers resume from the AutoCheckpoint on a rebuilt, smaller mesh
      (the checkpoint holds whole tensors, whatever the mesh).
    - `{control_dir}/np_request` holding an integer requests an
      explicit resize (the etcd np-watch analog): the controller
      gracefully kills the gang and relaunches at the requested size,
      clamped to np_range. Requested resizes consume no restart budget.
    """

    def __init__(self, script: str, script_args: Optional[List[str]] = None,
                 nproc: int = 1, master: str = "127.0.0.1:9500",
                 devices_per_proc: int = 0, log_dir: Optional[str] = None,
                 max_restarts: int = 3, heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout: float = 60.0, poll_interval: float = 0.5,
                 np_range: Optional[tuple] = None, permanent_after: int = 2,
                 control_dir: Optional[str] = None,
                 timeout: Optional[float] = None):
        self.script = script
        self.script_args = list(script_args or [])
        self.nproc = nproc
        host, _, port = master.rpartition(":")
        self.host = host or "127.0.0.1"
        self.base_port = int(port)
        self.devices_per_proc = devices_per_proc
        self.log_dir = log_dir
        self.max_restarts = max_restarts
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_timeout = heartbeat_timeout
        self.poll_interval = poll_interval
        self.incarnation = 0
        self.restarts = 0
        if np_range is not None:
            lo, hi = np_range
            if not (1 <= lo <= nproc <= hi):
                raise ValueError(
                    f"np_range {np_range} must satisfy "
                    f"1 <= min <= nproc({nproc}) <= max")
        self.np_range = np_range
        self.permanent_after = permanent_after
        self.control_dir = control_dir
        self.timeout = timeout
        # slot ids persist across resizes: slot -> host binding comes
        # from the launcher's hostfile ordering, so shrinking must drop
        # exactly the DEAD slots (not renumber from the top) and the
        # workers see their slot via PTPU_SLOT_ID. Strikes are
        # per-slot; survivors keep their identity (and their zero
        # strike count) across a shrink.
        self._slots: List[int] = list(range(nproc))
        self._strikes: Dict[int, int] = {s: 0 for s in self._slots}
        self.resizes: List[tuple] = []  # (incarnation, old_np, new_np)
        self.lost_slots: List[int] = []

    # --- gang lifecycle ------------------------------------------------------
    def _endpoints(self) -> str:
        return f"{self.host}:{self.base_port + self.incarnation}"

    def _spawn_gang(self) -> List[subprocess.Popen]:
        from .launch import build_worker_env
        procs = []
        master = self._endpoints()
        for rank in range(self.nproc):
            extra = {"PTPU_ELASTIC_INCARNATION": str(self.incarnation),
                     "PTPU_SLOT_ID": str(self._slots[rank])}
            if self.heartbeat_dir:
                extra["PTPU_HEARTBEAT_DIR"] = self.heartbeat_dir
            env = build_worker_env(rank, self.nproc, master,
                                   self.devices_per_proc, extra)
            stdout = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                stdout = open(os.path.join(
                    self.log_dir,
                    f"worker.{rank}.i{self.incarnation}.log"), "w")
            try:
                procs.append(subprocess.Popen(
                    [sys.executable, self.script] + self.script_args,
                    env=env, stdout=stdout,
                    stderr=subprocess.STDOUT if stdout else None))
            finally:
                if stdout is not None:
                    stdout.close()  # child inherited its own copy
        return procs

    def _kill_gang(self, procs: List[subprocess.Popen]):
        from .launch import stop_all
        stop_all(procs)

    def _stale_ranks(self, since: float,
                     codes: Optional[List[Optional[int]]] = None
                     ) -> List[int]:
        if not self.heartbeat_dir:
            return []
        now = time.time()
        stale = []
        for rank in range(self.nproc):
            if codes is not None and codes[rank] == 0:
                continue  # finished cleanly — of course it stopped beating
            path = os.path.join(self.heartbeat_dir, f"hb.{rank}")
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                mtime = since  # never beat yet: measure from gang start
            if now - max(mtime, since) > self.heartbeat_timeout:
                stale.append(rank)
        return stale

    # --- np-range elasticity -------------------------------------------------
    def _np_request(self) -> Optional[int]:
        """Pending explicit resize request, clamped to np_range. A
        request that is unusable or already satisfied is CONSUMED (else
        a stale file would re-fire after a later unrelated resize).
        Writers should publish atomically (write a temp file, then
        rename); as a second line of defense a file younger than one
        settle interval is left for the next poll, so a non-atomic
        multi-digit write isn't read half-done."""
        if not self.control_dir:
            return None
        path = os.path.join(self.control_dir, "np_request")
        try:
            settle = max(0.5, self.poll_interval)
            if time.time() - os.path.getmtime(path) < settle:
                return None  # possibly still being written
            with open(path) as f:
                raw = f.read().strip()
        except OSError:
            return None
        try:
            want = int(raw)
        except ValueError:
            # malformed request: CONSUME it (per the contract above —
            # otherwise the dead file re-parses on every poll forever)
            # and tell the operator why nothing resized
            print(f"[elastic] ignoring malformed np_request "
                  f"{raw!r} (want an integer)", file=sys.stderr)
            self._consume_np_request()
            return None
        if not self.np_range:
            print("[elastic] ignoring np_request: controller has no "
                  "np_range", file=sys.stderr)
            self._consume_np_request()
            return None
        lo, hi = self.np_range
        want = max(lo, min(hi, want))
        if want == self.nproc:
            self._consume_np_request()
            return None
        return want

    def _consume_np_request(self):
        try:
            os.remove(os.path.join(self.control_dir, "np_request"))
        except OSError:
            pass

    def _resize(self, new_slots: List[int], reason: str):
        old = self.nproc
        self._slots = new_slots
        self.nproc = len(new_slots)
        self._strikes = {s: self._strikes.get(s, 0) for s in new_slots}
        self.resizes.append((self.incarnation + 1, old, self.nproc))
        print(f"[elastic] resizing gang {old} -> {self.nproc} "
              f"(slots {new_slots}: {reason})", file=sys.stderr)

    def _account_failure(self, culprits: List[int]) -> Optional[str]:
        """Strike the culprit SLOTS; shrink past permanently-lost ones
        (keeping healthy slots' identities — the slot -> host binding
        means dropping the wrong slot would keep the dead host in the
        gang). Returns an error string when the job cannot continue."""
        culprit_slots = {self._slots[r] for r in culprits}
        for s in self._slots:
            if s in culprit_slots:
                self._strikes[s] += 1
            else:
                self._strikes[s] = 0  # healthy this incarnation
        dead = sorted(s for s in culprit_slots
                      if self._strikes[s] >= self.permanent_after)
        if not dead:
            return None
        if not self.np_range:
            return None  # fixed-size job: keep relaunching at nproc
        survivors = [s for s in self._slots if s not in dead]
        if len(survivors) < self.np_range[0]:
            return (f"slot(s) {dead} permanently lost; np "
                    f"{len(survivors)} would fall below min_np "
                    f"{self.np_range[0]}")
        self.lost_slots.extend(dead)
        self._resize(survivors,
                     f"slot(s) {dead} failed {self.permanent_after} "
                     f"incarnations in a row — treating as permanent "
                     f"loss")
        return None

    # --- main loop -----------------------------------------------------------
    def run(self) -> int:
        deadline = None if self.timeout is None else \
            time.time() + self.timeout
        while True:
            started = time.time()
            procs = self._spawn_gang()
            failure: Optional[str] = None
            culprits: List[int] = []
            resize_req: Optional[int] = None
            while True:
                codes = [p.poll() for p in procs]
                if any(c not in (None, 0) for c in codes):
                    culprits = [i for i, c in enumerate(codes)
                                if c not in (None, 0)]
                    failure = (f"rank(s) {culprits} exited non-zero "
                               f"({codes})")
                    break
                if all(c == 0 for c in codes):
                    return 0  # clean finish
                stale = self._stale_ranks(started, codes)
                if stale:
                    culprits = stale
                    failure = (f"rank(s) {stale} heartbeat stale "
                               f">{self.heartbeat_timeout}s")
                    break
                resize_req = self._np_request()
                if resize_req is not None:
                    failure = f"np_request -> {resize_req}"
                    break
                if deadline is not None and time.time() > deadline:
                    self._kill_gang(procs)
                    print(f"[elastic] gave up after {self.timeout} s",
                          file=sys.stderr)
                    return 124
                time.sleep(self.poll_interval)

            self._kill_gang(procs)
            if resize_req is not None:
                # explicit scale-out/in: graceful, no restart budget.
                # Shrink drops the highest slots; growth mints fresh
                # slot ids (new hosts, never a previously-lost id)
                self._consume_np_request()
                slots = self._slots[:resize_req]
                nxt = max(self._slots + self.lost_slots, default=-1) + 1
                while len(slots) < resize_req:
                    slots.append(nxt)
                    nxt += 1
                self._resize(slots, "np_request")
            else:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    print(f"[elastic] {failure}; restart budget "
                          f"({self.max_restarts}) exhausted",
                          file=sys.stderr)
                    return 1
                err = self._account_failure(culprits)
                if err:
                    print(f"[elastic] {err}; giving up", file=sys.stderr)
                    return 1
            self.incarnation += 1
            print(f"[elastic] {failure}; relaunching gang "
                  f"(np={self.nproc}, incarnation {self.incarnation}, "
                  f"endpoints {self._endpoints()})", file=sys.stderr)
