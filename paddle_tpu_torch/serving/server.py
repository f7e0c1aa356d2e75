"""The HTTP front door: overload-resilient streaming serving over
`LLMEngine` / `EngineFleet`.

The port of `paddle_tpu/serving/server.py`. The reference is stdlib
asyncio over its backend; so is this module, re-pointed at the port's
engine, fleet, `obs`, `testing.faults` and `metrics`. `LLMServer`
exposes a backend to real concurrent traffic as an asyncio HTTP server
(OpenAI-style `/v1/completions` with SSE streaming, `/healthz`,
`/metrics`), and its headline is the ROBUSTNESS contract, not the
protocol:

- SHAPED OVERLOAD, not emergent. Admission goes through
  `serving/slo.py` BEFORE anything reaches the engine: per-tenant
  token budgets (token bucket: sustained rate + burst), per-tenant
  concurrent-stream caps, and a global inflight cap sized at or below
  the backend's own bounded queue. A request outside any limit is shed
  with `429` + an honest `Retry-After`; a request inside every limit
  may still queue (block-boundary admission), bounded and observable.
  The engine's `EngineOverloadError` is never the shedding mechanism a
  client sees — by construction the cap keeps the engine queue from
  overflowing, and a belt-and-braces catch converts any residue into
  the same shaped 429.
- PRIORITY ADMISSION. A tenant's `TenantPolicy.priority` stamps
  `SamplingParams.priority` on its requests, which the engine's and
  fleet's admission order honor.
- STREAMING WITHOUT NEW SYNCS. Token delivery rides the engine's
  decode-block boundary: the scheduler feeds each streamed request's
  sink from host data it already has (one event per BLOCK, never per
  token, no extra device contact), and a bounded per-request relay
  queue bridges the scheduling thread to the asyncio loop. Greedy
  token streams through the server are bit-identical to the same
  prompts through a library `generate()`.
- DISCONNECT = CANCEL. A client that goes away (socket EOF, write
  failure, the `http_write` / `client_disconnect` fault points)
  triggers `cancel(rid)` on the scheduling thread: the lane freezes,
  the KV slot frees at the next block boundary, prefix pins release.
- GRACEFUL DRAIN. SIGTERM (or `begin_drain()`) stops admission (503 +
  Retry-After), lets in-flight work finish for `drain_grace_s`, then
  `snapshot()`s whatever remains and halts the scheduler mid-state.
  Live streams get a final `drain` event carrying their request id and
  delivered-token count; after restart (`LLMEngine.resume`,
  `load_engine(prefix, snapshot=...)` or `EngineFleet.resume`) clients
  REATTACH by id (`GET /v1/completions/<rid>?from=<delivered>`) and
  receive exactly the remaining tokens.

One thread touches the device. `EngineWorker` owns the backend on its
scheduling thread; every engine call is a closure run there, and what
crosses to the event loop (`_wcall` results, relay events, the drain
snapshot) is Python data, numpy arrays and CPU tensors only. On a card
this is a requirement, not a style: every CUDA graph capture runs in
PyTorch's `global` capture mode, where a CUDA call from another thread
invalidates the capture, and an engine captures at first use, a fleet
replica at spawn, revive and failover. `LLMServer.stop` closes the
backend only after the worker has been joined. Grad mode is
thread-local: the worker thread runs with autograd enabled, and the
engine's parameters are detached views (`GPT.serving_params`), so no
operation it runs records a graph.

The drain snapshot is pickled to `drain_path` with each tensor holding
its own bytes: a parked or handed-off request's host pages are views
of one pinned gather buffer (`PagedKVCache.gather_pages`), and a view
pickles its whole storage.

Observability: the server keeps its own lifecycle ring (shed /
disconnect / drain / reattach events, `obs.LifecycleTracer` kinds) and
a per-tenant metrics surface (`requests{tenant,code}`,
`shed{tenant,reason}`, disconnects, TTFT summaries) rendered at
`/metrics` in front of the backend's own exposition — one scrape,
strict-parser clean.

`python -m paddle_tpu_torch.serving.server` runs the disconnect-and-
drain soak and writes SERVER.json (`--device cpu` for the CPU; the
default is the card); `run_soak(model, args)` is the same soak for any
model.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import concurrent.futures
import json
import math
import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..obs import LifecycleTracer
from ..obs.prometheus import Family, render_families
from ..testing import faults
from .engine import EngineOverloadError, SamplingParams
from .metrics import OnlineStat
from .slo import SLOController, TenantPolicy

__all__ = ["LLMServer", "EngineWorker", "ServerMetrics", "ServerHandle",
           "run_soak", "soak_parser"]

_DEFAULT_TENANT = "default"
# bound tenant label cardinality: a client minting a fresh tenant name
# per request must not grow the metrics surface without bound
_MAX_TENANTS = 256


def own_bytes(obj):
    """`obj` (a snapshot: nested dicts, lists and tuples) with every
    tensor that is a view into a larger storage replaced by a
    contiguous copy of its own elements, the way `kv_tier.encode_payload`
    stores each leaf's own bytes; everything else is returned as it is.
    A snapshot's host pages are views of one gather buffer per request,
    and `pickle` writes a view's whole storage."""
    if isinstance(obj, torch.Tensor):
        own = obj.numel() * obj.element_size()
        if obj.untyped_storage().nbytes() > own or \
                not obj.is_contiguous():
            return obj.clone(memory_format=torch.contiguous_format)
        return obj
    if isinstance(obj, dict):
        return {k: own_bytes(v) for k, v in obj.items()}
    if type(obj) in (list, tuple):
        return type(obj)(own_bytes(v) for v in obj)
    return obj


class _ClientGone(Exception):
    """The client disconnected (EOF, write failure, or an injected
    `http_write`/`client_disconnect` fault) — handled, never fatal."""


# --------------------------------------------------------------------------- #
# the scheduling thread
# --------------------------------------------------------------------------- #


class EngineWorker:
    """Owns the engine/fleet on ONE dedicated thread — the engines are
    deliberately not thread-safe, so every touch (submit, cancel,
    stream attach, snapshot, scrape) is a closure executed between
    `step()`s on this thread, and stream events flow OUT through
    `loop.call_soon_threadsafe`. The asyncio side never blocks on
    device work and the scheduler never waits on a socket."""

    def __init__(self, backend, idle_wait_s: float = 0.005):
        self.backend = backend
        self.idle_wait_s = float(idle_wait_s)
        self._cmds: _queue.SimpleQueue = _queue.SimpleQueue()
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="engine-worker",
                                        daemon=True)
        self.step_errors: collections.deque = collections.deque(
            maxlen=16)

    def start(self):
        self._thread.start()

    @property
    def stopped(self) -> bool:
        return self._stop_evt.is_set()

    def stop(self, join: bool = True):
        self._stop_evt.set()
        self._cmds.put(None)  # wake the idle block
        if join and self._thread.is_alive() \
                and threading.current_thread() is not self._thread:
            self._thread.join(timeout=10.0)
        if join:
            # a call() that passed the stop check just before the flag
            # was set may have enqueued AFTER the worker's own final
            # drain — fail those callers here instead of stranding
            # their futures forever
            while True:
                try:
                    item = self._cmds.get_nowait()
                except _queue.Empty:
                    break
                if item is not None and item[1] is not None:
                    item[1].set_exception(
                        RuntimeError("worker stopped"))

    def halt_from_worker(self):
        """Stop stepping, callable from a worker-thread closure — the
        drain path snapshots and halts ATOMICALLY (no block runs
        between the snapshot and the stop)."""
        self._stop_evt.set()

    def call(self, fn) -> concurrent.futures.Future:
        """Run `fn()` on the scheduling thread; the Future resolves
        with its result (or exception). Raises RuntimeError once the
        worker stopped (callers would otherwise wait forever)."""
        if self._stop_evt.is_set():
            raise RuntimeError("worker stopped")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._cmds.put((fn, fut))
        return fut

    def post(self, fn):
        """Fire-and-forget `call` (disconnect cancels, event records —
        places where the server must not wait and errors are moot).
        Silently dropped once the worker stopped."""
        if not self._stop_evt.is_set():
            self._cmds.put((fn, None))

    def _exec(self, item) -> bool:
        if item is None:
            return False
        fn, fut = item
        try:
            res = fn()
            if fut is not None:
                fut.set_result(res)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            if fut is not None:
                fut.set_exception(e)
        return True

    def _idle_step_due(self) -> bool:
        """Step an idle FLEET while any replica is mid-recovery: the
        canary state machine only advances inside `step()`."""
        states = getattr(self.backend, "replica_states", None)
        if states is None:
            return False
        try:
            return any(s in ("quarantined", "recovering")
                       for s in states())
        except Exception:  # noqa: BLE001 — recovery probe only
            return False

    def _run(self):
        while not self._stop_evt.is_set():
            while True:  # commands first: admission beats decode
                try:
                    item = self._cmds.get_nowait()
                except _queue.Empty:
                    break
                self._exec(item)
                if self._stop_evt.is_set():
                    break
            if self._stop_evt.is_set():
                break
            try:
                if self.backend.has_work():
                    self.backend.step()
                elif self._idle_step_due():
                    self.backend.step()
                    time.sleep(0.002)  # recovery tick, don't spin hot
                else:
                    self._exec(self._cmds.get(timeout=self.idle_wait_s))
            except _queue.Empty:
                pass
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — the engines keep
                # their own recovery contract; anything escaping step()
                # is recorded and the loop breathes instead of spinning
                self.step_errors.append(f"{type(e).__name__}: {e}")
                time.sleep(0.01)
        while True:  # fail leftover callers instead of hanging them
            try:
                item = self._cmds.get_nowait()
            except _queue.Empty:
                break
            if item is not None and item[1] is not None:
                item[1].set_exception(RuntimeError("worker stopped"))


# --------------------------------------------------------------------------- #
# per-stream relay (engine thread -> event loop)
# --------------------------------------------------------------------------- #


class _StreamRelay:
    """The bounded per-request event queue between the scheduling
    thread and one HTTP response. The engine-side sink is hot-path
    cheap (one `call_soon_threadsafe` per decode block); the loop side
    dedups by cumulative token index so replays (attach, failover
    re-attach, resume after drain) never duplicate what the client
    already has."""

    __slots__ = ("rid", "delivered", "maxsize", "overflowed", "queue",
                 "_loop")

    def __init__(self, loop, maxsize: int = 1024, delivered: int = 0):
        self.rid = -1
        self.delivered = int(delivered)  # cumulative tokens sent
        self.maxsize = int(maxsize)
        self.overflowed = False
        self.queue: asyncio.Queue = asyncio.Queue()
        self._loop = loop

    def sink(self, kind: str, *payload):
        """ENGINE THREAD. Forward one stream event to the loop."""
        try:
            self._loop.call_soon_threadsafe(self._push, kind, payload)
        except RuntimeError:
            pass  # loop closed mid-shutdown: the stream is gone anyway

    def _push(self, kind: str, payload: Tuple):
        if kind == "tokens" and self.queue.qsize() >= self.maxsize:
            # a client too slow to drain its bounded buffer loses the
            # stream, not the engine: the pump sees `overflowed` and
            # ends the response (the request itself keeps generating
            # until the server cancels it)
            self.overflowed = True
            kind, payload = "overflow", ()
        self.queue.put_nowait((kind, payload))

    def push_local(self, kind: str, payload: Tuple = ()):
        """LOOP THREAD. Server-originated events (drain, replaced)."""
        self.queue.put_nowait((kind, payload))

    def fresh(self, start: int, toks: List[int]) -> List[int]:
        """Dedup one tokens event against what this client already
        has; advances the delivered watermark."""
        cut = max(0, self.delivered - int(start))
        out = list(toks[cut:])
        self.delivered = max(self.delivered, int(start) + len(toks))
        return out


# --------------------------------------------------------------------------- #
# server metrics (per-tenant labeled families)
# --------------------------------------------------------------------------- #


class ServerMetrics:
    """The front door's own counters, beside (never instead of) the
    backend's engine/fleet surfaces. Per-tenant labels are the point:
    overload must be attributable to WHO, not just how much."""

    def __init__(self):
        self.requests: Dict[Tuple[str, int], int] = {}   # (tenant, code)
        self.shed: Dict[Tuple[str, str], int] = {}       # (tenant, why)
        self.disconnects: Dict[str, int] = {}
        self.tokens_streamed: Dict[str, int] = {}
        self.ttft: Dict[str, OnlineStat] = {}
        self.reattached_streams = 0
        self.drain_events = 0
        self.draining = 0
        self._tenants: set = set()

    def _t(self, tenant: str) -> str:
        if tenant in self._tenants or len(self._tenants) < _MAX_TENANTS:
            self._tenants.add(tenant)
            return tenant
        return "_other"  # cardinality bound: see _MAX_TENANTS

    def on_request(self, tenant: str, code: int):
        k = (self._t(tenant), int(code))
        self.requests[k] = self.requests.get(k, 0) + 1

    def on_shed(self, tenant: str, reason: str):
        k = (self._t(tenant), reason)
        self.shed[k] = self.shed.get(k, 0) + 1

    def on_disconnect(self, tenant: str):
        t = self._t(tenant)
        self.disconnects[t] = self.disconnects.get(t, 0) + 1

    def on_tokens(self, tenant: str, n: int):
        t = self._t(tenant)
        self.tokens_streamed[t] = self.tokens_streamed.get(t, 0) + n

    def on_ttft(self, tenant: str, ttft_s: float):
        t = self._t(tenant)
        stat = self.ttft.get(t)
        if stat is None:
            stat = self.ttft[t] = OnlineStat()
        stat.observe(ttft_s)

    def shed_total(self) -> int:
        return sum(self.shed.values())

    def to_families(self, slo: SLOController) -> List[Family]:
        ns = "paddle_tpu_server"
        reqs = Family(f"{ns}_requests_total", "counter",
                      "HTTP requests by tenant and status code")
        for (tenant, code), n in sorted(self.requests.items()):
            reqs.add(n, {"tenant": tenant, "code": str(code)})
        shed = Family(f"{ns}_shed_total", "counter",
                      "requests turned away with 429/503 by tenant and "
                      "reason (backpressure | stream_cap | "
                      "token_budget | draining)")
        for (tenant, why), n in sorted(self.shed.items()):
            shed.add(n, {"tenant": tenant, "reason": why})
        disc = Family(f"{ns}_disconnects_total", "counter",
                      "client disconnects on live streams (each one "
                      "cancelled its request and freed its KV slot)")
        for tenant, n in sorted(self.disconnects.items()):
            disc.add(n, {"tenant": tenant})
        toks = Family(f"{ns}_tokens_streamed_total", "counter",
                      "tokens delivered to clients")
        for tenant, n in sorted(self.tokens_streamed.items()):
            toks.add(n, {"tenant": tenant})
        streams = Family(f"{ns}_streams_active", "gauge",
                         "live admitted streams per tenant")
        for tenant in sorted(set(list(slo._streams))):
            streams.add(slo.streams_active(tenant), {"tenant": tenant})
        ttft = Family(f"{ns}_ttft_seconds", "summary",
                      "request arrival to first streamed token, per "
                      "tenant (server-side: includes queue wait)")
        for tenant, stat in sorted(self.ttft.items()):
            ttft.add_summary(stat, {"tenant": tenant})
        fams = [reqs, shed, disc, toks, streams, ttft]
        fams.append(Family(f"{ns}_inflight", "gauge",
                           "admitted-but-unfinished requests")
                    .add(slo.inflight))
        fams.append(Family(f"{ns}_max_inflight", "gauge",
                           "the bounded-admission cap (sized at or "
                           "below the backend queue bound)")
                    .add(slo.max_inflight))
        fams.append(Family(f"{ns}_reattached_streams_total", "counter",
                           "streams re-bound to an in-flight request "
                           "by id (drain/restart or reconnect)")
                    .add(self.reattached_streams))
        fams.append(Family(f"{ns}_draining", "gauge",
                           "1 while the SIGTERM drain is in progress")
                    .add(self.draining))
        fams.append(Family(f"{ns}_drain_events_total", "counter",
                           "graceful drains initiated over this "
                           "process's lifetime (SIGTERM or /drain)")
                    .add(self.drain_events))
        return fams


# --------------------------------------------------------------------------- #
# the server
# --------------------------------------------------------------------------- #


class LLMServer:
    """Asyncio HTTP/SSE front door over an `LLMEngine` or
    `EngineFleet`.

    >>> eng = LLMEngine(model, max_slots=4)
    >>> srv = LLMServer(eng, policies={"pro": TenantPolicy(priority=1)})
    >>> handle = srv.run_in_thread()        # or: await srv.start()
    >>> ... HTTP traffic on handle.port ...
    >>> handle.stop()

    Endpoints:
      POST /v1/completions            JSON or SSE (`"stream": true`)
      GET  /v1/completions/<rid>      SSE reattach (`?from=<delivered>`)
      GET  /healthz                   200 serving / 503 draining
      GET  /metrics                   server + backend exposition

    The backend is OWNED by the server's scheduling thread while the
    server runs: do not call engine/fleet methods from other threads
    concurrently. `close_backend=True` also closes the backend on
    server stop."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 policies: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 max_inflight: Optional[int] = None,
                 drain_grace_s: float = 5.0,
                 drain_path: Optional[str] = None,
                 stream_buffer: int = 1024,
                 max_body_bytes: int = 8 << 20,
                 retry_after_draining_s: float = 5.0,
                 trace_capacity: int = 2048,
                 close_backend: bool = False,
                 owners: Optional[Dict[int, str]] = None,
                 clock=time.monotonic):
        self.backend = backend
        self.host = host
        self.port = int(port)          # 0 = ephemeral; real one after start()
        if max_inflight is None:
            # at or below the backend's own bound, so admission math —
            # not the engine's overflow exception — is what clients meet
            max_inflight = getattr(backend, "max_queue", None) \
                or getattr(backend, "max_pending", None) or 64
        # SLO debits priced in what the backend actually admits by: a
        # paged backend (kv_layout="paged") charges KV PAGES
        # (ceil(tokens / page_size)) so tenant budgets meter resident
        # device memory, not a token fiction
        paged = bool(getattr(backend, "paged", False))
        self.slo = SLOController(
            policies, default_policy, max_inflight=int(max_inflight),
            charge_unit="pages" if paged else "tokens",
            page_size=getattr(backend, "page_size", 1) or 1,
            clock=clock)
        self.metrics = ServerMetrics()
        self.tracer = LifecycleTracer(capacity=trace_capacity)
        self.worker = EngineWorker(backend)
        self.drain_grace_s = float(drain_grace_s)
        self.drain_path = drain_path
        self.stream_buffer = int(stream_buffer)
        self.max_body_bytes = int(max_body_bytes)
        self.retry_after_draining_s = float(retry_after_draining_s)
        self.close_backend = bool(close_backend)
        self.drain_snapshot: Optional[Dict] = None
        self._draining = False
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._relays: Dict[int, _StreamRelay] = {}
        # bounded record of terminal results the server itself
        # collected — what a late reattach after finish replays
        self._done: collections.OrderedDict = collections.OrderedDict()
        self._done_cap = 1024
        # rid -> tenant: reattach-by-id is tenant-scoped (a sequential
        # rid must not be a bearer token for another tenant's stream).
        # `owners=` seeds a restarted server from the drained one's
        # `drain_owners` so the check survives the restart. Bounded.
        self._owners: collections.OrderedDict = collections.OrderedDict(
            (int(k), str(v)) for k, v in (owners or {}).items())
        self._owners_cap = 4096
        self._zombies: set = set()     # cancelled rids awaiting reaping
        self._reaper_task: Optional[asyncio.Task] = None
        self._drain_task: Optional[asyncio.Task] = None
        self._closed_evt: Optional[asyncio.Event] = None

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    async def start(self):
        """Bind the socket, start the scheduling thread and the zombie
        reaper. The server is accepting when this returns."""
        self._loop = asyncio.get_running_loop()
        self._closed_evt = asyncio.Event()
        self.worker.start()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._reaper_task = asyncio.ensure_future(self._reaper())
        return self

    def install_signal_handlers(self):
        """SIGTERM/SIGINT -> graceful drain (call after start(), from
        the loop thread; no-op where the loop forbids it)."""
        import signal
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._loop.add_signal_handler(sig, self.begin_drain)
            except (NotImplementedError, RuntimeError):
                pass

    def begin_drain(self):
        """Start the graceful drain: stop admitting (503 +
        Retry-After), let in-flight work finish for `drain_grace_s`,
        snapshot what remains (atomically with halting the scheduler),
        notify live streams to reattach after restart, then stop."""
        if self._draining:
            return
        self._draining = True
        self.metrics.draining = 1
        self.metrics.drain_events += 1
        self.tracer.record("drain")
        self._drain_task = asyncio.ensure_future(self._drain())

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drain_owners(self) -> Dict[int, str]:
        """The rid -> tenant map to seed a restarted server with
        (`LLMServer(..., owners=server.drain_owners)`) so
        reattach-by-id stays tenant-scoped across the restart."""
        return dict(self._owners)

    async def _drain(self):
        deadline = time.monotonic() + self.drain_grace_s
        try:
            while time.monotonic() < deadline:
                try:
                    if not await self._wcall(self.backend.has_work):
                        break
                except (RuntimeError, asyncio.TimeoutError):
                    break  # worker already stopped
                await asyncio.sleep(0.02)

            def _snapshot_and_halt():
                snap = None
                if self.backend.has_work() \
                        and hasattr(self.backend, "snapshot"):
                    # each host page payload as its own bytes, not a
                    # view of the pinned gather buffer (pickled, a view
                    # writes its whole storage)
                    snap = own_bytes(self.backend.snapshot())
                self.worker.halt_from_worker()
                return snap

            try:
                self.drain_snapshot = \
                    await self._wcall(_snapshot_and_halt)
            except (RuntimeError, asyncio.TimeoutError):
                pass
            if self.drain_snapshot is not None \
                    and self.drain_path is not None:
                import pickle
                with open(self.drain_path, "wb") as f:
                    pickle.dump(self.drain_snapshot, f)
            for relay in list(self._relays.values()):
                relay.push_local("drain")
            await asyncio.sleep(0.05)  # let pumps flush the notice
        finally:
            await self.stop()

    async def stop(self):
        """Stop accepting, stop the scheduling thread, close the
        socket. Idempotent; `wait_closed()` unblocks. Live pumps get a
        final drain event so no handler waits forever on a relay the
        stopped scheduler will never feed."""
        self.worker.stop(join=False)
        if self._drain_task is not None:
            t, self._drain_task = self._drain_task, None
            if t is not asyncio.current_task():
                t.cancel()  # a hard stop mid-grace must not leave the
                # drain loop pending on a closed loop
        for relay in list(self._relays.values()):
            relay.push_local("drain")
        if self._server is not None:
            self._server.close()
            try:
                # 3.12's wait_closed also waits for handlers — bounded,
                # since the drain events above unblock every pump
                await asyncio.wait_for(self._server.wait_closed(),
                                       timeout=5.0)
            except Exception:  # noqa: BLE001 — already-dead transport
                pass
            self._server = None
        if self._reaper_task is not None:
            self._reaper_task.cancel()
            self._reaper_task = None
        self.worker.stop(join=True)
        if self.close_backend:
            try:
                # the worker was joined above: the scheduling thread is
                # gone, so backend ownership reverts to whoever shuts
                # the server down (and no capture can be running)
                self.backend.close()
            except Exception:  # noqa: BLE001 — best-effort shutdown
                pass
        if self._closed_evt is not None:
            self._closed_evt.set()

    async def wait_closed(self):
        if self._closed_evt is not None:
            await self._closed_evt.wait()

    def run_in_thread(self) -> "ServerHandle":
        """Run the server on a fresh event loop in a daemon thread —
        the embedding used by tests and by synchronous callers. Returns a
        handle with `.port`, `.call_soon(fn)`, `.drain()`, `.stop()`."""
        return ServerHandle(self)

    async def _wcall(self, fn):
        """Await a closure executed on the scheduling thread. Bounded:
        a command stranded by a shutdown race surfaces as
        asyncio.TimeoutError instead of hanging its handler forever."""
        return await asyncio.wait_for(
            asyncio.wrap_future(self.worker.call(fn)), timeout=60.0)

    # ------------------------------------------------------------------ #
    # zombie reaping (disconnect-cancelled results nobody will read)
    # ------------------------------------------------------------------ #
    async def _reaper(self):
        while True:
            await asyncio.sleep(0.25)
            if not self._zombies:
                continue
            rids = list(self._zombies)

            def _reap(rids=rids):
                out, gone = [], []
                for rid in rids:
                    if self.backend.has_result(rid):
                        out.append(self.backend.result(rid))
                    elif not self._backend_knows(rid):
                        gone.append(rid)  # nothing will ever arrive:
                        # the result was already collected elsewhere
                return out, gone

            try:
                collected, gone = await self._wcall(_reap)
            except (RuntimeError, asyncio.TimeoutError):
                return  # worker stopped: draining shutdown
            for g in collected:
                self._zombies.discard(g.request_id)
                self._remember(g)
            for rid in gone:
                self._zombies.discard(rid)

    def _backend_knows(self, rid: int) -> bool:
        """ENGINE THREAD. Is `rid` still live or collectable on the
        backend? False means the reaper can forget it — keeping it
        would grow the zombie set without bound."""
        if self.backend.has_result(rid):
            return True
        find = getattr(self.backend, "_find_request", None)
        if find is not None:                    # LLMEngine
            return find(rid) is not None
        tracked = getattr(self.backend, "_tracked", None)
        return tracked is not None and rid in tracked  # EngineFleet

    def _remember(self, g):
        """Bounded terminal-result record (reattach-after-finish)."""
        self._done[g.request_id] = {
            "token_ids": list(g.token_ids),
            "finish_reason": g.finish_reason,
            "error": g.error,
            "prompt_tokens": int(g.prompt.size),
            "ttft_s": g.ttft_s,
        }
        while len(self._done) > self._done_cap:
            self._done.popitem(last=False)

    # ------------------------------------------------------------------ #
    # HTTP plumbing (hand-rolled: stdlib only, Connection: close)
    # ------------------------------------------------------------------ #
    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            raise _ClientGone("empty request")
        parts = line.decode("latin-1").strip().split(" ")
        if len(parts) < 2:
            raise ValueError(f"bad request line {line!r}")
        method, target = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if len(headers) > 100:
                raise ValueError("too many headers")
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        if n > self.max_body_bytes:
            raise _TooLarge()
        body = await reader.readexactly(n) if n else b""
        path, _, query = target.partition("?")
        return method, path, query, headers, body

    @staticmethod
    def _head(status: int, ctype: str, extra: Dict[str, str],
              length: Optional[int]) -> bytes:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 413: "Payload Too Large",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        lines = [f"HTTP/1.1 {status} {reason}",
                 f"Content-Type: {ctype}", "Connection: close"]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        for k, v in (extra or {}).items():
            lines.append(f"{k}: {v}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def _respond_json(self, writer, status: int, obj,
                            extra: Optional[Dict[str, str]] = None):
        body = (json.dumps(obj) + "\n").encode()
        writer.write(self._head(status, "application/json",
                                extra or {}, len(body)) + body)
        await writer.drain()

    async def _respond_shed(self, writer, tenant: str, reason: str,
                            retry_after_s: float, status: int = 429):
        self.metrics.on_shed(tenant, reason)
        self.metrics.on_request(tenant, status)
        self.tracer.record("shed", args=(tenant, reason))
        await self._respond_json(
            writer, status,
            {"error": {"type": "overloaded" if status == 429
                       else "draining",
                       "reason": reason,
                       "retry_after_s": round(retry_after_s, 3)}},
            extra={"Retry-After":
                   str(max(1, int(math.ceil(retry_after_s))))})

    async def _sse_write(self, writer, obj) -> None:
        faults.fire("http_write")
        try:
            writer.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            await writer.drain()
        except (ConnectionError, BrokenPipeError, OSError) as e:
            raise _ClientGone(str(e)) from None

    # ------------------------------------------------------------------ #
    # connection handling / routing
    # ------------------------------------------------------------------ #
    async def _handle_conn(self, reader, writer):
        try:
            try:
                method, path, query, headers, body = \
                    await self._read_request(reader)
            except _TooLarge:
                await self._respond_json(
                    writer, 413, {"error": {"type": "payload_too_large"}})
                return
            except (_ClientGone, asyncio.IncompleteReadError,
                    ConnectionError):
                return
            except ValueError as e:
                await self._respond_json(
                    writer, 400,
                    {"error": {"type": "bad_request", "message": str(e)}})
                return
            if method == "GET" and path == "/healthz":
                await self._healthz(writer)
            elif method == "GET" and path == "/metrics":
                await self._metrics(writer)
            elif method == "POST" and path == "/v1/completions":
                await self._completions(reader, writer, headers, body)
            elif method == "GET" \
                    and path.startswith("/v1/completions/"):
                await self._reattach(reader, writer, path, query,
                                     headers)
            else:
                await self._respond_json(
                    writer, 404, {"error": {"type": "not_found",
                                            "path": path}})
        except (_ClientGone, ConnectionError, BrokenPipeError):
            pass
        except Exception as e:  # noqa: BLE001 — one connection's bug
            # must never take the accept loop down
            try:
                await self._respond_json(
                    writer, 500,
                    {"error": {"type": "internal",
                               "message": f"{type(e).__name__}: {e}"}})
            except Exception:  # noqa: BLE001 — writer already dead
                pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — already closed
                pass

    async def _healthz(self, writer):
        def _snapshot():
            # ENGINE THREAD: stats + replica states in ONE closure —
            # replica_states walks the fleet's health machine, which
            # the worker thread owns; reading it from the loop thread
            # would race quarantine/canary transitions mid-step
            stats = self.backend.stats()
            states = getattr(self.backend, "replica_states", None)
            try:
                rep = states() if states is not None else None
            except Exception:  # noqa: BLE001 — health is best-effort
                rep = None
            asc = getattr(self.backend, "autoscaler", None)
            return stats, rep, (asc.stats() if asc is not None
                                else None)

        try:
            stats, rep_states, asc_stats = await self._wcall(_snapshot)
        except (RuntimeError, asyncio.TimeoutError):
            stats, rep_states, asc_stats = {}, None, None
        status = "draining" if self._draining else "serving"
        payload = {
            "status": status,
            "inflight": self.slo.inflight,
            "queue_depth": stats.get("queue_depth",
                                     stats.get("fleet_pending", 0)),
            "slots_active": stats.get("slots_active", 0),
        }
        if rep_states is not None:
            payload["replica_states"] = rep_states
            # drain-aware replica accounting: a DRAINING replica still
            # finishes its streams but takes no new routes, so ops
            # probes (and the autoscaling soak) see capacity shrink
            # BEFORE the slot disappears from replica_states
            payload["replicas_serving"] = sum(
                1 for s in rep_states if s in ("healthy", "suspect"))
            payload["replicas_draining"] = sum(
                1 for s in rep_states if s == "draining")
        if asc_stats is not None:
            payload["autoscale"] = asc_stats
        await self._respond_json(
            writer, 503 if self._draining else 200, payload,
            extra={"Retry-After": str(max(1, int(
                self.retry_after_draining_s)))} if self._draining
            else None)

    async def _metrics(self, writer):
        server_text = render_families(
            self.metrics.to_families(self.slo))
        try:
            backend_text = await self._wcall(self.backend.to_prometheus)
        except (RuntimeError, asyncio.TimeoutError):
            backend_text = ""
        body = (server_text + backend_text).encode()
        writer.write(self._head(200, "text/plain; version=0.0.4",
                                {}, len(body)) + body)
        await writer.drain()

    # ------------------------------------------------------------------ #
    # POST /v1/completions
    # ------------------------------------------------------------------ #
    @staticmethod
    def _tenant_of(headers: Dict[str, str], payload: Dict) -> str:
        t = headers.get("x-tenant") or payload.get("user") \
            or _DEFAULT_TENANT
        return str(t)[:64]

    def _params_of(self, payload: Dict,
                   priority: int) -> Tuple[List[int], SamplingParams]:
        prompt = payload.get("prompt")
        if not isinstance(prompt, list) or not prompt \
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in prompt):
            raise ValueError("prompt must be a non-empty list of "
                             "token ids (ints)")
        # a client may LOWER its effective priority, never raise it
        # above its tenant's policy (priority is an SLO grant, not a
        # request parameter)
        req_pri = payload.get("priority")
        if req_pri is not None:
            priority = min(int(req_pri), priority)
        # best-of-n: the OpenAI-style `n` field (and `best_of`, which
        # without logprob ranking means "generate that many" — the
        # larger of the two wins). The backend forks the continuations
        # via COW pages under the paged layout; responses carry a
        # `choices` array / per-event `choice` indices.
        n = int(payload.get("n", 1) or 1)
        best_of = payload.get("best_of")
        if best_of is not None:
            n = max(n, int(best_of))
        # bound n BEFORE the server allocates one relay per choice:
        # the backend enforces the same limit, but a rejected request
        # must never have paid for its own oversized fan-out first
        cap = getattr(self.backend, "max_slots", None) or 64
        if not 1 <= n <= cap:
            raise ValueError(f"n/best_of must be in [1, {cap}] "
                             f"(continuations each hold a decode "
                             f"lane)")
        params = SamplingParams(
            max_new_tokens=int(payload.get("max_tokens", 16)),
            temperature=float(payload.get("temperature", 0.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            eos_token_id=payload.get("eos_token_id"),
            deadline_s=payload.get("deadline_s"),
            priority=priority, n=n)
        return [int(t) for t in prompt], params

    async def _completions(self, reader, writer, headers, body):
        try:
            payload = json.loads(body.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            await self._respond_json(
                writer, 400,
                {"error": {"type": "bad_request", "message": str(e)}})
            return
        tenant = self._tenant_of(headers, payload)
        if self._draining:
            await self._respond_shed(writer, tenant, "draining",
                                     self.retry_after_draining_s,
                                     status=503)
            return
        # parse params FIRST (a malformed request must be a 400, not a
        # budget debit), then the SLO admission decides shed vs admit
        try:
            policy = self.slo.policy_for(tenant)
            prompt, params = self._params_of(payload, policy.priority)
        except (ValueError, TypeError) as e:
            self.metrics.on_request(tenant, 400)
            await self._respond_json(
                writer, 400,
                {"error": {"type": "invalid_request",
                           "message": str(e)}})
            return
        # n continuations each reserve their own decode budget; the
        # prompt is charged once (under the paged layout it is SHARED
        # via COW pages, and the charge unit is pages already)
        reserve = len(prompt) + params.n * params.max_new_tokens
        adm = self.slo.admit(tenant, reserve)
        if not adm.admitted:
            await self._respond_shed(writer, tenant, adm.reason,
                                     adm.retry_after_s)
            return
        relays = [_StreamRelay(self._loop, maxsize=self.stream_buffer)
                  for _ in range(params.n)]
        relay = relays[0]
        t_arrival = time.perf_counter()
        try:
            rids = await self._wcall(
                lambda: self._submit_on_worker(prompt, params, relays))
            rid = rids[0]
        except ValueError as e:
            # the engine's own validation (oversize for max_seq, ...)
            self.slo.finish(adm, 0)
            self.metrics.on_request(tenant, 400)
            await self._respond_json(
                writer, 400,
                {"error": {"type": "invalid_request",
                           "message": str(e)}})
            return
        except EngineOverloadError:
            # belt and braces: the inflight cap makes this unreachable,
            # but if geometry ever disagrees the client STILL sees the
            # shaped 429, never the engine exception
            self.slo.finish(adm, 0)
            await self._respond_shed(writer, tenant, "backpressure",
                                     self.slo.min_retry_after_s * 4)
            return
        except RuntimeError as e:
            self.slo.finish(adm, 0)
            self.metrics.on_request(tenant, 503)
            await self._respond_json(
                writer, 503, {"error": {"type": "unavailable",
                                        "message": str(e)}})
            return
        except BaseException:
            # the narrow handlers above miss asyncio.TimeoutError (a
            # _wcall stranded by a shutdown race) and CancelledError —
            # any uncaught type must STILL release the admission, or
            # inflight stays debited forever and the backpressure gate
            # eventually 429s every tenant
            self.slo.finish(adm, 0)
            raise
        for r, rl in zip(rids, relays):
            rl.rid = r
            self._owners[r] = tenant
            self._register_relay(r, rl)
        while len(self._owners) > self._owners_cap:
            self._owners.popitem(last=False)
        stream = bool(payload.get("stream", False))
        try:
            if len(relays) > 1:
                if stream:
                    await self._serve_stream_multi(
                        reader, writer, rids, relays, tenant, adm,
                        prompt_len=len(prompt), t_arrival=t_arrival)
                else:
                    await self._serve_blocking_multi(
                        reader, writer, rids, relays, tenant, adm,
                        prompt_len=len(prompt), t_arrival=t_arrival)
            elif stream:
                await self._serve_stream(reader, writer, relay, tenant,
                                         adm, prompt_len=len(prompt),
                                         t_arrival=t_arrival)
            else:
                await self._serve_blocking(reader, writer, relay,
                                           tenant, adm,
                                           prompt_len=len(prompt),
                                           t_arrival=t_arrival)
        finally:
            for r, rl in zip(rids, relays):
                if self._relays.get(r) is rl:
                    self._relays.pop(r, None)

    def _submit_on_worker(self, prompt, params, relays) -> List[int]:
        """ENGINE THREAD: submit + attach atomically, so no block can
        run between the two (the first token always reaches the
        sink). With `params.n > 1` the backend preassigns the whole
        fork group's rids at submit; every continuation's relay
        attaches in the same critical section, so no fork can emit
        before its sink exists."""
        rid = self.backend.submit(prompt, params)
        rids = self.backend.fork_rids(rid) or [rid]
        for r, relay in zip(rids, relays):
            self.backend.attach_stream(r, relay.sink)
        return rids

    def _register_relay(self, rid: int, relay: _StreamRelay):
        old = self._relays.get(rid)
        if old is not None and old is not relay:
            old.push_local("replaced")
        self._relays[rid] = relay

    async def _collect_result(self, rid: int):
        """Collect a finished request's result off the worker (None if
        already collected or the worker is gone)."""

        def _collect():
            if self.backend.has_result(rid):
                return self.backend.result(rid)
            return None

        try:
            g = await self._wcall(_collect)
        except (RuntimeError, asyncio.TimeoutError):
            return None
        if g is not None:
            self._remember(g)
        return g

    def _on_disconnect(self, rid: int, tenant: str, relay, adm,
                       prompt_len: int = 0):
        """Shared disconnect path: cancel on the scheduling thread (the
        KV slot frees at the next block boundary, prefix pins release),
        refund the unused half of the reservation (a disconnected
        stream is charged prompt + the tokens it actually received),
        and leave the terminal result for the reaper."""
        self.metrics.on_disconnect(tenant)
        self.tracer.record("disconnect", rid)
        if rid not in self._done:
            # an already-recorded terminal (e.g. a reattach replay the
            # client abandoned) has nothing left to reap — adding it
            # would pin the zombie set forever
            self._zombies.add(rid)

        def _cancel():
            self.backend.detach_stream(rid)
            self.backend.cancel(rid)

        self.worker.post(_cancel)
        if adm is not None:
            self.slo.finish(adm,
                            tokens_used=prompt_len + relay.delivered)

    async def _next_event(self, relay, eof_task):
        """One relay event, racing client EOF; raises _ClientGone on
        disconnect (real or injected)."""
        ev_task = asyncio.ensure_future(relay.queue.get())
        try:
            done, _ = await asyncio.wait(
                {ev_task, eof_task},
                return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            ev_task.cancel()
            raise
        if ev_task not in done:
            ev_task.cancel()
            raise _ClientGone("client eof")
        kind, payload = ev_task.result()
        try:
            faults.fire("client_disconnect")
        except faults.InjectedFault:
            raise _ClientGone("injected client_disconnect") from None
        return kind, payload

    async def _serve_stream(self, reader, writer, relay, tenant, adm,
                            prompt_len: int, t_arrival: float):
        """Pump one SSE response until finished/drain/disconnect.
        `adm=None` marks a reattach pump (no SLO accounting — the
        original admission already paid; reattach never re-charges)."""
        writer.write(self._head(200, "text/event-stream",
                                {"Cache-Control": "no-cache",
                                 "X-Request-Id": str(relay.rid)}, None))
        await writer.drain()
        eof_task = asyncio.ensure_future(reader.read(65536))
        got_first = False
        try:
            while True:
                try:
                    kind, payload = await self._next_event(relay,
                                                           eof_task)
                except _ClientGone:
                    self._on_disconnect(relay.rid, tenant, relay, adm,
                                        prompt_len)
                    self.metrics.on_request(tenant, 200)
                    return
                if kind == "tokens":
                    fresh = relay.fresh(payload[0], payload[1])
                    if not fresh:
                        continue
                    if not got_first:
                        got_first = True
                        if adm is not None:
                            ttft = time.perf_counter() - t_arrival
                            self.metrics.on_ttft(tenant, ttft)
                    self.metrics.on_tokens(tenant, len(fresh))
                    try:
                        await self._sse_write(
                            writer, {"id": relay.rid,
                                     "index": relay.delivered
                                     - len(fresh),
                                     "token_ids": fresh})
                    except (_ClientGone, faults.InjectedFault):
                        self._on_disconnect(relay.rid, tenant, relay,
                                            adm, prompt_len)
                        self.metrics.on_request(tenant, 200)
                        return
                elif kind == "finished":
                    reason, error = payload[0], payload[1]
                    g = await self._collect_result(relay.rid)
                    used = prompt_len + relay.delivered
                    if adm is not None:
                        self.slo.finish(adm, tokens_used=used)
                    final = {"id": relay.rid, "finish_reason": reason,
                             "usage": {"prompt_tokens": prompt_len,
                                       "completion_tokens":
                                           relay.delivered}}
                    if error:
                        final["error"] = error
                    try:
                        await self._sse_write(writer, final)
                        writer.write(b"data: [DONE]\n\n")
                        await writer.drain()
                    except (_ClientGone, faults.InjectedFault,
                            ConnectionError):
                        pass  # finished anyway; nothing to cancel
                    self.metrics.on_request(tenant, 200)
                    return
                elif kind == "drain":
                    if adm is not None:
                        self.slo.finish(adm, tokens_used=prompt_len
                                        + relay.delivered)
                    try:
                        await self._sse_write(
                            writer, {"id": relay.rid, "drain": True,
                                     "delivered": relay.delivered})
                    except (_ClientGone, faults.InjectedFault,
                            ConnectionError):
                        pass
                    self.metrics.on_request(tenant, 200)
                    return
                elif kind == "replaced":
                    # a newer reattach took this stream over: THIS
                    # response ends, but the admission must still be
                    # released or inflight/stream counts leak forever
                    if adm is not None:
                        self.slo.finish(adm, tokens_used=prompt_len
                                        + relay.delivered)
                    self.metrics.on_request(tenant, 200)
                    return
                elif kind == "overflow":
                    # the client can't keep up: end ITS stream and
                    # cancel the request so the engine stops paying
                    self._on_disconnect(relay.rid, tenant, relay, adm,
                                        prompt_len)
                    try:
                        await self._sse_write(
                            writer, {"id": relay.rid,
                                     "error": "slow_client"})
                    except (_ClientGone, faults.InjectedFault,
                            ConnectionError):
                        pass
                    self.metrics.on_request(tenant, 200)
                    return
        finally:
            eof_task.cancel()

    async def _serve_blocking(self, reader, writer, relay, tenant, adm,
                              prompt_len: int, t_arrival: float):
        """Non-stream completion: accumulate, answer once."""
        eof_task = asyncio.ensure_future(reader.read(65536))
        toks: List[int] = []
        got_first = False
        try:
            while True:
                try:
                    kind, payload = await self._next_event(relay,
                                                           eof_task)
                except _ClientGone:
                    self._on_disconnect(relay.rid, tenant, relay, adm,
                                        prompt_len)
                    return
                if kind == "tokens":
                    fresh = relay.fresh(payload[0], payload[1])
                    if fresh and not got_first:
                        got_first = True
                        self.metrics.on_ttft(
                            tenant, time.perf_counter() - t_arrival)
                    toks.extend(fresh)
                elif kind == "finished":
                    reason, error = payload[0], payload[1]
                    await self._collect_result(relay.rid)
                    self.slo.finish(adm, tokens_used=prompt_len
                                    + len(toks))
                    self.metrics.on_tokens(tenant, len(toks))
                    out = {"id": relay.rid, "token_ids": toks,
                           "finish_reason": reason,
                           "usage": {"prompt_tokens": prompt_len,
                                     "completion_tokens": len(toks)}}
                    if error:
                        out["error"] = error
                    self.metrics.on_request(tenant, 200)
                    await self._respond_json(writer, 200, out)
                    return
                elif kind == "drain":
                    self.slo.finish(adm, tokens_used=prompt_len
                                    + len(toks))
                    self.metrics.on_request(tenant, 503)
                    await self._respond_json(
                        writer, 503,
                        {"id": relay.rid, "drain": True,
                         "delivered": len(toks),
                         "error": {"type": "draining",
                                   "message": "reattach by id after "
                                              "restart"}},
                        extra={"Retry-After": str(max(1, int(
                            self.retry_after_draining_s)))})
                    return
                elif kind == "replaced":
                    self.slo.finish(adm, tokens_used=prompt_len
                                    + len(toks))
                    return
                elif kind == "overflow":
                    # same as the streaming pump: a consumer that
                    # cannot keep up ends its request, releasing the
                    # admission AND the engine work
                    self._on_disconnect(relay.rid, tenant, relay, adm,
                                        prompt_len)
                    return
        finally:
            eof_task.cancel()

    # ------------------------------------------------------------------ #
    # best-of-n responses (one admission, n relays, `choices` surface)
    # ------------------------------------------------------------------ #
    def _on_disconnect_group(self, rids, tenant, relays, adm,
                             prompt_len: int):
        """Disconnect for a fork group: the client was the only
        consumer of every continuation, so ALL of them cancel (each
        frees its lane and pages at the next boundary); one admission
        is released, charged prompt + whatever was delivered across
        the choices."""
        self.metrics.on_disconnect(tenant)
        for rid in rids:
            self.tracer.record("disconnect", rid)
            if rid not in self._done:
                self._zombies.add(rid)

        def _cancel(rids=list(rids)):
            for rid in rids:
                self.backend.detach_stream(rid)
                self.backend.cancel(rid)

        self.worker.post(_cancel)
        if adm is not None:
            delivered = sum(r.delivered for r in relays)
            self.slo.finish(adm, tokens_used=prompt_len + delivered)

    async def _serve_blocking_multi(self, reader, writer, rids, relays,
                                    tenant, adm, prompt_len: int,
                                    t_arrival: float):
        """Non-stream best-of-n: drain every continuation
        CONCURRENTLY (per-relay pumps into one merged queue, like the
        streaming pump — the choices decode in parallel, so reading
        them one at a time would let a later choice's BOUNDED relay
        overflow while an earlier one is being read), then answer once
        with an OpenAI-style `choices` array (choice `index` matches
        submission order; each carries its own finish_reason)."""
        eof_task = asyncio.ensure_future(reader.read(65536))
        merged: asyncio.Queue = asyncio.Queue()

        async def pump(i, relay):
            while True:
                ev = await relay.queue.get()
                await merged.put((i, ev))
                if ev[0] in ("finished", "drain", "replaced",
                             "overflow"):
                    return

        pumps = [asyncio.ensure_future(pump(i, r))
                 for i, r in enumerate(relays)]
        choices = [{"index": i, "rid": rid, "token_ids": [],
                    "finish_reason": None}
                   for i, rid in enumerate(rids)]
        live = set(range(len(relays)))
        got_first = False
        try:
            while live:
                ev_task = asyncio.ensure_future(merged.get())
                try:
                    done, _ = await asyncio.wait(
                        {ev_task, eof_task},
                        return_when=asyncio.FIRST_COMPLETED)
                except asyncio.CancelledError:
                    ev_task.cancel()
                    raise
                if ev_task not in done:
                    ev_task.cancel()
                    self._on_disconnect_group(rids, tenant, relays,
                                              adm, prompt_len)
                    return
                i, (kind, payload) = ev_task.result()
                try:
                    faults.fire("client_disconnect")
                except faults.InjectedFault:
                    self._on_disconnect_group(rids, tenant, relays,
                                              adm, prompt_len)
                    return
                relay = relays[i]
                ch = choices[i]
                if kind == "tokens":
                    fresh = relay.fresh(payload[0], payload[1])
                    if fresh and not got_first:
                        got_first = True
                        self.metrics.on_ttft(
                            tenant, time.perf_counter() - t_arrival)
                    ch["token_ids"].extend(fresh)
                elif kind == "finished":
                    ch["finish_reason"] = payload[0]
                    if payload[1]:
                        ch["error"] = payload[1]
                    await self._collect_result(relay.rid)
                    live.discard(i)
                elif kind == "drain":
                    # the whole backend is draining: every choice
                    # will see it — answer once, clients reattach
                    # per continuation rid after the restart
                    total = sum(r.delivered for r in relays)
                    self.slo.finish(adm, tokens_used=prompt_len
                                    + total)
                    self.metrics.on_request(tenant, 503)
                    await self._respond_json(
                        writer, 503,
                        {"id": rids[0], "drain": True,
                         "choice_rids": list(rids),
                         "delivered": total,
                         "error": {"type": "draining",
                                   "message": "reattach each "
                                   "choice by rid after restart"}},
                        extra={"Retry-After": str(max(1, int(
                            self.retry_after_draining_s)))})
                    return
                elif kind == "replaced":
                    self.slo.finish(
                        adm, tokens_used=prompt_len
                        + sum(r.delivered for r in relays))
                    return
                elif kind == "overflow":
                    self._on_disconnect_group(rids, tenant, relays,
                                              adm, prompt_len)
                    return
            total = sum(len(c["token_ids"]) for c in choices)
            self.slo.finish(adm, tokens_used=prompt_len + total)
            self.metrics.on_tokens(tenant, total)
            self.metrics.on_request(tenant, 200)
            await self._respond_json(
                writer, 200,
                {"id": rids[0], "choices": choices,
                 "usage": {"prompt_tokens": prompt_len,
                           "completion_tokens": total}})
        finally:
            eof_task.cancel()
            for p in pumps:
                p.cancel()

    async def _serve_stream_multi(self, reader, writer, rids, relays,
                                  tenant, adm, prompt_len: int,
                                  t_arrival: float):
        """SSE best-of-n: per-relay pumps merge into one event stream;
        every data event carries its `choice` index (token events are
        per-choice cumulative, deduped by start index exactly like the
        single-choice stream). The response ends when the LAST choice
        finishes (one final usage event + [DONE]), or on
        drain/disconnect like the single-choice pump."""
        writer.write(self._head(200, "text/event-stream",
                                {"Cache-Control": "no-cache",
                                 "X-Request-Id": str(rids[0]),
                                 "X-Choices": str(len(rids))}, None))
        await writer.drain()
        eof_task = asyncio.ensure_future(reader.read(65536))
        merged: asyncio.Queue = asyncio.Queue()

        async def pump(i, relay):
            while True:
                ev = await relay.queue.get()
                await merged.put((i, ev))
                if ev[0] in ("finished", "drain", "replaced",
                             "overflow"):
                    return

        pumps = [asyncio.ensure_future(pump(i, r))
                 for i, r in enumerate(relays)]
        live = set(range(len(relays)))
        got_first = False
        try:
            while live:
                ev_task = asyncio.ensure_future(merged.get())
                try:
                    done, _ = await asyncio.wait(
                        {ev_task, eof_task},
                        return_when=asyncio.FIRST_COMPLETED)
                except asyncio.CancelledError:
                    ev_task.cancel()
                    raise
                if ev_task not in done:
                    ev_task.cancel()
                    self._on_disconnect_group(rids, tenant, relays,
                                              adm, prompt_len)
                    self.metrics.on_request(tenant, 200)
                    return
                i, (kind, payload) = ev_task.result()
                try:
                    faults.fire("client_disconnect")
                except faults.InjectedFault:
                    self._on_disconnect_group(rids, tenant, relays,
                                              adm, prompt_len)
                    self.metrics.on_request(tenant, 200)
                    return
                relay = relays[i]
                if kind == "tokens":
                    fresh = relay.fresh(payload[0], payload[1])
                    if not fresh:
                        continue
                    if not got_first:
                        got_first = True
                        self.metrics.on_ttft(
                            tenant, time.perf_counter() - t_arrival)
                    self.metrics.on_tokens(tenant, len(fresh))
                    try:
                        await self._sse_write(
                            writer, {"id": rids[0], "choice": i,
                                     "rid": relay.rid,
                                     "index": relay.delivered
                                     - len(fresh),
                                     "token_ids": fresh})
                    except (_ClientGone, faults.InjectedFault):
                        self._on_disconnect_group(rids, tenant, relays,
                                                  adm, prompt_len)
                        self.metrics.on_request(tenant, 200)
                        return
                elif kind == "finished":
                    live.discard(i)
                    await self._collect_result(relay.rid)
                    ev = {"id": rids[0], "choice": i,
                          "rid": relay.rid,
                          "finish_reason": payload[0]}
                    if payload[1]:
                        ev["error"] = payload[1]
                    if not live:
                        total = sum(r.delivered for r in relays)
                        self.slo.finish(adm, tokens_used=prompt_len
                                        + total)
                        ev["usage"] = {
                            "prompt_tokens": prompt_len,
                            "completion_tokens": total}
                    try:
                        await self._sse_write(writer, ev)
                        if not live:
                            writer.write(b"data: [DONE]\n\n")
                            await writer.drain()
                    except (_ClientGone, faults.InjectedFault,
                            ConnectionError):
                        if live:
                            self._on_disconnect_group(
                                rids, tenant, relays, adm, prompt_len)
                            self.metrics.on_request(tenant, 200)
                            return
                    if not live:
                        self.metrics.on_request(tenant, 200)
                        return
                elif kind == "drain":
                    total = sum(r.delivered for r in relays)
                    self.slo.finish(adm,
                                    tokens_used=prompt_len + total)
                    try:
                        await self._sse_write(
                            writer, {"id": rids[0], "drain": True,
                                     "choice_rids": list(rids),
                                     "delivered": total})
                    except (_ClientGone, faults.InjectedFault,
                            ConnectionError):
                        pass
                    self.metrics.on_request(tenant, 200)
                    return
                elif kind == "replaced":
                    self.slo.finish(
                        adm, tokens_used=prompt_len
                        + sum(r.delivered for r in relays))
                    self.metrics.on_request(tenant, 200)
                    return
                elif kind == "overflow":
                    self._on_disconnect_group(rids, tenant, relays,
                                              adm, prompt_len)
                    try:
                        await self._sse_write(
                            writer, {"id": rids[0], "choice": i,
                                     "error": "slow_client"})
                    except (_ClientGone, faults.InjectedFault,
                            ConnectionError):
                        pass
                    self.metrics.on_request(tenant, 200)
                    return
        finally:
            eof_task.cancel()
            for p in pumps:
                p.cancel()

    # ------------------------------------------------------------------ #
    # GET /v1/completions/<rid>  (reattach by request id)
    # ------------------------------------------------------------------ #
    async def _reattach(self, reader, writer, path, query, headers):
        tenant = headers.get("x-tenant") or _DEFAULT_TENANT
        try:
            rid = int(path.rsplit("/", 1)[1])
        except ValueError:
            await self._respond_json(
                writer, 400, {"error": {"type": "bad_request",
                                        "message": "bad request id"}})
            return
        frm = 0
        for part in query.split("&"):
            if part.startswith("from="):
                try:
                    frm = max(0, int(part[5:]))
                except ValueError:
                    pass
        owner = self._owners.get(rid)
        if owner is not None and owner != tenant:
            # tenant-scoped reattach: a guessed sequential rid must not
            # hand one tenant another's live stream (or the power to
            # cancel it by disconnecting). 404, not 403 — same response
            # as a nonexistent rid, so ids are not an existence oracle.
            self.metrics.on_request(tenant, 404)
            await self._respond_json(
                writer, 404, {"error": {"type": "not_found",
                                        "message": f"unknown request "
                                                   f"id {rid}"}})
            return
        done = self._done.get(rid)
        if done is not None:
            # finished while the client was away: replay the tail +
            # the terminal event from the server's own record
            self.metrics.reattached_streams += 1
            self.tracer.record("reattach", rid)
            relay = _StreamRelay(self._loop, delivered=frm)
            relay.rid = rid
            relay.push_local("tokens", (0, list(done["token_ids"])))
            relay.push_local("finished", (done["finish_reason"],
                                          done["error"]))
            await self._serve_stream(reader, writer, relay, tenant,
                                     None,
                                     prompt_len=done["prompt_tokens"],
                                     t_arrival=time.perf_counter())
            return
        relay = _StreamRelay(self._loop, maxsize=self.stream_buffer,
                             delivered=frm)
        relay.rid = rid
        try:
            ok = await self._wcall(
                lambda: self.backend.attach_stream(rid, relay.sink))
        except (RuntimeError, asyncio.TimeoutError):
            ok = False
        if not ok:
            self.metrics.on_request(tenant, 404)
            await self._respond_json(
                writer, 404, {"error": {"type": "not_found",
                                        "message": f"unknown request "
                                                   f"id {rid}"}})
            return
        self.metrics.reattached_streams += 1
        self.tracer.record("reattach", rid)
        self._register_relay(rid, relay)
        self._zombies.discard(rid)
        try:
            await self._serve_stream(reader, writer, relay, tenant,
                                     None, prompt_len=0,
                                     t_arrival=time.perf_counter())
        finally:
            if self._relays.get(rid) is relay:
                self._relays.pop(rid, None)


class _TooLarge(Exception):
    pass


class ServerHandle:
    """A server running on its own event loop in a daemon thread — the
    sync embedding: build, `.port`, then `stop()` (or `drain()` for the
    graceful path; returns the drain snapshot, if any)."""

    def __init__(self, server: LLMServer):
        self.server = server
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="llm-server",
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=30.0):
            raise RuntimeError("server failed to start within 30s")
        if self._error is not None:
            raise self._error

    _error: Optional[BaseException] = None

    def _run(self):
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self.server.start())
        except BaseException as e:  # noqa: BLE001 — surfaced to ctor
            self._error = e
            self._started.set()
            return
        self._started.set()
        try:
            self._loop.run_until_complete(self.server.wait_closed())
        finally:
            self._loop.close()

    @property
    def port(self) -> int:
        return self.server.port

    def call_soon(self, fn):
        self._loop.call_soon_threadsafe(fn)

    def drain(self, timeout: float = 30.0) -> Optional[Dict]:
        """Trigger the graceful drain and wait for shutdown; returns
        the drain snapshot (None when everything finished in grace)."""
        self.call_soon(self.server.begin_drain)
        self._thread.join(timeout=timeout)
        return self.server.drain_snapshot

    def stop(self, timeout: float = 10.0):
        """Hard stop (no drain, no snapshot)."""

        def _stop():
            asyncio.ensure_future(self.server.stop())

        try:
            self.call_soon(_stop)
        except RuntimeError:
            return
        self._thread.join(timeout=timeout)


# --------------------------------------------------------------------------- #
# `python -m paddle_tpu_torch.serving.server` — the disconnect-and-drain soak
# --------------------------------------------------------------------------- #


def soak_parser() -> argparse.ArgumentParser:
    """The soak's arguments: the reference's, with its defaults, plus
    `--device` ("cuda", the default, or "cpu")."""
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.server",
        description="disconnect-and-drain front-door soak emitting "
                    "SERVER.json")
    ap.add_argument("--server-out", default="SERVER.json")
    ap.add_argument("--requests", type=int, default=48,
                    help="behaved-tenant streams")
    ap.add_argument("--flood", type=int, default=24,
                    help="flood-tenant requests fired at a tight "
                         "budget (most must shed with 429)")
    ap.add_argument("--disconnect-every", type=int, default=5,
                    help="every Nth behaved stream disconnects after "
                         "its first chunk")
    ap.add_argument("--drain-after", type=int, default=12,
                    help="completed streams before the SIGTERM drain "
                         "(0 disables)")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1 serves through an EngineFleet and kills "
                         "a replica mid-soak")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic fleet mode: serve through an "
                         "EngineFleet that starts at --min-replicas "
                         "with a FleetAutoscaler attached, drive a 4x "
                         "load step so the policy scales out, then "
                         "PREEMPT a replica (kill with NO revive — the "
                         "watchdog must replace it unassisted). "
                         "SERVER.json gains the replica-count timeline "
                         "and scale events; the zero-stranded and "
                         "bit-identity gates are unchanged, and the "
                         "soak additionally requires at least one "
                         "scale-out and the preemption replaced")
    ap.add_argument("--min-replicas", type=int, default=1,
                    help="autoscaler floor (and the fleet's starting "
                         "size in --autoscale mode)")
    ap.add_argument("--max-replicas", type=int, default=3,
                    help="autoscaler ceiling (TP GROUPS when --tp>1)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spacing-ms", type=float, default=75.0,
                    help="behaved-stream arrival spacing (open-loop "
                         "offered load; 0 = an all-at-once burst, "
                         "whose p99 is slot-capacity queueing under "
                         "any scheduler)")
    ap.add_argument("--prefill-budget", type=int, default=16,
                    help="chunked-prefill interleaving budget for the "
                         "backend engines (0 = monolithic admission)")
    ap.add_argument("--paged", action="store_true",
                    help="serve the paged KV layout (one page "
                    "allocator under slots + prefix tree, SLO debits "
                    "in pages); the soak then also asserts zero "
                    "leaked pages at quiescence")
    ap.add_argument("--kv-dtype", choices=("bfloat16", "float16",
                                           "float32", "int8"),
                    default=None,
                    help="KV cache storage dtype; int8 stores per-row "
                         "int8 codes and scales. The soak's contracts "
                         "are UNCHANGED — zero stranded streams, "
                         "bit-identical surviving streams vs an "
                         "undisturbed engine on the SAME kv_dtype, "
                         "zero leaked pages (default: the model's own "
                         "dtype)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding: K drafted tokens per "
                         "verify round (0 = off). The soak's contracts "
                         "are UNCHANGED with speculation on — the "
                         "accept rule only ever emits the target's "
                         "own tokens")
    ap.add_argument("--draft", choices=("trunc", "int8"),
                    default="trunc",
                    help="speculative draft model (with --speculate): "
                         "the checkpoint's first blocks, or an "
                         "int8-quantized copy")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel group size: the backend (each "
                         "fleet replica) serves on a TP group of this "
                         "many ranks on the device")
    ap.add_argument("--tail-gate", type=float, default=400.0,
                    help="fail if steady-state ttft_p99_ms divided by "
                         "the platform's decode_ms_per_token exceeds "
                         "this ratio (0 disables) — the serving-tail "
                         "regression gate")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or "
                         "'cpu'")
    return ap


def main(argv=None) -> int:
    """The front-door soak: concurrent SSE streams of two tenants (one
    behaved, one flooding past its budget), client disconnects, a
    mid-soak SIGTERM drain + restart with stream reattach-by-id, and
    (with `--replicas > 1`) a replica kill, on a `gpt_tiny` from the
    seed. Writes SERVER.json and exits nonzero on ANY stranded stream,
    a bit-identity violation of the surviving greedy streams against an
    undisturbed library engine, /metrics output failing the strict
    exposition parser, a 429 without Retry-After, no shed at all, the
    tail gate, a leaked page or a broken autoscale contract."""
    args = soak_parser().parse_args(argv)
    from ..models import gpt_tiny
    model = gpt_tiny(seed=args.seed, device=args.device)
    model.eval()
    return run_soak(model, args)[0]


def run_soak(model, args, served=None) -> Tuple[int, Dict, Dict]:
    """The soak of `main` on any GPT `model` (on `args.device`), with
    `args` from `soak_parser()`. Runs on the main thread (the drain is
    a real SIGTERM, whose handler only the main thread may install) and
    puts the SIGTERM and SIGINT handlers back as they were. `served`,
    if given, is called with the backends that took traffic once every
    server has stopped, before the verdicts' undisturbed reference
    engine runs (what it reads is the served run's alone). Returns
    (exit code, the SERVER.json report, extras): `soak_s` the wall time,
    `warm_programs` the programs the warm-ups built, `builds_serving`
    the program builds (on a card, CUDA graph captures) made while a
    server took traffic and `builds_steady` those of the restarted
    server (whose streams the tail gate reads), `ttft_during` /
    `ttft_after` the sample counts of the two TTFT windows."""
    import signal
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError("the soak drains through a real SIGTERM: run "
                           "it on the main thread")
    saved = {sig: signal.getsignal(sig)
             for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        return asyncio.run(_soak(model, args, served))
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)


async def _soak_client(port: int, payload: Dict, tenant: str,
                       disconnect_after: Optional[int] = None,
                       delay_s: float = 0.0) -> Dict:
    """One SSE client; returns status, tokens, rid, client-side TTFT,
    and what ended the stream (finished / disconnected / drained).
    `delay_s` staggers the connection (open-loop arrivals: the tail
    gate needs a steady state to measure, which a single t=0 burst of
    every client never reaches — that burst's p99 is slot-capacity
    queueing under ANY admission scheduler)."""
    if delay_s > 0:
        await asyncio.sleep(delay_s)
    t0 = time.perf_counter()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       port)
    except OSError:
        # the server drained and closed before this (staggered) client
        # ever connected — a real client retries against the restarted
        # instance; the soak resubmits these in phase 2
        return {"status": 0, "tokens": [], "rid": -1, "events": 0,
                "retry_after": None, "disconnected": False,
                "drained": False, "ttft_s": None, "ttft_at": None,
                "finish_reason": None, "refused": True}
    body = json.dumps(payload).encode()
    writer.write(
        (f"POST /v1/completions HTTP/1.1\r\nHost: soak\r\n"
         f"X-Tenant: {tenant}\r\nContent-Type: application/json\r\n"
         f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
         ).encode() + body)
    await writer.drain()
    out = {"status": 0, "tokens": [], "rid": -1, "events": 0,
           "retry_after": None, "disconnected": False,
           "drained": False, "ttft_s": None, "ttft_at": None,
           "finish_reason": None}
    try:
        status_line = await reader.readline()
        out["status"] = int(status_line.split()[1])
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            if k.strip().lower() == "retry-after":
                out["retry_after"] = v.strip()
        if out["status"] != 200:
            return out
        async for ev in _sse_events(reader):
            out["events"] += 1
            if "id" in ev:
                out["rid"] = ev["id"]
            if ev.get("drain"):
                out["drained"] = True
                return out
            if "token_ids" in ev:
                if out["ttft_s"] is None:
                    out["ttft_at"] = time.perf_counter()
                    out["ttft_s"] = out["ttft_at"] - t0
                out["tokens"].extend(ev["token_ids"])
                if disconnect_after is not None \
                        and out["events"] >= disconnect_after:
                    out["disconnected"] = True
                    writer.close()
                    return out
            elif "finish_reason" in ev:
                out["finish_reason"] = ev["finish_reason"]
                if ev.get("error"):
                    out["error"] = ev["error"]
    except (ConnectionError, asyncio.IncompleteReadError):
        pass
    finally:
        try:
            writer.close()
        except Exception:  # noqa: BLE001
            pass
    return out


async def _sse_events(reader):
    """Yield decoded `data:` events until [DONE]/EOF."""
    while True:
        line = await reader.readline()
        if not line:
            return
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        data = line[len(b"data: "):]
        if data == b"[DONE]":
            return
        yield json.loads(data.decode())


async def _reattach_client(port: int, rid: int, frm: int,
                           tenant: str = "behaved") -> Dict:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"GET /v1/completions/{rid}?from={frm} HTTP/1.1\r\n"
                  f"Host: soak\r\nX-Tenant: {tenant}\r\n"
                  f"Connection: close\r\n\r\n").encode())
    await writer.drain()
    out = {"status": 0, "tokens": [], "finish_reason": None}
    try:
        status_line = await reader.readline()
        out["status"] = int(status_line.split()[1])
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
        if out["status"] != 200:
            return out
        async for ev in _sse_events(reader):
            if "token_ids" in ev:
                out["tokens"].extend(ev["token_ids"])
            elif "finish_reason" in ev:
                out["finish_reason"] = ev["finish_reason"]
    finally:
        try:
            writer.close()
        except Exception:  # noqa: BLE001
            pass
    return out


async def _http_get(port: int, path: str) -> Tuple[int, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"GET {path} HTTP/1.1\r\nHost: soak\r\n"
                  f"Connection: close\r\n\r\n").encode())
    await writer.drain()
    status_line = await reader.readline()
    status = int(status_line.split()[1])
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
    body = await reader.read()
    writer.close()
    return status, body


def _p99_ms(vals: List[float]) -> float:
    from .metrics import nearest_rank_p99
    return nearest_rank_p99(vals) * 1e3


def _engines(backend) -> List:
    return backend.live_engines() if hasattr(backend, "live_engines") \
        else [backend]


def _program_builds(backend) -> Dict:
    """Each live engine's decode and prefill program builds (on a card,
    CUDA graph captures), by engine."""
    return {e: sum(c["compiles"] for k, c in e.watchdog.counts().items()
                   if not k.endswith("_build"))
            for e in _engines(backend)}


def _builds_since(backend, before: Dict) -> int:
    """Program builds since `before` (`_program_builds`), over every
    engine live now (one built since counts whole)."""
    return sum(n - before.get(e, 0)
               for e, n in _program_builds(backend).items())


async def _soak(model, args, served=None) -> Tuple[int, Dict, Dict]:
    import sys

    import numpy as np

    from ..obs.prometheus import parse_exposition
    from .autoscale import AutoscalePolicy, FleetAutoscaler
    from .engine import LLMEngine
    from .fleet import EngineFleet

    soak_wall0 = time.perf_counter()
    eng_kw = dict(max_slots=args.slots, max_seq=256, max_queue=256,
                  prefix_block=8, seed=args.seed, device=args.device)
    if args.paged:
        # the paged layout: prefix_block is superseded by page_size
        # (the chunk IS the page); everything else composes unchanged
        eng_kw.pop("prefix_block")
        eng_kw.update(kv_layout="paged", page_size=8)
    if args.prefill_budget > 0:
        # the soak runs the serving stack the way production should:
        # chunked-prefill interleaving on (admission cannot
        # head-of-line-block decode); --prefill-budget 0 reproduces
        # monolithic admission
        eng_kw.update(prefill_budget=args.prefill_budget,
                      prefill_chunk=min(args.prefill_budget, 16))
    if args.kv_dtype is not None:
        # quantized KV threads through engine AND fleet as plain
        # config; the reference engine below re-serves on the same
        # kv_dtype, so the bit-identity gate compares quantized
        # streams to quantized streams
        eng_kw.update(kv_dtype=args.kv_dtype)
    if args.speculate > 0:
        # speculation threads through engine AND fleet untouched; the
        # soak asserts the same zero-stranded/bit-identity/tail
        # contracts hold with it on, which the accept rule guarantees
        eng_kw.update(speculate_k=args.speculate, draft=args.draft)
    if args.tp > 1:
        # TP-sharded serving threads through the same kwargs: the lone
        # backend serves on one TP group, a fleet one group per replica
        # (`fleet._build_engine` gives each its own ranks), and the
        # reference engine below re-serves on the same degree. Each
        # backend warms its own groups on the worker (`_start_warm`).
        eng_kw.update(tp=args.tp)

    # every FleetAutoscaler the soak attaches (the pre-drain backend's
    # and, after a restart, the resumed backend's) — the verdict sums
    # their decision logs so no scale event is lost across the drain
    scalers: List[FleetAutoscaler] = []

    def _attach_scaler(fleet) -> FleetAutoscaler:
        # soak-speed knobs: the policy's production defaults hold for
        # seconds; this soak's whole load step lasts a few seconds, so
        # holds/cooldowns shrink to keep hysteresis OBSERVABLE (a
        # breach still must persist across fleet rounds) without
        # making the run minutes long
        sc = FleetAutoscaler(fleet, AutoscalePolicy(
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            out_hold_s=0.05, in_hold_s=0.5,
            out_cooldown_s=0.2, in_cooldown_s=1.0),
            heartbeat_timeout_s=1.0)
        scalers.append(sc)
        return sc

    def build_backend():
        if args.autoscale:
            fleet = EngineFleet(model, replicas=args.min_replicas,
                                snapshot_every=2,
                                quarantine_backoff_s=0.01,
                                register_stats=False, **eng_kw)
            _attach_scaler(fleet)
            return fleet
        if args.replicas > 1:
            return EngineFleet(model, replicas=args.replicas,
                               snapshot_every=2,
                               quarantine_backoff_s=0.01,
                               register_stats=False, **eng_kw)
        return LLMEngine(model, register_stats=False, **eng_kw)

    policies = {
        "behaved": TenantPolicy(priority=1),
        "flood": TenantPolicy(tokens_per_s=50.0, burst_tokens=120.0,
                              max_streams=4),
    }
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(1, 512, (int(rng.randint(4, 16)),)).tolist()
               for _ in range(args.requests)]
    if args.autoscale:
        # the LOAD STEP: after the base wave, 2x as many requests at
        # 4x the arrival rate — the sustained backlog breach the
        # policy must answer with scale-outs, then (offered load
        # subsiding at the end) drain back toward the floor
        prompts += [rng.randint(1, 512,
                                (int(rng.randint(4, 16)),)).tolist()
                    for _ in range(2 * args.requests)]
    # every 6th behaved stream decodes 16x longer: with open-loop
    # arrivals the short streams finish between arrivals, so without
    # these the SIGTERM drain would always find an empty backend and
    # the snapshot/reattach path would go unexercised
    max_toks = [args.max_new_tokens * (16 if i % 6 == 3 else 1)
                for i in range(len(prompts))]

    # WARM the programs of the backend the server takes traffic on:
    # without this the first requests pay the program builds (on a
    # card, CUDA graph captures, 0.1-0.4 s each at GPT-small) and the
    # backlog they create pollutes every later stream's TTFT — the
    # tail gate measures the serving tail, not the build tail. The
    # reference warms a throwaway engine because its compiled programs
    # live with the model; the port's graphs belong to each engine, so
    # the served backend warms itself, and so does the backend the
    # restart builds after the drain. The warm-up runs on the worker
    # thread, before traffic: a thread's first capture also pays
    # one-time costs of its own (on a card, a replica revived mid-soak
    # captured in 0.8 s on a worker that had not captured, 0.15 s on
    # one that had), which belong outside the timed windows too.
    warm_lens = sorted({len(p) for p in prompts})
    warm_programs = 0

    async def _start_warm(srv) -> Dict:
        """Warm `srv`'s backend on its worker; its program builds."""
        nonlocal warm_programs

        def warm():
            return srv.backend.warm_up(warm_lens), \
                _program_builds(srv.backend)

        n, builds = await srv._wcall(warm)
        warm_programs += n
        return builds

    def _arrival_s(i: int) -> float:
        if i < args.requests:
            return i * args.spacing_ms * 1e-3
        # step-wave arrivals: 4x rate, starting where the base wave's
        # schedule ends
        return (args.requests * args.spacing_ms
                + (i - args.requests) * args.spacing_ms / 4.0) * 1e-3
    sp = {"max_tokens": args.max_new_tokens, "temperature": 0.0,
          "stream": True}

    server = LLMServer(build_backend(), policies=policies,
                       close_backend=True, drain_grace_s=0.1)
    await server.start()
    builds0 = await _start_warm(server)
    server.install_signal_handlers()

    # --- phase 1: concurrent behaved streams + a flood burst --------- #
    flood_t0 = time.perf_counter()
    tasks = []
    for i, p in enumerate(prompts):
        dc = 2 if args.disconnect_every \
            and i % args.disconnect_every == args.disconnect_every - 1 \
            else None
        tasks.append(asyncio.ensure_future(_soak_client(
            server.port,
            {**sp, "max_tokens": max_toks[i], "prompt": p}, "behaved",
            disconnect_after=dc, delay_s=_arrival_s(i))))
    flood_tasks = [asyncio.ensure_future(_soak_client(
        server.port, {**sp, "prompt": prompts[i % len(prompts)]},
        "flood")) for i in range(args.flood)]

    # --- autoscale extras: replica timeline + injected preemption --- #
    soak_t0 = time.monotonic()   # monotonic: comparable to the
    #                              autoscaler's own event clock
    timeline: List[List] = []
    sampler_task = None
    if args.autoscale:
        async def _sample_replicas():
            while True:
                def _counts():
                    st = server.backend.replica_states()
                    return (len(st), sum(1 for s in st
                                         if s in ("healthy",
                                                  "suspect")))
                try:
                    tot, srv = await server._wcall(_counts)
                except (RuntimeError, asyncio.TimeoutError):
                    return   # worker halted (drain) — timeline ends
                timeline.append([round(time.monotonic() - soak_t0,
                                       3), tot, srv])
                await asyncio.sleep(0.2)

        sampler_task = asyncio.ensure_future(_sample_replicas())

    killed_replica = -1
    if args.autoscale:
        # PREEMPTION mid-step: wait for the load step to be in flight,
        # then kill the busiest replica and do NOT revive it — the
        # watchdog's replace path must spawn the substitute on its own
        await asyncio.sleep(_arrival_s(args.requests) + 0.3)

        def _preempt():
            b = server.backend
            states = b.replica_states()
            if sum(1 for s in states
                   if s in ("healthy", "suspect")) < 2:
                return -1    # lone replica: killing it strands nothing
                #              (failover re-pends) but leaves no peer
                #              to adopt — retry once scaled out
            victim = b.busiest()
            b.kill(victim)   # no revive: preemptible capacity is GONE
            return victim

        for _ in range(20):
            try:
                killed_replica = await server._wcall(_preempt)
            except RuntimeError:
                break
            if killed_replica >= 0:
                break
            await asyncio.sleep(0.1)
    elif args.replicas > 1:
        await asyncio.sleep(0.3)

        def _kill():
            b = server.backend
            victim = b.busiest()
            b.kill(victim)
            b.revive(victim)
            return victim

        try:
            killed_replica = await server._wcall(_kill)
        except RuntimeError:
            pass

    # scrape the live server mid-traffic (tenant labels present) —
    # BEFORE the drain closes it
    exposition_ok = True
    await asyncio.sleep(0.1)
    try:
        _, body = await _http_get(server.port, "/metrics")
        parse_exposition(body.decode())
    except Exception as e:  # noqa: BLE001 — the gate
        print(f"FAIL: exposition: {e}", file=sys.stderr)
        exposition_ok = False

    drain_fired = False
    if args.drain_after > 0:
        while sum(t.done() for t in tasks) < min(args.drain_after,
                                                 len(tasks)):
            await asyncio.sleep(0.02)
        import os
        import signal as _signal
        os.kill(os.getpid(), _signal.SIGTERM)  # the REAL drain path
        drain_fired = True

    flood = await asyncio.gather(*flood_tasks)
    flood_done_t = time.perf_counter()  # the overload window closes
    behaved = await asyncio.gather(*tasks)
    if args.autoscale and not drain_fired:
        # offered load has subsided: give the policy a few rounds to
        # drain back toward the floor before the final timeline sample
        # (the scale-IN half of the elasticity story)
        t_settle = time.perf_counter()
        while time.perf_counter() - t_settle < 4.0:
            def _n_serving():
                return sum(1 for s in server.backend.replica_states()
                           if s in ("healthy", "suspect"))
            try:
                if await server._wcall(_n_serving) <= args.min_replicas:
                    break
            except (RuntimeError, asyncio.TimeoutError):
                break
            await asyncio.sleep(0.2)
    if sampler_task is not None:
        sampler_task.cancel()
        await asyncio.gather(sampler_task, return_exceptions=True)
    if drain_fired:
        await server.wait_closed()
    else:
        await server.stop()
    # the worker is joined: the backend is this thread's again
    builds_serving = _builds_since(server.backend, builds0)
    builds_steady = 0

    # --- phase 2: restart from the drain snapshot, reattach ---------- #
    reattached = 0
    snap = server.drain_snapshot
    interrupted = [r for r in behaved
                   if r.get("drained") and r["rid"] >= 0]
    if drain_fired:
        # the restart happens whether or not the drain left a snapshot
        # (a fully drained backend has nothing to resume, but late
        # staggered clients still need the restarted instance to
        # resubmit against — exactly like production)
        if snap is not None:
            backend2 = (EngineFleet.resume(model, snap,
                                           register_stats=False)
                        if args.replicas > 1 or args.autoscale
                        else LLMEngine.resume(model, snap,
                                              register_stats=False))
            if args.autoscale:
                _attach_scaler(backend2)
        else:
            backend2 = build_backend()
        server2 = LLMServer(backend2, policies=policies,
                            close_backend=True,
                            owners=server.drain_owners)
        await server2.start()
        builds2 = await _start_warm(server2)
        for r in interrupted:
            rr = await _reattach_client(server2.port, r["rid"],
                                        len(r["tokens"]))
            if rr["status"] == 200:
                reattached += 1
                r["tokens"].extend(rr["tokens"])
                r["finish_reason"] = rr["finish_reason"]
        # staggered clients that arrived during/after the drain were
        # refused or 503-shed — a real client honors Retry-After and
        # resubmits to the restarted instance; their streams must
        # still land bit-identical
        for i, r in enumerate(behaved):
            if r.get("refused") or r["status"] == 503:
                rr = await _soak_client(
                    server2.port,
                    {**sp, "max_tokens": max_toks[i],
                     "prompt": prompts[i]}, "behaved")
                behaved[i] = rr
        try:
            _, body = await _http_get(server2.port, "/metrics")
            parse_exposition(body.decode())
        except Exception as e:  # noqa: BLE001 — the gate
            print(f"FAIL: exposition(2): {e}", file=sys.stderr)
            exposition_ok = False
        await server2.stop()
        builds_steady = _builds_since(backend2, builds2)
        builds_serving += builds_steady
    if served is not None:
        served([server.backend] + ([server2.backend] if drain_fired
                                   else []))

    # --- verdicts ---------------------------------------------------- #
    # bit-identity: surviving complete greedy streams == an undisturbed
    # library engine; disconnected streams are strict prefixes
    ref_eng = LLMEngine(model, register_stats=False, **eng_kw)
    ref = [r.token_ids for r in ref_eng.generate(
        [np.asarray(p, np.int32) for p in prompts],
        [SamplingParams(max_new_tokens=mt) for mt in max_toks])]
    # the platform's decode speed, measured on the same model/config
    # by the undisturbed reference engine — the denominator that turns
    # the soak's absolute ttft_p99 into a machine-independent tail
    # ratio for the gate below
    rsnap = ref_eng.stats()
    decode_ms_per_token = (
        rsnap["decode_step_avg_s"] * rsnap["decode_step_count"]
        / max(rsnap["decode_tokens"], 1) * 1e3)
    kv_dtype = ref_eng.kv_dtype    # resolved storage dtype (the
    # engine normalizes None to the model's own dtype)
    kv_bytes_per_token = rsnap["kv_bytes_per_token"]
    ref_eng.close()
    mismatches = []
    stranded = []
    for i, r in enumerate(behaved):
        if r["status"] != 200:
            stranded.append(i)  # behaved tenant must never shed here
            continue
        if r.get("disconnected"):
            if r["tokens"] != ref[i][:len(r["tokens"])]:
                mismatches.append(i)
            continue
        if r.get("finish_reason") is None:
            stranded.append(i)  # incl. drained streams whose reattach
            continue            # failed — the no-strand contract
        if r["tokens"] != ref[i]:
            mismatches.append(i)
    shed_count = sum(1 for r in flood if r["status"] in (429, 503))
    missing_retry_after = [r for r in flood
                           if r["status"] == 429
                           and not r["retry_after"]]
    # TTFT under shedding pressure vs steady: behaved streams whose
    # first token landed while the flood burst was still in flight vs
    # after it ended (the soak's honest "did shaping protect the
    # behaved tenant" pair)
    flood_window_end = flood_done_t or flood_t0
    ttfts = [(r["ttft_at"], r["ttft_s"]) for r in behaved
             if r.get("ttft_s") is not None
             and r.get("ttft_at") is not None]
    during = [t for at, t in ttfts if at <= flood_window_end]
    after = [t for at, t in ttfts if at > flood_window_end]

    # tail gate: the steady-state ttft_p99, normalized by the
    # platform's own decode speed so the threshold is machine-
    # independent; the default (400) fails the soak if the stack
    # regresses toward monolithic admission's tail.
    # --autoscale runs a deliberate UNDER-capacity window: the load
    # step must breach and HOLD before the policy may add replicas,
    # so the streams arriving inside that window queue by design and
    # their TTFT measures the hysteresis, not the serving path. The
    # autoscale soak's gates are the elasticity contracts (scale-out
    # happened, preemption replaced, zero stranded, zero mismatches);
    # the tail gate stays armed for the fixed-capacity soaks.
    steady_ms = _p99_ms(after or during)
    tail_ratio = steady_ms / max(decode_ms_per_token, 1e-9)
    tail_ok = args.tail_gate <= 0 or args.autoscale \
        or tail_ratio <= args.tail_gate

    # paged zero-leak gate: at quiescence (every stream finished or
    # cancelled, prefix tree cleared) the page pool must hold NOTHING
    # beyond the reserved trash page — a nonzero count is a refcount
    # leak, the paged layout's equivalent of a stranded KV slot
    final_backend = server2.backend if drain_fired else server.backend
    leaked_pages = 0
    if args.paged:
        for eng in _engines(final_backend):
            if not getattr(eng, "paged", False):
                continue
            if eng.prefix is not None:
                eng.prefix.clear()
            leaked_pages += eng.cache.pool.leaked()

    # speculative-decoding tally for the artifact: summed over the
    # final backend's live engines (acceptance is an efficiency
    # signal; the stream contracts above are what the soak GATES)
    spec_proposed = spec_accepted = spec_fallbacks = 0
    if args.speculate > 0:
        for eng in _engines(final_backend):
            st = eng.stats()
            spec_proposed += int(st.get("spec_proposed", 0))
            spec_accepted += int(st.get("spec_accepted", 0))
            spec_fallbacks += int(st.get("spec_fallbacks", 0))

    # autoscale verdicts: decision logs summed over every attached
    # controller (pre-drain + restarted), the sampled replica-count
    # timeline, and proof the injected preemption was REPLACED (a
    # "replace rN" scale-out in the log) rather than merely survived
    asc_events = [ev for sc in scalers for ev in sc.events()]
    asc_scale_outs = sum(sc.scale_outs for sc in scalers)
    asc_scale_ins = sum(sc.scale_ins for sc in scalers)
    asc_spawn_failures = sum(sc.scale_out_failures for sc in scalers)
    preempt_replaced = any(k == "scale_out" and "replace" in d
                           for _, k, d in asc_events)
    autoscale_ok = (not args.autoscale
                    or (asc_scale_outs >= 1 and killed_replica >= 0
                        and preempt_replaced))

    report = {
        "requests": len(behaved),
        "flood_requests": len(flood),
        "shed_count": shed_count,
        "sheds_missing_retry_after": len(missing_retry_after),
        "disconnected_streams": sum(1 for r in behaved
                                    if r.get("disconnected")),
        "drained": bool(drain_fired),
        "drain_snapshot": snap is not None,
        "reattached_streams": reattached,
        "killed_replica": killed_replica,
        "stranded_count": len(stranded),
        "bit_mismatches": len(mismatches),
        "exposition_ok": bool(exposition_ok),
        "ttft_p99_shed_ms": _p99_ms(during),
        "ttft_p99_steady_ms": steady_ms,
        "decode_ms_per_token": round(decode_ms_per_token, 4),
        "ttft_tail_ratio": round(tail_ratio, 2),
        "tail_gate_ratio": args.tail_gate,
        "tail_gate_ok": bool(tail_ok),
        "prefill_budget": args.prefill_budget,
        "paged": bool(args.paged),
        "tp": int(args.tp),
        "kv_dtype": kv_dtype,
        "kv_bytes_per_token": round(float(kv_bytes_per_token), 2),
        "leaked_pages": int(leaked_pages),
        "speculate_k": int(args.speculate),
        "spec_proposed": spec_proposed,
        "spec_accepted": spec_accepted,
        "spec_fallbacks": spec_fallbacks,
        "spec_acceptance_rate": round(
            spec_accepted / spec_proposed, 4) if spec_proposed else 0.0,
    }
    if args.autoscale:
        report.update({
            "autoscale": True,
            "min_replicas": int(args.min_replicas),
            "max_replicas": int(args.max_replicas),
            # [t_since_soak_start_s, replicas_total, replicas_serving]
            "replica_timeline": timeline,
            "replicas_peak": max((t[1] for t in timeline),
                                 default=args.min_replicas),
            "scale_events": [[round(ts - soak_t0, 3), k, d]
                             for ts, k, d in asc_events],
            "scale_outs": asc_scale_outs,
            "scale_ins": asc_scale_ins,
            "spawn_failures": asc_spawn_failures,
            "preempt_replaced": bool(preempt_replaced),
            "autoscale_ok": bool(autoscale_ok),
        })
    with open(args.server_out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.server_out}: {json.dumps(report)}")
    ok = (not stranded and not mismatches and exposition_ok
          and not missing_retry_after and shed_count > 0 and tail_ok
          and leaked_pages == 0 and autoscale_ok)
    if not autoscale_ok:
        print(f"FAIL: autoscale contract: scale_outs="
              f"{asc_scale_outs} killed_replica={killed_replica} "
              f"preempt_replaced={preempt_replaced}", file=sys.stderr)
    if leaked_pages:
        print(f"FAIL: {leaked_pages} leaked KV pages at quiescence",
              file=sys.stderr)
    if stranded:
        print(f"FAIL: stranded streams: {stranded}", file=sys.stderr)
    if mismatches:
        print(f"FAIL: bit-identity mismatches: {mismatches}",
              file=sys.stderr)
    if missing_retry_after:
        print("FAIL: 429 without Retry-After", file=sys.stderr)
    if shed_count == 0:
        print("FAIL: flood produced zero sheds — overload shaping "
              "untested", file=sys.stderr)
    if not tail_ok:
        print(f"FAIL: serving tail ratio {tail_ratio:.1f} exceeds the "
              f"gate {args.tail_gate:.1f} (steady ttft_p99 "
              f"{steady_ms:.1f}ms at {decode_ms_per_token:.3f} "
              f"ms/token decode)", file=sys.stderr)
    extras = {"soak_s": time.perf_counter() - soak_wall0,
              "warm_programs": warm_programs,
              "builds_serving": builds_serving,
              "builds_steady": builds_steady,
              "ttft_during": len(during), "ttft_after": len(after)}
    return (0 if ok else 1), report, extras


if __name__ == "__main__":
    import sys
    sys.exit(main())
