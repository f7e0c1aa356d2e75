"""Logical ranks in one process: the runtime under `parallel/`.

A mesh of the port (`parallel.mesh.Mesh`) is k logical ranks that one
Python process drives on one device, as `nn/tp.py`'s TP group is
(ROADMAP Queue 1 item 13.4). This module is what the layers meet:

- **Collectives over lists** (`combine`): the ranks' tensors joined in
  rank order. Sums add ((p0 + p1) + p2) + ... in the parts' dtype
  (`nn.tp.all_reduce`), gathers concatenate (`nn.tp.all_gather`).
  `COUNTS` counts each collective once, whatever its number of ranks;
  `WIRE` adds up the bytes of the parts each moved, by dtype (every
  rank's part once: what the ranks would send), so a test can hold
  what crosses the wire (`parallel.compression`'s int8 sums).
- **SPMD runs** (`spmd(coords, fn)`): `fn(i)` for every rank i, each in
  a thread of its own (rank i's, kept for the process) and one thread
  at a time. A rank runs until it
  meets a collective or returns; then the next rank in rank order runs.
  A collective met in a run is a rendezvous: each rank of its group
  leaves its part, the last to arrive combines them in rank order, and
  every rank gets that result (views of one tensor on the shared
  device). So a run is deterministic (a fixed order of launches,
  rank-order sums), and ranks that must meet inside a computation can:
  batch norm under a mesh reduces each layer's moments over the data
  ranks mid-forward. When a part requires grad the collective is one
  autograd node over the ranks' parts with an output per rank
  (`_Joined`), whose backward takes the ranks' gradients in rank
  order: one backward over the ranks' graphs (the Trainer's joint
  backward) then gives the same bits whatever ran before it in the
  process.
- **The rank context** (`RankContext`, thread-local, entered with
  `use`): the rank's place in the mesh and what the layers read there.
  Dropout draws one mask over the global batch and keeps the rank's
  rows (`global_rows`); batch norm averages its shifted moments over
  the data ranks (`sync_moments`); a masked-mean loss divides by the
  count over the global batch (`mean_denominator`, filled from a count
  pass: `counting`). The Trainer enters the context inside the
  function it checkpoints, so a forward recomputed in the backward sees
  the same context; every entry after the first replays the
  collectives' results the first recorded, in order.
"""
from __future__ import annotations

import contextlib
import functools
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops_cuda.decode_attention import _LaunchCounter
from . import tp as _tp

__all__ = ["COUNTS", "WIRE", "counts", "wire", "reset_counts", "combine", "spmd",
           "RankContext", "use", "current", "in_run", "collective",
           "axis_index", "counting", "is_counting", "record_count",
           "mean_denominator", "axis_info", "rank_store",
           "mark_split", "split_marks",
           "global_rows", "sync_moments", "REDUCE_OPS"]

OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
       "all_to_all", "ppermute", "barrier")
REDUCE_OPS = ("sum", "max", "min", "avg", "prod")

# each collective once per call, whatever the number of ranks it joins
COUNTS: Dict[str, _LaunchCounter] = {name: _LaunchCounter() for name in OPS}


# bytes of the ranks' parts the collectives moved, by dtype name
WIRE: Dict[str, int] = {}


def counts() -> Dict[str, int]:
    return {k: c.count for k, c in COUNTS.items()}


def wire() -> Dict[str, int]:
    """{dtype name: bytes} of the parts the collectives joined since
    the last `reset_counts`."""
    return dict(WIRE)


def record_wire(parts):
    for p in parts:
        if isinstance(p, torch.Tensor):
            k = str(p.dtype).replace("torch.", "")
            WIRE[k] = WIRE.get(k, 0) + p.numel() * p.element_size()


def reset_counts():
    for c in COUNTS.values():
        c.reset()
    WIRE.clear()


# --------------------------------------------------------------------------- #
# the collectives' arithmetic, over the ranks' parts in rank order
# --------------------------------------------------------------------------- #

def _reduce(parts, op: str = "sum"):
    if op == "sum":
        return _tp.all_reduce(parts)
    if op == "avg":
        return _tp.all_reduce(parts) / len(parts)
    if op not in REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op!r}; expected one of "
                         f"{REDUCE_OPS}")
    f = {"max": torch.maximum, "min": torch.minimum, "prod": torch.mul}[op]
    out = parts[0]
    for p in parts[1:]:
        out = f(out, p)
    return out


def _all_gather(parts, axis: int = 0, tiled: bool = True):
    if tiled:
        return _tp.all_gather(parts, dim=axis)
    return torch.stack(list(parts), dim=axis)


def _reduce_scatter(parts, op: str = "sum", axis: int = 0):
    if op != "sum":
        raise NotImplementedError("reduce_scatter supports sum")
    n = len(parts)
    total = _tp.all_reduce(parts)
    if total.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of size "
                         f"{total.shape[axis]} does not split over {n} "
                         f"ranks")
    return list(total.chunk(n, dim=axis))


def _broadcast(parts, src: int = 0):
    return parts[src]


def _all_to_all(parts, split_axis: int = 0, concat_axis: int = 0):
    n = len(parts)
    for p in parts:
        if p.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of size "
                             f"{p.shape[split_axis]} does not split over "
                             f"{n} ranks")
    chunks = [p.chunk(n, dim=split_axis) for p in parts]
    return [torch.cat([chunks[j][i] for j in range(n)], dim=concat_axis)
            for i in range(n)]


def _ppermute(parts, perm=()):
    out = [None] * len(parts)
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"ppermute: rank {dst} receives twice")
        out[dst] = parts[src]
    return [o if o is not None else torch.zeros_like(p)
            for o, p in zip(out, parts)]


def _barrier(parts):
    return None


# name -> (function of the parts, whether every rank gets the same result)
_ARITH = {"all_reduce": (_reduce, True), "all_gather": (_all_gather, True),
          "reduce_scatter": (_reduce_scatter, False),
          "broadcast": (_broadcast, True),
          "all_to_all": (_all_to_all, False),
          "ppermute": (_ppermute, False), "barrier": (_barrier, True)}


def _grad_of(name, ctx, parts, gs):
    """The parts' gradients of collective `name` from the ranks' output
    gradients `gs` (None: zeros), each sum taken in rank order."""
    kw, k = ctx.kw, len(gs)

    def total():
        out = None
        for g in gs:
            if g is not None:
                out = g if out is None else out + g
        return out

    if name == "all_reduce":
        t = total()
        if t is not None and kw.get("op", "sum") == "avg":
            t = t / k
        return [t] * k
    if name == "all_gather":
        t, axis = total(), kw.get("axis", 0)
        if t is None:
            return [None] * k
        if not kw.get("tiled", True):
            return list(t.unbind(axis))
        return list(t.split([p.shape[axis] for p in parts], dim=axis))
    if name == "reduce_scatter":
        axis = kw.get("axis", 0)
        gs = [g if g is not None else o for g, o in zip(gs, ctx.outs)]
        whole = torch.cat(gs, dim=axis)
        return [whole] * k
    if name == "broadcast":
        return [total() if i == kw.get("src", 0) else None
                for i in range(k)]
    if name == "all_to_all":
        gs = [g if g is not None else o for g, o in zip(gs, ctx.outs)]
        return _all_to_all(gs, split_axis=kw.get("concat_axis", 0),
                           concat_axis=kw.get("split_axis", 0))
    if name == "ppermute":
        out = [None] * k
        for src, dst in kw.get("perm", ()):
            out[src] = gs[dst]
        return out
    raise NotImplementedError(f"no gradient for {name}")


class _Joined(torch.autograd.Function):
    """A collective over the ranks' parts as ONE autograd node with one
    output per rank. The ranks' graphs meet in it, so the joint
    backward sums their gradients in rank order inside the node: where
    each rank read one shared result, the engine added the ranks'
    gradients in the order it reached them, which follows the autograd
    sequence numbers of the ranks' threads (their history in the
    process), so two equal runs could differ in the last bit."""

    @staticmethod
    def forward(ctx, name, kw, *parts):
        fn, shared = _ARITH[name]
        ctx.name, ctx.kw = name, dict(kw)
        out = fn(list(parts), **ctx.kw)
        outs = [out] * len(parts) if shared else list(out)
        # fresh tensor objects: an output may not be an input or
        # another output
        outs = [o.view_as(o) for o in outs]
        # shapes only: what a missing output gradient is zeros of
        ctx.outs = [torch.empty_like(o, device="meta") for o in outs]
        ctx.parts = [torch.empty_like(p, device="meta") for p in parts]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        dev = next(g for g in gs if g is not None).device
        ctx.outs = [torch.zeros(o.shape, dtype=o.dtype, device=dev)
                    for o in ctx.outs]
        return (None, None, *_grad_of(ctx.name, ctx, ctx.parts, gs))


def _joined(name: str, parts: list, kw) -> list:
    """The ranks' results of collective `name`, one per part: through
    `_Joined` when a part requires grad, else the shared result (or
    the per-rank list)."""
    fn, shared = _ARITH[name]
    if torch.is_grad_enabled() and all(
            isinstance(p, torch.Tensor) for p in parts) and any(
            p.requires_grad for p in parts):
        if name == "all_reduce" and kw.get("op", "sum") not in ("sum",
                                                               "avg"):
            raise NotImplementedError(
                f"the gradient of all_reduce {kw['op']} inside an SPMD "
                f"run: reduce a detached tensor")
        return list(_Joined.apply(name, tuple(sorted(kw.items())), *parts))
    out = fn(parts, **kw)
    return [out] * len(parts) if shared else list(out)


def combine(name: str, parts: Sequence[torch.Tensor], **kw):
    """Collective `name` over the ranks' `parts` (rank order), counted
    once: one tensor when every rank gets the same (all_reduce,
    all_gather, broadcast), else the list of the ranks' results."""
    fn, _ = _ARITH[name]
    out = fn(list(parts), **kw)
    COUNTS[name].count += 1
    record_wire(parts)
    return out


# --------------------------------------------------------------------------- #
# SPMD runs
# --------------------------------------------------------------------------- #

class _Aborted(Exception):
    """Raised in the ranks of a run another rank has failed."""


class _Slot:
    def __init__(self, name, members):
        self.name = name
        self.members = members
        self.parts: Dict[int, object] = {}
        self.result = None
        self.complete = False
        self.taken = 0


class _Run:
    def __init__(self, coords: Sequence[Dict[str, int]],
                 partial: bool = False):
        self.coords = [dict(c) for c in coords]
        self.partial = partial
        self.k = len(self.coords)
        self.cv = threading.Lock()
        # one condition per rank over the one lock: a handover wakes the
        # rank it hands to, not every waiting rank
        self.wake = [threading.Condition(self.cv) for _ in range(self.k)]
        self.turn = 0
        self.done = [False] * self.k
        self.blocked: List[Optional[_Slot]] = [None] * self.k
        self.slots: Dict[tuple, _Slot] = {}
        self.seq: List[Dict[tuple, int]] = [{} for _ in range(self.k)]
        self.error: Optional[BaseException] = None

    def members(self, r: int, axes) -> List[int]:
        """The ranks that share rank r's coordinates off `axes`."""
        me = self.coords[r]
        return [q for q, c in enumerate(self.coords)
                if all(c.get(a) == v for a, v in me.items()
                       if a not in axes)]

    def _ready(self, q: int) -> bool:
        s = self.blocked[q]
        return not self.done[q] and (s is None or s.complete)

    def handover(self, r: int):
        """Give the turn to the next rank after r that can run (caller
        holds the lock)."""
        for d in range(1, self.k + 1):
            q = (r + d) % self.k
            if self._ready(q):
                self.turn = q
                self.wake[q].notify()
                return
        if not all(self.done) and self.error is None:
            waiting = {q: s.name for q, s in enumerate(self.blocked)
                       if s is not None and not self.done[q]}
            self.error = RuntimeError(
                f"SPMD run: ranks wait in collectives that can never "
                f"complete ({waiting}); every rank of a group must call "
                f"the same collectives in the same order")
        self.wake_all()

    def wake_all(self):
        for w in self.wake:
            w.notify_all()

    def wait_turn(self, r: int):
        while self.error is None and not (self.turn == r
                                          and self._ready(r)):
            self.wake[r].wait()
        if self.error is not None:
            raise _Aborted()

    def meet(self, r: int, name: str, axes: tuple, part, kw):
        """Rank r's part of collective `name` over `axes`; returns its
        result once every rank of the group has arrived."""
        with self.cv:
            if self.partial:
                self.error = NotImplementedError(
                    f"{name} over {axes} inside an SPMD run of this "
                    f"process's ranks of a mesh that spans processes: "
                    f"collectives across processes inside a computation "
                    f"are ROADMAP item 18")
                self.wake_all()
                raise _Aborted()
            seq = self.seq[r].get(axes, 0)
            self.seq[r][axes] = seq + 1
            off = tuple(sorted((a, v) for a, v in self.coords[r].items()
                               if a not in axes))
            key = (axes, off, seq)
            slot = self.slots.get(key)
            if slot is None:
                slot = self.slots[key] = _Slot(name,
                                               self.members(r, axes))
            if slot.name != name:
                self.error = RuntimeError(
                    f"SPMD run: rank {r} calls {name} where rank "
                    f"{min(slot.parts)} called {slot.name} (collective "
                    f"{seq} over {axes})")
                self.wake_all()
                raise _Aborted()
            slot.parts[r] = part
            if len(slot.parts) == len(slot.members):
                parts = [slot.parts[q] for q in slot.members]
                slot.result = _joined(name, parts, kw)
                COUNTS[name].count += 1
                record_wire(parts)
                slot.complete = True
            self.blocked[r] = slot
            self.handover(r)
            self.wait_turn(r)
            self.blocked[r] = None
            slot.taken += 1
            if slot.taken == len(slot.members):
                del self.slots[key]
            return slot.result[slot.members.index(r)]


class _Worker(threading.Thread):
    """A rank's thread, kept for the process: what a thread caches
    (cuDNN's execution plans are per thread) stays warm from one run
    to the next.

    Each job runs under the intra-op thread count of the thread that
    submitted it. OpenMP's and MKL's thread counts are per thread:
    `torch.set_num_threads` on the driving thread leaves a worker at
    the count it took at its first parallel op, so a rank's GEMMs and
    reductions could split their sums another way than the driving
    thread's, and from one run to the next."""

    def __init__(self, index: int):
        super().__init__(name=f"rank{index}", daemon=True)
        self.jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self.threads: Optional[int] = None
        self.start()

    def run(self):
        while True:
            job, threads, done = self.jobs.get()
            try:
                if threads != self.threads:
                    torch.set_num_threads(threads)
                    self.threads = threads
                job()
            finally:
                # the job's closure holds its run (the ranks' results
                # and, after a failure, their graphs): not past its end
                job = None
                done.set()


_workers: List[_Worker] = []
_workers_lock = threading.Lock()


def _on_workers(fns) -> None:
    """Run fns[i] on worker i and wait for all; from inside a worker
    (a run within a run) on fresh threads instead."""
    threads = torch.get_num_threads()
    if threading.current_thread() in _workers:
        def pinned(f):
            torch.set_num_threads(threads)
            f()

        fresh = [threading.Thread(target=pinned, args=(f,), daemon=True)
                 for f in fns]
        for t in fresh:
            t.start()
        for t in fresh:
            t.join()
        return
    # one run at a time on the workers: two runs from two threads
    # sharing them could each wait for a rank queued behind the other
    with _workers_lock:
        while len(_workers) < len(fns):
            _workers.append(_Worker(len(_workers)))
        done = []
        for w, f in zip(_workers, fns):
            ev = threading.Event()
            w.jobs.put((f, threads, ev))
            done.append(ev)
        for ev in done:
            ev.wait()


class _Local(threading.local):
    def __init__(self):
        self.run: Optional[_Run] = None
        self.rank = 0
        self.ctx: Optional["RankContext"] = None
        self.counts: Optional[list] = None


_local = _Local()


def in_run() -> bool:
    return _local.run is not None


def spmd(coords: Sequence[Dict[str, int]], fn: Callable[[int], object],
         partial: bool = False) -> list:
    """[fn(0), ..., fn(k-1)], rank i at mesh coordinates `coords[i]`,
    the ranks taking turns in rank order between collectives (see the
    module docstring). A failure in any rank ends the run and is raised
    here; a rank left waiting in a collective that cannot complete
    raises `RuntimeError`. `partial`: the ranks are this process's
    share of a mesh that spans processes, and a collective raises
    `NotImplementedError`."""
    run = _Run(coords, partial)
    results: list = [None] * run.k

    def body(r):
        prev = (_local.run, _local.rank)
        _local.run, _local.rank = run, r
        try:
            with run.cv:
                run.wait_turn(r)
            results[r] = fn(r)
        except _Aborted:
            pass
        except BaseException as e:          # the rank's own failure
            with run.cv:
                if run.error is None:
                    run.error = e
        finally:
            with run.cv:
                run.done[r] = True
                run.blocked[r] = None
                if run.turn == r:
                    run.handover(r)
                if run.error is not None:
                    run.wake_all()
            _local.run, _local.rank = prev

    if run.k == 1:
        body(0)
    else:
        _on_workers([functools.partial(body, r) for r in range(run.k)])
    if run.error is not None:
        raise run.error
    return results


# --------------------------------------------------------------------------- #
# the rank context
# --------------------------------------------------------------------------- #

class RankContext:
    """Rank `coords` of a mesh of `shape` ({axis: size}): its index
    among the data ranks (`data_axes`, row-major) and their number, the
    rows of its batch shard, the global counts its loss's masked means
    divide by (`denominators`, None: the rank's own counts), and the
    axes its gradients are split over in an optimizer update
    (`update_axes`: the Trainer's ZeRO partitions, over which a global
    norm sums)."""

    def __init__(self, coords: Dict[str, int], shape: Dict[str, int],
                 data_axes: Sequence[str] = (), rows: Optional[int] = None):
        self.coords = dict(coords)
        self.shape = dict(shape)
        self.data_axes = tuple(data_axes)
        idx, n = 0, 1
        for a in self.data_axes:
            idx = idx * self.shape.get(a, 1) + self.coords.get(a, 0)
            n *= self.shape.get(a, 1)
        self.data_index, self.data_ranks = idx, n
        self.rows = rows
        self.update_axes: tuple = ()
        # what a layer leaves for the loss on this rank (an MoE layer's
        # aux loss), by the layer's key
        self.store: Dict[object, object] = {}
        self.denominators: Optional[List[torch.Tensor]] = None
        self._den_pos = 0
        self._log: list = []
        self._pos = 0
        self._entries = 0

    @property
    def replaying(self) -> bool:
        return self._entries > 1


@contextlib.contextmanager
def use(ctx: RankContext):
    """Enter `ctx` on this thread; the first entry records its
    collectives' results, every later one replays them in order."""
    prev = _local.ctx
    _local.ctx = ctx
    ctx._entries += 1
    ctx._pos = 0
    ctx._den_pos = 0
    try:
        yield ctx
    finally:
        _local.ctx = prev


def current() -> Optional[RankContext]:
    return _local.ctx


def collective(name: str, part, axes: Sequence[str], **kw):
    """This rank's side of collective `name` over the mesh `axes`: a
    rendezvous inside an SPMD run, a replay in a recomputed forward."""
    axes = tuple(axes)
    ctx = _local.ctx
    if ctx is not None and ctx.replaying:
        if ctx._pos >= len(ctx._log):
            raise RuntimeError(f"recomputed forward calls {name} beyond "
                               f"the {len(ctx._log)} collectives its "
                               f"first run made")
        out = ctx._log[ctx._pos]
        ctx._pos += 1
        if not isinstance(out, torch.Tensor):
            return out
        # the recorded value, as a leaf that requires grad when the
        # original did: the recomputed ops then save what the first
        # forward's saved (the gradient runs through the first graph)
        return out.detach().requires_grad_(out.requires_grad)
    run = _local.run
    if run is None:
        raise RuntimeError(
            f"{name} over {axes} on one rank's tensor needs an SPMD run "
            f"(parallel.spmd, or Trainer(mesh=)); outside one pass the "
            f"list of the ranks' tensors")
    out = run.meet(_local.rank, name, axes, part, kw)
    if ctx is not None:
        ctx._log.append(out)
        ctx._pos += 1
    return out


def axis_index(axes: Sequence[str]) -> int:
    """This rank's index in its group over `axes` (0 outside a run)."""
    run = _local.run
    if run is None:
        return 0
    return run.members(_local.rank, tuple(axes)).index(_local.rank)


def axis_info(axis: str):
    """(this rank's index along mesh axis `axis`, the axis' size): from
    the rank context (so a forward a checkpoint recomputes outside the
    run reads the same), else from the SPMD run's coordinates; (0, 1)
    outside both."""
    ctx = _local.ctx
    if ctx is not None and axis in ctx.shape:
        return ctx.coords.get(axis, 0), ctx.shape[axis]
    run = _local.run
    if run is None or axis not in run.coords[_local.rank]:
        return 0, 1
    group = run.members(_local.rank, (axis,))
    return group.index(_local.rank), len(group)


def rank_store() -> Optional[Dict[object, object]]:
    """The rank context's store (None outside one): where a layer
    leaves a value its rank's loss reads (`parallel.moe`'s aux loss),
    since the ranks' module replicas share the loss function's
    closure."""
    ctx = _local.ctx
    return None if ctx is None else ctx.store


def mark_split(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Note on an output tensor that the ranks along `axis` hold its
    pieces along `dim` (a GPT's vocab-sharded logits over "tp", its
    sequence chunks over "sp"): `Trainer(mesh=)` joins them so the
    step returns the global output."""
    t._rank_split = getattr(t, "_rank_split", ()) + ((axis, dim),)
    return t


def split_marks(t) -> tuple:
    return getattr(t, "_rank_split", ())


# --- what the layers read ----------------------------------------------------

@contextlib.contextmanager
def counting():
    """The count pass: masked means inside record their counts
    (`record_count`) and return 0; yields the list of counts."""
    prev = _local.counts
    _local.counts = []
    try:
        yield _local.counts
    finally:
        _local.counts = prev


def is_counting() -> bool:
    return _local.counts is not None


def record_count(count: torch.Tensor) -> torch.Tensor:
    """Record one masked mean's count in the count pass; its stand-in
    value is 0."""
    _local.counts.append(count.detach().to(torch.float32).reshape(()))
    return torch.zeros((), dtype=torch.float32, device=count.device)


def mean_denominator(local: torch.Tensor) -> torch.Tensor:
    """What a masked mean divides by: `local` (its own count), or under
    a mesh the all-reduced count of the global batch, the i-th masked
    mean of the rank's loss taking the i-th."""
    ctx = _local.ctx
    if ctx is None or ctx.denominators is None:
        return local
    if ctx._den_pos >= len(ctx.denominators):
        raise RuntimeError("the loss takes more masked means than its "
                           "count pass recorded")
    d = ctx.denominators[ctx._den_pos]
    ctx._den_pos += 1
    return d.to(device=local.device, dtype=local.dtype)


def global_rows(shape) -> Optional[tuple]:
    """(global shape, first row, rows) when a draw of `shape` is this
    data rank's rows of one draw over the global batch (its leading dim
    is the rank's batch rows); None elsewhere."""
    ctx = _local.ctx
    shape = tuple(shape)
    if ctx is None or ctx.data_ranks == 1 or ctx.rows is None or \
            not shape or shape[0] != ctx.rows:
        return None
    return ((shape[0] * ctx.data_ranks,) + shape[1:],
            ctx.data_index * ctx.rows, ctx.rows)


def sync_moments(mean_s: torch.Tensor, ex2_s: torch.Tensor):
    """Batch norm's shifted moments averaged over the data ranks in rank
    order (the global batch's moments for equal shards); unchanged
    outside a mesh."""
    ctx = _local.ctx
    if ctx is None or ctx.data_ranks == 1:
        return mean_s, ex2_s
    both = collective("all_reduce", torch.stack([mean_s, ex2_s]),
                      ctx.data_axes, op="avg")
    return both[0], both[1]
