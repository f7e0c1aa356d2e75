"""Decode blocks and prefills as CUDA graphs: the counterpart of the JAX
engine's compiled block programs (`_build_decode_block_fn`,
`_build_spec_decode_block_fn` and its `_jits` cache) and of its
compiled prefill programs (`_prefill_fn`, one per bucket, built by
`_build_prefill_fn` / `_build_paged_prefill_fn`).

An engine owns one `LaneState`, the static input buffers of its decode
blocks (cur / pos / rem / act / salt / temp / topk / topp / eos, and
the block tables under the paged layout), and one `BlockRunner` per
block program it dispatches: plain, and speculative when `speculate_k`
> 0. Both runners read the same buffers, so a block degraded to the
plain program continues from the speculative one's lane state.

- The runner's function CHAINS the lane state in place: the block's
  new cur / pos / rem / act are copied into the input buffers at its
  end, so block N+1 replays off block N's state with no host round
  trip. Host mirror edits (admission, cancel, a discard) are uploaded
  into the same buffers (`LaneState.upload`) before the next replay.
- On a CUDA device the function is captured once into a CUDA graph. A
  speculative block is one replay; a plain block is `decode_block_size`
  replays of a one-step graph, each shifting its row into the block's
  outputs: the same bits as one block-long graph at one step's capture
  cost, which a replica spawned or revived under traffic pays on the
  one thread that serves every stream. Warm-up and capture run with
  every lane frozen (act all False): a frozen lane parks its writes at
  row T-1 (slotted) or on the trash page (paged), rows no live lane
  attends, and the chained state is restored afterwards. A capture
  that fails raises `GraphCaptureError`; nothing carries on eagerly.
  The cycle collector is paused during each capture
  (`_cycle_collector_paused`).
- After each run the block's outputs (tokens, emit flags and, for a
  speculative block, the (proposed, accepted) tally) are copied to a
  host buffer owned by that dispatch, behind an event: the one host
  sync of `_process_block` is that event's `synchronize()`, and the
  next replay may overwrite the static outputs meanwhile.
- On the CPU (the tests) the same runner calls the function directly
  on the same static buffers: staging, chaining and re-upload run as on
  the card; only capture and replay are card-only.
- Kernel launch counters count Python calls, and a replay makes none:
  `counted_capture` records each counter's launches over the capture
  (restoring every counter afterwards, since warm-up and capture run no
  processed block) and `count_replay` adds them on every replay. A TP
  engine's collective counters (`nn/tp.py`) are such counters too.
- Under a TP group every rank's kernels and the collectives between
  them run on the engine's one device, so a block, a one-step program
  or a prefill is still one capture and one replay.

Prefill: an engine owns one `PrefillRunner` per prefill row count it
uses, made at the first prefill of that many rows, as the JAX engine
jits a bucket on demand. Everything a prefill call varies (the padded
token ids, the slot, the first position, the real length and, paged,
the lane's block-table row) lives in one static device buffer, filled
through pinned staging behind an event as `LaneState.upload` does, so
one captured graph serves every call of its row count. Warm-up and
capture run with every write parked (at a position past the cache's
rows: slotted row T-1, the paged trash page). All prefill graphs of an
engine share one graph memory pool: they never replay at once, and
nothing allocated in the pool outlives its capture (the logits go to a
buffer made at warm-up), so any replay order is safe.

Model-side generation (`models/gpt.py` `generate_compiled` and
`beam_search_compiled`, the counterparts of the reference's one-XLA-
program loops): a `GraphedCall` holds one whole generation, its every
step unrolled over static buffers the caller owns, as one CUDA graph
per signature; each call is one replay and its outputs are copied out.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops_cuda.decode_attention import _LaunchCounter

__all__ = ["GraphCaptureError", "LaneState", "BlockRunner", "BlockResult",
           "PrefillRunner", "GraphedCall", "counted_capture",
           "count_replay"]

# the lane-state arguments of `_decode_block` / `_spec_decode_block`,
# in their order; `tables` (paged) rides as a keyword
LANE_ARGS = ("cur", "pos", "rem", "act", "salt", "temp", "topk", "topp",
             "eos")
# the part of the lane state a block advances (and chains in place)
CHAINED = ("cur", "pos", "rem", "act")


class GraphCaptureError(RuntimeError):
    """A decode block or a prefill could not be captured into a CUDA
    graph. Raised through the engine's recovery boundary: it is a fault
    of the program or the configuration, not a transient one."""


def counted_capture(warm_up: Callable[[], None],
                    capture: Callable[[], None]) -> List[int]:
    """Run `warm_up()` then `capture()`; return every launch counter's
    count over `capture()` alone, one entry per
    `_LaunchCounter.instances`. Every counter is restored to its value
    before `warm_up()`, raise or not: neither runs a processed block."""
    counters = list(_LaunchCounter.instances)
    before = [c.count for c in counters]
    try:
        warm_up()
        mid = [c.count for c in counters]
        capture()
        return [c.count - m for c, m in zip(counters, mid)]
    finally:
        for c, b in zip(counters, before):
            c.count = b


def count_replay(deltas: List[int]):
    """Add one replay's launches (`counted_capture`'s result)."""
    for c, d in zip(_LaunchCounter.instances, deltas):
        c.count += d


def _host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A host tensor to copy through: pinned when `device` is a card,
    so a `non_blocking` copy is truly asynchronous."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=device.type == "cuda")


def _event(device: torch.device) -> Optional[torch.cuda.Event]:
    return torch.cuda.Event() if device.type == "cuda" else None


def _warm_up_and_capture(graph: torch.cuda.CUDAGraph, step: Callable,
                         pool=None) -> List[int]:
    """Warm `step()` up, then capture it into `graph` (in the graph
    memory pool `pool`, or a pool of its own); returns
    `counted_capture`'s launch deltas."""
    ctx = torch.cuda.graph(graph, pool=pool)
    # warm up on the stream the capture runs on (PyTorch's one
    # process-wide capture stream): cuBLAS keeps a workspace per stream
    # for the life of the process, so a new side stream per capture
    # would hold one more workspace per engine
    side = ctx.capture_stream

    def warm_up():
        # off the current stream, as graph capture requires: lazy
        # library loads, cuBLAS handles and the int8 kernel's
        # shared-memory opt-in happen here, outside the capture
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)

    def capture():
        with _cycle_collector_paused(), ctx:
            step()

    return counted_capture(warm_up, capture)


@contextlib.contextmanager
def _cycle_collector_paused():
    """Python's cycle collector held off for the span of a capture.

    A collection that runs inside a capture (set off by any allocation
    the step makes) frees whatever dead cycles hold, such as another
    engine's CUDA graphs: a fleet leaves such engines behind at a
    failover or a scale-in. A CUDA graph destroyed on the capturing
    thread invalidates the capture (`cudaErrorStreamCaptureInvalidated`).
    Paused, those cycles wait for the next collection outside any
    capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class LaneState:
    """The static input buffers of an engine's decode blocks, made from
    the host mirrors `arrays` (name -> numpy array)."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 device: torch.device):
        self.device = device
        self.bufs = {k: torch.from_numpy(np.array(a)).to(device)
                     for k, a in arrays.items()}
        self._stage = {k: _host_buffer(b.shape, b.dtype, device)
                       for k, b in self.bufs.items()}
        self._staged = _event(device)

    def upload(self, arrays: Dict[str, np.ndarray]):
        """Copy the host mirrors into the static buffers (stream-ordered
        after every block enqueued so far). On a card the copies go
        through pinned staging buffers; the previous upload's copies
        are waited for before the staging buffers are refilled."""
        if self._staged is not None:
            self._staged.synchronize()
        for k, a in arrays.items():
            stage = self._stage[k]
            np.copyto(stage.numpy(), a)
            self.bufs[k].copy_(stage, non_blocking=True)
        if self._staged is not None:
            self._staged.record()


class BlockResult:
    """One dispatched block's outputs on their way to the host."""

    def __init__(self, host: torch.Tensor, event):
        self._host = host
        self._event = event

    def wait(self) -> np.ndarray:
        """The flat int64 outputs (tokens, emits[, proposed, accepted]),
        after waiting for their copy: the block's one host sync."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().copy()


class BlockRunner:
    """One decode block program of an engine over `lanes`.

    `body(*lane_args, tables=...)` is `_spec_decode_block`, or
    `_decode_block` of one step, with everything but the lane state
    bound; it returns (tokens (rows, S), emits (rows, S), cur, pos, rem,
    act[, tally (2,)]). A block emits `steps` rows: a speculative block
    in one run of the program; a plain block in `steps` runs of the
    one-step program, whose state chains in place and whose row shifts
    into the block's outputs, so its capture (and a replica's stall at
    spawn) costs a step's, not a block's, with the same bits. `graphed`
    captures the program into a CUDA graph (the lanes must live on a
    card)."""

    _RING = 2   # dispatches in flight at most: the block and one ahead

    def __init__(self, body: Callable, lanes: LaneState, steps: int,
                 spec: bool, graphed: bool):
        self.body = body
        self.lanes = lanes
        self.steps = int(steps)
        self.spec = bool(spec)
        self.runs = 1 if self.spec else self.steps
        S = lanes.bufs["cur"].shape[0]
        n = 2 * self.steps * S + (2 if spec else 0)
        dev = lanes.device
        self.out = torch.zeros(n, dtype=torch.int64, device=dev)
        self._ring = [(_host_buffer((n,), torch.int64, dev), _event(dev))
                      for _ in range(self._RING)]
        self._next = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.deltas: List[int] = []
        if graphed:
            self._capture()

    def _step(self):
        """One run of the program: read the static inputs, write the
        static outputs (a plain block's one-step run shifts the block's
        rows up one and writes its row last), chain the lane state into
        the inputs."""
        bufs = self.lanes.bufs
        toks, emits, *state = self.body(*(bufs[k] for k in LANE_ARGS),
                                        tables=bufs.get("tables"))
        tally = state[4:]
        if self.spec:
            parts = [toks.reshape(-1).to(torch.int64),
                     emits.reshape(-1).to(torch.int64)]
            parts += [t.reshape(-1).to(torch.int64) for t in tally]
            self.out.copy_(torch.cat(parts))
        else:
            n = self.out.numel() // 2
            for rows, new in ((self.out[:n], toks), (self.out[n:], emits)):
                rows = rows.view(self.steps, -1)
                rows.copy_(torch.cat([rows[1:], new.to(torch.int64)]))
        for name, t in zip(CHAINED, state[:4]):
            bufs[name].copy_(t)

    @contextlib.contextmanager
    def frozen(self):
        """Every lane frozen for the duration (act all False), the
        chained lane state restored after: what warm-up and capture run
        under, so that neither touches a row a live lane attends nor
        moves the state a later replay continues from."""
        bufs = self.lanes.bufs
        saved = {k: bufs[k].clone() for k in CHAINED}
        bufs["act"].zero_()
        try:
            yield
        finally:
            for k in CHAINED:
                bufs[k].copy_(saved[k])

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        kind = "speculative" if self.spec else "plain"
        try:
            with self.frozen():
                self.deltas = _warm_up_and_capture(graph, self._step)
        except Exception as err:  # noqa: BLE001 — named and re-raised
            raise GraphCaptureError(
                f"capturing the {kind} decode block ({self.steps} steps, "
                f"{self.runs} runs) "
                f"into a CUDA graph failed: {type(err).__name__}: "
                f"{err}") from err
        self.graph = graph

    def run_once(self):
        """One run of the program (a graph replay, or the function),
        without the outputs' host copy: what a continuation's replay
        step runs."""
        if self.graph is not None:
            self.graph.replay()
            count_replay(self.deltas)
        else:
            self._step()

    def run(self) -> BlockResult:
        """One block: `runs` graph replays (or, ungraphed, runs of the
        function on the static buffers), then the outputs' copy to this
        dispatch's host buffer behind an event."""
        for _ in range(self.runs):
            self.run_once()
        host, event = self._ring[self._next]
        self._next = (self._next + 1) % self._RING
        host.copy_(self.out, non_blocking=True)
        if event is not None:
            event.record()
        return BlockResult(host, event)


class PrefillRunner:
    """One prefill program of an engine: `rows` rows.

    `body(ids, slot, pos0, length, table=...)` is the engine's
    `_prefill_forward` with the model and the cache bound: ids (1, rows)
    and slot / pos0 / length (1,) int64, and, when `table_len` > 0 (the
    paged layout), the lane's block-table row (table_len,), all device
    values; it returns the last real row's fp32 logits. `cache_rows` is
    the cache's T: warm-up and capture run at position T, where every
    write parks. `graphed` captures the program into a CUDA graph in
    the graph memory pool `pool` (the inputs must live on a card)."""

    def __init__(self, body: Callable, rows: int, cache_rows: int,
                 table_len: int, device: torch.device, graphed: bool,
                 pool=None):
        self.body = body
        self.rows = R = int(rows)
        self.cache_rows = int(cache_rows)
        n = R + 3 + int(table_len)
        # ids, slot, pos0, length, table: one buffer, one upload
        self._inp = torch.zeros(n, dtype=torch.int64, device=device)
        self._stage = _host_buffer((n,), torch.int64, device)
        self._staged = _event(device)
        self._args = (self._inp[:R].view(1, R), self._inp[R:R + 1],
                      self._inp[R + 1:R + 2], self._inp[R + 2:R + 3])
        self._table = self._inp[R + 3:] if table_len else None
        self.out: Optional[torch.Tensor] = None  # made by the first run
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.deltas: List[int] = []
        self.pool_bytes = 0       # what the capture added to the pool
        if graphed:
            self._capture(pool)

    def _upload(self, ids: np.ndarray, slot: int, pos0: int,
                table: Optional[np.ndarray]):
        """Stage one call's inputs (ids zero-padded to `rows`) and copy
        them into the static buffer, stream-ordered after every program
        enqueued so far; the previous upload's copy is waited for before
        the staging buffer is refilled."""
        if self._staged is not None:
            self._staged.synchronize()
        st, R = self._stage.numpy(), self.rows
        st[:R] = 0
        st[:ids.size] = ids
        st[R:R + 3] = (slot, pos0, ids.size)
        if self._table is not None:
            st[R + 3:] = 0 if table is None else table
        self._inp.copy_(self._stage, non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def _step(self):
        logits = self.body(*self._args, table=self._table)
        if self.out is None:
            self.out = torch.empty_like(logits)
        self.out.copy_(logits)

    def _capture(self, pool):
        graph = torch.cuda.CUDAGraph()
        dev = self._inp.device

        def step():
            # what the capture's allocations add to the pool (warm-up
            # allocates outside it, and makes `out` there too)
            r0 = torch.cuda.memory_reserved(dev)
            self._step()
            if torch.cuda.is_current_stream_capturing():
                self.pool_bytes = torch.cuda.memory_reserved(dev) - r0

        try:
            # every write parks: slot 0 from position T on
            self._upload(np.zeros(1, np.int64), 0, self.cache_rows, None)
            self.deltas = _warm_up_and_capture(graph, step, pool)
        except Exception as err:  # noqa: BLE001 — named and re-raised
            raise GraphCaptureError(
                f"capturing the {self.rows}-row prefill into a CUDA graph "
                f"failed: {type(err).__name__}: {err}") from err
        self.graph = graph

    def run(self, ids: np.ndarray, slot: int, pos0: int,
            table: Optional[np.ndarray] = None) -> torch.Tensor:
        """Prefill `ids` (at most `rows` tokens) into `slot` from
        position `pos0` (through the lane's block-table row `table` when
        paged): a graph replay (or, ungraphed, the function on the
        static buffers). Returns a copy of the last real token's fp32
        logits: the next replay may overwrite the static buffer before
        the caller samples from them."""
        self._upload(ids, slot, pos0, table)
        if self.graph is not None:
            self.graph.replay()
            count_replay(self.deltas)
        else:
            self._step()
        return self.out.clone()


class GraphedCall:
    """A function of static device buffers, run as one CUDA graph.

    `fn()` reads buffers its caller owns and fills between calls, and
    returns a tuple of tensors; they are copied into output buffers made
    at the first run, so nothing the graph allocates outlives its
    capture and graphs may share the memory pool `pool`. `graphed`
    captures it (after one warm-up run, whose launches are not counted);
    otherwise, and on the CPU, `run()` calls `fn` directly."""

    def __init__(self, fn: Callable, graphed: bool, pool=None,
                 what: str = "call"):
        self.fn = fn
        self.outs: Optional[List[torch.Tensor]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.deltas: List[int] = []
        self.pool_bytes = 0       # what the capture added to the pool
        if graphed:
            self._capture(pool, what)

    def _step(self):
        res = self.fn()
        if self.outs is None:
            self.outs = [torch.empty_like(r) for r in res]
        for o, r in zip(self.outs, res):
            o.copy_(r)

    def _capture(self, pool, what: str):
        graph = torch.cuda.CUDAGraph()

        def step():
            dev = torch.cuda.current_device()
            r0 = torch.cuda.memory_reserved(dev)
            self._step()
            if torch.cuda.is_current_stream_capturing():
                self.pool_bytes = torch.cuda.memory_reserved(dev) - r0

        try:
            self.deltas = _warm_up_and_capture(graph, step, pool)
        except Exception as err:  # noqa: BLE001 — named and re-raised
            raise GraphCaptureError(
                f"capturing the {what} into a CUDA graph failed: "
                f"{type(err).__name__}: {err}") from err
        self.graph = graph

    def run(self) -> List[torch.Tensor]:
        """One call: a replay (its launches counted) or, ungraphed, the
        function; returns copies of the outputs."""
        if self.graph is not None:
            self.graph.replay()
            count_replay(self.deltas)
        else:
            self._step()
        return [o.clone() for o in self.outs]
