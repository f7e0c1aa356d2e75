"""Decode blocks as CUDA graphs: the counterpart of the JAX engine's
compiled block programs (`_build_decode_block_fn`,
`_build_spec_decode_block_fn` and its `_jits` cache).

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
- On a CUDA device the function is captured once into a CUDA graph and
  every block is one replay. Warm-up and capture run with every lane
  frozen (act all False): a frozen lane parks its writes at row T-1
  (slotted) or on the trash page (paged), rows no live lane attends,
  and the chained state is restored afterwards. A capture that fails
  raises `GraphCaptureError`; nothing carries on eagerly.
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
  processed block) and `count_replay` adds them on every replay.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops_cuda.decode_attention import _LaunchCounter

__all__ = ["GraphCaptureError", "LaneState", "BlockRunner", "BlockResult",
           "counted_capture", "count_replay"]

# the lane-state arguments of `_decode_block` / `_spec_decode_block`,
# in their order; `tables` (paged) rides as a keyword
LANE_ARGS = ("cur", "pos", "rem", "act", "salt", "temp", "topk", "topp",
             "eos")
# the part of the lane state a block advances (and chains in place)
CHAINED = ("cur", "pos", "rem", "act")


class GraphCaptureError(RuntimeError):
    """A decode block could not be captured into a CUDA graph. Raised
    through the engine's recovery boundary: it is a fault of the
    program or the configuration, not a transient one."""


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

    `body(*lane_args, tables=...)` is `_decode_block` or
    `_spec_decode_block` with everything but the lane state bound; it
    returns (tokens (steps, S), emits (steps, S), cur, pos, rem, act[,
    tally (2,)]). `graphed` captures it into a CUDA graph (the lanes
    must live on a card)."""

    _RING = 2   # dispatches in flight at most: the block and one ahead

    def __init__(self, body: Callable, lanes: LaneState, steps: int,
                 spec: bool, graphed: bool):
        self.body = body
        self.lanes = lanes
        self.steps = int(steps)
        self.spec = bool(spec)
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
        """The block: read the static inputs, write the static outputs,
        chain the lane state into the inputs."""
        bufs = self.lanes.bufs
        toks, emits, *state = self.body(*(bufs[k] for k in LANE_ARGS),
                                        tables=bufs.get("tables"))
        tally = state[4:]
        parts = [toks.reshape(-1).to(torch.int64),
                 emits.reshape(-1).to(torch.int64)]
        parts += [t.reshape(-1).to(torch.int64) for t in tally]
        self.out.copy_(torch.cat(parts))
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
        ctx = torch.cuda.graph(graph)
        # warm up on the stream the capture runs on (PyTorch's one
        # process-wide capture stream): cuBLAS keeps a workspace per
        # stream for the life of the process, so a new side stream per
        # capture would hold one more workspace per engine
        side = ctx.capture_stream

        def warm_up():
            # off the current stream, as graph capture requires: lazy
            # library loads, cuBLAS handles and the int8 kernel's
            # shared-memory opt-in happen here, outside the capture
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._step()
            torch.cuda.current_stream().wait_stream(side)

        def capture():
            with ctx:
                self._step()

        kind = "speculative" if self.spec else "plain"
        try:
            with self.frozen():
                self.deltas = counted_capture(warm_up, capture)
        except Exception as err:  # noqa: BLE001 — named and re-raised
            raise GraphCaptureError(
                f"capturing the {kind} decode block ({self.steps} steps) "
                f"into a CUDA graph failed: {type(err).__name__}: "
                f"{err}") from err
        self.graph = graph

    def run(self) -> BlockResult:
        """One block: a graph replay (or, ungraphed, the function on the
        static buffers), then the outputs' copy to this dispatch's host
        buffer behind an event."""
        if self.graph is not None:
            self.graph.replay()
            count_replay(self.deltas)
        else:
            self._step()
        host, event = self._ring[self._next]
        self._next = (self._next + 1) % self._RING
        host.copy_(self.out, non_blocking=True)
        if event is not None:
            event.record()
        return BlockResult(host, event)
