#!/usr/bin/env python3
"""Which dead objects, freed inside a CUDA graph capture, invalidate it?
A probe of the serving engine's captures on one NVIDIA H100.

A fleet leaves dead engines behind (a failover, a scale-in, a retired
replica), and the cycle collector frees them wherever it happens to
run, a capture included. This script frees one kind of garbage inside
a capture each, in a process of its own:

- graph / pinned / event / tensor: a captured and replayed CUDA graph,
  a pinned host buffer used by a non-blocking copy, a recorded event,
  a device tensor, each held by a dead reference cycle that a
  `gc.collect()` inside a second graph's capture frees;
- engine_nopause / engine: three captured `LLMEngine`s (gpt_tiny)
  dropped inside reference cycles, then a fresh engine's prefill and
  decode block captured with the collector run at nearly every
  allocation, without and with the engine's pause of the collector
  during a capture (`serving/graphs.py` `_cycle_collector_paused`).
  Whether a full collection lands inside a capture depends on the
  collector's timing, so this runs `TRIALS` times and counts.

Each prints one `PROBE <kind>: capture ok` or `capture FAILED: ...`
(engine kinds: in how many of the trials), or says that its process
ended before it could report.

    python3 scripts/capture_gc_probe.py          # every kind
    python3 scripts/capture_gc_probe.py graph    # one kind
"""
from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys

KINDS = ("graph", "pinned", "event", "tensor", "engine_nopause", "engine")
TRIALS = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Box:
    pass


def _garbage(torch, kind: str):
    """A dead reference cycle holding one object of `kind`."""
    b = _Box()
    b.me = b
    if kind == "graph":
        x = torch.zeros(1024, device="cuda")
        g = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            x.add_(1)
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g):
            x.add_(1)
        g.replay()
        b.g, b.x = g, x
    elif kind == "pinned":
        h = torch.ones(1 << 20, pin_memory=True)
        d = torch.empty(1 << 20, device="cuda")
        d.copy_(h, non_blocking=True)
        b.h, b.d = h, d
    elif kind == "event":
        e = torch.cuda.Event()
        e.record()
        b.e = e
    else:
        b.t = torch.empty(1 << 24, device="cuda")
    torch.cuda.synchronize()


def _collect_inside_capture(torch) -> int:
    y = torch.zeros(4096, device="cuda")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y.add_(1)
        n = gc.collect()
        y.mul_(2)
    g.replay()
    torch.cuda.synchronize()
    return n


def _engines(kind: str) -> list:
    """The failures of `TRIALS` trials (their first lines): a capture
    of any engine in a trial, the dead ones' included."""
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    from paddle_tpu_torch.models import gpt_tiny
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    from paddle_tpu_torch.serving import graphs
    if kind == "engine_nopause":
        graphs._cycle_collector_paused = contextlib.nullcontext
    m = gpt_tiny(seed=0, device="cuda")
    sp = SamplingParams(max_new_tokens=4)
    failed = []
    for _ in range(TRIALS):
        thresholds = gc.get_threshold()
        try:
            for _ in range(3):
                dead = LLMEngine(m, max_slots=2, max_seq=256,
                                 device="cuda")
                dead.me = dead
                dead.generate([np.arange(5), np.arange(100)], sp)
                del dead
            gc.collect(0)
            eng = LLMEngine(m, max_slots=2, max_seq=256, device="cuda")
            gc.set_threshold(1, 1, 1)
            eng.generate([np.arange(200)], sp)
            del eng
        except Exception as err:  # noqa: BLE001 — counted
            failed.append(f"{type(err).__name__}: "
                          f"{str(err).splitlines()[0]}")
        finally:
            gc.set_threshold(*thresholds)
        gc.collect()
        torch.cuda.synchronize()
    return failed


def probe(kind: str):
    import torch
    if kind.startswith("engine"):
        failed = _engines(kind)
        what = (f"capture FAILED in {len(failed)} of {TRIALS} trials: "
                f"{failed[0]}" if failed else
                f"capture ok in {TRIALS} of {TRIALS} trials")
        print(f"PROBE {kind}: {what}", flush=True)
        return
    try:
        _garbage(torch, kind)
        n = _collect_inside_capture(torch)
        print(f"PROBE {kind}: capture ok, {n} objects collected",
              flush=True)
    except Exception as err:  # noqa: BLE001 — the probe's result
        print(f"PROBE {kind}: capture FAILED: {type(err).__name__}: "
              f"{str(err).splitlines()[0]}", flush=True)


def main() -> int:
    if len(sys.argv) > 1:
        probe(sys.argv[1])
        return 0
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    for kind in KINDS:
        proc = subprocess.run([sys.executable, __file__, kind],
                              capture_output=True, text=True, timeout=300)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            # a capture error raised where it cannot propagate (an
            # event recorded by a destructor) ends the process
            why = ("a capture invalidated" if "during capture"
                   in proc.stderr else "see its standard error")
            print(f"PROBE {kind}: the process ended with code "
                  f"{proc.returncode} before it reported ({why})",
                  flush=True)
            sys.stderr.write(proc.stderr[-4000:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
