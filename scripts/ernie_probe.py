#!/usr/bin/env python3
"""Probe behind chip_smoke.py's ERNIE phases (6j, 6k): where a step of
ERNIE-3.0-base at bench.py's configuration goes on the card, on the
dense attention route (dropout 0.1) and on the K2/K3 route
(`attention_dropout=0`), in turns dense / flash / dense / flash.

    python3 scripts/ernie_probe.py [--turns 4] [--out FILE]

Each turn builds `BertForSequenceClassification(ernie_base(...), 2)`
from seed 0 with chip_smoke's trainer and batch (AdamW(2e-5), O2 bf16,
64 x 128 ids), takes 3 warm-up steps, then: step ms over 10 steps
ending in a synchronise; one more step's host enqueue ms (the time
`train_steps` takes to return, before the device has finished); and a
profile of 2 steps (torch.profiler): the host ops by self CPU time and
the device's busy ms and kernels by device time. Needs the card; every
line names it and its power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def turn(torch, np, cs, P, name: str, dropout: float, card: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = P.models.ernie_base(attention_dropout=dropout)
    model, tr = cs.ernie_trainer(P, cfg)
    ids, y = cs.ernie_batch(torch, np, cfg)
    tr.train_steps(ids, y, steps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_steps(ids, y, steps=10)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 100
    t0 = time.perf_counter()
    tr.train_steps(ids, y, steps=1)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_steps(ids, y, steps=2)
        torch.cuda.synchronize()
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = cs.busy_us(kernels) / 1e3 / 2
    by = {}
    for e in kernels:
        by[e.name] = by.get(e.name, 0.0) + (e.time_range.end
                                            - e.time_range.start) / 2e3
    cs.log(f"{name}: {step_ms:.2f} ms a step, one step's host enqueue "
           f"{host_ms:.2f} ms, device busy {busy:.2f} ms a step [{card}]")
    cs.log("  host ops by self CPU time (ms over 2 steps, calls):")
    for e in host[:12]:
        cs.log(f"    {e.self_cpu_time_total / 1e3:8.2f} {e.count:6d} "
               f"{e.key[:90]}")
    cs.log("  kernels by device time (ms a step):")
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    for k, v in top:
        cs.log(f"    {v:8.3f}  {k[:100]}")
    del model, tr
    torch.cuda.empty_cache()
    return {"route": name, "step_ms": step_ms, "host_enqueue_ms": host_ms,
            "busy_ms": busy,
            "host_ops": [(e.key, e.self_cpu_time_total / 2e3, e.count // 2)
                         for e in host[:12]],
            "kernels": top}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out", help="also write the numbers to this JSON file")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ernie_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paddle_tpu_torch as P
    from paddle_tpu_torch.ops_cuda import _build
    card = cs.card_line()
    _build.build(["flash_attention_fwd", "flash_attention_bwd"])
    runs = [turn(torch, np, cs, P, *(("dense", 0.1), ("flash", 0.0))[i % 2],
                 card) for i in range(args.turns)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "turns": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
