#!/usr/bin/env python3
"""Serving A/B of two checkouts of the PyTorch/CUDA port on one card.

    python3 scripts/serving_ab.py --a PARENT_DIR --b CHANGE_DIR \
        [--order ABBAABBA] [--out result.json]

Each turn of `--order` is a fresh process in that checkout's root: it
builds the checkout's kernels (cached after its first turn), runs the
checkout's own `chip_smoke.py` phase 4 (GPT-small bf16 served through
the slotted engine and kernel K1: 16 requests, 64 new tokens each) and
phase 8's K1 timing (the wrapper's median at the phase-4 shapes), then
profiles one decode block of 8 lanes (torch.profiler) and reports
tokens/s, decode ms per step, TTFT p50, the K1 median, the K1
wrapper's host time per call and the CUDA kernels launched per decode
step (all, and the decode kernel's). The host time is taken with the
stream held by a device sleep, so the calls only enqueue: 50 calls at
phase 8's shapes, the median of 7 such rounds. The summary gives every
turn, each version's median and spread (max - min over median) per
metric, and B's medians over A's.
Alternating in one call keeps both versions on one card and one host.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, statistics, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
import paddle_tpu_torch as P
from paddle_tpu_torch.ops_cuda import _build, decode_attention as dec
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
_build.build()
run = cs.phase_engine(torch, np, P)
nums = cs.phase_numbers(torch, dec, run, cs.card_line())
# the K1 wrapper's host time per call: the stream waits on a sleep of
# ~0.1 s while the host enqueues 50 calls (a few ms), so no call waits
gen = torch.Generator(device="cuda").manual_seed(5)
S, T, nh, hd = 8, 1024, 12, 64
q = torch.randn(S, nh, hd, device="cuda", generator=gen).bfloat16()
kc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).bfloat16()
vc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).bfloat16()
lens = torch.tensor(nums["lengths"], dtype=torch.int32, device="cuda")
dec.ragged_decode_attention(q, kc, vc, lens)
torch.cuda.synchronize()
rounds = []
for _ in range(7):
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(50):
        dec.ragged_decode_attention(q, kc, vc, lens)
    rounds.append((time.perf_counter() - t0) / 50 * 1e6)
    torch.cuda.synchronize()
# one profiled decode block: 8 lanes admitted by a first step, then one
# step that only decodes; CUDA kernels per decode step, all and K1's
eng = LLMEngine(run["model"], **cs.SERVE_KW)
for p in run["prompts"][:8]:
    eng.submit(p, SamplingParams(max_new_tokens=64))
eng.step()
torch.cuda.synchronize()
before = eng.stats()["decode_steps"]
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    eng.step()
    torch.cuda.synchronize()
steps = eng.stats()["decode_steps"] - before
kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("Command Buffer")]
print("AB " + json.dumps({
    "tokens_per_s": run["tokens_per_s"],
    "decode_ms_per_token": run["decode_ms_per_token"],
    "ttft_p50_s": run["ttft_p50_s"], "k1_ms": nums["ms"],
    "k1_host_us": statistics.median(rounds),
    "kernels_per_decode_step": len(kernels) / steps,
    "decode_kernels_per_decode_step":
        sum("decode_kernel" in n for n in kernels) / steps}))
"""

METRICS = ("tokens_per_s", "decode_ms_per_token", "ttft_p50_s", "k1_ms",
           "k1_host_us", "kernels_per_decode_step",
           "decode_kernels_per_decode_step")


def run_turn(root: Path, timeout: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=str(root),
                          capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"turn in {root} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][3:])


def summarise(turns):
    out = {}
    for v in ("A", "B"):
        runs = [t for name, t in turns if name == v]
        out[v] = {}
        for m in METRICS:
            xs = [r[m] for r in runs]
            med = statistics.median(xs)
            out[v][m] = {"runs": xs, "median": med,
                         "spread": (max(xs) - min(xs)) / med if med else 0.0}
    out["B_over_A"] = {m: out["B"][m]["median"] / out["A"][m]["median"]
                       for m in METRICS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", required=True, help="checkout B (the change)")
    ap.add_argument("--order", default="ABBAABBA")
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds per turn")
    ap.add_argument("--out", help="also write the summary to this file")
    args = ap.parse_args(argv)
    if set(args.order) - {"A", "B"} or not {"A", "B"} <= set(args.order):
        ap.error("--order needs both A and B, and nothing else")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    roots = {"A": Path(args.a).resolve(), "B": Path(args.b).resolve()}
    turns = []
    for i, v in enumerate(args.order):
        r = run_turn(roots[v], args.timeout)
        turns.append((v, r))
        print(f"turn {i} {v}: " + ", ".join(f"{m} {r[m]:.6g}"
                                           for m in METRICS), flush=True)
    summary = {"card": card, "order": args.order,
               "roots": {k: str(p) for k, p in roots.items()},
               "turns": [{"version": v, **r} for v, r in turns],
               **summarise(turns)}
    for m in METRICS:
        a, b = summary["A"][m], summary["B"][m]
        print(f"{m}: A median {a['median']:.6g} (spread {a['spread']:.3f}),"
              f" B median {b['median']:.6g} (spread {b['spread']:.3f}), "
              f"B/A {summary['B_over_A'][m]:.4f}  [{card}]", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
