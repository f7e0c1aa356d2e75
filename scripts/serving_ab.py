#!/usr/bin/env python3
"""Serving A/B of two checkouts of the PyTorch/CUDA port on one card.

    python3 scripts/serving_ab.py --a PARENT_DIR --b CHANGE_DIR \
        [--order ABBAABBA] [--out result.json]

Each turn of `--order` is a fresh process in that checkout's root: it
builds the checkout's kernels (cached after its first turn), runs the
checkout's own `chip_smoke.py` phase 4 (GPT-small bf16 served through
the slotted engine and kernel K1: 16 requests, 64 new tokens each) and
phase 8's K1 timing (the wrapper's median at the phase-4 shapes), then
profiles a window of 3 decode-only scheduler steps at 8 lanes
(torch.profiler), then serves phase 4d's load (the int8-PTQ GPT-small
through K7) twice and runs phase 4e (speculation off and on, trunc and
int8 drafts). It reports tokens/s, decode ms per step and TTFT p50 /
p99 of phase 4; the K1 median and the K1 wrapper's host time per call;
of the profiled window, per decode step dispatched in it, the CUDA
kernels (all, and the decode kernel's), the device's busy ms (the
union of the kernels' intervals), the window's wall ms, and the busy
share of the wall time; tokens/s and decode ms per step of phase 4d's
load, and whether its two runs gave the same streams
(`int8_repeat_equal`, not summarised); tokens/s of phase 4e off, trunc
and int8. The host time is taken with the stream held by a device
sleep, so the calls only enqueue: 50 calls at phase 8's shapes, the
median of 7 such rounds. The summary gives every turn, each version's
median and spread (max - min over median) per metric, and B's medians
over A's.
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
import dataclasses, json, statistics, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
import paddle_tpu_torch as P
from paddle_tpu_torch.ops_cuda import _build, decode_attention as dec
from paddle_tpu_torch.ops_cuda import int8_linear as k7
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
del q, kc, vc
# a profiled window of 3 scheduler steps that only decode (8 lanes
# admitted by a first step): the blocks dispatched in it, their CUDA
# kernels, the device's busy time (the union of the kernels' intervals)
# and the window's wall time
eng = LLMEngine(run["model"], **cs.SERVE_KW)
for p in run["prompts"][:8]:
    eng.submit(p, SamplingParams(max_new_tokens=64))
eng.step()
torch.cuda.synchronize()
dispatched = [0]
real = eng._dispatch_block
def counted():
    dispatched[0] += 1
    return real()
eng._dispatch_block = counted
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
steps = dispatched[0] * eng.decode_block_size
kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("Command Buffer")]
spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
busy_us, end = 0.0, float("-inf")
for a, z in spans:
    if z > end:
        busy_us += z - max(a, end)
        end = z
del eng
out = {
    "tokens_per_s": run["tokens_per_s"],
    "decode_ms_per_token": run["decode_ms_per_token"],
    "ttft_p50_s": run["ttft_p50_s"], "ttft_p99_s": run["ttft_p99_s"],
    "k1_ms": nums["ms"], "k1_host_us": statistics.median(rounds),
    "kernels_per_decode_step": len(kernels) / steps,
    "decode_kernels_per_decode_step":
        sum("decode_kernel" in e.name for e in kernels) / steps,
    "busy_ms_per_decode_step": busy_us / 1e3 / steps,
    "profiled_ms_per_decode_step": wall_us / 1e3 / steps,
    "busy_share": busy_us / wall_us}
# phase 4d's load (the int8-PTQ GPT-small through K7 at 4 slots), served
# twice after a warm-up: the first run's numbers, and whether the second
# gives the same streams
model = cs.ptq_gpt_small(torch, np, P)
prompts, params = run["prompts"][:8], run["params"][:8]
LLMEngine(model, **cs.SPEC_KW).generate(prompts[:2],
                                        SamplingParams(max_new_tokens=8))
torch.cuda.synchronize()
streams = []
for i in range(2):
    eng = LLMEngine(model, **cs.SPEC_KW)
    streams.append([r.token_ids for r in eng.generate(prompts, params)])
    torch.cuda.synchronize()
    if i == 0:
        st = eng.stats()
        out["int8_tokens_per_s"] = st["tokens_per_sec"]
        out["int8_decode_ms_per_token"] = st["decode_ms_per_token"]
    del eng
out["int8_repeat_equal"] = streams[0] == streams[1]
del model
torch.cuda.empty_cache()
spec = cs.phase_speculative(torch, np, dec, k7, run)
out["spec_off_tokens_per_s"] = spec["off_bf16"]["tokens_per_s"]
out["spec_trunc_tokens_per_s"] = spec["trunc slotted"]["tokens_per_s"]
out["spec_int8_tokens_per_s"] = spec["int8 slotted"]["tokens_per_s"]
print("AB " + json.dumps(out))
"""

METRICS = ("tokens_per_s", "decode_ms_per_token", "ttft_p50_s",
           "ttft_p99_s", "k1_ms", "k1_host_us", "kernels_per_decode_step",
           "decode_kernels_per_decode_step", "busy_ms_per_decode_step",
           "profiled_ms_per_decode_step", "busy_share", "int8_tokens_per_s",
           "int8_decode_ms_per_token", "spec_off_tokens_per_s",
           "spec_trunc_tokens_per_s", "spec_int8_tokens_per_s")


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
    ap.add_argument("--timeout", type=int, default=600,
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
                                           for m in METRICS)
              + f", int8_repeat_equal {r['int8_repeat_equal']}", flush=True)
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
