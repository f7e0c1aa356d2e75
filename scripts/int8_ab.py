#!/usr/bin/env python3
"""Int8-GEMV (kernel K7) A/B of two checkouts of the PyTorch/CUDA port on
one card.

    python3 scripts/int8_ab.py --a PARENT_DIR --b CHANGE_DIR \
        [--order ABBAABBA] [--out result.json]

Each turn of `--order` is a fresh process in that checkout's root: it
builds the checkout's kernels (cached after its first turn) and, through
the checkout's own `chip_smoke.py` helpers and K7 wrapper:
- times K7 at 4 bf16 rows (bf16 weight scales and bias) at GPT-small's
  five (k, n) and gpt_1p3b's four block shapes: the median after an L2
  flush behind a device sleep (`chip_smoke.time_ms`);
- profiles one decode block of the int8-PTQ GPT-small at 4 lanes
  (torch.profiler): K7's device ms per decode step and the device's busy
  ms per decode step (the union of every kernel's interval);
- runs phase 4d (the int8-PTQ GPT-small served with max_slots 4 on 8 of
  phase 4's requests): tokens/s and decode ms per step;
- serves the same 8 requests (32 new tokens) from GPT-small bf16 with
  the int8 draft (`speculate_k=3`, `draft="int8"`, phase 4e's int8
  slotted case) after a warm-up: tokens/s.
The summary gives every turn, each version's median and spread (max -
min over median) per metric, and B's medians over A's. Alternating in
one call keeps both versions on one card and one host.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TURN = r"""
import dataclasses, json, sys
sys.path.insert(0, ".")
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
import paddle_tpu_torch as P
from paddle_tpu_torch.ops_cuda import _build, decode_attention as dec
from paddle_tpu_torch.ops_cuda import int8_linear as k7
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
SHAPES = json.loads(sys.argv[1])
_build.build()
out = {}
gen = torch.Generator(device="cuda").manual_seed(17)
flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
for k, n in SHAPES:
    x, qw, ws, sx, biases = cs.int8_inputs(torch, gen, 4, k, n,
                                           torch.bfloat16)
    b = biases["bf16 bias"]
    out[f"k7_{k}x{n}_ms"] = cs.time_ms(
        torch, lambda: k7.int8_linear_fused(x, qw, ws, sx, b), flush)
    del x, qw, ws, b
del flush
torch.cuda.empty_cache()

# one profiled decode block of the int8-PTQ GPT-small at 4 lanes
model = cs.ptq_gpt_small(torch, np, P)
prompts, params = cs.serving_load(np, SamplingParams, model.cfg.vocab_size)
eng = LLMEngine(model, **cs.SPEC_KW)
for p in prompts[:4]:
    eng.submit(p, SamplingParams(max_new_tokens=64))
eng.step()
eng.step()
torch.cuda.synchronize()
before = eng.stats()["decode_steps"]
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    eng.step()
    torch.cuda.synchronize()
steps = eng.stats()["decode_steps"] - before
kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("Command Buffer")]
spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
busy_us, end = 0.0, float("-inf")
for a, z in spans:
    if z > end:
        busy_us += z - max(a, end)
        end = z
k7_us = sum(e.time_range.end - e.time_range.start for e in kernels
            if "int8_" in e.name)
out["k7_device_ms_per_step"] = k7_us / 1e3 / steps
out["busy_ms_per_step"] = busy_us / 1e3 / steps
out["k7_launches_per_step"] = sum("int8_" in e.name for e in kernels) / steps
del eng

run = cs.phase_int8_serving(torch, np, P, dec, k7,
                            {"prompts": prompts, "params": params})
out["int8_tokens_per_s"] = run["tokens_per_s"]
out["int8_decode_ms_per_step"] = run["decode_ms_per_token"]
del model
torch.cuda.empty_cache()

# the int8 draft of phase 4e (slotted, KV bf16)
bf16 = cs.gpt_small_bf16(torch, P)
spec_params = [dataclasses.replace(p, max_new_tokens=32) for p in params[:8]]
kw = dict(cs.SPEC_KW, speculate_k=cs.SPEC_K, draft="int8")
LLMEngine(bf16, **kw).generate(prompts[:2], SamplingParams(max_new_tokens=8))
torch.cuda.synchronize()
eng = LLMEngine(bf16, **kw)
eng.generate(prompts[:8], spec_params)
torch.cuda.synchronize()
out["draft_tokens_per_s"] = eng.stats()["tokens_per_sec"]
print("AB " + json.dumps(out))
"""

# (k, n): GPT-small's block linears and the int8 draft's tied head, then
# gpt_1p3b's block linears
SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 50304),
          (2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048))
METRICS = tuple(f"k7_{k}x{n}_ms" for k, n in SHAPES) + (
    "k7_device_ms_per_step", "busy_ms_per_step", "k7_launches_per_step",
    "int8_tokens_per_s", "int8_decode_ms_per_step", "draft_tokens_per_s")


def run_turn(root: Path, timeout: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN, json.dumps(SHAPES)],
                          cwd=str(root),
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
