#!/usr/bin/env python3
"""Serving A/B of two checkouts of the PyTorch/CUDA port on one card.

    python3 scripts/serving_ab.py --a PARENT_DIR --b CHANGE_DIR \
        [--order ABBAABBA] [--out result.json]

Each turn of `--order` is a fresh process in that checkout's root: it
builds the checkout's kernels (cached after its first turn), runs the
checkout's own `chip_smoke.py` phase 4 (GPT-small bf16 served through
the slotted engine and kernel K1: 16 requests, 64 new tokens each) and
phase 8's K1 timing (kernel + split merge, and the kernel alone, at the
phase-4 shapes), and reports tokens/s, decode ms per step, TTFT p50 and
the two K1 medians. The summary gives every turn, each version's median
and spread (max - min over median) per metric, and B's medians over A's.
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
import json, sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
import paddle_tpu_torch as P
from paddle_tpu_torch.ops_cuda import _build, decode_attention as dec
_build.build()
run = cs.phase_engine(torch, np, P)
nums = cs.phase_numbers(torch, dec, run, cs.card_line())
print("AB " + json.dumps({
    "tokens_per_s": run["tokens_per_s"],
    "decode_ms_per_token": run["decode_ms_per_token"],
    "ttft_p50_s": run["ttft_p50_s"], "k1_ms": nums["ms"],
    "k1_kernel_ms": nums["kernel_ms"]}))
"""

METRICS = ("tokens_per_s", "decode_ms_per_token", "ttft_p50_s", "k1_ms",
           "k1_kernel_ms")


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
