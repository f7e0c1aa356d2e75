#!/usr/bin/env python3
"""Training-attention A/B of two checkouts of the PyTorch/CUDA port on
one card.

    python3 scripts/flash_ab.py --a PARENT_DIR --b CHANGE_DIR \
        [--order ABBAABBA] [--out result.json]

Each turn of `--order` is a fresh process in that checkout's root: it
builds the checkout's kernels (cached after its first turn), runs the
checkout's own `chip_smoke.py` phase 6 (GPT-small trained at full width,
bs 18 x 1024, 1 warm-up + 10 steps through K2 and K3, then a
torch.profiler breakdown of 3 more steps) and phase 8's K2/K3 timing
(the medians at the training shape after an L2 flush), then GPT-small in
fp32 at `Trainer`'s default amp_level=None (1 warm-up, 3 timed steps at
the same batch) and the flash forward and backward medians in fp32 at
that training shape and in bf16 at head dim 32 (b 4, s 512, h 24,
causal, packed qkv), each through the checkout's own kernels. It reports
the step ms, tokens/s, the K2 and K3 medians, the profiled device ms per
step of the flash kernels and of the whole step, the fp32 step ms and
the four fp32 / bf16 d 32 medians. The summary gives
every turn, each version's median and spread (max - min over median)
per metric, and B's medians over A's. Alternating in one call keeps
both versions on one card and one host.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TURN = r"""
import inspect, json, sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
import paddle_tpu_torch as P
from paddle_tpu_torch.ops_cuda import _build, flash_attention as fa
built = _build.build()
train = cs.phase_train(torch, np, P, profile=True)
args = (torch, fa, cs.card_line())
if len(inspect.signature(cs.phase_flash_numbers).parameters) > 3:
    args += (built,)
nums = cs.phase_flash_numbers(*args)
prof = train["profile"] or {}
groups = prof.get("groups_ms_per_step", {})

import math, time
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.optimizer import AdamW
torch.backends.cuda.matmul.allow_tf32 = False
model = P.models.gpt_small(seed=0, device="cuda")
tr = Trainer(model, AdamW(learning_rate=1e-4),
             lambda logits, y: model.loss(logits, y))
bs, seq = cs.FLASH_SHAPE["b"], cs.FLASH_SHAPE["s"]
ids = torch.from_numpy(np.random.RandomState(0).randint(
    0, model.cfg.vocab_size, (bs, seq))).cuda()
tr.train_step(ids, ids)
torch.cuda.synchronize()
t0 = time.perf_counter()
tr.train_steps(ids, ids, steps=3)
torch.cuda.synchronize()
fp32_step_ms = (time.perf_counter() - t0) / 3 * 1e3
del tr, model, ids
torch.cuda.empty_cache()

gen = torch.Generator(device="cuda").manual_seed(9)
flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
medians = {}
for key, b, s_, h, d, dtype in (("fp32", bs, seq, 12, 64, torch.float32),
                                ("bf16_d32", 4, 512, 24, 32,
                                 torch.bfloat16)):
    q, k, v, g = cs.flash_inputs(torch, gen, b, s_, s_, h, d, True, dtype)
    scale = 1 / math.sqrt(d)
    o, lse = fa._launch_fwd(q, k, v, True, scale)
    medians[key + "_fwd_ms"] = cs.time_ms(
        torch, lambda: fa._launch_fwd(q, k, v, True, scale), flush, reps=10)
    medians[key + "_bwd_ms"] = cs.time_ms(
        torch, lambda: fa._launch_bwd(q, k, v, o, lse, g, True, scale),
        flush, reps=10)
    del q, k, v, g, o, lse
print("AB " + json.dumps({
    "step_ms": train["step_ms"], "tokens_per_s": train["tokens_per_s"],
    "k2_ms": nums["fwd"]["ms"], "k3_ms": nums["bwd"]["ms"],
    "flash_device_ms_per_step": groups.get("flash K2/K3", float("nan")),
    "busy_ms_per_step": prof.get("busy_ms_per_step", float("nan")),
    "fp32_step_ms": fp32_step_ms, **medians,
    "groups_ms_per_step": groups}))
"""

METRICS = ("step_ms", "tokens_per_s", "k2_ms", "k3_ms",
           "flash_device_ms_per_step", "busy_ms_per_step", "fp32_step_ms",
           "fp32_fwd_ms", "fp32_bwd_ms", "bf16_d32_fwd_ms",
           "bf16_d32_bwd_ms")


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
