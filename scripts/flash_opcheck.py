#!/usr/bin/env python3
"""`torch.library.opcheck` of the K2/K3 operators on the card:
`paddle_tpu_torch::flash_attention_fwd` and `flash_attention_bwd` on
CUDA tensors, where their implementations launch the hand-written
kernels.

    python3 scripts/flash_opcheck.py [--out FILE]

opcheck runs the operator's schema test, its fake implementation
against the real kernel's outputs (shapes, dtypes and strides: the
forward's lse is K2's whole (b, h, round_up(sq, 128)) row buffer), the
autograd registration and the AOT-dispatch test, on each case below:
bf16 (the `wgmma` route) at ERNIE's head width, causal and not, equal
and unequal lengths with ragged tails; fp16 (`wgmma_f16`) at d 32; fp32
(`tf32x3`) at d 64. Prints each case's result beside the card's name
and power limit, and one JSON line last; exits 1 when a case fails or
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# (dtype, b, sq, sk, h, d, causal)
CASES = [("bfloat16", 2, 128, 128, 2, 64, False),
         ("bfloat16", 2, 128, 128, 2, 64, True),
         ("bfloat16", 2, 100, 200, 2, 64, False),
         ("bfloat16", 2, 200, 200, 2, 64, True),
         ("float16", 2, 128, 128, 2, 32, True),
         ("float32", 2, 128, 128, 2, 64, True)]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown card"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the JSON summary to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_opcheck: needs a CUDA card", file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    card = card_line()
    print(card)
    results = []
    for dtype, b, sq, sk, h, d, causal in CASES:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(0)

        def rand(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dt)
        q, k, v = rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d)
        scale = d ** -0.5
        case = dict(dtype=dtype, b=b, sq=sq, sk=sk, h=h, d=d, causal=causal)
        try:
            torch.library.opcheck(
                fa.flash_attention_fwd,
                (q.clone().requires_grad_(), k, v, causal, scale))
            out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
            go = rand(b, sq, h, d)
            torch.library.opcheck(
                fa.flash_attention_bwd,
                (q, k, v, out, lse, go, causal, scale))
            torch.cuda.synchronize()
            case["ok"] = True
        except Exception as e:  # noqa: BLE001 — reported per case
            case["ok"] = False
            case["error"] = f"{type(e).__name__}: {e}"[:2000]
            traceback.print_exc()
        print(f"[{card}] opcheck {dtype} b {b} sq {sq} sk {sk} h {h} d {d} "
              f"causal {causal}: {'pass' if case['ok'] else 'FAIL'}",
              flush=True)
        results.append(case)
    summary = {"card": card, "cases": results,
               "ok": all(c["ok"] for c in results)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
