#!/usr/bin/env python3
"""Does a row's result depend on how many rows share the call? A probe
of the speculative verify pass's design, on one NVIDIA H100.

The verify pass of `paddle_tpu_torch.serving.engine._spec_decode_block`
runs the k+1 positions of S lanes as S * (k+1) virtual lanes. Its
streams equal the spec-off engine's only if every verify row gets the
bits of the plain decode step, which runs S rows. This script measures:

1. ops: for S in {1, 2, 3, 4, 8} and W = k+1 in {2, 3, 4, 5}, in bf16
   and fp32 (TF32 off), GPT-small's GEMMs (768 x 2304 / 768 / 3072,
   3072 x 768, 768 x 50304), the decode LayerNorm `_ln` and the
   sampler (`filtered_logits`, `sample_tokens_per_lane`): one call over
   S * W rows against W calls over S rows each; every pair that is not
   bitwise equal is counted and listed;
2. streams: the phase-4e load of `chip_smoke.py` (GPT-small bf16,
   max_slots 4, k 3, 8 requests, 32 new tokens) served with the
   grouped verify (the engine's) and with every row-wise op of the
   verify run once over all S * W rows, against the spec-off streams.

    python3 scripts/verify_row_probe.py [--out result.json]

Needs one card; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 50304))


def probe_ops():
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.serving import sampler as SM
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    diffs, cases = [], 0
    for dt in (torch.bfloat16, torch.float32):
        ws = {kn: (torch.randn(*kn, device="cuda", generator=g) * 0.02)
              .to(dt) for kn in SHAPES}
        lw = torch.randn(768, device="cuda", generator=g).to(dt)
        for S, W in itertools.product((1, 2, 3, 4, 8), (2, 3, 4, 5)):
            def split(fn, x):
                return torch.cat([fn(c) for c in x.chunk(W)])
            for k, n in SHAPES:
                x = torch.randn(S * W, 1, k, device="cuda",
                                generator=g).to(dt)
                w = ws[(k, n)]
                cases += 1
                if not torch.equal(torch.matmul(x, w),
                                   split(lambda c: torch.matmul(c, w), x)):
                    diffs.append(f"matmul {str(dt)[6:]} S={S} W={W} "
                                 f"{k}x{n}")
            x = torch.randn(S * W, 1, 768, device="cuda", generator=g).to(dt)
            cases += 1
            if not torch.equal(G._ln(x, lw, lw, 1e-5),
                               split(lambda c: G._ln(c, lw, lw, 1e-5), x)):
                diffs.append(f"_ln {str(dt)[6:]} S={S} W={W}")
            if dt != torch.float32:
                continue
            B = S * W
            lg = torch.randn(B, 50304, device="cuda", generator=g) * 3
            knobs = (torch.full((B,), 0.9, device="cuda"),
                     torch.full((B,), 50, device="cuda"),
                     torch.full((B,), 0.9, device="cuda"))
            salts = torch.arange(B, device="cuda")
            pos = salts + 7
            cases += 2
            one = SM.filtered_logits(lg, *knobs)
            per = torch.cat([SM.filtered_logits(
                lg.chunk(W)[j], *(t.chunk(W)[j] for t in knobs))
                for j in range(W)])
            if not torch.equal(one, per):
                diffs.append(f"filtered_logits S={S} W={W}")
            one = SM.sample_tokens_per_lane(lg, 0, salts, pos, *knobs)
            per = torch.cat([SM.sample_tokens_per_lane(
                lg.chunk(W)[j], 0, salts.chunk(W)[j], pos.chunk(W)[j],
                *(t.chunk(W)[j] for t in knobs)) for j in range(W)])
            if not torch.equal(one, per):
                diffs.append(f"sample_tokens_per_lane S={S} W={W}")
    torch.cuda.synchronize()
    return cases, diffs


def probe_streams():
    import chip_smoke as C
    import paddle_tpu_torch as P
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.serving import engine as E
    from paddle_tpu_torch.serving import sampler as SM
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model = P.models.gpt_small(seed=0, device="cuda", dtype="bf16")
    prompts, params = C.serving_load(np, SamplingParams, 50304)
    prompts = prompts[:8]
    params = [dataclasses.replace(p, max_new_tokens=32) for p in params[:8]]
    ref = [r.token_ids for r in LLMEngine(model, **C.SPEC_KW).generate(
        prompts, params)]

    def one_call(fn, x, groups):
        return fn(x)

    def one_call_draws(logits, seed, salts, positions, *knobs):
        S, W, V = logits.shape
        rep = [t.repeat_interleave(W) for t in (salts, *knobs)]
        return SM.sample_tokens_per_lane(
            logits.reshape(S * W, V), seed, rep[0], positions.reshape(-1),
            *rep[1:]).reshape(S, W)

    out = {}
    saved = (G._by_groups, E._by_groups, E.sample_verify_tokens)
    for mode in ("grouped", "one call"):
        if mode == "one call":
            G._by_groups = E._by_groups = one_call
            E.sample_verify_tokens = one_call_draws
        try:
            for draft in ("trunc", "int8"):
                got = [r.token_ids for r in LLMEngine(
                    model, speculate_k=C.SPEC_K, draft=draft,
                    **C.SPEC_KW).generate(prompts, params)]
                out[f"{mode}, {draft} draft"] = sum(
                    a == b for a, b in zip(got, ref))
        finally:
            G._by_groups, E._by_groups, E.sample_verify_tokens = saved
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("verify_row_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    card = C.card_line()
    cases, diffs = probe_ops()
    print(f"[{card}; torch {torch.__version__}, CUDA {torch.version.cuda}]")
    print(f"ops: {len(diffs)} of {cases} (op, dtype, S, W) cases differ "
          f"between one call over S*W rows and W calls over S rows")
    for d in diffs:
        print(f"  {d}")
    streams = probe_streams()
    for k, v in streams.items():
        print(f"streams, {k}: {v}/8 equal to spec off")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "cases": cases, "differ": diffs,
                       "streams_equal": streams}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
