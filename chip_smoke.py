#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out result.json]

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):
1. card name and power limit (nvidia-smi); build every kernel with nvcc.
2. kernel K1 (ragged split-K flash-decode) against its plain version on
   the card at GPT-small decode shapes (B = S = 8, T = 1024, nh = 12,
   hd = 64), fp32 and bf16, 1 and 2 splits, a repeated-slot verify
   layout, lengths 0, 1, block_k - 1, block_k, block_k + 1, 513, T - 1,
   T; outputs within fp32 atol = rtol = 1e-4 / bf16 atol = rtol = 2e-2
   of `ragged_decode_reference`, visit counts exactly the live-chunk
   arithmetic, and dead cache rows never read (NaN-filled dead rows
   leave the output bitwise unchanged).
3. the slice end to end at full width: GPT-small (768 hidden, 12
   layers, 12 heads, vocab 50304, random weights from a seed) in bf16
   served by `LLMEngine(max_slots=8, max_seq=1024, decode_block_size=8)`
   on 16 requests (prompts 16..700 tokens, 64 new tokens, mostly greedy,
   some sampled). Every request finishes; K1 launched exactly
   num_layers x decode steps times; one host sync per dispatch; two
   greedy requests served alone reproduce their batched streams bitwise.
4. ragged against masked attention in fp32: equal greedy streams,
   except after a step whose top-2 logit margin is below 1e-3 (margins
   logged).
5. numbers: K1's median time at phase-3 shapes and lengths beside its
   byte bound, the plain version's time and one
   `scaled_dot_product_attention` call over the full slab with the keep
   mask (a yardstick only; the port never calls it); engine tokens/s,
   decode ms/token, TTFT p50/p99 — each beside the card and its power
   limit.
Then one JSON line of kernel records and, last, the device line.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, device memory
FP32_FLOPS = 67e12               # H100 SXM data sheet, fp32 non-tensor
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------- #
# phase 2: the kernel against its plain version
# --------------------------------------------------------------------------- #

def kernel_cases(torch, T: int, block_k: int):
    full = [0, 1, block_k - 1, block_k, block_k + 1, 513, T - 1, T]
    verify_lengths = [100, 101, 102, 700, 701, 702, 5, 6]
    verify_slots = [0, 0, 0, 1, 1, 1, 2, 2]
    for dtype in (torch.float32, torch.bfloat16):
        for ns in (1, 2):
            yield f"{str(dtype)[6:]} splits={ns}", dtype, ns, full, None
        yield (f"{str(dtype)[6:]} verify slot_map", dtype, 2,
               verify_lengths, verify_slots)


def phase_kernel(torch, dec):
    S, T, nh, hd = 8, 1024, 12, 64
    block_k, _ = dec.pick_decode_blocks(T, hd, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for name, dtype, ns, lengths, slots in kernel_cases(torch, T, block_k):
        B = len(lengths)
        q = torch.randn(B, nh, hd, device="cuda", generator=gen).to(dtype)
        kc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
        vc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        smap = None if slots is None else torch.tensor(
            slots, dtype=torch.int32, device="cuda")
        out, visits = dec.ragged_decode_attention(
            q, kc, vc, lens, slot_map=smap, block_k=block_k, num_splits=ns,
            with_stats=True)
        torch.cuda.synchronize()
        ref = dec.ragged_decode_reference(q, kc, vc, lens, slot_map=smap)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(dtype)[6:]]
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        # visit counts: clip(ceil((len - split_start) / block_k), 0, blocks)
        rows = T // ns
        want = [[min(max(-(-(n - p * rows) // block_k), 0), rows // block_k)
                 for p in range(ns)] for n in lengths]
        check(visits.cpu().tolist() == want,
              f"{name}: visits {visits.cpu().tolist()} != {want}")
        # raw split outputs against the plain split-K version
        sm = smap if smap is not None else torch.arange(
            B, dtype=torch.int32, device="cuda")
        acc, m, l_, _ = dec._launch_cuda(q, kc, vc, lens, sm,
                                         1 / math.sqrt(hd), block_k, ns)
        pacc, pm, pl, _ = dec.ragged_decode_split_plain(
            q, kc, vc, lens, sm, 1 / math.sqrt(hd), block_k, ns)
        torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(l_, pl, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(acc, pacc, atol=1e-3, rtol=1e-4)
        # dead rows are never read: NaN there leaves the output unchanged
        keep = (torch.arange(T, device="cuda")[None, :]
                < lens[:, None].long())
        kn, vn = kc.clone(), vc.clone()
        live = torch.zeros(S, T, dtype=torch.bool, device="cuda")
        for b, s in enumerate(sm.tolist()):
            live[s] |= keep[b]
        kn[~live] = float("nan")
        vn[~live] = float("nan")
        out_nan = dec.ragged_decode_attention(
            q, kn, vn, lens, slot_map=smap, block_k=block_k, num_splits=ns)
        torch.cuda.synchronize()
        check(torch.equal(out_nan, out), f"{name}: a dead row was read")
        worst = max(worst, err)
        log(f"  K1 {name}: max|kernel - reference| = {err:.3e} "
            f"(atol=rtol={tol['atol']:g}), visits exact, dead rows unread")
    return worst


# --------------------------------------------------------------------------- #
# phases 3-4: the engine
# --------------------------------------------------------------------------- #

def make_prompts(np, n, lo, hi, vocab, seed):
    rng = np.random.RandomState(seed)
    lengths = np.linspace(lo, hi, n).astype(int)
    rng.shuffle(lengths)
    return [rng.randint(0, vocab, (int(k),)).astype(np.int32)
            for k in lengths]


def phase_engine(torch, np, P):
    from paddle_tpu_torch.ops_cuda.decode_attention import LAUNCHES
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    t0 = time.perf_counter()
    model = P.models.gpt_small(seed=0, device="cuda", dtype="bf16")
    cfg = model.cfg
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.vocab_size)
          == (768, 12, 12, 50304), f"not GPT-small: {cfg}")
    log(f"  GPT-small bf16 built from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = make_prompts(np, 16, 16, 700, cfg.vocab_size, seed=1)
    params = [SamplingParams(max_new_tokens=64) for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=64, temperature=0.8)
    params[7] = SamplingParams(max_new_tokens=64, temperature=1.0, top_k=50)
    params[11] = SamplingParams(max_new_tokens=64, temperature=0.9,
                                top_p=0.9)
    params[14] = SamplingParams(max_new_tokens=64, temperature=0.7,
                                top_k=40, top_p=0.95)
    kw = dict(max_slots=8, max_seq=1024, decode_block_size=8, seed=0,
              device="cuda")
    # warm-up (cuBLAS handles, allocator) outside the measured run
    LLMEngine(model, **kw).generate(prompts[:2],
                                    SamplingParams(max_new_tokens=8))
    torch.cuda.synchronize()

    eng = LLMEngine(model, **kw)
    check(eng.attend_impl == "ragged", f"auto gave {eng.attend_impl}")
    LAUNCHES.reset()
    t0 = time.perf_counter()
    results = eng.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.count
    st = eng.stats()
    for r, p in zip(results, prompts):
        check(r.finish_reason == "length" and len(r.token_ids) == 64,
              f"request {r.request_id}: {r.finish_reason}, "
              f"{len(r.token_ids)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.token_ids),
              f"request {r.request_id}: token id out of range")
    check(launches == cfg.num_layers * st["decode_steps"],
          f"K1 launches {launches} != {cfg.num_layers} x "
          f"{st['decode_steps']} decode steps")
    check(st["host_syncs"] == st["decode_dispatches"],
          f"host_syncs {st['host_syncs']} != dispatches "
          f"{st['decode_dispatches']}")
    log(f"  served {len(results)} requests ({st['prompt_tokens']} prompt, "
        f"{st['generated_tokens']} generated tokens) in {wall:.2f} s; "
        f"K1 launches {launches} = {cfg.num_layers} layers x "
        f"{st['decode_steps']} decode steps; host_syncs {st['host_syncs']}"
        f" = dispatches {st['decode_dispatches']}")
    # the engine's own invariant: a request served alone gives the same
    # stream as in the batch (lanes are row-independent)
    for i in (0, 1):
        solo = LLMEngine(model, **kw).generate([prompts[i]], params[i])[0]
        check(solo.token_ids == results[i].token_ids,
              f"request {i}: alone {solo.token_ids[:8]}... != batched "
              f"{results[i].token_ids[:8]}...")
    log("  greedy requests 0 and 1 served alone: streams bitwise equal")
    return {"launches": launches, "prompts": prompts,
            "tokens_per_s": st["tokens_per_sec"],
            "decode_ms_per_token": st["decode_ms_per_token"],
            "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
            "decode_steps": st["decode_steps"],
            "dispatches": st["decode_dispatches"], "wall_s": wall}


def phase_ragged_vs_masked(torch, np, P):
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    model = P.models.gpt_small(seed=0, device="cuda", dtype="float32")
    prompts = make_prompts(np, 8, 16, 700, model.cfg.vocab_size, seed=2)
    sp = SamplingParams(max_new_tokens=32)
    kw = dict(max_slots=8, max_seq=1024, decode_block_size=8, seed=0,
              device="cuda")
    ragged = LLMEngine(model, attend_impl="ragged", **kw).generate(prompts,
                                                                  sp)
    masked = LLMEngine(model, attend_impl="masked", **kw).generate(prompts,
                                                                  sp)
    min_margin, diverged = float("inf"), 0
    for i, (p, r, m) in enumerate(zip(prompts, ragged, masked)):
        seq = np.concatenate([p, np.asarray(m.token_ids[:-1], np.int32)])
        lg = model.logits(torch.from_numpy(seq[None]).long().cuda())[0]
        top2 = torch.topk(lg[len(p) - 1:].float(), 2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        min_margin = min(min_margin, float(margins.min()))
        k = next((j for j, (a, b) in enumerate(zip(r.token_ids, m.token_ids))
                  if a != b), None)
        if k is not None:
            diverged += 1
            check(margins[k] < 1e-3,
                  f"request {i}: ragged and masked diverge at step {k} with "
                  f"top-2 margin {margins[k]:.3e} >= 1e-3")
            log(f"  request {i}: diverges at step {k}, top-2 margin "
                f"{margins[k]:.3e} (< 1e-3: a near-tie)")
    log(f"  ragged vs masked fp32: {len(prompts) - diverged}/{len(prompts)}"
        f" greedy streams equal; min top-2 logit margin {min_margin:.3e}")
    return {"min_margin": min_margin, "diverged": diverged}


# --------------------------------------------------------------------------- #
# phase 5: numbers
# --------------------------------------------------------------------------- #

def time_ms(torch, fn, flush, reps: int = 50) -> float:
    """Median device time of one `fn()` call: each call is queued behind
    a ~1 ms device sleep (so host-side launch work is hidden and the
    events time the device only) and after an L2 flush (a cache's rows
    are cold in real decode: a layer's K/V slabs far exceed the 50 MB
    L2)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def phase_numbers(torch, dec, engine_run, card: str):
    F = torch.nn.functional
    S, T, nh, hd = 8, 1024, 12, 64
    dtype = torch.bfloat16
    isz = 2
    # phase-3 shapes; lengths of the first 8 requests halfway through
    # their 64 new tokens
    lengths = [int(p.size) + 32 for p in engine_run["prompts"][:S]]
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(S, nh, hd, device="cuda", generator=gen).to(dtype)
    kc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
    vc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sm = torch.arange(S, dtype=torch.int32, device="cuda")
    block_k, ns = dec.pick_decode_blocks(T, hd, dtype)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    keep = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None]           # (B,1,1,T)
    qs, ks, vs = q[:, :, None], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)

    ms = time_ms(torch, lambda: dec.ragged_decode_attention(q, kc, vc, lens),
                 flush)
    kernel_ms = time_ms(torch, lambda: dec._launch_cuda(
        q, kc, vc, lens, sm, 1 / math.sqrt(hd), block_k, ns), flush)
    plain_ms = time_ms(torch, lambda: dec.ragged_decode_reference(
        q, kc, vc, lens), flush)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=keep), flush)
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)
    torch.testing.assert_close(lib_out[:, :, 0].float(),
                               dec.ragged_decode_attention(
                                   q, kc, vc, lens).float(), **TOL["bfloat16"])
    live = sum(min(n, T) for n in lengths)
    nbytes = (2 * live * nh * hd * isz          # K and V live rows
              + 2 * S * nh * hd * isz           # q in, output out
              + 4 * S)                          # lengths
    flops = 4 * live * nh * hd                  # q.k and p.v, 2 each
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"  K1 at phase-3 shapes (B=S={S}, T={T}, nh={nh}, hd={hd}, bf16, "
        f"block_k={block_k}, splits={ns}, lengths {lengths}) [card: {card}]")
    log(f"    wrapper (kernel + split merge) median {ms:.4f} ms; kernel "
        f"alone {kernel_ms:.4f} ms")
    log(f"    byte bound {bytes_ms:.5f} ms ({nbytes} B at 3.35 TB/s), op "
        f"bound {ops_ms:.6f} ms -> bound {bound_ms:.5f} ms (bytes)")
    log(f"    plain version (ragged_decode_reference) {plain_ms:.4f} ms; "
        f"library yardstick (scaled_dot_product_attention, full slab + "
        f"keep mask) {library_ms:.4f} ms")
    log(f"  engine, phase 3 [card: {card}]: "
        f"{engine_run['tokens_per_s']:.1f} tokens/s, decode "
        f"{engine_run['decode_ms_per_token']:.3f} ms/token (per decode "
        f"step), TTFT p50 {engine_run['ttft_p50_s'] * 1e3:.1f} ms, p99 "
        f"{engine_run['ttft_p99_s'] * 1e3:.1f} ms")
    return {"ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "lengths": lengths}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON "
                                  "file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np
    import paddle_tpu_torch as P
    from paddle_tpu_torch.ops_cuda import _build
    from paddle_tpu_torch.ops_cuda import decode_attention as dec

    t_start = time.perf_counter()
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    log(f"  built {sorted(built) or 'nothing (cached)'} with nvcc "
        f"{' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s")

    log("phase 2: K1 against its plain version")
    max_err = phase_kernel(torch, dec)
    log("phase 3: GPT-small served at full width through K1")
    engine_run = phase_engine(torch, np, P)
    log("phase 4: ragged vs masked attention, fp32")
    rvm = phase_ragged_vs_masked(torch, np, P)
    log("phase 5: numbers")
    nums = phase_numbers(torch, dec, engine_run, card)

    kernels = [{
        "name": "ragged_decode", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops_pallas/decode_attention.py:225",
        "launches": engine_run["launches"], "max_abs_err": max_err,
        "ms": nums["ms"], "plain_ms": nums["plain_ms"],
        "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
        "library_ms": nums["library_ms"]}]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels,
                       "kernel_only_ms": nums["kernel_ms"],
                       "timing_lengths": nums["lengths"],
                       "engine": {k: v for k, v in engine_run.items()
                                  if k != "prompts"},
                       "ragged_vs_masked": rvm,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
