#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out result.json] [--profile]

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):
1. card name and power limit (nvidia-smi); build every kernel with nvcc,
   one process per source, all at once.
2. kernel K1 (ragged split-K flash-decode) against its plain version on
   the card at GPT-small decode shapes (B = S = 8, T = 1024, nh = 12,
   hd = 64), fp32 and bf16, 1 and 2 splits, a repeated-slot verify
   layout, lengths 0, 1, block_k - 1, block_k, block_k + 1, 513, T - 1,
   T; outputs within fp32 atol = rtol = 1e-4 / bf16 atol = rtol = 2e-2
   of `ragged_decode_reference`, visit counts exactly the live-chunk
   arithmetic, and dead cache rows never read (NaN-filled dead rows
   leave the output bitwise unchanged).
3. kernels K2 (flash-attention forward) and K3 (backward) against their
   plain versions in bf16: the training shape (b 18, s 1024, h 12,
   d 64, causal, q/k/v strided slices of one fused qkv tensor as the
   model passes them), sq < sk (256 vs 1024) causal, a length that is
   no tile multiple (1000) non-causal and causal, d = 128. The output
   within atol = rtol = 2e-2, the logsumexp within atol = 1e-3, each
   gradient within max|kernel - plain| <= 2e-2 * max|plain|; two
   backward runs bitwise equal.
4. serving at full width: GPT-small (768 hidden, 12 layers, 12 heads,
   vocab 50304, random weights from a seed) in bf16 served by
   `LLMEngine(max_slots=8, max_seq=1024, decode_block_size=8)` on 16
   requests (prompts 16..700 tokens, 64 new tokens, mostly greedy, some
   sampled). Every request finishes; K1 launched exactly num_layers x
   decode steps times; one host sync per dispatch; two greedy requests
   served alone reproduce their batched streams bitwise.
5. ragged against masked attention in fp32: equal greedy streams,
   except after a step whose top-2 logit margin is below 1e-3 (margins
   logged).
6. training at full width: GPT-small from seed 0 under
   `Trainer(AdamW(1e-4), amp_level="O2", amp_dtype="bfloat16")` on one
   resident batch of 18 x 1024 token ids (numpy seed 0), as `bench.py`
   trains; one warm-up step, then 10 steps. Every loss finite, the last
   below the first, K2 and K3 each launched exactly 12 x 10 times; step
   ms, tokens/s and peak memory.
7. gradients of one step of a full-width 2-layer GPT-small (bs 8 x
   1024, bf16 O2 parameters) through the kernels against the same step
   with the plain versions swapped in on the same CUDA tensors:
   ||g_kernel - g_plain|| / ||g_plain|| <= 3e-2 for every parameter.
8. numbers: K1's median time at phase-4 shapes and lengths beside its
   byte bound, the plain version's time and one
   `scaled_dot_product_attention` call over the full slab with the keep
   mask; K2 and K3 at the training shape beside their bounds, plain
   versions and `scaled_dot_product_attention` (causal) forward and
   backward (yardsticks only; the port never calls it); engine
   tokens/s, decode ms/token, TTFT p50/p99 — each beside the card and
   its power limit.
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
BF16_FLOPS = 989e12              # H100 SXM data sheet, bf16 dense tensor
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
# phase 3: K2 and K3 against their plain versions
# --------------------------------------------------------------------------- #

FLASH_SHAPE = dict(b=18, s=1024, h=12, d=64)     # GPT-small, bench.py bs


def flash_inputs(torch, gen, b, sq, sk, h, d, packed):
    """bf16 q, k, v (b, s, h, d) and a cotangent g; `packed` gives q, k,
    v as the strided slices of one (b, s, 3, h, d) tensor, the layout
    the model's fused qkv projection hands the kernels."""
    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()
    if packed:
        qkv = rnd(b, sq, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d)
    return q, k, v, rnd(b, sq, h, d)


def flash_cases():
    f = FLASH_SHAPE
    yield "training shape", f["b"], f["s"], f["s"], f["h"], f["d"], True, True
    yield "sq < sk", 4, 256, 1024, 12, 64, True, False
    yield "s 1000", 4, 1000, 1000, 12, 64, False, False
    yield "s 1000 causal", 4, 1000, 1000, 12, 64, True, False
    yield "d 128", 4, 512, 512, 8, 128, True, False


def phase_flash_kernels(torch, fa):
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, b, sq, sk, h, d, causal, packed in flash_cases():
        q, k, v, g = flash_inputs(torch, gen, b, sq, sk, h, d, packed)
        scale = 1 / math.sqrt(d)
        out, lse = fa._launch_fwd(q, k, v, causal, scale)
        dq, dk, dv = fa._launch_bwd(q, k, v, out, lse, g, causal, scale)
        torch.cuda.synchronize()
        pout, plse = fa.flash_forward_plain(q, k, v, causal, scale)
        torch.testing.assert_close(out.float(), pout.float(),
                                   **TOL["bfloat16"])
        torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)
        err_o = (out.float() - pout.float()).abs().max().item()
        # the backward held against its plain version on the kernel's
        # own forward (the residuals the autograd Function saves)
        plain = fa.flash_backward_plain(q, k, v, out, lse, g, causal, scale)
        rel = []
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
            check(bool(torch.isfinite(got).all()), f"{name}: {gname} "
                                                   f"not finite")
            e = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            check(e <= 2e-2 * ref, f"{name}: {gname} max err {e:.3e} > "
                                   f"2e-2 x max|plain| {ref:.3e}")
            worst["bwd"] = max(worst["bwd"], e)
            rel.append(e / ref)
        again = fa._launch_bwd(q, k, v, out, lse, g, causal, scale)
        check(all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)),
              f"{name}: two backward runs differ")
        worst["fwd"] = max(worst["fwd"], err_o)
        log(f"  K2/K3 {name} (b {b}, sq {sq}, sk {sk}, h {h}, d {d}, "
            f"causal {causal}{', packed qkv' if packed else ''}): "
            f"max|out err| {err_o:.3e}, max|lse err| "
            f"{(lse - plse).abs().max().item():.3e}, dq/dk/dv max err / "
            f"max|plain| {rel[0]:.2e}/{rel[1]:.2e}/{rel[2]:.2e}; backward "
            f"bitwise deterministic")
        del q, k, v, g, out, lse, dq, dk, dv, pout, plse, plain, again
    torch.cuda.empty_cache()
    return worst


# --------------------------------------------------------------------------- #
# phases 4-5: the engine
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
# phases 6-7: training
# --------------------------------------------------------------------------- #

TRAIN_STEPS = 10


KERNEL_GROUPS = (("flash K2/K3", ("flash_fwd", "flash_bwd")),
                 ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
                 ("torch elementwise / reduction", ("at::native",)))


def profile_steps(torch, trainer, ids, steps: int = 3, top: int = 25):
    """Device time by kernel over `steps` training steps
    (torch.profiler, CUDA activity), per step, grouped as
    KERNEL_GROUPS; the device's busy share of the wall time (the union
    of the kernels' intervals). Diagnostics only (`--profile`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_steps(ids, ids, steps=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Command Buffer")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                     # union of intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e3 / steps
    if busy == 0:
        log("  profile: torch.profiler saw no device time")
        return None
    by_name, groups = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + ms)
        g = next((g for g, keys in KERNEL_GROUPS
                  if any(k in e.name for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms
    log(f"  profile of {steps} steps [{card_line()}]: wall {wall_ms:.2f} ms "
        f"per step, device busy {busy:.2f} ms per step (idle share "
        f"{1 - busy / wall_ms:.3f})")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g}: {ms:.2f} ms/step ({ms / busy:.1%} of busy)")
    rows = sorted(((t, n // steps, k) for k, (n, t) in by_name.items()),
                  reverse=True)
    for ms, n, key in rows[:top]:
        log(f"    {ms:8.3f} ms/step {n:5d} calls  {key[:100]}")
    return {"wall_ms_per_step": wall_ms, "busy_ms_per_step": busy,
            "groups_ms_per_step": groups,
            "kernels": [{"ms_per_step": ms, "calls_per_step": n, "name": k}
                        for ms, n, k in rows[:top]]}


def phase_train(torch, np, P, profile: bool = False):
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    model = P.models.gpt_small(seed=0, device="cuda")
    cfg = model.cfg
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.vocab_size)
          == (768, 12, 12, 50304), f"not GPT-small: {cfg}")
    bs, seq = FLASH_SHAPE["b"], FLASH_SHAPE["s"]
    trainer = Trainer(model, AdamW(learning_rate=1e-4),
                      lambda logits, y: model.loss(logits, y),
                      amp_level="O2", amp_dtype="bfloat16")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (bs, seq))).cuda()
    t0 = time.perf_counter()
    warm, _ = trainer.train_step(ids, ids)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fa.FWD_LAUNCHES.reset()
    fa.BWD_LAUNCHES.reset()
    t0 = time.perf_counter()
    _, losses = trainer.train_steps(ids, ids, steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count
    peak = torch.cuda.max_memory_allocated()
    losses = [float(warm)] + losses.cpu().tolist()
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: "
                                                 f"{losses}")
    check(losses[-1] < losses[1], f"loss did not fall over the "
                                  f"{TRAIN_STEPS} steps: {losses}")
    want = cfg.num_layers * TRAIN_STEPS
    check(fwd == want and bwd == want,
          f"K2/K3 launches {fwd}/{bwd} != {cfg.num_layers} layers x "
          f"{TRAIN_STEPS} steps")
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = bs * seq * TRAIN_STEPS / wall
    log(f"  GPT-small O2 bf16, bs {bs} x seq {seq}, AdamW(1e-4): warm-up "
        f"step {warm_s:.2f} s, then {TRAIN_STEPS} steps in {wall:.3f} s; "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"  K2 launches {fwd}, K3 launches {bwd} = {cfg.num_layers} layers "
        f"x {TRAIN_STEPS} steps")
    prof = profile_steps(torch, trainer, ids) if profile else None
    del trainer, model
    torch.cuda.empty_cache()
    return {"fwd_launches": fwd, "bwd_launches": bwd, "losses": losses,
            "step_ms": step_ms, "tokens_per_s": tok_s,
            "peak_bytes": peak, "wall_s": wall, "warmup_s": warm_s,
            "profile": prof}


class _PlainFlash:
    """Swaps the plain K2/K3 functions in for the kernels on CUDA
    tensors, for the gradient check only (restored on exit)."""

    def __init__(self, torch, fa):
        self.fa = fa

        class Plain(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, causal, scale):
                out, lse = fa.flash_forward_plain(q, k, v, causal, scale)
                ctx.save_for_backward(q, k, v, out, lse)
                ctx.causal, ctx.scale = causal, scale
                return out

            @staticmethod
            def backward(ctx, g):
                q, k, v, out, lse = ctx.saved_tensors
                return (*fa.flash_backward_plain(q, k, v, out, lse, g,
                                                 ctx.causal, ctx.scale),
                        None, None)
        self.plain = Plain

    def __enter__(self):
        self.saved = self.fa.FlashAttentionFunction
        self.fa.FlashAttentionFunction = self.plain

    def __exit__(self, *exc):
        self.fa.FlashAttentionFunction = self.saved


def phase_grad_check(torch, np, P):
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    model = P.models.GPT(P.models.GPTConfig(hidden_size=768, num_layers=2,
                                            num_heads=12),
                         seed=0, device="cuda")
    norm = {k for k in dict(model.named_parameters())
            if ".ln" in k or k.startswith("ln_")}
    params = {k: (p.detach() if k in norm else p.detach().bfloat16())
              .requires_grad_() for k, p in model.named_parameters()}
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, model.cfg.vocab_size, (8, 1024))).cuda()

    def grads():
        logits = torch.func.functional_call(model, params, (ids,))
        loss = model.loss(logits, ids)
        return dict(zip(params, torch.autograd.grad(loss,
                                                    list(params.values()))))

    fa.BWD_LAUNCHES.reset()
    g_kernel = grads()
    check(fa.BWD_LAUNCHES.count == 2, "kernel path did not launch K3")
    with _PlainFlash(torch, fa):
        g_plain = grads()
    check(fa.BWD_LAUNCHES.count == 2, "plain path launched K3")
    worst, worst_name = 0.0, ""
    for k in params:
        a, b = g_kernel[k].float(), g_plain[k].float()
        rel = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
        check(rel <= 3e-2, f"{k}: ||g_kernel - g_plain|| / ||g_plain|| = "
                           f"{rel:.3e} > 3e-2")
        if rel > worst:
            worst, worst_name = rel, k
    log(f"  2-layer full-width GPT-small, bs 8 x 1024, bf16: {len(params)} "
        f"parameter gradients, kernel vs plain attention; worst relative "
        f"error {worst:.3e} ({worst_name}), limit 3e-2")
    del model, params, g_kernel, g_plain
    torch.cuda.empty_cache()
    return {"worst_rel": worst, "worst_param": worst_name}


# --------------------------------------------------------------------------- #
# phase 8: numbers
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
    # phase-4 shapes; lengths of the first 8 requests halfway through
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
    log(f"  K1 at phase-4 shapes (B=S={S}, T={T}, nh={nh}, hd={hd}, bf16, "
        f"block_k={block_k}, splits={ns}, lengths {lengths}) [card: {card}]")
    log(f"    wrapper (kernel + split merge) median {ms:.4f} ms; kernel "
        f"alone {kernel_ms:.4f} ms")
    log(f"    byte bound {bytes_ms:.5f} ms ({nbytes} B at 3.35 TB/s), op "
        f"bound {ops_ms:.6f} ms -> bound {bound_ms:.5f} ms (bytes)")
    log(f"    plain version (ragged_decode_reference) {plain_ms:.4f} ms; "
        f"library yardstick (scaled_dot_product_attention, full slab + "
        f"keep mask) {library_ms:.4f} ms")
    log(f"  engine, phase 4 [card: {card}]: "
        f"{engine_run['tokens_per_s']:.1f} tokens/s, decode "
        f"{engine_run['decode_ms_per_token']:.3f} ms/token (per decode "
        f"step), TTFT p50 {engine_run['ttft_p50_s'] * 1e3:.1f} ms, p99 "
        f"{engine_run['ttft_p99_s'] * 1e3:.1f} ms")
    return {"ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "lengths": lengths}


def flash_bound(b, sq, sk, h, d, causal, n_products, n_q, n_k):
    """(bound ms, "bytes" | "operations", bytes, flops) of a flash call:
    `n_q` bf16 (b, sq, h, d) and `n_k` bf16 (b, sk, h, d) tensors each
    read or written once, plus the fp32 (b, h, sq) logsumexp, over 3.35
    TB/s; 2 d flops per product per visible (query, key) pair (under
    the causal rule only the pairs this shape keeps: q + sk - sq >= j),
    over the bf16 tensor-core peak."""
    if causal:
        off = sk - sq
        pairs = sum(min(q + off + 1, sk) for q in range(sq))
    else:
        pairs = sq * sk
    flops = n_products * 2 * d * pairs * b * h
    nbytes = 2 * b * h * d * (n_q * sq + n_k * sk) + 4 * b * h * sq
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes, flops


def phase_flash_numbers(torch, fa, card: str):
    F = torch.nn.functional
    f = FLASH_SHAPE
    b, s_, h, d = f["b"], f["s"], f["h"], f["d"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, g = flash_inputs(torch, gen, b, s_, s_, h, d, packed=True)
    scale = 1 / math.sqrt(d)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out, lse = fa._launch_fwd(q, k, v, True, scale)
    fwd_ms = time_ms(torch, lambda: fa._launch_fwd(q, k, v, True, scale),
                     flush, reps=20)
    bwd_ms = time_ms(torch, lambda: fa._launch_bwd(q, k, v, out, lse, g,
                                                   True, scale), flush,
                     reps=20)
    fwd_plain = time_ms(torch, lambda: fa.flash_forward_plain(
        q, k, v, True, scale), flush, reps=5)
    bwd_plain = time_ms(torch, lambda: fa.flash_backward_plain(
        q, k, v, out, lse, g, True, scale), flush, reps=5)
    # yardstick: one PyTorch call of the same function, (b, h, s, d)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    torch.testing.assert_close(lib_out.transpose(1, 2).float(), out.float(),
                               **TOL["bfloat16"])
    fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), flush, reps=20)
    gt = g.transpose(1, 2)
    bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), gt, retain_graph=True), flush, reps=20)
    # K2: q.k and p.v; reads q, k, v, writes out and lse. K3: the five
    # products of the merged TPU kernel (s, dp, dv, dk, dq); reads q, k,
    # v, out, g and lse, writes dq, dk, dv
    fwd_bound = flash_bound(b, s_, s_, h, d, True, 2, n_q=2, n_k=2)
    bwd_bound = flash_bound(b, s_, s_, h, d, True, 5, n_q=4, n_k=4)
    log(f"  K2/K3 at the training shape (b {b}, s {s_}, h {h}, d {d}, "
        f"causal, bf16, packed qkv) [card: {card}]")
    for name, ms, plain, lib, (bound, by, nbytes, flops) in (
            ("K2 forward", fwd_ms, fwd_plain, fwd_lib, fwd_bound),
            ("K3 backward", bwd_ms, bwd_plain, bwd_lib, bwd_bound)):
        log(f"    {name}: median {ms:.4f} ms; bound {bound:.4f} ms "
            f"({by}: {nbytes} B, {flops / 1e9:.2f} GFLOP); plain "
            f"{plain:.3f} ms; scaled_dot_product_attention {lib:.4f} ms")
    del q, k, v, g, out, lse, qt, kt, vt, lib_out, flush
    torch.cuda.empty_cache()
    return {"fwd": {"ms": fwd_ms, "plain_ms": fwd_plain,
                    "library_ms": fwd_lib, "bound_ms": fwd_bound[0],
                    "bound_by": fwd_bound[1]},
            "bwd": {"ms": bwd_ms, "plain_ms": bwd_plain,
                    "library_ms": bwd_lib, "bound_ms": bwd_bound[0],
                    "bound_by": bwd_bound[1]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON "
                                  "file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 3 training steps by kernel "
                         "(torch.profiler) after phase 6")
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
    from paddle_tpu_torch.ops_cuda import flash_attention as fa

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
    log("phase 3: K2 and K3 against their plain versions")
    flash_err = phase_flash_kernels(torch, fa)
    log("phase 4: GPT-small served at full width through K1")
    engine_run = phase_engine(torch, np, P)
    log("phase 5: ragged vs masked attention, fp32")
    rvm = phase_ragged_vs_masked(torch, np, P)
    log("phase 6: GPT-small trained at full width through K2 and K3")
    train = phase_train(torch, np, P, profile=args.profile)
    log("phase 7: gradients through the kernels vs the plain versions")
    grad = phase_grad_check(torch, np, P)
    log("phase 8: numbers")
    nums = phase_numbers(torch, dec, engine_run, card)
    fnums = phase_flash_numbers(torch, fa, card)
    log(f"  training, phase 6 [card: {card}]: {train['step_ms']:.2f} ms per "
        f"step, {train['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{train['peak_bytes'] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")

    flash = "paddle_tpu/ops_pallas/flash_attention.py"
    kernels = [{
        "name": "ragged_decode", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/decode_attention.cu",
        "replaces": "paddle_tpu/ops_pallas/decode_attention.py:225",
        "launches": engine_run["launches"], "max_abs_err": max_err,
        "ms": nums["ms"], "plain_ms": nums["plain_ms"],
        "bound_ms": nums["bound_ms"], "bound_by": nums["bound_by"],
        "library_ms": nums["library_ms"]}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/flash_attention_fwd.cu",
        "replaces": f"{flash}:90", "launches": train["fwd_launches"],
        "max_abs_err": flash_err["fwd"], **fnums["fwd"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/flash_attention_bwd.cu",
        "replaces": f"{flash}:205", "launches": train["bwd_launches"],
        "max_abs_err": flash_err["bwd"], **fnums["bwd"]}]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels,
                       "kernel_only_ms": nums["kernel_ms"],
                       "timing_lengths": nums["lengths"],
                       "engine": {k: v for k, v in engine_run.items()
                                  if k != "prompts"},
                       "ragged_vs_masked": rvm, "train": train,
                       "grad_check": grad,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    log(f"  whole run {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
