#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out result.json] [--profile]

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):
1. card name and power limit (nvidia-smi); build every kernel with nvcc,
   one process per source, all at once.
2. kernel K1 (ragged flash-decode; each lane and head cut into C(T) =
   min(8, max(1, T / 128)) CTAs of one thread-block cluster, merged
   inside the launch) against its plain version (split-K + merge) and
   the full-slab reference on the card at GPT-small decode shapes
   (B = S = 8, nh = 12, hd = 64) at T = 1024 (C = 8), 256 (C = 2) and 64
   (C = 1), fp32 and bf16, the reference's 1 and 2 splits, a
   repeated-slot verify layout, lengths 0, 1, block_k - 1, block_k,
   block_k + 1, 513, T - 1, T; outputs within fp32 atol = rtol = 1e-4 /
   bf16 2e-2 of `ragged_decode_reference` and within 1e-5 / 2e-2 of the
   plain split + merge, one launch per call, visit counts exactly the
   reference's live-chunk arithmetic, and dead cache rows never read
   (NaN-filled dead rows leave the output bitwise unchanged).
2a. kernels K4 (paged), K5 (int8) and K6 (paged int8) against their
   plain versions (split + merge) at the same shapes and the same three
   T, fp32 and bf16, pages of 64 rows at shuffled ids, the phase-2 edge
   lengths and the phase-4 lengths (clipped to T): outputs within
   atol = rtol = 1e-5 (fp32) / 2e-2 (bf16), visit counts exact, NaN in
   dead rows, unbound pages and the trash page (in the scales, for
   int8) leaves the output bitwise unchanged; K4 == K1 and K6 == K5
   bitwise on the same rows.
2b. kernel K7 (fused int8 GEMV) against its plain version, bitwise, at
   GPT-small's five (k, n) (768 x 2304 / 768 / 3072, 3072 x 768 and the
   int8 draft's head 768 x 50304), gpt_1p3b's four block shapes (2048 x
   6144 / 2048 / 8192, 8192 x 2048) and three edges through the wrapper
   (k 100, no multiple of 4, at n 16 and 48; k 20, shorter than one
   split of the launch plan, at n 768), 1-4 rows, x in bf16 and fp32
   (the weight scales in x's dtype), without a bias and with an fp32
   and a bf16 one; inputs include x on code half-points ((c + 0.5) *
   sx) and on +-127.5 * sx. Each shape's launch plan is logged.
3. kernels K2 (flash-attention forward) and K3 (backward: delta, dk/dv
   and dq kernels) on both routes, `wgmma` (bf16 at head dim 32, 64,
   128) and `tf32x3` (fp32 at 32, 64, 128: the split kernel, then every
   product as three TF32 products), against their plain versions (fp32
   products exact, TF32 off): the training shape (b 18,
   s 1024, h 12, d 64, causal, q/k/v strided slices of one fused qkv
   tensor as the model passes them), sq < sk (256 vs 1024) causal, a
   length that is no tile multiple (1000) non-causal and causal,
   d = 128, and the edges of the TMA tiles: d = 128 on a packed qkv
   (two 64-column boxes per row tile, strided), causal sq 200 against
   sk 1000 (sq no multiple of 128, sk - sq a multiple of neither 64 nor
   128), causal sq 1 against sk 333 (one query under one tile), and
   b x h = 1024 heads (far more work items than SMs); then causal sq
   1024 against sk 256 (768 rows with no visible key: the reference's
   uniform softmax), causal sq 300 / sk 200, d 128 sq 1000 / sk 900
   (the last empty row inside a K2 warpgroup and a K3 query tile) and
   sq 1000 / sk 936 (the edge between K2's two warpgroups of a tile),
   b x h = 66000 at s 128; fp32 at d 64 (packed), 32 and 128, fp32
   sq 200 / sk 333, fp32 causal sq 300 / sk 200, bf16 d 32 packed and
   not, bf16 d 32 causal sq 300 / sk 200 and sq 1 / sk 333 (the 64-byte
   swizzle on the same edges as d 64), fp32 d 128 sq 1000 / sk 900 and
   an fp32 slice whose strides are no multiple of 16 bytes. bf16: the
   output
   within atol = rtol = 2e-2, the logsumexp within atol = 1e-3, each
   gradient within max|kernel - plain| <= 2e-2 * max|plain|; fp32: the
   output and each gradient within 1e-5 * max|plain|, the logsumexp
   within 1e-5 * max|plain|; rows with no visible key have lse -1e30
   and dq 0; two backward runs bitwise equal; each call launches on
   its route only.
3b. the TF32 probe (`csrc/tf32_probe.cu`): a 64 x 64 x 32 wgmma tile
   product against an fp32 FFMA product and fp64, at the magnitudes of
   attention scores (normal operands) and probabilities ([0, 1) times
   normal): the largest error relative to max|fp64| of one TF32
   product, of 3xTF32 from shared memory and of 3xTF32 with A from
   registers (the tf32x3 route's P and dS, in its permuted fragments);
   both 3xTF32 within 1e-5. Chosen operands show whether the card
   truncates or rounds the 13 low bits of an fp32 operand it reads as
   TF32.
4. serving at full width: GPT-small (768 hidden, 12 layers, 12 heads,
   vocab 50304, random weights from a seed) in bf16 served by
   `LLMEngine(max_slots=8, max_seq=1024, decode_block_size=8)` on 16
   requests (prompts 16..700 tokens, 64 new tokens, mostly greedy, some
   sampled). Every request finishes; K1 launched exactly num_layers x
   decode steps times; one host sync per dispatch; two greedy requests
   served alone reproduce their batched streams bitwise.
4b. the same load through `kv_layout="paged"` (K4), `kv_dtype="int8"`
   (K5) and both (K6): each run launches its kernel exactly num_layers
   x decode steps times and the other decode kernels never; paged
   streams equal slotted ones token for token.
4c. paged int8 with `kv_pages=49`: admission waits on pages while lanes
   are free, all 16 requests finish with (b)'s streams, 0 pages leak.
4d. an int8-PTQ GPT-small (the port's `PTQ` over the bf16 model,
   calibrated on two fixed batches from numpy seed 0) served with
   `max_slots=4` on 8 of phase 4's requests: K7 launched exactly 4 x 12
   times per decode step (prefill rows exceed 4 and take the unfused
   product), K1 12 times; the same load with K7's plain version swapped
   in gives the same streams.
4e. speculation on == off at GPT-small bf16: `max_slots=4`,
   `decode_block_size=8`, `speculate_k=3`, 8 of phase 4's requests
   (greedy and sampled, one stopping at an EOS, 32 new tokens): draft
   trunc and int8 on the slotted layout, int8 on the paged layout, int8
   with `kv_dtype="int8"`; every stream equals the spec-off engine's
   token for token. K7 launches = (4 x draft_layers + 1) x k x
   spec_rounds x decode blocks (int8 draft), 0 (trunc); the decode
   kernel's = (k x draft_layers + 12) x spec_rounds x decode blocks.
   Acceptance rate and tokens/s, off against on, are logged.
5. ragged against masked attention in fp32: equal greedy streams,
   except after a step whose top-2 logit margin is below 1e-3 (margins
   logged).
5d. paged against slotted greedy streams with fp32 weights: K4 against
   K1 and K6 against K5, equal token for token (smallest top-2 margin
   logged).
6. training at full width: GPT-small from seed 0 under
   `Trainer(AdamW(1e-4), amp_level="O2", amp_dtype="bfloat16")` on one
   resident batch of 18 x 1024 token ids (numpy seed 0), as `bench.py`
   trains; one warm-up step, then 10 steps. Every loss finite, the last
   below the first, K2 and K3 each launched exactly 12 x 10 times; step
   ms, tokens/s and peak memory.
6b. fp32 training at `Trainer`'s default amp_level=None through the
   tf32x3 route: gpt_tiny (head dim 32, bs 8 x 256, AdamW 1e-3) takes 3
   steps on the card and the same 3 on the CPU (plain attention),
   losses within 1e-4 relative; gpt_tiny under O2 (bf16 at head dim 32)
   takes 3 steps on the wgmma route; GPT-small in fp32 takes 1 warm-up
   and 3 timed steps at bs 18 x 1024 (step ms, tokens/s). Each counts
   its launches on its route only (4 x 3 each way for gpt_tiny, 12 x 4
   for GPT-small).
7. gradients of one step of a full-width 2-layer GPT-small (bs 8 x
   1024, bf16 O2 parameters) through the kernels against the same step
   with the plain versions swapped in on the same CUDA tensors:
   ||g_kernel - g_plain|| / ||g_plain|| <= 3e-2 for every parameter.
8. numbers: K1's median time (one launch, merge included) at phase-4
   shapes and lengths beside its byte bound, the plain version's time and one
   `scaled_dot_product_attention` call over the full slab with the keep
   mask; K4, K5 and K6 the same way (their yardstick gathers pages
   and/or dequantises first); the engine through each of them; K2 and K3 at the training shape beside their bounds, plain
   versions and `scaled_dot_product_attention` (causal) forward and
   backward (yardsticks only; the port never calls it); engine
   tokens/s, decode ms/token, TTFT p50/p99 — each beside the card and
   its power limit. K3's parts (delta, dk/dv, dq) are timed one at a
   time, and each flash source's nvcc time and each flash kernel's
   registers, local (spill) bytes and dynamic shared memory are
   printed. The timer's floor under the same `time_ms`: an empty
   kernel (with and without the flush) and 96 empty CTAs in clusters
   of 8 that meet at one cluster barrier. K7 at each (k, n) of 2b's
   GPT-small and gpt_1p3b shapes with 4 bf16 rows: median after an L2
   flush, byte bound, a read-only stream over the same weight bytes
   (what a perfect GEMV could read under this timer), K7's timing
   variants (without the quantize prologue, without the cluster
   merge, without the whole reduction, without prologue and
   reduction), plain version, and two yardsticks never called by the
   port (bf16 `torch.matmul` with the fp weights, and `torch._int_mm`
   on rows padded to 32). The tf32x3 route's forward
   and backward at GPT-small's fp32 training shape (the split kernel's
   share timed alone) and the wgmma route at phase 3's bf16 d 32 shape,
   beside their bounds (fp32: three TF32 products over 495 TFLOP/s, and
   the FFMA bound over 67 TFLOP/s), plain versions,
   `scaled_dot_product_attention` (TF32 off), and each kernel's
   registers and spills.
Then one JSON line of kernel records and, last, the device line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, device memory
FP32_FLOPS = 67e12               # H100 SXM data sheet, fp32 non-tensor
TF32_FLOPS = 495e12              # H100 SXM data sheet, TF32 dense tensor
BF16_FLOPS = 989e12              # H100 SXM data sheet, bf16 dense tensor
INT8_OPS = 1979e12               # H100 SXM data sheet, int8 dense tensor
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

# T = 1024 (GPT-small's max_seq: 8 CTAs per lane and head), 256 (2) and
# 64 (1), the fused kernel's cluster sizes C(T)
DECODE_T = (1024, 256, 64)


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
    """K1 (fused: its split ranges merged inside the launch through a
    thread-block cluster) against the full-slab reference and against
    the plain split-K version + merge, at each T of DECODE_T; visit
    counts exact; NaN in dead rows leaves the output bitwise unchanged.
    Lengths past T are clipped to T by every version."""
    S, nh, hd = 8, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for T in DECODE_T:
        block_k, _ = dec.pick_decode_blocks(T, hd, torch.bfloat16)
        for name, dtype, ns, lengths, slots in kernel_cases(torch, T,
                                                            block_k):
            if T % (block_k * ns):
                continue
            name = f"T {T} (C {dec.cluster_size(T)}) {name}"
            B = len(lengths)
            q = torch.randn(B, nh, hd, device="cuda", generator=gen).to(dtype)
            kc = torch.randn(S, T, nh, hd, device="cuda",
                             generator=gen).to(dtype)
            vc = torch.randn(S, T, nh, hd, device="cuda",
                             generator=gen).to(dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            smap = None if slots is None else torch.tensor(
                slots, dtype=torch.int32, device="cuda")
            dec.LAUNCHES.reset()
            out, visits = dec.ragged_decode_attention(
                q, kc, vc, lens, slot_map=smap, block_k=block_k,
                num_splits=ns, with_stats=True)
            torch.cuda.synchronize()
            check(dec.LAUNCHES.count == 1, f"{name}: {dec.LAUNCHES.count} "
                                           f"launches for one call")
            ref = dec.ragged_decode_reference(q, kc, vc, lens, slot_map=smap)
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(dtype)[6:]]
            check(bool(torch.isfinite(out).all()),
                  f"{name}: non-finite output")
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            # visit counts: clip(ceil((len - split_start) / block_k), 0,
            # blocks), the reference's arithmetic for its (block_k, ns)
            rows = T // ns
            want = [[min(max(-(-(n - p * rows) // block_k), 0),
                         rows // block_k) for p in range(ns)]
                    for n in lengths]
            check(visits.cpu().tolist() == want,
                  f"{name}: visits {visits.cpu().tolist()} != {want}")
            # against the plain split-K version and its merge
            sm = smap if smap is not None else torch.arange(
                B, dtype=torch.int32, device="cuda")
            plain = dec.ragged_decode_split_plain(
                q, kc, vc, lens, sm, 1 / math.sqrt(hd), block_k, ns)
            want_out = dec._merge_splits(*plain[:3], q.dtype)
            torch.testing.assert_close(out.float(), want_out.float(),
                                       **PLAIN_TOL[str(dtype)[6:]])
            check(plain[3].tolist() == want, f"{name}: plain visits")
            # dead rows are never read: NaN there leaves the output
            # unchanged
            keep = (torch.arange(T, device="cuda")[None, :]
                    < lens[:, None].long())
            kn, vn = kc.clone(), vc.clone()
            live = torch.zeros(S, T, dtype=torch.bool, device="cuda")
            for b, s in enumerate(sm.tolist()):
                live[s] |= keep[b]
            kn[~live] = float("nan")
            vn[~live] = float("nan")
            out_nan = dec.ragged_decode_attention(
                q, kn, vn, lens, slot_map=smap, block_k=block_k,
                num_splits=ns)
            torch.cuda.synchronize()
            check(torch.equal(out_nan, out), f"{name}: a dead row was read")
            worst = max(worst, err)
            log(f"  K1 {name}: max|kernel - reference| = {err:.3e} "
                f"(atol=rtol={tol['atol']:g}), within "
                f"{PLAIN_TOL[str(dtype)[6:]]['atol']:g} of plain split + "
                f"merge, visits exact, dead rows unread, one launch")
    return worst


# --------------------------------------------------------------------------- #
# phase 2a: K4, K5, K6 against their plain versions
# --------------------------------------------------------------------------- #

PAGE = 64                       # the engine's default page at max_seq 1024
PLAIN_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def serving_lengths(np, T: int):
    """The first 8 phase-4 requests' lengths halfway through their 64
    new tokens (the rows a decode step of that run attends)."""
    return [min(int(p.size) + 32, T)
            for p in make_prompts(np, 16, 16, 700, 50304, seed=1)[:8]]


def page_tables(torch, gen, S, T, lengths, page):
    """Shuffled block tables for S lanes of T rows: each lane's bound
    pages (enough for its length) at random page ids, 0 (the trash page)
    past them, and spare pages left unbound. Returns (tables, number of
    pages, live mask (num_pages, page) of the rows below each length)."""
    maxp = T // page
    num_pages = 1 + S * maxp + 7
    ids = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    tables = ids[:S * maxp].reshape(S, maxp).to(torch.int32)
    live = torch.zeros(num_pages, page, dtype=torch.bool, device="cuda")
    for s, n in enumerate(lengths):
        nb = -(-n // page)
        tables[s, nb:] = 0
        for j in range(nb):
            live[int(tables[s, j]), :min(page, n - j * page)] = True
    return tables, num_pages, live


def to_pages(torch, x, tables, num_pages, page):
    """Slotted rows x (S, T, ...) scattered into a (num_pages, page,
    ...) pool through `tables` (bound pages only; the rest stay 0)."""
    pool = torch.zeros((num_pages, page) + tuple(x.shape[2:]),
                       dtype=x.dtype, device="cuda")
    S, maxp = tables.shape
    for s in range(S):
        for j in range(maxp):
            pid = int(tables[s, j])
            if pid:
                pool[pid] = x[s, j * page:(j + 1) * page]
    return pool


def paged_cases(torch, np):
    """(T, dtype, name, lengths) of phase 2a: each T of DECODE_T, fp32
    and bf16, the edge lengths and the serving lengths, clipped to T."""
    for T in DECODE_T:
        for dtype in (torch.float32, torch.bfloat16):
            yield T, dtype, "edges", [min(n, T) for n in (
                0, 1, PAGE - 1, PAGE, PAGE + 1, 513, T - 1, T)]
            yield T, dtype, "serving", [min(n, T) for n in
                                        serving_lengths(np, 1024)]


def phase_paged_quant_kernels(torch, np, dec):
    """K4 (paged), K5 (int8) and K6 (paged int8) at the serving shapes
    and each T of DECODE_T against their plain versions (split + merge)
    on the same CUDA tensors; visit counts; NaN in dead rows and on the
    trash page leaves the output bitwise unchanged; K4 ≡ K1 and K6 ≡ K5
    bitwise on the same rows. Lengths are clipped to T."""
    from paddle_tpu_torch.quantization.kv import kv_quantize
    S, nh, hd = 8, 12, 64
    scale = 1 / math.sqrt(hd)
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"K4": 0.0, "K5": 0.0, "K6": 0.0}
    for T, dtype, lname, lengths in paged_cases(torch, np):
        tname = f"T {T} {str(dtype)[6:]}"
        tol = PLAIN_TOL[str(dtype)[6:]]
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn(S, nh, hd, device="cuda", generator=gen).to(dtype)
        kc = torch.randn(S, T, nh, hd, device="cuda",
                         generator=gen).to(dtype)
        vc = torch.randn(S, T, nh, hd, device="cuda",
                         generator=gen).to(dtype)
        kq, ks = kv_quantize(kc)
        vq, vs = kv_quantize(vc)
        sm = torch.arange(S, dtype=torch.int32, device="cuda")
        keep = (torch.arange(T, device="cuda")[None, :]
                < lens[:, None].long())                  # (S, T)
        tables, npages, live = page_tables(torch, gen, S, T, lengths,
                                           PAGE)
        kp, vp, kqp, vqp, ksp, vsp = (
            to_pages(torch, x, tables, npages, PAGE)
            for x in (kc, vc, kq, vq, ks, vs))
        cases = {
            "K4": (dict(paged=True), (kp, vp, None, None)),
            "K5": (dict(paged=False), (kq, vq, ks, vs)),
            "K6": (dict(paged=True), (kqp, vqp, ksp, vsp))}
        outs = {}
        for kname, (how, (k_, v_, ks_, vs_)) in cases.items():
            if how["paged"]:
                bk, ns = dec.pick_paged_decode_blocks(T, PAGE, hd,
                                                      k_.dtype)
                run = lambda k_, v_, ks_, vs_, bk=bk, ns=ns: \
                    dec.paged_ragged_decode_attention(
                        q, k_, v_, tables, lens, block_k=bk,
                        num_splits=ns, with_stats=True, k_scale=ks_,
                        v_scale=vs_)
                plain = dec.paged_decode_split_plain(
                    q, k_, v_, tables, lens, scale, bk, ns, ks_, vs_)
            else:
                bk, ns = dec.pick_decode_blocks(T, hd, k_.dtype)
                run = lambda k_, v_, ks_, vs_, bk=bk, ns=ns: \
                    dec.ragged_decode_attention(
                        q, k_, v_, lens, block_k=bk, num_splits=ns,
                        with_stats=True, k_scale=ks_, v_scale=vs_)
                plain = dec.ragged_decode_split_plain(
                    q, k_, v_, lens, sm, scale, bk, ns, ks_, vs_)
            out, visits = run(k_, v_, ks_, vs_)
            torch.cuda.synchronize()
            want = dec._merge_splits(*plain[:3], q.dtype)
            check(bool(torch.isfinite(out).all()),
                  f"{kname} {tname} {lname}: non-finite output")
            torch.testing.assert_close(out.float(), want.float(), **tol)
            err = (out.float() - want.float()).abs().max().item()
            rows = T // ns
            exp = [[min(max(-(-(n - p * rows) // bk), 0), rows // bk)
                    for p in range(ns)] for n in lengths]
            check(visits.cpu().tolist() == exp == plain[3].tolist(),
                  f"{kname} {tname} {lname}: visits "
                  f"{visits.cpu().tolist()} != {exp}")
            # dead rows and the trash page never read: NaN there (in
            # the scales, for int8 codes) leaves the output unchanged
            nan = float("nan")
            if how["paged"]:
                dead = ~live
                if ks_ is None:
                    out_nan, _ = run(k_.masked_fill(dead[..., None, None],
                                                    nan),
                                     v_.masked_fill(dead[..., None, None],
                                                    nan), None, None)
                else:
                    out_nan, _ = run(k_, v_,
                                     ks_.masked_fill(dead[..., None], nan),
                                     vs_.masked_fill(dead[..., None], nan))
            else:
                out_nan, _ = run(k_, v_,
                                 ks_.masked_fill(~keep[..., None], nan),
                                 vs_.masked_fill(~keep[..., None], nan))
            torch.cuda.synchronize()
            check(torch.equal(out_nan, out),
                  f"{kname} {tname} {lname}: a dead row was read")
            outs[kname] = out
            worst[kname] = max(worst[kname], err)
            log(f"  {kname} {tname} {lname} (block_k {bk}, splits {ns}):"
                f" max|kernel - plain| = {err:.3e} (atol=rtol="
                f"{tol['atol']:g}), visits exact, dead rows and trash "
                f"page unread")
        # the addressing seam does not change the arithmetic
        k1 = dec.ragged_decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        check(torch.equal(outs["K4"], k1),
              f"K4 != K1 bitwise ({tname} {lname})")
        check(torch.equal(outs["K6"], outs["K5"]),
              f"K6 != K5 bitwise ({tname} {lname})")
        log(f"  {tname} {lname}: K4 == K1 and K6 == K5 bitwise")
    return worst


# --------------------------------------------------------------------------- #
# phase 2b: K7 against its plain version
# --------------------------------------------------------------------------- #

# (k, n) of GPT-small's block linears (qkv, out, fc1, fc2) and of the
# int8 draft's tied head
INT8_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768),
               (768, 50304))
# (k, n) of gpt_1p3b's block linears (hidden 2048)
INT8_1P3B_SHAPES = ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048))
HALF_SX = 1.0 / 64      # a power of two: (c + 0.5) * sx is exact in bf16


# (k, n) cases through the wrapper beyond the models' shapes: k no
# multiple of 4 at n = 16 and 48 (one and three column groups), and a k
# shorter than one split of the launch plan
INT8_EDGE_SHAPES = ((100, 16), (100, 48), (20, 768))


def int8_inputs(torch, gen, m, k, n, dtype):
    """x (m, k) in `dtype` whose first row holds exact code half-points
    ((c + 0.5) * sx for c in -3..3, and +-127.5 * sx) at sx = 1/64,
    int8 weights (k, n), weight scales (n,) in `dtype`, sx, and fp32
    and bf16 biases."""
    x = torch.randn(m, k, device="cuda", generator=gen) * 0.5
    halves = torch.tensor([-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5,
                           127.5, -127.5], device="cuda") * HALF_SX
    x[0, :halves.numel()] = halves[:k]
    qw = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                       dtype=torch.int8)
    ws = (torch.rand(n, device="cuda", generator=gen) * 0.01).to(dtype)
    b = torch.randn(n, device="cuda", generator=gen)
    sx = torch.tensor(HALF_SX, device="cuda")
    return x.to(dtype), qw, ws, sx, {"no bias": None, "fp32 bias": b,
                                     "bf16 bias": b.bfloat16()}


def phase_int8_kernel(torch, k7):
    """K7 against its plain version on the same CUDA tensors: equal bit
    for bit at every shape (GPT-small's, gpt_1p3b's block linears and
    the edge cases), row count, dtype and bias."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = 0
    for k, n in INT8_SHAPES + INT8_1P3B_SHAPES + INT8_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for m in (1, 2, 3, 4):
                x, qw, ws, sx, biases = int8_inputs(torch, gen, m, k, n,
                                                    dtype)
                for bname, b in biases.items():
                    out = k7.int8_linear_fused(x, qw, ws, sx, b)
                    want = k7.int8_linear_plain(x, qw, ws, sx, b)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(out).all()),
                          f"K7 {k}x{n} m={m} {dtype} {bname}: non-finite")
                    err = (out.float() - want.float()).abs().max().item()
                    check(torch.equal(out, want),
                          f"K7 {k}x{n} m={m} {dtype} {bname}: max|kernel "
                          f"- plain| = {err:.3e}, not bitwise")
                    cases += 1
        log(f"  K7 {k}x{n} ({k7.launch_plan(4, k, n, sms)} at 4 rows): "
            f"rows 1-4, fp32 and bf16 x, no / fp32 / bf16 bias, half-point "
            f"codes: kernel == plain bitwise")
    log(f"  K7: {cases} cases bitwise equal; max|kernel - plain| = 0")
    return 0.0


# --------------------------------------------------------------------------- #
# phase 3: K2 and K3 against their plain versions
# --------------------------------------------------------------------------- #

FLASH_SHAPE = dict(b=18, s=1024, h=12, d=64)     # GPT-small, bench.py bs


def flash_inputs(torch, gen, b, sq, sk, h, d, packed, dtype=None):
    """q, k, v (b, s, h, d) and a cotangent g in `dtype` (bf16 by
    default); `packed` gives q, k, v as the strided slices of one
    (b, s, 3, h, d) tensor, the layout the model's fused qkv projection
    hands the kernels; "odd" the same slices of rows one element longer
    (strides no multiple of 16 bytes: the tf32x3 route's split kernel
    takes them, TMA would not)."""
    dtype = dtype or torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    if packed == "odd":
        rows = rnd(b, sq, 3 * h * d + 1)[..., :3 * h * d]
        qkv = rows.unflatten(-1, (3, h, d))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    elif packed:
        qkv = rnd(b, sq, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d)
    return q, k, v, rnd(b, sq, h, d)


def flash_cases(torch):
    """(name, b, sq, sk, h, d, causal, packed, dtype): bf16 d 64 and
    128 cases, then the fp32 (tf32x3) and bf16 d 32 ones."""
    f, bf, f32 = FLASH_SHAPE, torch.bfloat16, torch.float32
    yield ("training shape", f["b"], f["s"], f["s"], f["h"], f["d"], True,
           True, bf)
    yield "sq < sk", 4, 256, 1024, 12, 64, True, False, bf
    yield "s 1000", 4, 1000, 1000, 12, 64, False, False, bf
    yield "s 1000 causal", 4, 1000, 1000, 12, 64, True, False, bf
    yield "d 128", 4, 512, 512, 8, 128, True, False, bf
    # the edges of the TMA tiles
    yield "d 128 packed", 4, 512, 512, 8, 128, True, True, bf
    yield "sq 200, sk 1000", 2, 200, 1000, 12, 64, True, False, bf
    yield "sq 1, sk 333", 2, 1, 333, 12, 64, True, False, bf
    yield "b x h 1024", 32, 128, 128, 32, 64, False, False, bf
    # rows with no visible key (causal sq > sk) and b x h past 65535
    yield "causal sq 1024, sk 256", 4, 1024, 256, 12, 64, True, False, bf
    # the edge between empty and live rows inside a K2 warpgroup and a K3
    # query tile (row 100), and between K2's two warpgroups (row 64)
    yield "causal sq 300, sk 200", 2, 300, 200, 12, 64, True, False, bf
    yield "d 128 sq 1000, sk 900", 2, 1000, 900, 8, 128, True, False, bf
    yield "causal sq 1000, sk 936", 2, 1000, 936, 12, 64, True, False, bf
    yield "b x h 66000", 5500, 128, 128, 12, 64, False, False, bf
    # fp32 (the tf32x3 route) at d 32, 64, 128, and bf16 at d 32 (the
    # 64-byte swizzle) on the edges d 64 takes; the main paths' shapes:
    # phase 6b's GPT-small fp32 and gpt_tiny O2
    yield ("fp32 training shape", f["b"], f["s"], f["s"], f["h"], f["d"],
           True, True, f32)
    yield "fp32 d 32", 4, 512, 512, 8, 32, True, False, f32
    yield "fp32 d 128", 2, 512, 512, 8, 128, True, False, f32
    yield "fp32 sq 200, sk 333", 2, 200, 333, 12, 64, False, False, f32
    yield "fp32 causal sq 300, sk 200", 2, 300, 200, 12, 64, True, False, f32
    yield "bf16 d 32 packed", 4, 512, 512, 24, 32, True, True, bf
    yield "bf16 d 32", 4, 512, 512, 24, 32, True, False, bf
    yield "bf16 d 32 causal sq 300, sk 200", 2, 300, 200, 12, 32, True, \
        False, bf
    yield "bf16 d 32 sq 1, sk 333", 2, 1, 333, 12, 32, True, False, bf
    yield "bf16 d 32 gpt_tiny packed", 8, 256, 256, 4, 32, True, True, bf
    yield "fp32 d 128 sq 1000, sk 900", 2, 1000, 900, 8, 128, True, False, f32
    yield "fp32 odd strides", 2, 200, 200, 3, 64, True, "odd", f32
    # the longest preset rows (gpt_1p3b: d 128, max_seq 2048): the
    # forward's one running sum over every key tile
    yield "fp32 d 128 causal s 2048", 2, 2048, 2048, 8, 128, True, False, \
        f32


LAYOUT_NOTE = {True: ", packed qkv", "odd": ", odd strides"}


def flash_route_counters(fa):
    """{route: (forward counter, backward counter)} of the flash
    kernels."""
    return {fa.WGMMA: (fa.WGMMA_FWD_LAUNCHES, fa.WGMMA_BWD_LAUNCHES),
            fa.TF32X3: (fa.TF32X3_FWD_LAUNCHES, fa.TF32X3_BWD_LAUNCHES)}


def hold_flash(torch, fa, name, q, k, v, g, causal, scale, out, lse,
               grads):
    """Holds one flash call's (out, lse) and (dq, dk, dv) against the
    plain versions (the backward on the kernel's own forward, the
    residuals the autograd Function saves) at phase 3's tolerances.
    Returns max|out err|, max|lse err| over rows that see a key, and
    each gradient's max err and max err / max|plain|."""
    sq, sk = q.shape[1], k.shape[1]
    pout, plse = fa.flash_forward_plain(q, k, v, causal, scale)
    empty = fa.empty_rows(sq, sk, causal, q.device)
    fp32 = q.dtype == torch.float32
    if fp32:
        tol_o = 1e-5 * pout.abs().max().item()
        torch.testing.assert_close(out, pout, atol=tol_o, rtol=0)
    else:
        torch.testing.assert_close(out.float(), pout.float(),
                                   **TOL["bfloat16"])
    live_lse, live_plse = lse[:, :, ~empty], plse[:, :, ~empty]
    tol_l = 1e-5 * live_plse.abs().max().item() if fp32 else 1e-3
    torch.testing.assert_close(live_lse, live_plse, atol=tol_l, rtol=0)
    check(bool((lse[:, :, empty] == -1e30).all()),
          f"{name}: an empty row's lse is not -1e30")
    err_o = (out.float() - pout.float()).abs().max().item()
    err_l = (live_lse - live_plse).abs().max().item()
    ref_o = pout.float().abs().max().item()
    del pout, plse
    plain = fa.flash_backward_plain(q, k, v, out, lse, g, causal, scale)
    check(bool((grads[0][:, empty] == 0).all()), f"{name}: empty rows' dq")
    errs, rel = [], []
    lim = 1e-5 if fp32 else 2e-2
    for gname, got, want in zip(("dq", "dk", "dv"), grads, plain):
        check(bool(torch.isfinite(got).all()), f"{name}: {gname} "
                                               f"not finite")
        e = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        check(e <= lim * ref, f"{name}: {gname} max err {e:.3e} > "
                              f"{lim:g} x max|plain| {ref:.3e}")
        errs.append(e)
        rel.append(e / ref)
    return {"out_err": err_o, "out_rel": err_o / ref_o, "lse_err": err_l,
            "grad_err": errs, "grad_rel": rel, "limit": lim,
            "empty": int(empty.sum())}


def phase_flash_kernels(torch, fa):
    """K2/K3 on both routes against their plain versions, with fp32
    products exact (TF32 off). bf16: out
    within atol = rtol = 2e-2, lse within 1e-3, gradients within 2e-2 x
    max|plain|. fp32: out and gradients within 1e-5 x max|plain|, lse
    within 1e-5 x max|plain lse| on rows that see a key. Rows with no
    visible key: lse -1e30 exactly, dq 0. Two backward runs bitwise
    equal; each case counts one launch on its route and none on the
    other. The fp32 odd-strided case (q, k, v, g through the split's hi
    copies) gives the same bits as its values in contiguous tensors
    (which TMA reads in place as their own hi parts)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"fwd": 0.0, "bwd": 0.0, "tf32x3_fwd": 0.0, "tf32x3_bwd": 0.0}
    for name, b, sq, sk, h, d, causal, packed, dtype in flash_cases(torch):
        q, k, v, g = flash_inputs(torch, gen, b, sq, sk, h, d, packed,
                                  dtype)
        scale = 1 / math.sqrt(d)
        route = fa._check_cuda_args(q, k, v, causal)
        counters = flash_route_counters(fa)
        for c in (*counters[fa.WGMMA], *counters[fa.TF32X3]):
            c.reset()
        out, lse = fa._launch_fwd(q, k, v, causal, scale)
        dq, dk, dv = fa._launch_bwd(q, k, v, out, lse, g, causal, scale)
        torch.cuda.synchronize()
        counts = {r: (f.count, bw.count) for r, (f, bw) in counters.items()}
        check(counts == {r: (1, 1) if r == route else (0, 0)
                         for r in counters},
              f"{name}: launches by route {counts}, expected {route}")
        held = hold_flash(torch, fa, name, q, k, v, g, causal, scale, out,
                          lse, (dq, dk, dv))
        err_o, rel, lim = held["out_err"], held["grad_rel"], held["limit"]
        key = "bwd" if route == fa.WGMMA else "tf32x3_bwd"
        worst[key] = max(worst[key], *held["grad_err"])
        again = fa._launch_bwd(q, k, v, out, lse, g, causal, scale)
        check(all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)),
              f"{name}: two backward runs differ")
        if packed == "odd":
            same = [x.contiguous() for x in (q, k, v, g)]
            o2, l2 = fa._launch_fwd(*same[:3], causal, scale)
            grads = fa._launch_bwd(*same[:3], out, lse, same[3], causal,
                                   scale)
            check(torch.equal(o2, out) and torch.equal(l2, lse) and all(
                torch.equal(x, y) for x, y in zip(grads, (dq, dk, dv))),
                f"{name}: in-place hi and copied hi differ")
            del same, o2, l2, grads
        key = "fwd" if route == fa.WGMMA else "tf32x3_fwd"
        worst[key] = max(worst[key], err_o)
        n_empty = held["empty"]
        log(f"  {route} {name} (b {b}, sq {sq}, sk {sk}, h {h}, d {d}, "
            f"{str(dtype)[6:]}, causal {causal}"
            f"{LAYOUT_NOTE.get(packed, '')}"
            f"{f', {n_empty} empty rows' if n_empty else ''}"
            f"): max|out err| {err_o:.3e} ({held['out_rel']:.2e} of "
            f"max|plain|), max|lse err| {held['lse_err']:.3e}, dq/dk/dv "
            f"max err / max|plain| {rel[0]:.2e}/{rel[1]:.2e}/{rel[2]:.2e} "
            f"(limit {lim:g}); backward bitwise deterministic"
            f"{'; equal to in-place hi' if packed == 'odd' else ''}")
        del q, k, v, g, out, lse, dq, dk, dv, again
        torch.cuda.empty_cache()
    return worst


def tf32_bits(torch, m: int, sign: float = 1.0) -> float:
    """1 + m 2^-23 (times `sign`): an fp32 value whose 13 low bits are m."""
    x = torch.tensor([0x3F800000 | m], dtype=torch.int32).view(
        torch.float32).item()
    return sign * x


def phase_tf32_probe(torch, fa):
    """(3b) The tensor cores' TF32 arithmetic (`fa.tf32_probe`): a 64 x
    64 x 32 product at the magnitudes of scores (a, b normal) and of
    probabilities (a uniform in [0, 1), b normal): the largest error
    over max|fp64 product| of the fp32 FFMA product (TF32 off), of one
    TF32 product of the raw values, of 3xTF32 from shared memory and of
    3xTF32 with a from registers; both 3xTF32 within 1e-5. Then a[:, 0]
    = 1 + m 2^-23 for chosen low bits m (below, at and above half a
    TF32 ulp, odd and even, both signs), b[:, 0] = 1, the rest 0: the
    product is the card's TF32 reading of each value, compared with
    truncation, round-to-nearest-even and round-half-away."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = {}
    for name in ("scores", "probabilities"):
        a = torch.randn(64, 32, device="cuda", generator=gen)
        if name == "probabilities":
            a = torch.rand(64, 32, device="cuda", generator=gen)
        b = torch.randn(64, 32, device="cuda", generator=gen)
        ref = a.double() @ b.double().T
        den = ref.abs().max().item()
        rec = {"fp32 FFMA": ((a @ b.T).double() - ref).abs().max().item()
               / den}
        for mode, what in ((0, "1xTF32"), (1, "3xTF32 shared"),
                           (2, "3xTF32 registers")):
            got = fa.tf32_probe(a, b, mode).double()
            rec[what] = (got - ref).abs().max().item() / den
        errs[name] = rec
        check(rec["3xTF32 shared"] <= 1e-5 and rec["3xTF32 registers"]
              <= 1e-5, f"3xTF32 probe ({name}): {rec}")
    lows = (0, 0x0FFF, 0x1000, 0x1001, 0x1800, 0x1FFF, 0x2FFF, 0x3000)
    vals = [tf32_bits(torch, m, s) for s in (1.0, -1.0) for m in lows] * 4
    a = torch.zeros(64, 32, device="cuda")
    b = torch.zeros(64, 32, device="cuda")
    a[:, 0] = torch.tensor(vals, device="cuda")
    b[:, 0] = 1.0
    got = fa.tf32_probe(a, b, 0)[:, 0].cpu()
    bits = torch.tensor(vals).view(torch.int32)
    low, odd = bits & 8191, (bits >> 13) & 1
    down = bits & -8192
    rules = {"truncate": down,
             "nearest even": down + 8192 * ((low > 4096) | ((low == 4096)
                                                            & (odd == 1))),
             "nearest, ties away": down + 8192 * (low >= 4096)}
    found = [r for r, want in rules.items()
             if torch.equal(got, want.view(torch.float32))]
    log(f"  TF32 probe, 64 x 64 x 32, error / max|fp64|: " + "; ".join(
        f"{name}: " + ", ".join(f"{k} {v:.2e}" for k, v in rec.items())
        for name, rec in errs.items()))
    log(f"  the card reads an fp32 operand as TF32 by: "
        f"{found[0] if found else 'none of ' + str(list(rules))} (low bits "
        f"{[hex(m) for m in lows]} of 1 + m 2^-23 read as "
        f"{[got[i].item() for i in range(len(lows))]})")
    check(len(found) == 1, f"TF32 reading matches {found or 'no rule'}")
    return {"errors": errs, "rule": found[0]}


# --------------------------------------------------------------------------- #
# phases 4-5: the engine
# --------------------------------------------------------------------------- #

def make_prompts(np, n, lo, hi, vocab, seed):
    rng = np.random.RandomState(seed)
    lengths = np.linspace(lo, hi, n).astype(int)
    rng.shuffle(lengths)
    return [rng.randint(0, vocab, (int(k),)).astype(np.int32)
            for k in lengths]


SERVE_KW = dict(max_slots=8, max_seq=1024, decode_block_size=8, seed=0,
                device="cuda")
# the four decode kernels and the engine knobs that select them
DECODE_VARIANTS = (("K1", {}), ("K4", dict(kv_layout="paged")),
                   ("K5", dict(kv_dtype="int8")),
                   ("K6", dict(kv_layout="paged", kv_dtype="int8")))


def decode_counters(dec):
    return {"K1": dec.LAUNCHES, "K4": dec.PAGED_LAUNCHES,
            "K5": dec.QUANT_LAUNCHES, "K6": dec.PAGED_QUANT_LAUNCHES}


def serving_load(np, SamplingParams, vocab):
    """The 16 requests of phase 4: prompts 16..700 tokens, 64 new
    tokens, 12 greedy and 4 sampled."""
    prompts = make_prompts(np, 16, 16, 700, vocab, seed=1)
    params = [SamplingParams(max_new_tokens=64) for _ in prompts]
    params[3] = SamplingParams(max_new_tokens=64, temperature=0.8)
    params[7] = SamplingParams(max_new_tokens=64, temperature=1.0, top_k=50)
    params[11] = SamplingParams(max_new_tokens=64, temperature=0.9,
                                top_p=0.9)
    params[14] = SamplingParams(max_new_tokens=64, temperature=0.7,
                                top_k=40, top_p=0.95)
    return prompts, params


def serve(torch, dec, model, prompts, params, name, **knobs):
    """Serve the load through one engine with every decode counter set
    to 0 just before and read just after. Checks: every request
    finishes with 64 in-range tokens; the variant's kernel launched
    num_layers x decode steps times and no other decode kernel at all;
    one host sync per dispatch."""
    from paddle_tpu_torch.serving import LLMEngine
    counters = decode_counters(dec)
    eng = LLMEngine(model, **{**SERVE_KW, **knobs})
    check(eng.attend_impl == "ragged", f"auto gave {eng.attend_impl}")
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    results = eng.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c.count for k, c in counters.items()}
    st = eng.stats()
    vocab, layers = model.cfg.vocab_size, model.cfg.num_layers
    for r in results:
        check(r.finish_reason == "length" and len(r.token_ids) == 64,
              f"{name} request {r.request_id}: {r.finish_reason}, "
              f"{len(r.token_ids)} tokens")
        check(all(0 <= t < vocab for t in r.token_ids),
              f"{name} request {r.request_id}: token id out of range")
    want = {k: layers * st["decode_steps"] if k == name else 0
            for k in counters}
    check(counts == want, f"{name}: decode kernel launches {counts} != "
                          f"{want} ({layers} layers x {st['decode_steps']} "
                          f"decode steps)")
    check(st["host_syncs"] == st["decode_dispatches"],
          f"{name}: host_syncs {st['host_syncs']} != dispatches "
          f"{st['decode_dispatches']}")
    if eng.paged:
        check(eng.cache.pool.leaked() == 0, f"{name}: leaked pages")
    log(f"  {name} {knobs or 'slotted'}: {len(results)} requests "
        f"({st['prompt_tokens']} prompt, {st['generated_tokens']} generated"
        f" tokens) in {wall:.2f} s; {name} launches {counts[name]} = "
        f"{layers} layers x {st['decode_steps']} decode steps, other "
        f"decode kernels 0; host_syncs = dispatches "
        f"{st['decode_dispatches']}; kv_bytes_per_token "
        f"{st['kv_bytes_per_token']:.0f}")
    return eng, results, {
        "launches": counts[name], "tokens_per_s": st["tokens_per_sec"],
        "decode_ms_per_token": st["decode_ms_per_token"],
        "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
        "decode_steps": st["decode_steps"],
        "dispatches": st["decode_dispatches"], "wall_s": wall,
        "kv_bytes_per_token": st["kv_bytes_per_token"],
        "kv_pages_peak": st["kv_pages_peak"],
        "streams": [r.token_ids for r in results]}


def gpt_small_bf16(torch, P):
    t0 = time.perf_counter()
    model = P.models.gpt_small(seed=0, device="cuda", dtype="bf16")
    cfg = model.cfg
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.vocab_size)
          == (768, 12, 12, 50304), f"not GPT-small: {cfg}")
    log(f"  GPT-small bf16 built from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def phase_engine(torch, np, P):
    from paddle_tpu_torch.ops_cuda import decode_attention as dec
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model = gpt_small_bf16(torch, P)
    prompts, params = serving_load(np, SamplingParams, model.cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator) outside the measured run
    LLMEngine(model, **SERVE_KW).generate(prompts[:2],
                                          SamplingParams(max_new_tokens=8))
    torch.cuda.synchronize()
    _, results, run = serve(torch, dec, model, prompts, params, "K1")
    # the engine's own invariant: a request served alone gives the same
    # stream as in the batch (lanes are row-independent)
    for i in (0, 1):
        solo = LLMEngine(model, **SERVE_KW).generate([prompts[i]],
                                                     params[i])[0]
        check(solo.token_ids == results[i].token_ids,
              f"request {i}: alone {solo.token_ids[:8]}... != batched "
              f"{results[i].token_ids[:8]}...")
    log("  greedy requests 0 and 1 served alone: streams bitwise equal")
    return {**run, "prompts": prompts, "model": model, "params": params}


def phase_engine_variants(torch, np, dec, engine_run):
    """(b) the phase-4 load served through K4, K5 and K6; paged streams
    equal the slotted ones token for token (bf16: K4 against phase 4's
    K1, int8: K6 against K5), sampled requests included."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model, prompts, params = (engine_run[k] for k in
                              ("model", "prompts", "params"))
    runs = {"K1": engine_run}
    for name, knobs in DECODE_VARIANTS[1:]:
        LLMEngine(model, **SERVE_KW, **knobs).generate(
            prompts[:2], SamplingParams(max_new_tokens=8))     # warm-up
        torch.cuda.synchronize()
        runs[name] = serve(torch, dec, model, prompts, params, name,
                           **knobs)[2]
    for paged, slotted in (("K4", "K1"), ("K6", "K5")):
        check(runs[paged]["streams"] == runs[slotted]["streams"],
              f"{paged} streams != {slotted} streams")
        log(f"  {paged} (paged) and {slotted} (slotted): all 16 streams "
            f"equal token for token")
    return runs


def phase_page_pressure(torch, dec, engine_run, int8_streams):
    """(c) paged int8 with kv_pages = 49 (48 usable pages of 64 rows;
    a request's span takes 2-12): admission waits on pages while lanes
    are free, every request finishes with K6's streams of (b), and no
    page leaks."""
    from paddle_tpu_torch.serving import LLMEngine
    model, prompts, params = (engine_run[k] for k in
                              ("model", "prompts", "params"))
    eng = LLMEngine(model, **SERVE_KW, kv_layout="paged", kv_dtype="int8",
                    kv_pages=49)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    waited = 0
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        if eng._queue and eng.cache.num_free > 0:
            waited += 1            # lanes free, the head waits on pages
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results = [eng.result(r) for r in rids]
    st = eng.stats()
    check(all(r.finish_reason == "length" and len(r.token_ids) == 64
              for r in results), "a request under page pressure failed")
    check(waited > 0, "admission never waited on pages")
    check(eng.cache.pool.leaked() == 0,
          f"{eng.cache.pool.leaked()} pages leaked")
    check(st["kv_pages_peak"] <= 49, f"peak {st['kv_pages_peak']} > 49")
    check([r.token_ids for r in results] == int8_streams,
          "streams under page pressure != K6 streams of (b)")
    log(f"  paged int8, kv_pages 49: 16/16 requests finished in {wall:.2f}"
        f" s, admission waited on pages at {waited} steps with lanes free,"
        f" peak {st['kv_pages_peak']} pages, 0 leaked; streams equal (b)'s")
    return {"waited_steps": waited, "kv_pages_peak": st["kv_pages_peak"],
            "wall_s": wall}


SPEC_KW = dict(max_slots=4, max_seq=1024, decode_block_size=8, seed=0,
               device="cuda")
SPEC_K = 3


def ptq_gpt_small(torch, np, P):
    """The port's PTQ over GPT-small bf16 from seed 0, calibrated on two
    fixed (4, 128) batches of token ids from numpy seed 0."""
    from paddle_tpu_torch.quantization import PTQ, Int8Linear
    model = P.models.gpt_small(seed=0, device="cuda", dtype="bf16")
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, model.cfg.vocab_size, (4, 128))
               for _ in range(2)]
    ptq = PTQ()
    ptq.quantize(model)
    ptq.sample(model, batches)
    ptq.convert(model)
    n = sum(isinstance(m, Int8Linear) for m in model.modules())
    check(n == 4 * model.cfg.num_layers, f"{n} Int8Linear layers")
    return model


class _PlainInt8:
    """Swaps K7's plain version in for the kernel on CUDA tensors, for
    the control run only (restored on exit)."""

    def __init__(self, k7):
        self.k7 = k7

    def __enter__(self):
        self.saved = self.k7.int8_linear_fused
        self.k7.int8_linear_fused = self.k7.int8_linear_plain

    def __exit__(self, *exc):
        self.k7.int8_linear_fused = self.saved


def phase_int8_serving(torch, np, P, dec, k7, engine_run):
    """(4d) an int8-PTQ GPT-small served through K7 with max_slots = 4:
    48 K7 launches and 12 K1 launches per decode step; the plain version
    swapped in for K7 gives the same streams."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model = ptq_gpt_small(torch, np, P)
    prompts, params = engine_run["prompts"][:8], engine_run["params"][:8]
    kw = dict(SPEC_KW)
    LLMEngine(model, **kw).generate(prompts[:2],
                                    SamplingParams(max_new_tokens=8))
    torch.cuda.synchronize()
    k7.INT8_LAUNCHES.reset()
    dec.LAUNCHES.reset()
    eng = LLMEngine(model, **kw)
    t0 = time.perf_counter()
    results = eng.generate(prompts, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    launches, k1 = k7.INT8_LAUNCHES.count, dec.LAUNCHES.count
    layers = model.cfg.num_layers
    check(all(r.finish_reason == "length" and len(r.token_ids) == 64
              for r in results), "an int8 request did not finish")
    check(launches == 4 * layers * st["decode_steps"],
          f"K7 launches {launches} != 4 x {layers} x "
          f"{st['decode_steps']} decode steps")
    check(k1 == layers * st["decode_steps"], f"K1 launches {k1}")
    check(st["host_syncs"] == st["decode_dispatches"], "host syncs")
    streams = [r.token_ids for r in results]
    with _PlainInt8(k7):
        k7.INT8_LAUNCHES.reset()
        plain = [r.token_ids for r in LLMEngine(model, **kw).generate(
            prompts, params)]
        check(k7.INT8_LAUNCHES.count == 0, "the plain run launched K7")
    check(plain == streams, "K7 streams != plain-version streams")
    log(f"  int8-PTQ GPT-small, max_slots 4: 8 requests in {wall:.2f} s, "
        f"{st['tokens_per_sec']:.1f} tokens/s, decode "
        f"{st['decode_ms_per_token']:.3f} ms/step; K7 launches {launches} "
        f"= 4 x {layers} x {st['decode_steps']} decode steps, K1 {k1}; "
        f"streams with K7's plain version swapped in: equal, 8/8")
    del model, eng
    torch.cuda.empty_cache()
    return {"launches": launches, "decode_steps": st["decode_steps"],
            "tokens_per_s": st["tokens_per_sec"],
            "decode_ms_per_token": st["decode_ms_per_token"],
            "wall_s": wall}


def phase_speculative(torch, np, dec, k7, engine_run):
    """(4e) speculation on == off at GPT-small bf16, token for token:
    trunc and int8 drafts on the slotted layout, int8 on the paged
    layout, int8 with an int8 KV cache; launch counts of K7 and of the
    decode kernel against their formulas."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    model = engine_run["model"]
    layers = model.cfg.num_layers
    prompts = engine_run["prompts"][:8]
    params = [dataclasses.replace(p, max_new_tokens=32)
              for p in engine_run["params"][:8]]
    counters = decode_counters(dec)

    def run(name, **knobs):
        eng = LLMEngine(model, **SPEC_KW, **knobs)
        for c in list(counters.values()) + [k7.INT8_LAUNCHES]:
            c.reset()
        t0 = time.perf_counter()
        res = eng.generate(prompts, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        check(st["host_syncs"] == st["decode_dispatches"],
              f"{name}: host syncs {st['host_syncs']} != dispatches")
        return eng, res, st, wall, {k: c.count for k, c in counters.items()}

    # the EOS: request 0's 7th token in a first spec-off run (the runs
    # with the EOS set are identical to it up to that token)
    _, first, _, _, _ = run("off, no EOS")
    params[0] = dataclasses.replace(params[0],
                                    eos_token_id=first[0].token_ids[6])
    out, refs = {}, {}
    for kv in ("bf16", "int8"):
        kvk = {} if kv == "bf16" else dict(kv_dtype="int8")
        _, res, st, wall, _ = run(f"off {kv}", **kvk)
        refs[kv] = [r.token_ids for r in res]
        out[f"off_{kv}"] = {"tokens_per_s": st["tokens_per_sec"],
                            "wall_s": wall}
        log(f"  spec off, KV {kv}: {st['tokens_per_sec']:.1f} tokens/s, "
            f"{st['decode_dispatches']} blocks, {wall:.2f} s")
        if kv == "bf16":
            check(res[0].finish_reason == "stop" and len(res[0].token_ids)
                  <= 7, "request 0 did not stop at its EOS")
    for name, knobs, kv, kernel in (
            ("trunc slotted", dict(draft="trunc"), "bf16", "K1"),
            ("int8 slotted", dict(draft="int8"), "bf16", "K1"),
            ("int8 paged", dict(draft="int8", kv_layout="paged"), "bf16",
             "K4"),
            ("int8 slotted, int8 KV", dict(draft="int8", kv_dtype="int8"),
             "int8", "K5")):
        eng, res, st, wall, counts = run(name, speculate_k=SPEC_K, **knobs)
        streams = [r.token_ids for r in res]
        same = sum(a == b for a, b in zip(streams, refs[kv]))
        check(same == len(prompts), f"spec {name}: {len(prompts) - same} "
                                    f"streams differ from spec off")
        blocks, rounds, dl = (st["decode_dispatches"], eng.spec_rounds,
                              eng.draft_layers)
        k7_want = (4 * dl + 1) * SPEC_K * rounds * blocks             if knobs["draft"] == "int8" else 0
        check(k7.INT8_LAUNCHES.count == k7_want,
              f"spec {name}: K7 launches {k7.INT8_LAUNCHES.count} != "
              f"(4 x {dl} + 1) x {SPEC_K} x {rounds} x {blocks} = {k7_want}")
        dec_want = {k: (SPEC_K * dl + layers) * rounds * blocks
                    if k == kernel else 0 for k in counters}
        check(counts == dec_want, f"spec {name}: decode launches {counts} "
                                  f"!= {dec_want}")
        check(st["spec_proposed"] > 0 and st["spec_blocks"] == blocks,
              f"spec {name}: spec counters {st['spec_proposed']}, "
              f"{st['spec_blocks']}")
        log(f"  spec on, {name} (k {SPEC_K}, draft_layers {dl}, rounds "
            f"{rounds}): 8/8 streams equal spec off; {blocks} blocks; K7 "
            f"launches {k7.INT8_LAUNCHES.count} = (4 x {dl} + 1) x {SPEC_K}"
            f" x {rounds} x {blocks}; {kernel} launches {counts[kernel]} = "
            f"({SPEC_K} x {dl} + {layers}) x {rounds} x {blocks}; "
            f"acceptance {st['spec_acceptance_rate']:.3f}; "
            f"{st['tokens_per_sec']:.1f} tokens/s (off, KV {kv}: "
            f"{out['off_' + kv]['tokens_per_s']:.1f})")
        out[name] = {"k7_launches": k7.INT8_LAUNCHES.count,
                     "decode_launches": counts[kernel], "blocks": blocks,
                     "acceptance": st["spec_acceptance_rate"],
                     "tokens_per_s": st["tokens_per_sec"], "wall_s": wall}
    log(f"  EOS: request 0 stopped after {len(refs['bf16'][0])} tokens "
        f"with KV bf16, spec off and on")
    return out


def phase_paged_vs_slotted(torch, np, P):
    """(d) paged ≡ slotted greedy streams in fp32 (K4 against K1) and in
    int8 over fp32 weights (K6 against K5), token for token; the
    smallest top-2 margin of the fp32 model's logits along the streams
    is logged."""
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    model = P.models.gpt_small(seed=0, device="cuda", dtype="float32")
    prompts = make_prompts(np, 8, 16, 700, model.cfg.vocab_size, seed=2)
    sp = SamplingParams(max_new_tokens=32)
    streams = {name: [r.token_ids for r in LLMEngine(
        model, **SERVE_KW, **knobs).generate(prompts, sp)]
        for name, knobs in DECODE_VARIANTS}
    out = {}
    for paged, slotted in (("K4", "K1"), ("K6", "K5")):
        margin = float("inf")
        for p, toks in zip(prompts, streams[slotted]):
            seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
            lg = model.logits(torch.from_numpy(seq[None]).long().cuda())[0]
            top2 = torch.topk(lg[len(p) - 1:].float(), 2, dim=-1).values
            margin = min(margin, (top2[:, 0] - top2[:, 1]).min().item())
        same = sum(a == b for a, b in zip(streams[paged], streams[slotted]))
        check(same == len(prompts), f"fp32 weights: {paged} != {slotted} "
                                    f"in {len(prompts) - same} streams")
        log(f"  fp32 weights, {paged} vs {slotted}: {same}/{len(prompts)} "
            f"greedy streams equal token for token; smallest top-2 margin "
            f"of the fp32 model along them {margin:.3e}")
        out[f"{paged}_vs_{slotted}_min_margin"] = margin
    del model
    torch.cuda.empty_cache()
    return out


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
    for c in (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES, fa.WGMMA_FWD_LAUNCHES,
              fa.WGMMA_BWD_LAUNCHES):
        c.reset()
    t0 = time.perf_counter()
    _, losses = trainer.train_steps(ids, ids, steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = fa.FWD_LAUNCHES.count, fa.BWD_LAUNCHES.count
    check((fa.WGMMA_FWD_LAUNCHES.count, fa.WGMMA_BWD_LAUNCHES.count)
          == (fwd, bwd), "bf16 training left the wgmma route")
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


TINY_STEPS = 3
FP32_SMALL_STEPS = 3


def route_counts(counters):
    return {r: (f.count, b.count) for r, (f, b) in counters.items()}


def phase_train_fp32(torch, np, P):
    """(6b) fp32 models at `Trainer`'s default amp_level=None, which the
    tf32x3 route carries: gpt_tiny (head dim 32) takes 3 AdamW steps on
    the card and the same 3 steps on the CPU (plain attention), losses
    within 1e-4 relative (fp32 both sides, TF32 off; the sums run in
    other orders); gpt_tiny under O2 takes 3 steps through the wgmma
    route (bf16 at head dim 32), losses finite and falling; then
    GPT-small in fp32 takes 1 warm-up and 3 timed steps at bs 18 x
    1024. Every flash launch of a run on its route (layers x steps each
    way), none on the other."""
    from paddle_tpu_torch.framework import Trainer
    from paddle_tpu_torch.ops_cuda import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = flash_route_counters(fa)
    ids = np.random.RandomState(2).randint(0, 1024, (8, 256))
    none = {fa.WGMMA: (0, 0), fa.TF32X3: (0, 0)}
    losses, counts = {}, {}
    for run, dev, amp in (("cpu", "cpu", None), ("cuda", "cuda", None),
                          ("O2", "cuda", "O2")):
        model = P.models.gpt_tiny(seed=0, device=dev)
        kw = dict(amp_level="O2", amp_dtype="bfloat16") if amp else {}
        tr = Trainer(model, AdamW(learning_rate=1e-3),
                     lambda logits, y, m=model: m.loss(logits, y), **kw)
        t = torch.from_numpy(ids).to(dev)
        for c in (*counters[fa.WGMMA], *counters[fa.TF32X3]):
            c.reset()
        _, ls = tr.train_steps(t, t, steps=TINY_STEPS)
        losses[run] = ls.cpu().tolist()
        counts[run] = route_counts(counters)
    n = 4 * TINY_STEPS                      # gpt_tiny: 4 layers
    check(counts["cuda"] == {**none, fa.TF32X3: (n, n)},
          f"gpt_tiny fp32 launches by route {counts['cuda']}, want tf32x3 "
          f"{n} = 4 layers x {TINY_STEPS} steps")
    check(counts["O2"] == {**none, fa.WGMMA: (n, n)},
          f"gpt_tiny O2 launches by route {counts['O2']}, want wgmma {n}")
    check(counts["cpu"] == none, "the CPU run launched a kernel")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                 losses["cpu"]))
    check(all(math.isfinite(x) for x in losses["cuda"]) and rel <= 1e-4,
          f"gpt_tiny fp32: card losses {losses['cuda']} vs CPU "
          f"{losses['cpu']}: max relative difference {rel:.3e} > 1e-4")
    check(all(math.isfinite(x) for x in losses["O2"])
          and losses["O2"][-1] < losses["O2"][0],
          f"gpt_tiny O2 losses {losses['O2']}")
    log(f"  gpt_tiny fp32, amp_level=None, AdamW(1e-3), bs 8 x 256: card "
        f"losses {[round(x, 6) for x in losses['cuda']]}, CPU "
        f"{[round(x, 6) for x in losses['cpu']]}, max relative difference "
        f"{rel:.2e} (limit 1e-4); tf32x3 launches {n}/{n}, wgmma 0")
    log(f"  gpt_tiny O2 (bf16, head dim 32): losses "
        f"{[round(x, 4) for x in losses['O2']]}; wgmma launches {n}/{n}, "
        f"tf32x3 0")

    model = P.models.gpt_small(seed=0, device="cuda")
    cfg = model.cfg
    check(cfg.num_heads == 12 and cfg.hidden_size == 768,
          f"not GPT-small: {cfg}")
    bs, seq = FLASH_SHAPE["b"], FLASH_SHAPE["s"]
    tr = Trainer(model, AdamW(learning_rate=1e-4),
                 lambda logits, y: model.loss(logits, y))
    big = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (bs, seq))).cuda()
    warm, _ = tr.train_step(big, big)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (*counters[fa.WGMMA], *counters[fa.TF32X3]):
        c.reset()
    t0 = time.perf_counter()
    _, ls = tr.train_steps(big, big, steps=FP32_SMALL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    small_counts = route_counts(counters)
    n = cfg.num_layers * FP32_SMALL_STEPS
    check(small_counts == {**none, fa.TF32X3: (n, n)},
          f"GPT-small fp32 launches by route {small_counts}, want tf32x3 "
          f"{n}")
    small_losses = [float(warm)] + ls.cpu().tolist()
    check(all(math.isfinite(x) for x in small_losses),
          f"GPT-small fp32 losses {small_losses}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = wall / FP32_SMALL_STEPS * 1e3
    tok_s = bs * seq * FP32_SMALL_STEPS / wall
    log(f"  GPT-small fp32, amp_level=None, bs {bs} x {seq}: 1 warm-up, "
        f"then {FP32_SMALL_STEPS} steps at {step_ms:.2f} ms per step, "
        f"{tok_s:.1f} tokens/s, losses "
        f"{[round(x, 4) for x in small_losses]}, peak "
        f"{peak / 2**30:.2f} GiB; tf32x3 launches {n}/{n} = "
        f"{cfg.num_layers} layers x {FP32_SMALL_STEPS} steps, wgmma 0 "
        f"[card: {card_line()}]")
    del tr, model, big
    torch.cuda.empty_cache()
    return {"tiny_losses": losses, "tiny_rel": rel,
            "small_losses": small_losses, "small_step_ms": step_ms,
            "small_tokens_per_s": tok_s, "small_peak_bytes": peak,
            "fwd_launches": n, "bwd_launches": n}


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
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    keep = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None]           # (B,1,1,T)
    qs, ks, vs = q[:, :, None], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)

    ms = time_ms(torch, lambda: dec.ragged_decode_attention(q, kc, vc, lens),
                 flush)
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
    C = dec.cluster_size(T)
    log(f"  K1 at phase-4 shapes (B=S={S}, T={T}, nh={nh}, hd={hd}, bf16, "
        f"{C} CTAs per lane and head in one cluster, {C * nh * S} CTAs; "
        f"lengths {lengths}) [card: {card}]")
    log(f"    wrapper median {ms:.4f} ms (one launch: the kernel and its "
        f"cluster merge)")
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
    return {"ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "lengths": lengths}


def phase_paged_quant_numbers(torch, np, dec, card: str):
    """(e) K4, K5 and K6 at the phase-4 shapes and lengths (bf16 queries;
    K4 over bf16 pages, K5/K6 over int8 codes with f32 scales; pages of
    64 rows at shuffled ids): the wrapper's median (one launch, the
    merge inside it), the plain version (the full-slab reference), the
    library yardstick (gather and/or dequantise, then one
    `scaled_dot_product_attention` with the keep mask; timed only, never
    on the path), and the bound from this run's lengths."""
    from paddle_tpu_torch.quantization.kv import kv_dequant, kv_quantize
    F = torch.nn.functional
    S, T, nh, hd = 8, 1024, 12, 64
    lengths = serving_lengths(np, T)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(S, nh, hd, device="cuda", generator=gen).bfloat16()
    kc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).bfloat16()
    vc = torch.randn(S, T, nh, hd, device="cuda", generator=gen).bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kq, ks = kv_quantize(kc)
    vq, vs = kv_quantize(vc)
    tables, npages, _ = page_tables(torch, gen, S, T, lengths, PAGE)
    kp, vp, kqp, vqp, ksp, vsp = (to_pages(torch, x, tables, npages, PAGE)
                                  for x in (kc, vc, kq, vq, ks, vs))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    keep = (torch.arange(T, device="cuda")[None, :]
            < lens[:, None].long())[:, None, None]           # (B,1,1,T)

    def gather(pool):
        return pool[tables.long()].reshape(S, T, *pool.shape[2:])

    def sdpa(k_, v_):
        return F.scaled_dot_product_attention(
            q[:, :, None], k_.permute(0, 2, 1, 3), v_.permute(0, 2, 1, 3),
            attn_mask=keep)[:, :, 0]

    bf = torch.bfloat16
    cases = {
        "K4": dict(
            run=lambda: dec.paged_ragged_decode_attention(q, kp, vp, tables,
                                                          lens),
            blocks=dec.pick_paged_decode_blocks(T, PAGE, hd, bf),
            plain=lambda: dec.paged_decode_reference(q, kp, vp, tables,
                                                     lens),
            library=lambda: sdpa(gather(kp), gather(vp)),
            library_what="gather pages + scaled_dot_product_attention",
            row_bytes=hd * 2, ops_per_elem=4, tables=True),
        "K5": dict(
            run=lambda: dec.ragged_decode_attention(q, kq, vq, lens,
                                                    k_scale=ks, v_scale=vs),
            blocks=dec.pick_decode_blocks(T, hd, torch.int8),
            plain=lambda: dec.ragged_decode_reference(
                q, kq, vq, lens, k_scale=ks, v_scale=vs),
            library=lambda: sdpa(kv_dequant(kq, ks, bf),
                                 kv_dequant(vq, vs, bf)),
            library_what="dequantise + scaled_dot_product_attention",
            row_bytes=hd + 4, ops_per_elem=6, tables=False),
        "K6": dict(
            run=lambda: dec.paged_ragged_decode_attention(
                q, kqp, vqp, tables, lens, k_scale=ksp, v_scale=vsp),
            blocks=dec.pick_paged_decode_blocks(T, PAGE, hd, torch.int8),
            plain=lambda: dec.paged_decode_reference(
                q, kqp, vqp, tables, lens, k_scale=ksp, v_scale=vsp),
            library=lambda: sdpa(kv_dequant(gather(kqp), gather(ksp), bf),
                                 kv_dequant(gather(vqp), gather(vsp), bf)),
            library_what="gather + dequantise + "
                         "scaled_dot_product_attention",
            row_bytes=hd + 4, ops_per_elem=6, tables=True)}
    live = sum(min(n, T) for n in lengths)
    log(f"  K4/K5/K6 at phase-4 shapes (B=S={S}, T={T}, nh={nh}, hd={hd}, "
        f"bf16 queries, page {PAGE}, lengths {lengths}) [card: {card}]")
    out = {}
    for name, c in cases.items():
        bk, ns = c["blocks"]
        ms = time_ms(torch, c["run"], flush)
        plain_ms = time_ms(torch, c["plain"], flush)
        library_ms = time_ms(torch, c["library"], flush)
        torch.testing.assert_close(c["library"]().float(), c["run"]().float(),
                                   **TOL["bfloat16"])
        # K and V of the live rows (int8: codes + one f32 scale per row
        # and head), q in, output out, lengths, the page tables
        nbytes = (2 * live * nh * c["row_bytes"] + 2 * S * nh * hd * 2
                  + 4 * S + (4 * tables.numel() if c["tables"] else 0))
        flops = c["ops_per_elem"] * live * nh * hd
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        C = dec.cluster_size(T)
        log(f"    {name} (reference picks block_k {bk}, splits {ns}; "
            f"{C} CTAs per lane and head, {C * nh * S} CTAs): "
            f"wrapper median {ms:.4f} ms (one launch); "
            f"bound {bound_ms:.5f} ms ({nbytes} B at 3.35 TB/s; "
            f"{flops} fp32 ops = {ops_ms:.6f} ms); plain {plain_ms:.4f} ms; "
            f"library ({c['library_what']}) {library_ms:.4f} ms")
        out[name] = {"ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations", "bytes": nbytes,
                     "block_k": bk, "num_splits": ns}
    del flush
    torch.cuda.empty_cache()
    return out


def phase_int8_numbers(torch, k7, card: str):
    """K7 at each (k, n) of INT8_SHAPES and INT8_1P3B_SHAPES with 4 bf16
    rows (bf16 weight scales and bias, as the PTQ model holds them): the
    median after an L2 flush, the byte bound (weights, scales, bias and
    x read once, the output written once), the plain version, and two
    yardsticks that the port never calls: the bf16 `torch.matmul` with
    the fp weights (what int8 replaces) and `torch._int_mm` on rows
    padded to 32. Beside them, the timer's floor under the same
    `time_ms`: an empty kernel (also without the flush), a read-only
    stream over the shape's weight bytes, an empty launch in clusters of
    8 with one cluster barrier, and K7's timing variants without its
    quantize prologue, without its cluster merge, without its
    cross-thread reduction (merge included), and without both."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    no_flush = torch.empty(16, dtype=torch.uint8, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m, bf = 4, torch.bfloat16
    empty_ms = time_ms(torch, lambda: k7.timer_empty("cuda"), flush)
    empty_nf_ms = time_ms(torch, lambda: k7.timer_empty("cuda"), no_flush)
    cluster_ms = time_ms(torch, lambda: k7.timer_empty("cuda", 96, 8), flush)
    log(f"  the timer's floor [card: {card}]: an empty kernel reads "
        f"{empty_ms:.4f} ms after the 128 MB flush, {empty_nf_ms:.4f} ms "
        f"without it; 96 empty CTAs in clusters of 8 meeting at one "
        f"cluster barrier {cluster_ms:.4f} ms")
    out = {"floor": {"empty_ms": empty_ms, "empty_no_flush_ms": empty_nf_ms,
                     "empty_cluster8_ms": cluster_ms}}
    log(f"  K7 at 4 bf16 rows, bf16 scales and bias [card: {card}]")
    variants = (("no_prologue", k7.NO_PROLOGUE),
                ("no_merge", k7.NO_MERGE),
                ("no_reduction", k7.NO_REDUCTION),
                ("neither", k7.NO_PROLOGUE | k7.NO_REDUCTION))
    for k, n in INT8_SHAPES + INT8_1P3B_SHAPES:
        x, qw, ws, sx, biases = int8_inputs(torch, gen, m, k, n, bf)
        b = biases["bf16 bias"]
        w = torch.randn(k, n, device="cuda", generator=gen).to(bf)
        q32 = torch.randint(-127, 128, (32, k), generator=gen,
                            device="cuda", dtype=torch.int8)
        ms = time_ms(torch, lambda: k7.int8_linear_fused(x, qw, ws, sx, b),
                     flush)
        plain_ms = time_ms(torch, lambda: k7.int8_linear_plain(
            x, qw, ws, sx, b), flush)
        matmul_ms = time_ms(torch, lambda: torch.matmul(x, w), flush)
        try:
            int_mm_ms = time_ms(torch, lambda: torch._int_mm(q32, qw), flush)
        except RuntimeError as err:        # a yardstick only: log why not
            int_mm_ms = None
            log(f"    torch._int_mm {k}x{n} does not run: {err}")
        read_ms = time_ms(torch, lambda: k7.timer_stream_read(
            qw, sink, 4 * sms), flush)
        parts = {name: time_ms(torch, lambda: k7._launch_cuda(
            x, qw, ws, sx, b, parts=p), flush) for name, p in variants}
        # weights, bf16 scales and bias, the fp32 sx, x in, out out
        nbytes = k * n + 2 * n + 2 * n + 4 + 2 * m * k + 2 * m * n
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * m * k * n / INT8_OPS * 1e3
        log(f"    {k}x{n} {k7.launch_plan(m, k, n, sms)}: median {ms:.4f} "
            f"ms; bound {bound:.5f} ms "
            f"(bytes: {nbytes} B; {2 * m * k * n} int8 ops = "
            f"{ops_ms:.6f} ms); floor: empty {empty_ms:.4f}, stream read "
            f"of the {k * n} weight bytes {read_ms:.4f} ms; variants: "
            + ", ".join(f"{name} {t:.4f}" for name, t in parts.items())
            + f" ms; plain {plain_ms:.4f} ms; bf16 torch.matmul "
            f"{matmul_ms:.4f} ms; torch._int_mm (32 rows) "
            f"{'-' if int_mm_ms is None else f'{int_mm_ms:.4f}'} ms")
        out[f"{k}x{n}"] = {"ms": ms, "plain_ms": plain_ms,
                           "bound_ms": max(bound, ops_ms), "bytes": nbytes,
                           "stream_read_ms": read_ms,
                           **{f"{name}_ms": t for name, t in parts.items()},
                           "bf16_matmul_ms": matmul_ms,
                           "int_mm_ms": int_mm_ms}
    del flush
    torch.cuda.empty_cache()
    return out


def flash_bound(b, sq, sk, h, d, causal, n_products, n_q, n_k,
                itemsize=2, peak=BF16_FLOPS):
    """(bound ms, "bytes" | "operations", bytes, flops) of a flash call:
    `n_q` (b, sq, h, d) and `n_k` (b, sk, h, d) tensors of `itemsize`
    bytes each read or written once, plus the fp32 (b, h, sq)
    logsumexp, over 3.35 TB/s; 2 d flops per product per visible
    (query, key) pair (under the causal rule only the pairs this shape
    keeps: q + sk - sq >= j), over the peak of the inputs' type (bf16
    tensor cores; fp32 67 TFLOP/s, or TF32's 495 with three products
    per product)."""
    if causal:
        off = sk - sq
        pairs = sum(min(q + off + 1, sk) for q in range(sq))
    else:
        pairs = sq * sk
    flops = n_products * 2 * d * pairs * b * h
    nbytes = itemsize * b * h * d * (n_q * sq + n_k * sk) + 4 * b * h * sq
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes, flops


def phase_flash_numbers(torch, fa, card: str, built):
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
    # K3's three kernels one at a time (dk/dv and dq read the rows the
    # delta kernel wrote)
    rows = fa._bwd_rows(b, h, s_, "cuda")
    parts = {name: time_ms(torch, lambda: fa._launch_bwd(
        q, k, v, out, lse, g, True, scale, parts=part, rows=rows), flush,
        reps=20) for name, part in (("delta", fa.BWD_DELTA),
                                    ("dk/dv", fa.BWD_DKDV),
                                    ("dq", fa.BWD_DQ))}
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
    log("    K3 parts, each kernel alone: " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in parts.items()))
    info = {f"{tname} d {dd}": fa.kernel_info(dd, getattr(torch, tname))
            for tname in ("bfloat16", "float32") for dd in (32, 64, 128)}
    for dd, kernels in info.items():
        log(f"    {dd}: " + "; ".join(
            f"{name} {regs} registers, {local} local (spill) bytes, "
            f"{smem} B dynamic shared memory, {threads} threads"
            for name, (regs, local, smem, threads) in kernels.items()))
    log("    nvcc: " + (", ".join(
        f"{name} {sec:.1f} s" for name, sec in sorted(built.items())
        if name.startswith("flash")) or "cached, not built in this run"))
    del q, k, v, g, out, lse, qt, kt, vt, lib_out, flush, rows
    torch.cuda.empty_cache()
    return {"fwd": {"ms": fwd_ms, "plain_ms": fwd_plain,
                    "library_ms": fwd_lib, "bound_ms": fwd_bound[0],
                    "bound_by": fwd_bound[1]},
            "bwd": {"ms": bwd_ms, "plain_ms": bwd_plain,
                    "library_ms": bwd_lib, "bound_ms": bwd_bound[0],
                    "bound_by": bwd_bound[1]},
            "bwd_parts_ms": parts,
            "kernel_info": {dd: {n: list(v) for n, v in kernels.items()}
                            for dd, kernels in info.items()},
            "nvcc_s": {n: t for n, t in built.items()
                       if n.startswith("flash")}}


# the other timed rows: the tf32x3 route at GPT-small's fp32 training
# shape (phase 6b) and the wgmma route at phase 3's bf16 head dim 32 case
ROUTE_TIMING = (("fp32 d 64, GPT-small training shape", FLASH_SHAPE["b"],
                 FLASH_SHAPE["s"], FLASH_SHAPE["h"], 64, "float32"),
                ("bf16 d 32", 4, 512, 24, 32, "bfloat16"))


def phase_flash_route_numbers(torch, fa, card: str):
    """K2/K3 at ROUTE_TIMING's shapes (causal, packed qkv), first held
    against their plain versions there (`hold_flash`), then forward and
    backward medians after an L2 flush (fp32: the split kernel's share
    timed alone too) beside their bounds (fp32: three TF32 products per
    product over 495 TFLOP/s, and the FFMA bound over 67 TFLOP/s; bf16
    over the tensor cores' peak), the plain versions and
    `scaled_dot_product_attention` (a yardstick only, with TF32 off)."""
    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(9)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, b, s_, h, d, tname in ROUTE_TIMING:
        dtype = getattr(torch, tname)
        fp32 = dtype == torch.float32
        q, k, v, g = flash_inputs(torch, gen, b, s_, s_, h, d, True, dtype)
        scale = 1 / math.sqrt(d)
        route = fa._check_cuda_args(q, k, v, True)
        check(route == (fa.TF32X3 if fp32 else fa.WGMMA),
              f"{name}: route {route}")
        o, lse = fa._launch_fwd(q, k, v, True, scale)
        held = hold_flash(torch, fa, name, q, k, v, g, True, scale, o, lse,
                          fa._launch_bwd(q, k, v, o, lse, g, True, scale))
        fwd_ms = time_ms(torch, lambda: fa._launch_fwd(q, k, v, True, scale),
                         flush, reps=10)
        bwd_ms = time_ms(torch, lambda: fa._launch_bwd(q, k, v, o, lse, g,
                                                       True, scale),
                         flush, reps=10)
        split, parts = {}, {}
        if fp32:    # the split kernel alone, and each backward kernel
            from paddle_tpu_torch.ops_cuda._build import load_library
            lib = load_library("flash_attention_fwd", fa._FWD_SIGNATURES)
            sc = fa._scratch(lib, "fwd", q, k)
            split["forward"] = time_ms(torch, lambda: fa._launch_fwd(
                q, k, v, True, scale, parts=fa.FWD_SPLIT, scratch=sc),
                flush, reps=10)
            lib = load_library("flash_attention_bwd", fa._BWD_SIGNATURES)
            sc = fa._scratch(lib, "bwd", q, k)
            rows = fa._bwd_rows(b, h, s_, "cuda")
            fa._launch_bwd(q, k, v, o, lse, g, True, scale, rows=rows,
                           scratch=sc)
            for pname, bit in (("split", fa.BWD_SPLIT),
                               ("delta", fa.BWD_DELTA),
                               ("dk/dv", fa.BWD_DKDV), ("dq", fa.BWD_DQ)):
                parts[pname] = time_ms(torch, lambda: fa._launch_bwd(
                    q, k, v, o, lse, g, True, scale, parts=bit, rows=rows,
                    scratch=sc), flush, reps=10)
            split["backward"] = parts["split"]
            del sc, rows
        fwd_plain = time_ms(torch, lambda: fa.flash_forward_plain(
            q, k, v, True, scale), flush, reps=3)
        bwd_plain = time_ms(torch, lambda: fa.flash_backward_plain(
            q, k, v, o, lse, g, True, scale), flush, reps=3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush, reps=10)
        bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), g.transpose(1, 2), retain_graph=True),
            flush, reps=10)
        isz = 4 if fp32 else 2
        log(f"  {route} route, {name} (b {b}, s {s_}, h {h}, d {d}, causal, "
            f"packed qkv) [card: {card}]: against the plain versions, out "
            f"max err {held['out_rel']:.2e} of max|plain|, dq/dk/dv "
            + "/".join(f"{r:.2e}" for r in held["grad_rel"])
            + f" (limit {held['limit']:g})")
        rec = {"held": held}
        for part, ms, plain, lib, n_prod, n_io in (
                ("forward", fwd_ms, fwd_plain, fwd_lib, 2, 2),
                ("backward", bwd_ms, bwd_plain, bwd_lib, 5, 4)):
            if fp32:
                bound, by, nbytes, flops = flash_bound(
                    b, s_, s_, h, d, True, 3 * n_prod, n_io, n_io, isz,
                    TF32_FLOPS)
                ffma = flash_bound(b, s_, s_, h, d, True, n_prod, n_io, n_io,
                                   isz, FP32_FLOPS)[0]
                extra = (f"; FFMA bound {ffma:.4f} ms; split kernel alone "
                         f"{split[part]:.4f} ms ({split[part] / ms:.1%})")
            else:
                bound, by, nbytes, flops = flash_bound(
                    b, s_, s_, h, d, True, n_prod, n_io, n_io, isz,
                    BF16_FLOPS)
                ffma, extra = None, ""
            log(f"    {part}: median {ms:.4f} ms; bound {bound:.4f} ms "
                f"({by}: {nbytes} B, {flops / 1e9:.2f} GFLOP){extra}; plain "
                f"{plain:.3f} ms; scaled_dot_product_attention "
                f"{lib:.4f} ms")
            rec[part] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                         "bound_ms": bound, "bound_by": by,
                         "ffma_bound_ms": ffma, "split_ms": split.get(part)}
        if parts:
            log("    backward parts, each alone: " + ", ".join(
                f"{pname} {ms:.4f} ms" for pname, ms in parts.items()))
            rec["backward_parts_ms"] = parts
        out[name] = rec
        del q, k, v, g, o, lse, qt, kt, vt, lib_out
        torch.cuda.empty_cache()
    del flush
    return out


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
    from paddle_tpu_torch.ops_cuda import int8_linear as k7

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
    log("phase 2a: K4, K5 and K6 against their plain versions")
    pq_err = phase_paged_quant_kernels(torch, np, dec)
    log("phase 2b: K7 against its plain version, bitwise")
    k7_err = phase_int8_kernel(torch, k7)
    log("phase 3: K2 and K3 against their plain versions")
    flash_err = phase_flash_kernels(torch, fa)
    log("phase 3b: the tensor cores' TF32 arithmetic")
    probe = phase_tf32_probe(torch, fa)
    log("phase 4: GPT-small served at full width through K1")
    engine_run = phase_engine(torch, np, P)
    log("phase 4b: the same load through K4 (paged), K5 (int8), K6 "
        "(paged int8)")
    variants = phase_engine_variants(torch, np, dec, engine_run)
    log("phase 4c: paged int8 starved of pages (kv_pages = 49)")
    pressure = phase_page_pressure(torch, dec, engine_run,
                                   variants["K6"]["streams"])
    log("phase 4d: an int8-PTQ GPT-small served through K7")
    int8_run = phase_int8_serving(torch, np, P, dec, k7, engine_run)
    log("phase 4e: speculation on == off, GPT-small bf16")
    spec = phase_speculative(torch, np, dec, k7, engine_run)
    del engine_run["model"], variants["K1"]
    torch.cuda.empty_cache()
    log("phase 5: ragged vs masked attention, fp32")
    rvm = phase_ragged_vs_masked(torch, np, P)
    log("phase 5d: paged vs slotted greedy streams, fp32 weights")
    pvs = phase_paged_vs_slotted(torch, np, P)
    log("phase 6: GPT-small trained at full width through K2 and K3")
    train = phase_train(torch, np, P, profile=args.profile)
    log("phase 6b: fp32 training at amp_level=None through the tf32x3 "
        "route (gpt_tiny against the CPU, GPT-small timed), gpt_tiny O2 "
        "through the wgmma route")
    train32 = phase_train_fp32(torch, np, P)
    log("phase 7: gradients through the kernels vs the plain versions")
    grad = phase_grad_check(torch, np, P)
    log("phase 8: numbers")
    nums = phase_numbers(torch, dec, engine_run, card)
    pqnums = phase_paged_quant_numbers(torch, np, dec, card)
    for name, run in variants.items():
        log(f"  engine through {name}, phase 4b [card: {card}]: "
            f"{run['tokens_per_s']:.1f} tokens/s, decode "
            f"{run['decode_ms_per_token']:.3f} ms/token (per decode step), "
            f"TTFT p50 {run['ttft_p50_s'] * 1e3:.1f} ms, kv_bytes_per_token"
            f" {run['kv_bytes_per_token']:.0f}")
    fnums = phase_flash_numbers(torch, fa, card, built)
    rnums = phase_flash_route_numbers(torch, fa, card)
    k7nums = phase_int8_numbers(torch, k7, card)
    log(f"  engine, int8-PTQ GPT-small through K7, phase 4d [card: {card}]: "
        f"{int8_run['tokens_per_s']:.1f} tokens/s, decode "
        f"{int8_run['decode_ms_per_token']:.3f} ms/token (per decode step)")
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
        "max_abs_err": flash_err["fwd"], **fnums.pop("fwd")}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/flash_attention_bwd.cu",
        "replaces": f"{flash}:205", "launches": train["bwd_launches"],
        "max_abs_err": flash_err["bwd"], **fnums.pop("bwd")}]
    # the tf32x3 route: the same sources, fp32 at GPT-small's training
    # shape (phase 6b's launches); bound: three TF32 products per product
    tf32_main = rnums[ROUTE_TIMING[0][0]]
    for part, line, key in (("fwd", 90, "forward"), ("bwd", 205,
                                                     "backward")):
        kernels.append({
            "name": f"flash_attention_tf32x3_{part}", "route": "cuda",
            "source": f"paddle_tpu_torch/ops_cuda/csrc/flash_attention_"
                      f"{part}.cu",
            "replaces": f"{flash}:{line}",
            "launches": train32[f"{part}_launches"],
            "max_abs_err": flash_err[f"tf32x3_{part}"],
            **{k: tf32_main[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}})
    dpy = "paddle_tpu/ops_pallas/decode_attention.py"
    for name, line, what in (("K4", 258, "paged_decode"),
                             ("K5", 242, "ragged_decode_int8"),
                             ("K6", 279, "paged_decode_int8")):
        kernels.append({
            "name": what, "route": "cuda",
            "source": "paddle_tpu_torch/ops_cuda/csrc/decode_attention.cu",
            "replaces": f"{dpy}:{line}",
            "launches": variants[name]["launches"],
            "max_abs_err": pq_err[name],
            **{k: pqnums[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}})
    # K7's record: one GPT-small block's four linears at 4 bf16 rows
    # (the decode step's K7 work per layer); each shape is in --out. No
    # one PyTorch call computes the fused function (the bf16 matmul and
    # torch._int_mm yardsticks are logged beside it), so library_ms is
    # null
    block = [k7nums[f"{k}x{n}"] for k, n in INT8_SHAPES[:4]]
    kernels.append({
        "name": "int8_linear_fused", "route": "cuda",
        "source": "paddle_tpu_torch/ops_cuda/csrc/int8_linear.cu",
        "replaces": "paddle_tpu/quantization/__init__.py:92",
        "launches": int8_run["launches"], "max_abs_err": k7_err,
        "ms": sum(r["ms"] for r in block),
        "plain_ms": sum(r["plain_ms"] for r in block),
        "bound_ms": sum(r["bound_ms"] for r in block), "bound_by": "bytes",
        "library_ms": None})
    if args.out:
        def drop(run):
            return {k: v for k, v in run.items()
                    if k not in ("prompts", "params", "streams")}
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels,
                       "timing_lengths": nums["lengths"],
                       "engine": drop(engine_run),
                       "engine_variants": {k: drop(v)
                                           for k, v in variants.items()},
                       "page_pressure": pressure,
                       "paged_quant_numbers": pqnums,
                       "ragged_vs_masked": rvm, "paged_vs_slotted": pvs,
                       "train": train, "grad_check": grad,
                       "int8_serving": int8_run, "speculative": spec,
                       "int8_numbers": k7nums, "flash_numbers": fnums,
                       "flash_route_numbers": rnums, "tf32_probe": probe,
                       "train_fp32": train32,
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
