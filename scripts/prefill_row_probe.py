#!/usr/bin/env python3
"""Does a prompt row's prefill depend on the bucket or chunk it was
computed in? A probe of the serving engine's prefill row floor, on one
NVIDIA H100.

Chunked prefill, interleaved admission and prefix-cache hits are exact
only if a prompt row's K/V and logits do not depend on how many rows
share its calls. This script measures, at GPT-small widths in bf16:

1. ops: GPT-small's prefill GEMMs (768 x 2304 / 768 / 3072, 3072 x
   768), the prefill LayerNorm `_ln`, the tanh GELU, the softmax over
   1024 keys and attention's two products (12 heads, head dim 64,
   1024 keys): the same input rows computed in calls of R rows, for R
   from 16 to 1024 (powers of two and 192, 384, 640, 768), against one
   call of 1024 rows; per R the rows that differ are counted;
2. prefills: the 16 prompts of `chip_smoke.py`'s phase 4g (a seeded
   512-token shared prompt + a 16-188-token tail each) ingested by the
   engine monolithically (prefix cache off), through the prefix cache
   (slotted, hits after the first), in 64-token chunks, and both, under
   four prefill designs: no floor (`PREFILL_MIN_ROWS` 1), the engine's
   floor (every call at least 128 rows), and a fixed row grid of G = 64
   or 128 rows (every row-wise op and attention's two products on calls
   of exactly G rows, the last padded; implemented here, not in the
   engine, on the engine's signature): per design, the requests whose
   K/V rows (every layer) or first-token logits are not bitwise the
   monolithic ones;
3. cost: per design, the median time of one prefill of 700 tokens (a
   1024-row bucket), of one 64-token chunk and of one 16-token piece
   (each a replay of the engine's prefill program of its row count,
   captured by a first call before the timing),
   and phase 4's load (16 requests, prompts 16-700 tokens, 64 new
   tokens, prefix cache off) served, with its TTFT p50 / p99 and
   tokens/s.

With `--tp 2 4` the probe runs at the per-rank shapes of TP-sharded
serving instead (`LLMEngine(tp=k)`, every rank on the one card): part 1
over each rank's GEMMs (qkv and fc1 with 1/k of the columns, out and
fc2 with 1/k of the rows) and attention's products over 12/k heads, and
part 2 through engines of each degree under the designs "no floor"
and "floor 128" (the grid designs are an unsharded forward); part 3 is
skipped.

    python3 scripts/prefill_row_probe.py [--tp 2 4] [--out result.json]

Needs one card; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GEMMS = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
ROWS = (16, 32, 64, 128, 192, 256, 384, 512, 640, 768, 1024)
DESIGNS = ("no floor", "floor 128", "grid 64", "grid 128")


def probe_ops(tp: int = 1):
    """{op: {R: rows differing from one 1024-row call}}: calls of R rows
    over the first R * (1024 // R) rows; at `tp` > 1 one rank's GEMMs
    and attention over its 12 / tp heads."""
    from paddle_tpu_torch.models import gpt as G
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g)
                * scale).to(dt)

    ops = {}
    gemms = GEMMS if tp == 1 else ((768, 2304 // tp), (768 // tp, 768),
                                   (768, 3072 // tp), (3072 // tp, 768))
    nh = 12 // tp
    for k, n in gemms:
        w, x = rnd(k, n, scale=0.02), rnd(1024, 1, k)
        ops[f"matmul {k}x{n}"] = (lambda t, w=w: torch.matmul(t, w), x)
    lw, lb = rnd(768), rnd(768)
    ops["_ln 768"] = (lambda t: G._ln(t, lw, lb, 1e-5), rnd(1024, 1, 768))
    ops["gelu 3072"] = (lambda t: torch.nn.functional.gelu(
        t, approximate="tanh"), rnd(1024, 1, 3072))
    ops["softmax 1024 fp32"] = (lambda t: torch.softmax(t, dim=-1),
                                rnd(1024, 12, 1024).float())
    kc, vc = rnd(1, 1024, nh, 64), rnd(1, 1024, nh, 64)
    ops[f"scores q.k {nh}x64x1024"] = (
        lambda t: torch.einsum("bqnd,bknd->bnqk", t.transpose(0, 1).float(),
                               kc.float())[0].transpose(0, 1),
        rnd(1024, 1, nh, 64))
    wts = torch.softmax(torch.randn(1024, 1, nh, 1024, device="cuda",
                                    generator=g), -1).to(dt)
    ops[f"weights.v {nh}x1024x64"] = (
        lambda t: torch.einsum("bnqk,bknd->bqnd", t.permute(1, 2, 0, 3),
                               vc).transpose(0, 1),
        wts)
    out = {}
    for name, (fn, x) in ops.items():
        ref = fn(x)
        row = {}
        for R in ROWS:
            m = R * (1024 // R)
            got = torch.cat([fn(c) for c in x[:m].split(R)])
            row[R] = int((got != ref[:m]).reshape(m, -1).any(1).sum())
        out[name] = row
    torch.cuda.synchronize()
    return out


def grid_prefill_forward(G):
    """The engine's `_prefill_forward` with a fixed row grid of G rows:
    the rows ride dim 0, every row-wise op runs on calls of exactly G
    rows and attention on G queries at a time, the last call padded
    with zero rows."""
    from paddle_tpu_torch.models import gpt as M
    from paddle_tpu_torch.quantization.kv import kv_update
    from paddle_tpu_torch.serving import engine as E

    def by_rows(fn, x):
        n, pad = x.shape[0], -x.shape[0] % G
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return torch.cat([fn(c) for c in x.split(G)])[:n]

    def forward(cfg, params, k_list, v_list, ids, slot, pos0, length,
                table=None, page_size=0):
        # the engine's signature: slot, pos0, length (1,) device values
        # in the prefill program's static buffer, writes and the lane
        # view through the engine's own `_prefill_rows`
        assert table is None, "the grid probe runs the slotted layout"
        L = ids.shape[1]
        dev = ids.device
        q_pos = pos0 + torch.arange(L, device=dev)
        T, rows, lane_view = E._prefill_rows(k_list[0], slot, q_pos)
        key_pos = torch.arange(T, device=dev)
        x = E._embed(params, ids.t(), q_pos[:, None])         # (L, 1, h)
        eps = cfg.layer_norm_eps
        for i in range(cfg.num_layers):
            p = M._block_params(params, i)
            qkv = by_rows(lambda t: M._apply_linear(
                p, "attn.qkv", M._ln(t, p["ln1.weight"], p["ln1.bias"],
                                     eps)), x).reshape(
                L, 1, 3, cfg.num_heads, cfg.head_dim)
            q, kn, vn = qkv[:, 0, 0], qkv[:, 0, 1], qkv[:, 0, 2]
            kv_update(k_list[i], rows, kn)
            kv_update(v_list[i], rows, vn)
            kc, vc = lane_view(k_list[i], q.dtype), lane_view(v_list[i],
                                                               q.dtype)
            outs = []
            for r0 in range(0, L, G):
                qc = q[r0:r0 + G]
                n = qc.shape[0]
                if n < G:
                    qc = torch.cat([qc, qc.new_zeros((G - n,)
                                                     + qc.shape[1:])])
                keep = key_pos[None, :] <= (
                    q_pos[r0:r0 + 1] + torch.arange(G, device=dev))[:, None]
                outs.append(M._masked_attend(qc[None], kc, vc,
                                             keep[None, None])[0, :n])
            a = torch.cat(outs).reshape(L, 1, -1)
            x = x + by_rows(lambda t: M._apply_linear(p, "attn.out", t), a)
            x = x + by_rows(lambda t: M._apply_linear(
                p, "mlp.fc2", torch.nn.functional.gelu(M._apply_linear(
                    p, "mlp.fc1", M._ln(t, p["ln2.weight"], p["ln2.bias"],
                                        eps)), approximate="tanh")), x)
        x = by_rows(lambda t: M._ln(t, params["ln_f.weight"],
                                    params["ln_f.bias"], eps), x)
        return M._head(params, x.index_select(0, length - 1))[0, 0].float()

    return forward


@contextlib.contextmanager
def design(name):
    """The engine with one prefill design in place, for the engines made
    inside the block (an engine builds each prefill program at its first
    use, from the design in place then)."""
    from paddle_tpu_torch.serving import engine as E
    saved = (E.PREFILL_MIN_ROWS, E._prefill_forward)
    try:
        if name == "no floor":
            E.PREFILL_MIN_ROWS = 1
        elif name.startswith("grid"):
            E.PREFILL_MIN_ROWS = 1
            E._prefill_forward = grid_prefill_forward(int(name.split()[1]))
        yield
    finally:
        E.PREFILL_MIN_ROWS, E._prefill_forward = saved


def load_4g(vocab):
    """Phase 4g's prompts (the same function `chip_smoke.py` uses)."""
    import chip_smoke as C
    from paddle_tpu_torch.serving import SamplingParams
    return C.shared_prefix_load(np, SamplingParams, vocab)[0]


def ingest_all(E, eng, prompts):
    """Prefill every prompt through the engine's admission path (cache
    hit, suffix prefill, insert) one at a time; returns per request the
    K/V rows of every layer (a TP engine's ranks' heads joined) and the
    first-token logits, on the host."""
    from paddle_tpu_torch.quantization.kv import slab_parts
    out = []
    for i, p in enumerate(prompts):
        req = E._Request(i, p, E.SamplingParams(max_new_tokens=1), 0.0)
        slot = eng.cache.allocate()
        logits = eng._ingest_tokens(slot, req, p, need_logits=True)
        rows = [torch.cat([t[slot, :p.size] for t in slab_parts(slab)],
                          dim=-2).float().cpu()
                for slab in eng.cache.k + eng.cache.v]
        out.append((rows, logits.float().cpu()))
        eng._release_prefix(req)
        eng.cache.release(slot)
    return out


CONFIGS = (("prefix cache", {}),
           ("64-token chunks", dict(prefix_cache=False, prefill_chunk=64)),
           ("prefix cache + 64-token chunks", dict(prefill_chunk=64)))


def probe_prefills(model, prompts, tp: int = 1, designs=DESIGNS):
    """{design: {config: requests not bitwise monolithic}}, through
    engines of TP degree `tp`."""
    from paddle_tpu_torch.serving import engine as E
    kw = dict(max_slots=8, max_seq=1024, seed=0, device="cuda", tp=tp)
    result = {}
    for name in designs:
        with design(name):
            ref = ingest_all(E, E.LLMEngine(model, prefix_cache=False, **kw),
                             prompts)
            row = {}
            for cname, knobs in CONFIGS:
                got = ingest_all(E, E.LLMEngine(model, **kw, **knobs),
                                 prompts)
                row[cname] = sum(
                    not (all(torch.equal(a, b) for a, b in zip(ra, rb))
                         and torch.equal(la, lb))
                    for (ra, la), (rb, lb) in zip(ref, got))
        result[name] = row
    return result


def median_ms(fn, reps=7):
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def probe_cost(model):
    """{design: {what: ms, s or tokens/s}}."""
    import chip_smoke as C
    from paddle_tpu_torch.serving import engine as E
    rng = np.random.RandomState(0)
    toks = rng.randint(0, model.cfg.vocab_size, 700).astype(np.int32)
    prompts, params = C.serving_load(np, E.SamplingParams,
                                     model.cfg.vocab_size)
    out = {}
    for name in DESIGNS:
        with design(name):
            eng = E.LLMEngine(model, max_slots=8, max_seq=1024, seed=0,
                              device="cuda", prefix_cache=False)
            slot = eng.cache.allocate()
            # each program's first call builds (on the card: captures) it
            for n in (700, 64, 16):
                eng._prefill_tokens(slot, toks[:n], 0)
            row = {"prefill 700 tokens (1024-row bucket) ms": median_ms(
                lambda: eng._prefill_tokens(slot, toks, 0)),
                "prefill 64-token chunk ms": median_ms(
                lambda: eng._prefill_tokens(slot, toks[:64], 512)),
                "prefill 16-token piece ms": median_ms(
                lambda: eng._prefill_tokens(slot, toks[:16], 512))}
            kw = dict(max_slots=8, max_seq=1024, seed=0, device="cuda",
                      prefix_cache=False)
            E.LLMEngine(model, **kw).generate(
                prompts[:2], E.SamplingParams(max_new_tokens=8))
            srv = E.LLMEngine(model, **kw)
            srv.generate(prompts, params)
            st = srv.stats()
            row["phase 4 ttft p50 s"] = st["ttft_p50_s"]
            row["phase 4 ttft p99 s"] = st["ttft_p99_s"]
            row["phase 4 tokens/s"] = st["tokens_per_sec"]
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    ap.add_argument("--tp", type=int, nargs="*", default=[],
                    help="probe these TP degrees' per-rank shapes instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prefill_row_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    import paddle_tpu_torch as P
    card = C.card_line()
    print(f"[{card}; torch {torch.__version__}, CUDA {torch.version.cuda}]")
    if args.tp:
        return probe_tp(args, card)
    ops = probe_ops()
    print("ops: rows that differ from one 1024-row call, by the rows R "
          "per call")
    for name, row in ops.items():
        print(f"  {name:24s} " + " ".join(f"R{r}:{n}" for r, n in
                                           row.items()))
    with torch.no_grad():
        model = P.models.gpt_small(seed=0, device="cuda", dtype="bf16")
        prefills = probe_prefills(model, load_4g(model.cfg.vocab_size))
        print("prefills: requests (of 16) not bitwise the monolithic "
              "prefill, by design")
        for name, row in prefills.items():
            print(f"  {name}: {row}")
        cost = probe_cost(model)
    print(f"cost by design [{card}]:")
    for name, row in cost.items():
        print(f"  {name}: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in row.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "ops": ops, "prefills": prefills,
                       "cost": cost}, f, indent=1)
    return 0


def probe_tp(args, card: str) -> int:
    """Parts 1 and 2 at the per-rank shapes of each degree in
    `args.tp`."""
    import paddle_tpu_torch as P
    result = {"card": card}
    with torch.no_grad():
        model = P.models.gpt_small(seed=0, device="cuda", dtype="bf16")
        prompts = load_4g(model.cfg.vocab_size)
        for tp in args.tp:
            ops = probe_ops(tp)
            print(f"tp={tp} ops (one rank's shapes): rows that differ from "
                  f"one 1024-row call, by the rows R per call")
            for name, row in ops.items():
                print(f"  {name:24s} " + " ".join(f"R{r}:{n}" for r, n in
                                                   row.items()))
            prefills = probe_prefills(model, prompts, tp=tp,
                                      designs=DESIGNS[:2])
            print(f"tp={tp} prefills: requests (of 16) not bitwise the "
                  f"monolithic prefill of the same degree, by design")
            for name, row in prefills.items():
                print(f"  {name}: {row}")
            result[f"tp{tp}"] = {"ops": ops, "prefills": prefills}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
