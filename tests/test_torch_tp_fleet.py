"""TP groups as fleet replicas, and the group-agnostic payload, in the
port (`paddle_tpu_torch/serving/fleet.py`, `sharded_kv.py`,
`paged_kv.py`), after tests/test_tp_serving.py's `TestFleetTPGroup`, on
gpt_tiny on the CPU.

- `EngineFleet(tp=2)`: replica i is the TP group of logical ranks
  [2i, 2i + 2); a kill takes out a whole group, and its requests drain
  onto the surviving group with 0 stranded and every stream equal to an
  undisturbed tp=2 engine's (bitwise: same degree) and to tp=1's
  (greedy, reference top-2 margins > 1e-3); a scale-out adds a group; a
  fleet snapshot resumes on groups.
- A page payload never shows the group: a tp=2 pool gathers the very
  bytes a tp=1 pool gathers for the same rows (fp32 and int8), takes a
  tp=1 payload back, and a tp=2 engine's extract / KV-tier chunks
  continue on a tp=1 engine and the other way round; host swap at tp=2
  is bitwise.
- `python -m paddle_tpu_torch.serving.server --tp 2` passes the soak's
  gates on the CPU (slotted).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.serving import (EngineFleet, KVTier, LLMEngine,
                                      SamplingParams, make_kv_manager,
                                      make_tp_mesh)
from port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(max_slots=2, max_seq=64, seed=7, register_stats=False,
           device="cpu")
PAGED = dict(kv_layout="paged", page_size=16)


@pytest.fixture(scope="module")
def model():
    return gpt_tiny(seed=0, device="cpu")


def _prompts(lengths, seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _streams(results):
    return [list(r.token_ids) for r in results]


def _fleet(model, **kw):
    return EngineFleet(model, replicas=2, tp=2, quarantine_backoff_s=0.0,
                       **{**CFG, **kw})


def _margins(model, prompts, streams):
    out = []
    for p, s in zip(prompts, streams):
        ids = torch.from_numpy(np.concatenate([p, s[:-1]]).astype(
            np.int64))[None]
        top = torch.topk(model.logits(ids)[0, len(p) - 1:].float(), 2).values
        out.append(float((top[:, 0] - top[:, 1]).min()))
    return out


def test_replicas_are_disjoint_tp_groups(model):
    fleet = _fleet(model)
    try:
        groups = [r.engine.mesh.ranks for r in fleet._replicas]
        assert groups == [(0, 1), (2, 3)]
        assert all(r.engine.tp == 2 and r.engine.mesh.device.type == "cpu"
                   for r in fleet._replicas)
        fps = [r.engine._mesh_fp for r in fleet._replicas]
        assert fps == [(2, 0, 1), (2, 2, 3)]
        # a scale-out adds the next group, never a lone rank
        idx = fleet.add_replica()
        assert fleet._by_idx(idx).engine.mesh.ranks == (4, 5)
    finally:
        fleet.close()


@pytest.mark.parametrize("layout", [{}, PAGED], ids=["slotted", "paged"])
def test_tp_fleet_kill_failover_bit_identical(model, layout):
    prompts = _prompts([5, 12, 9, 7, 4, 10])
    sp = SamplingParams(max_new_tokens=8)
    want = _streams(LLMEngine(model, tp=2, **CFG, **layout).generate(
        prompts, sp))
    assert want == _streams(LLMEngine(model, **CFG, **layout).generate(
        prompts, sp))
    assert min(_margins(model, prompts, want)) > 1e-3
    fleet = _fleet(model, snapshot_every=1, **layout)
    try:
        rids = [fleet.submit(p, sp) for p in prompts]
        for _ in range(2):
            fleet.step()
        victim = fleet.busiest()
        fleet.kill(victim)
        fleet.revive(victim)
        fleet.run_until_complete(max_steps=500)
        assert [list(fleet.result(r).token_ids) for r in rids] == want
        st = fleet.stats()
        assert st["kills"] == 1 and st["failovers"] == 1
        for r in fleet._replicas:
            assert r.engine.tp == 2
            assert r.engine.watchdog.compiles_unexpected == 0
        snap = fleet.snapshot()
        again = EngineFleet.resume(model, snap)
        assert [r.engine.mesh.ranks for r in again._replicas] == \
            [(0, 1), (2, 3)]
        again.close()
    finally:
        fleet.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tp2_payload_equals_tp1_payload(kv_dtype):
    """Same rows, same payload bytes: the tp=2 pool joins its ranks'
    heads into the tp=1 layout, and splits a tp=1 payload back."""
    kw = dict(num_layers=2, max_slots=2, max_seq=64, num_heads=4,
              head_dim=8, device="cpu", page_size=16, kv_dtype=kv_dtype)
    one = make_kv_manager("paged", **kw)
    two = make_kv_manager("paged", make_tp_mesh(2), **kw)
    gen = torch.Generator().manual_seed(0)
    for slab in one.k + one.v:
        for t in ([slab["q"], slab["s"]] if kv_dtype else [slab]):
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
            else:
                t.copy_(torch.rand(t.shape, generator=gen))
    pages = [3, 1, 5]
    k1, v1 = one.gather_pages(pages)
    two.scatter_pages(pages, k1, v1)
    k2, v2 = two.gather_pages(pages)

    def raw(rows):
        leaves = [rows["q"], rows["s"]] if kv_dtype else [rows]
        return b"".join(t.contiguous().numpy().tobytes() for t in leaves)
    for a, b in zip(k1 + v1, k2 + v2):
        assert raw(a) == raw(b)
        if kv_dtype:
            assert a["q"].shape == b["q"].shape == (3, 16, 4, 8)
        else:
            assert a.shape == b.shape == (3, 16, 4, 8)
    # the rank slabs hold the payload's heads, rank by rank
    part = two.k[1][1]
    want = k1[1]["q"][:, :, 2:] if kv_dtype else k1[1][:, :, 2:]
    got = (part["q"] if kv_dtype else part)[torch.tensor(pages)]
    assert torch.equal(got, want)


def test_extract_adopt_and_tier_across_degrees(model):
    """A tp=2 engine's request continues on a tp=1 engine from its
    pages (extract -> adopt), tp=2 KV-tier chunks bind on tp=1 and
    back, and a tp=2 host swap is bitwise."""
    prompts = _prompts([40, 23], seed=5)
    sp = SamplingParams(max_new_tokens=10)
    want = _streams(LLMEngine(model, **CFG, **PAGED).generate(prompts, sp))
    assert min(_margins(model, prompts, want)) > 1e-3
    for src_tp, dst_tp in ((2, 1), (1, 2)):
        src = LLMEngine(model, tp=src_tp, **CFG, **PAGED)
        dst = LLMEngine(model, tp=dst_tp, **CFG, **PAGED)
        rids = [src.submit(p, sp) for p in prompts]
        src.step()
        moved = {}
        for rid in rids:
            d = src.extract(rid)
            assert d is not None and "kv_pages" in d
            dst.advance_salt_clock(src.salt_clock())
            moved[dst.adopt(d, keep_salt=True)] = rid
        dst.run_until_complete(max_steps=200)
        got = {moved[r]: list(dst.result(r).token_ids) for r in moved}
        assert [got[r] for r in rids] == want
        # pages, no prefill
        assert dst.stats()["prefill_tokens_computed"] == 0
    for pub_tp, sub_tp in ((2, 1), (1, 2)):
        tier = KVTier(page_size=16)
        pub = LLMEngine(model, tp=pub_tp, kv_tier=tier, **CFG, **PAGED)
        assert _streams(pub.generate(prompts, sp)) == want
        sub = LLMEngine(model, tp=sub_tp, kv_tier=tier, **CFG, **PAGED)
        assert _streams(sub.generate(prompts, sp)) == want
        assert sub.metrics.kv_tier_hits > 0
    eng = LLMEngine(model, tp=2, **CFG, **PAGED)
    base = _streams(eng.generate(prompts, sp))
    rid = eng.submit(prompts[0], sp)
    eng.step()
    assert eng.swap_out(rid) and eng.swapped_rids == [rid]
    eng.swap_in(rid)
    eng.run_until_complete(max_steps=200)
    assert list(eng.result(rid).token_ids) == base[0]
    eng.prefix.clear()
    assert eng.cache.pool.leaked() == 0


def test_server_soak_tp2_cpu(tmp_path):
    """The front door's soak at `--tp 2` (slotted): every gate of the
    soak, SERVER.json recording tp = 2."""
    out = tmp_path / "SERVER.json"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-m",
         "paddle_tpu_torch.serving.server", "--device", "cpu",
         "--requests", "16", "--flood", "8", "--drain-after", "3",
         "--max-new-tokens", "6", "--spacing-ms", "100", "--tp", "2",
         "--server-out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["tp"] == 2
    assert report["stranded_count"] == 0 and report["bit_mismatches"] == 0
    assert report["drained"] and report["exposition_ok"]
    assert report["tail_gate_ok"] and report["leaked_pages"] == 0
