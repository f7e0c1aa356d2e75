"""Port snapshot / resume, adopt / extract / unqueue and the salt clock
(`paddle_tpu_torch/serving/engine.py`) against the JAX reference, and
the reference's contracts held inside the port.

- Inside the port, bitwise on the CPU: snapshot → pickle → resume
  continues every greedy AND sampled stream (slotted, paged, int8 KV,
  speculative, interleaved), also for a request snapshotted mid-prefill,
  which re-enters queued and emits nothing twice; the free-slot order,
  the salt counter and the remaining deadlines carry across; a resume
  may turn the prefix cache off.
- Moving requests: `extract()` defers the slot release past an
  in-flight block and records no result; `unqueue()` assigns the salt
  its pop would have; `adopt(keep_salt=True)` with the origin's salt
  clock continues the origin's sampled streams bitwise.
- No slab healing is ported: the slabs are written in place, so after
  a faulted decode dispatch every live row is intact and the retry
  continues bitwise.
- Across packages: a JAX engine's snapshot (prefix cache on,
  `prefill_budget` set, some requests mid-prefill) resumed in the port
  continues the JAX engine's greedy streams, where the reference's
  top-2 logit margin is above 1e-3 at every step.
"""
import pickle
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.quantization.kv import slab_leaves
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.testing import faults
from port_streams import reference_margins
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_model():
    pt.seed(0)
    m = jax_gpt_tiny()
    m.eval()
    return m


@pytest.fixture(scope="module")
def model(jax_model):
    np_params = {k: np.asarray(v)
                 for k, v in jax_model.raw_parameters().items()}
    return load_jax_params(gpt_tiny(device="cpu"), np_params)


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _shared(tails, seed=3):
    head = _prompts([24], seed=seed)[0]
    return [np.concatenate([head, t]) for t in _prompts(tails, seed + 1)]


def _mixed_params():
    return [SamplingParams(max_new_tokens=20),
            SamplingParams(max_new_tokens=18, temperature=0.9),
            SamplingParams(max_new_tokens=16, temperature=0.8, top_k=16),
            SamplingParams(max_new_tokens=14, temperature=0.7, top_p=0.9)]


BASE = dict(max_slots=2, max_seq=96, seed=7, device="cpu")
CONFIGS = {
    "slotted": dict(prefix_block=8),
    "paged": dict(kv_layout="paged", page_size=8),
    "int8_kv": dict(prefix_block=8, kv_dtype="int8"),
    "speculative": dict(prefix_block=8, speculate_k=2),
    "interleaved": dict(prefix_block=8, prefill_budget=8),
    "one_lane": dict(prefix_block=8, max_slots=1),
}


def _engine(model, **kw):
    return LLMEngine(model, **{**BASE, **kw})


def _reference(model, prompts, params, **kw):
    eng = _engine(model, **kw)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run_until_complete(max_steps=500)
    return [eng.result(r).token_ids for r in rids]


def _lane_rows(eng):
    """rid -> every layer's K/V rows [0, pos) of its lane (codes and
    scales for int8), read through the block table when paged."""
    out = {}
    for s, r in sorted(eng._active.items()):
        n = int(eng._pos[s])
        rows = []
        for slab in eng.cache.k + eng.cache.v:
            for t in slab_leaves(slab):
                if eng.paged:
                    idx = torch.arange(n)
                    tab = torch.from_numpy(eng.cache.block_tables[s]).long()
                    rows.append(t[tab[idx // eng.page_size],
                                  idx % eng.page_size].clone())
                else:
                    rows.append(t[s, :n].clone())
        out[r.rid] = rows
    return out


def _same_rows(a, b) -> bool:
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(torch.equal(x, y)
                                       for x, y in zip(a[k], b[k]))
        for k in a)


# ---------------------------------------------------------------------- #
# snapshot → pickle → resume
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_snapshot_resume_continues_bitwise(model, config):
    prompts, params = _shared((4, 7, 3, 9)), _mixed_params()
    kw = CONFIGS[config]
    ref = _reference(model, prompts, params, **kw)
    eng = _engine(model, **kw)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.step()
    while not any(r.finish_reason is None and r.generated
                  for r in eng._active.values()):
        eng.step()
    snap = pickle.loads(pickle.dumps(eng.snapshot()))
    assert snap["active"] and all(r["generated"] for r in snap["active"])
    slots = {r["rid"]: r["slot"] for r in snap["active"]}
    eng2 = LLMEngine.resume(model, snap)
    assert {r.rid: s for s, r in eng2._active.items()} == slots
    # the re-ingest (prefill) rebuilt the rows decode had written, bit
    # for bit: on the CPU no product runs on one row
    assert _same_rows(_lane_rows(eng), _lane_rows(eng2))
    eng2.run_until_complete(max_steps=500)
    assert [eng2.result(r).token_ids for r in rids] == ref
    # the snapshot engine keeps serving: its streams are unchanged too
    eng.run_until_complete(max_steps=500)
    assert [eng.result(r).token_ids for r in rids] == ref
    if eng2.paged:
        eng2.prefix.clear()
        assert eng2.cache.pool.leaked() == 0


def test_resume_through_a_warm_cache_or_with_it_off(model):
    prompts, params = _shared((4, 7, 3, 9), seed=5), _mixed_params()
    ref = _reference(model, prompts, params, prefix_cache=False)
    eng = _engine(model, prefix_block=8)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    for _ in range(2):
        eng.step()
    snap = eng.snapshot()
    warm = LLMEngine.resume(model, snap)
    warm.run_until_complete(max_steps=500)
    assert [warm.result(r).token_ids for r in rids] == ref
    assert warm.stats()["prefix_tokens_reused"] > 0
    assert warm.prefix_pool_pages == snap["engine"]["prefix_pool_pages"]
    off = LLMEngine.resume(model, snap, prefix_cache=False)
    assert off.prefix is None
    off.run_until_complete(max_steps=500)
    assert [off.result(r).token_ids for r in rids] == ref


def test_mid_prefill_snapshot_resume_no_reemit(model):
    prompts = _prompts([80], seed=5)
    sp = SamplingParams(max_new_tokens=5, temperature=0.9)
    cfg = dict(max_slots=1, seed=11, prefill_budget=16, prefill_chunk=16)
    ref = _reference(model, prompts, [sp], **cfg)
    eng = _engine(model, **cfg)
    rid = eng.submit(prompts[0], sp)
    eng.step()
    assert eng.prefilling == 1
    snap = pickle.loads(pickle.dumps(eng.snapshot()))
    assert not snap["active"] and len(snap["queued"]) == 1
    assert snap["queued"][0]["generated"] == []
    assert snap["queued"][0]["salt"] == 0
    eng2 = LLMEngine.resume(model, snap)
    eng2.run_until_complete(max_steps=300)
    assert eng2.result(rid).token_ids == ref[0]
    assert eng2.stats()["generated_tokens"] == len(ref[0])


def test_resume_carries_free_slots_salts_and_deadlines(model):
    prompts = _prompts((5, 9, 13, 7, 11, 6), seed=8)
    params = [SamplingParams(max_new_tokens=2, temperature=0.9),
              SamplingParams(max_new_tokens=30, temperature=0.9),
              SamplingParams(max_new_tokens=2, temperature=0.9),
              SamplingParams(max_new_tokens=8, temperature=0.9,
                             deadline_s=100.0),
              SamplingParams(max_new_tokens=8, temperature=0.9),
              SamplingParams(max_new_tokens=8, temperature=0.9)]
    cfg = dict(max_slots=3, decode_block_size=2)
    ref = _reference(model, prompts, params, **cfg)
    eng = _engine(model, **cfg)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.step()            # two short requests retired: slots free again
    snap = eng.snapshot()
    assert len(snap["free_slots"]) == 2 and len(snap["queued"]) == 3
    assert snap["free_slots"] == eng.cache.free_slots()
    eng2 = LLMEngine.resume(model, snap)
    assert eng2.cache.free_slots() == snap["free_slots"]
    assert eng2.salt_clock() == eng.salt_clock() == snap["next_salt"]
    eng.step()
    eng2.step()
    assert {r.rid: s for s, r in eng2._active.items()} == \
        {r.rid: s for s, r in eng._active.items()}
    left = [r for r in list(eng2._queue) + list(eng2._active.values())
            if r.rid == rids[3]][0]
    remaining = left.deadline_t - time.perf_counter()
    assert 90.0 < remaining < 100.0
    eng2.run_until_complete(max_steps=500)
    assert [eng2.result(r).token_ids for r in rids] == ref


# ---------------------------------------------------------------------- #
# moving requests: extract / unqueue / adopt, the salt clock
# ---------------------------------------------------------------------- #

def test_salt_clock_is_monotonic(model):
    eng = _engine(model)
    assert eng.salt_clock() == 0
    eng.advance_salt_clock(5)
    eng.advance_salt_clock(3)
    assert eng.salt_clock() == 5
    rid = eng.submit(_prompts([6])[0], SamplingParams(max_new_tokens=30))
    eng.step()
    assert [r.salt for r in eng._active.values() if r.rid == rid] == [5]
    assert eng.salt_clock() == 6


def test_drain_extract_unqueue_adopt_keep_salt(model):
    """A graceful drain: the origin's decoding requests move with
    extract(), its queued ones with unqueue() (pop order), its salt
    clock first; the adopter continues every sampled stream
    bitwise."""
    prompts = _shared((4, 7, 3, 9, 6), seed=9)
    params = _mixed_params() + [SamplingParams(max_new_tokens=12,
                                               temperature=1.0)]
    ref = _reference(model, prompts, params, prefix_block=8)
    a = _engine(model, prefix_block=8)
    rids = [a.submit(p, sp) for p, sp in zip(prompts, params)]
    a.step()
    a.step()
    moving = [a.extract(r.rid) for _, r in sorted(a._active.items())]
    assert all(d is not None and d["generated"] for d in moving)
    queued = [r.rid for r in a._queue]
    moving += [a.unqueue(rid) for rid in queued]
    assert all(d["salt"] is not None for d in moving)
    assert a.extract(12345) is None and a.unqueue(rids[0]) is None
    b = _engine(model, prefix_block=8)
    b.advance_salt_clock(a.salt_clock())
    for d in pickle.loads(pickle.dumps(moving)):
        b.adopt(d, keep_salt=True)
    b.run_until_complete(max_steps=500)
    assert [b.result(r).token_ids for r in rids] == ref
    # the origin drains without recording the moved requests
    a.run_until_complete(max_steps=50)
    assert not a._results and a.cache.num_free == a.max_slots
    assert b.salt_clock() == a.salt_clock()


def test_extract_defers_slot_release_past_inflight_block(model):
    prompts = _prompts((5, 9), seed=10)
    params = [SamplingParams(max_new_tokens=30, temperature=0.9),
              SamplingParams(max_new_tokens=30)]
    ref = _reference(model, prompts, params, decode_block_size=2)
    a = _engine(model, decode_block_size=2)
    rids = [a.submit(p, sp) for p, sp in zip(prompts, params)]
    a.step()
    a.step()
    assert a._inflight is not None           # the overlap lookahead
    slot = [s for s, r in a._active.items() if r.rid == rids[0]][0]
    d = a.extract(rids[0])
    free = a.cache.num_free
    a.submit(_prompts([6], seed=11)[0], SamplingParams(max_new_tokens=4))
    assert slot in a._active and a.cache.num_free == free
    a.step()                                  # the in-flight block lands
    assert slot not in a._active or a._active[slot].rid != rids[0]
    assert rids[0] not in a._results
    b = _engine(model, decode_block_size=2)
    b.adopt(d, keep_salt=True)
    b.run_until_complete(max_steps=300)
    assert b.result(rids[0]).token_ids == ref[0]
    a.run_until_complete(max_steps=300)
    assert a.result(rids[1]).token_ids == ref[1]


def test_adopt_resalts_by_default_and_keeps_greedy_streams(model):
    prompts = _prompts((7, 12), seed=12)
    params = [SamplingParams(max_new_tokens=12),
              SamplingParams(max_new_tokens=12, temperature=0.9)]
    ref = _reference(model, prompts, params)
    a = _engine(model)
    rids = [a.submit(p, sp) for p, sp in zip(prompts, params)]
    a.step()
    snap = a.snapshot()
    b = _engine(model)
    b.advance_salt_clock(40)
    for d in snap["active"]:
        assert b.adopt(d) == d["rid"]
    b.run_until_complete(max_steps=300)
    assert b.result(rids[0]).token_ids == ref[0]          # greedy
    got = b.result(rids[1]).token_ids
    n = len(snap["active"][1]["generated"])
    assert got[:n] == ref[1][:n] and got != ref[1]        # re-salted
    assert b.salt_clock() == 42


def test_mid_prefill_adopt_no_reemit(model):
    prompts = _prompts([80], seed=5)
    sp = SamplingParams(max_new_tokens=5, temperature=0.9)
    cfg = dict(max_slots=1, seed=11, prefill_budget=16, prefill_chunk=16)
    ref = _reference(model, prompts, [sp], **cfg)
    eng = _engine(model, **cfg)
    rid = eng.submit(prompts[0], sp)
    eng.step()
    snap = eng.snapshot()
    peer = _engine(model, **cfg)
    assert peer.adopt(snap["queued"][0], keep_salt=True) == rid
    peer.run_until_complete(max_steps=300)
    assert peer.result(rid).token_ids == ref[0]
    # a best-of-2 adoption dict: rejected where the group cannot hold
    # its lanes (the reference's n > max_slots rule), served where it can
    group = dict(snap["queued"][0], fork_rids=[rid, rid + 1],
                 params=dict(snap["queued"][0]["params"], n=2))
    with pytest.raises(ValueError, match="max_slots"):
        peer.adopt(group)
    wide = _engine(model, **{**cfg, "max_slots": 2})
    assert wide.adopt(group) == rid and wide.fork_rids(rid) == [rid, rid + 1]
    wide.run_until_complete(max_steps=300)
    # re-salted at the wide engine's pop: salt 0 for the parent, as the
    # reference run's request had
    assert wide.result(rid).token_ids == ref[0]
    assert len(wide.result(rid + 1).token_ids) == 5


# ---------------------------------------------------------------------- #
# no slab healing: the slabs survive a faulted dispatch
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("config", ["slotted", "paged", "int8_kv"])
def test_slabs_intact_after_faulted_decode_dispatch(model, config):
    """The JAX engine heals slabs a failed compiled step consumed; the
    port writes them in place, so a faulted decode dispatch leaves every
    live lane's rows as they were, and the retry continues bitwise."""
    prompts, params = _shared((4, 7, 3, 9), seed=13), _mixed_params()
    kw = CONFIGS[config]
    ref = _reference(model, prompts, params, **kw)
    eng = _engine(model, max_retries=2, retry_backoff_s=0.0, **kw)
    real = eng._dispatch_block
    seen = {"n": 0}

    def dispatch():
        seen["n"] += 1
        if seen["n"] == 4:
            seen["before"] = _lane_rows(eng)
            raise faults.InjectedFault("decode_dispatch", 4)
        if seen["n"] == 5:
            seen["after"] = _lane_rows(eng)
        return real()

    eng._dispatch_block = dispatch
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run_until_complete(max_steps=500)
    assert [eng.result(r).token_ids for r in rids] == ref
    assert eng.metrics.recoveries == 1
    assert seen["before"] and _same_rows(seen["before"], seen["after"])


# ---------------------------------------------------------------------- #
# across packages
# ---------------------------------------------------------------------- #

def test_jax_snapshot_resumes_in_port(jax_model, model):
    """A JAX engine's snapshot, taken with requests decoding and one
    mid-prefill, resumed by the port: the port's tokens continue the
    JAX engine's greedy streams."""
    prompts = _shared((40, 6, 30, 11), seed=14)
    kw = dict(max_slots=2, max_seq=96, seed=1, decode_block_size=4,
              attend_impl="masked", prefill_budget=16, prefix_block=8)
    sp = JaxParams(max_new_tokens=10)
    want = [r.token_ids for r in JaxEngine(
        jax_model, register_stats=False, trace=False, **kw).generate(
        prompts, sp)]
    margins = reference_margins(jax_model, prompts, want)
    print(f"smallest reference top-2 margin per stream: {margins}")
    assert min(margins) > 1e-3, f"near-tie in the reference: {margins}"
    jeng = JaxEngine(jax_model, register_stats=False, trace=False, **kw)
    rids = [jeng.submit(p, sp) for p in prompts]
    for _ in range(3):
        jeng.step()
    snap = pickle.loads(pickle.dumps(jeng.snapshot()))
    assert snap["active"] and snap["engine"]["prefix_cache"] \
        and snap["engine"]["prefill_budget"] == 16
    eng = LLMEngine.resume(model, snap, device="cpu")
    assert eng.prefill_budget == 16 and eng.prefix is not None
    eng.run_until_complete(max_steps=300)
    assert [eng.result(r).token_ids for r in rids] == want
