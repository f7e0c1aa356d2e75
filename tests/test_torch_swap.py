"""Host swap and page payloads in the port's engine
(`LLMEngine.swap_out` / `swap_in`, `_admit_pages`, the paged `extract`),
the counterpart of `tests/test_paged_kv.py`'s `TestHostSwap`.

- A round trip under page pressure (swap out frees real pages, a
  waiting admission proceeds, swap in continues the parked stream) is
  bitwise an unswapped run, for fp and int8 KV, overlap on and off.
- Snapshot and resume carry the parked request's host pages: it
  reactivates on the resumed engine with no prefill.
- A failed swap (`page_swap` faults past the retries) leaves the request
  resident and decoding; a retried fault recovers.
- Cancel, deadline, unqueue and a stream attached while parked work on
  a parked request; swap on the slotted layout raises.
- A paged `extract` then `adopt` computes 0 prefill tokens and continues
  bitwise; a best-of-n sibling on shared prompt pages swaps and comes
  back on owned pages.
- Across packages: a JAX engine's snapshot with a swapped request
  (`gpt_tiny` fp32) resumes in the port by upload, and its greedy
  continuation equals the JAX engine's (where the reference's top-2
  margin is above 1e-3).
"""
import time

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.testing import faults

from port_streams import reference_margins
from port_threads import one_torch_thread  # noqa: F401 — autouse fixture

PAGED = dict(max_seq=64, kv_layout="paged", page_size=16, device="cpu")


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


def _leaked(eng) -> int:
    if eng.prefix is not None:
        eng.prefix.clear()
    return eng.cache.pool.leaked()


def _drain(eng):
    while eng.has_work():
        eng.step()


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_swap_roundtrip_under_pressure(model, kv_dtype, overlap):
    prompts = _prompts((30, 30))
    sp = SamplingParams(max_new_tokens=24, temperature=0.8, top_k=20)
    kw = dict(PAGED, max_slots=2, kv_dtype=kv_dtype, overlap=overlap,
              prefix_cache=False)
    want = [r.token_ids for r in LLMEngine(model, **kw).generate(
        prompts, [sp, sp])]
    # one span (54 rows: 4 pages) fits at a time: 5 usable pages
    eng = LLMEngine(model, kv_pages=6, **kw)
    r0, r1 = eng.submit(prompts[0], sp), eng.submit(prompts[1], sp)
    eng.step()
    assert eng.cache.num_active == 1 and eng.decoding_rids() == [r0]
    assert eng.page_load() == 4 + 4        # held + the queued span
    assert eng.swap_out(r0)
    assert eng.swapped_rids == [r0] and not eng.decoding_rids()
    assert eng.cache.pool.pages_used == 1 and eng.kv_pages_free == 5
    assert eng.page_load() == 4            # the queued span only
    _drain(eng)                            # the freed pages admit r1
    assert not eng.has_work() and eng.swapped_rids == [r0]
    assert eng.result(r1).token_ids == want[1]
    assert eng.swap_in(r0) and not eng.swap_in(r0)
    _drain(eng)
    assert eng.result(r0).token_ids == want[0]
    st = eng.stats()
    assert st["swap_outs"] == st["swap_ins"] == 1
    # 30 prompt rows + 8 decoded (one block) = 38 rows: 3 pages
    assert st["pages_swapped_out"] == st["pages_swapped_in"] == 3
    assert st["swap_host_syncs"] == 1
    assert st["host_syncs"] == st["decode_dispatches"]
    # the reactivation uploaded pages: only the two prompts prefilled
    assert st["prefill_tokens_computed"] == 60
    assert _leaked(eng) == 0
    kinds = [e[2] for e in eng.tracer.events() if e[3] == r0]
    assert kinds.count("swap_out") == kinds.count("swap_in") == 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_swap_snapshot_resume_carries_host_pages(model, kv_dtype):
    prompts = _prompts((20, 12))
    sp = SamplingParams(max_new_tokens=16, temperature=0.6)
    kw = dict(PAGED, max_slots=2, kv_dtype=kv_dtype)
    want = [r.token_ids for r in LLMEngine(model, **kw).generate(
        prompts, [sp, sp])]
    eng = LLMEngine(model, **kw)
    r0, r1 = eng.submit(prompts[0], sp), eng.submit(prompts[1], sp)
    eng.step()
    assert eng.swap_out(r0)
    snap = eng.snapshot()
    assert [d["rid"] for d in snap["swapped"]] == [r0]
    parked = snap["swapped"][0]
    assert parked["kv_pages"]["rows"] == 20 + len(parked["generated"]) - 1
    eng2 = LLMEngine.resume(model, snap)
    assert eng2.swapped_rids == [r0]
    _drain(eng2)                           # r1 only: r0 stays parked
    pf = eng2.metrics.prefill_tokens_computed
    assert eng2.swap_in(r0)
    _drain(eng2)
    assert eng2.metrics.prefill_tokens_computed == pf   # 0 for r0
    assert eng2.result(r0).token_ids == want[0]
    assert eng2.result(r1).token_ids == want[1]
    assert eng2.metrics.swap_ins == 1 and _leaked(eng2) == 0
    # a layout override cannot take the pages: the request re-ingests
    eng3 = LLMEngine.resume(model, snap, kv_layout="slotted",
                            page_size=None, kv_pages=None)
    assert not eng3.swapped_rids and eng3.pending == 1
    _drain(eng3)
    assert eng3.result(r0).token_ids == want[0]


def test_failed_swap_leaves_request_resident(model):
    sp = SamplingParams(max_new_tokens=16)
    prompt = _prompts((12,))[0]
    eng = LLMEngine(model, max_slots=1, max_retries=1, retry_backoff_s=0.0,
                    **PAGED)
    rid = eng.submit(prompt, sp)
    eng.step()
    plan = faults.FaultPlan().fail_at("page_swap", 1, 2)
    with faults.inject(plan):
        assert not eng.swap_out(rid)
    assert plan.injected["page_swap"] == 2
    assert not eng.swapped_rids and eng.decoding_rids() == [rid]
    _drain(eng)
    want = LLMEngine(model, max_slots=1, **PAGED).generate([prompt], sp)
    assert eng.result(rid).token_ids == want[0].token_ids
    assert eng.stats()["swap_outs"] == 0 and _leaked(eng) == 0


def test_swap_fault_retry_recovers(model):
    eng = LLMEngine(model, max_slots=1, retry_backoff_s=0.0, **PAGED)
    rid = eng.submit(_prompts((12,))[0], SamplingParams(max_new_tokens=16))
    eng.step()
    plan = faults.FaultPlan().fail_at("page_swap", 1, 3)
    with faults.inject(plan):
        assert eng.swap_out(rid)           # retried past the fault
        assert eng.swap_in(rid)
        _drain(eng)                        # the scatter retries too
    assert plan.injected["page_swap"] == 2
    assert eng.metrics.recoveries == 2
    assert eng.result(rid).finish_reason == "length"
    assert _leaked(eng) == 0


def test_swap_needs_paged_layout_and_a_decoding_request(model):
    eng = LLMEngine(model, max_slots=1, max_seq=64, device="cpu")
    rid = eng.submit(_prompts((8,))[0], SamplingParams(max_new_tokens=8))
    with pytest.raises(RuntimeError, match="paged"):
        eng.swap_out(rid)
    assert eng.page_load() is None and eng.kv_pages_free == 0
    paged = LLMEngine(model, max_slots=1, **PAGED)
    q = paged.submit(_prompts((8,))[0], SamplingParams(max_new_tokens=8))
    assert not paged.swap_out(q)           # queued, not decoding
    assert not paged.swap_out(12345)


def test_parked_cancel_deadline_and_unqueue(model):
    eng = LLMEngine(model, max_slots=3, **PAGED)
    sp = SamplingParams(max_new_tokens=30)
    p = _prompts((8,))[0]
    r0, r1 = eng.submit(p, sp), eng.submit(p, sp)
    r2 = eng.submit(p, SamplingParams(max_new_tokens=30, deadline_s=0.05))
    eng.step()
    assert all(eng.swap_out(r) for r in (r0, r1, r2))
    assert eng.cancel(r0)
    g = eng.result(r0)
    assert g.finish_reason == "cancelled" and g.token_ids
    time.sleep(0.06)
    eng.submit(p, SamplingParams(max_new_tokens=2))
    _drain(eng)                            # the sweep expires r2
    g = eng.result(r2)
    assert g.finish_reason == "deadline" and g.token_ids
    d = eng.unqueue(r1)
    assert d["kv_pages"]["rows"] == 8 + len(d["generated"]) - 1
    assert not eng.swapped_rids and _leaked(eng) == 0
    other = LLMEngine(model, max_slots=1, **PAGED)
    other.adopt(d, keep_salt=True)
    _drain(other)
    assert other.metrics.prefill_tokens_computed == 0
    want = LLMEngine(model, max_slots=1, **PAGED).generate([p], sp)[0]
    assert other.result(r1).token_ids == want.token_ids


def test_stream_attached_while_parked_replays(model):
    eng = LLMEngine(model, max_slots=1, **PAGED)
    sp = SamplingParams(max_new_tokens=20, temperature=0.7)
    rid = eng.submit(_prompts((10,))[0], sp)
    eng.step()
    assert eng.swap_out(rid)
    got = []
    assert eng.attach_stream(rid, lambda kind, *a: got.append((kind, a)))
    assert got[0][0] == "tokens" and got[0][1][0] == 0
    assert eng.swap_in(rid)
    _drain(eng)
    toks = []
    for kind, a in got:
        if kind == "tokens":
            start, ids = a
            toks[start:start + len(ids)] = ids
    assert got[-1] == ("finished", ("length", None))
    assert toks == eng.result(rid).token_ids


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_extract_adopt_uploads_pages(model, kv_dtype):
    prompts = _prompts((21, 9))
    sp = SamplingParams(max_new_tokens=18, temperature=0.9, top_k=40)
    kw = dict(PAGED, max_slots=2, kv_dtype=kv_dtype)
    want = [r.token_ids for r in LLMEngine(model, **kw).generate(
        prompts, [sp, sp])]
    eng = LLMEngine(model, **kw)
    rids = [eng.submit(p, sp) for p in prompts]
    eng.step()
    eng.step()
    d = eng.extract(rids[0])
    assert d["kv_pages"]["origin"] == "handoff"
    assert d["kv_pages"]["rows"] == 21 + len(d["generated"]) - 1
    assert eng.stats()["swap_host_syncs"] == 1
    other = LLMEngine(model, **kw)
    other.advance_salt_clock(eng.salt_clock())
    other.adopt(d, keep_salt=True)
    _drain(other)
    _drain(eng)
    assert other.metrics.prefill_tokens_computed == 0
    assert other.metrics.replay_steps == 0
    assert other.result(rids[0]).token_ids == want[0]
    assert eng.result(rids[1]).token_ids == want[1]
    assert _leaked(eng) == 0 and _leaked(other) == 0
    # a slotted adopter cannot take pages: it re-ingests, bitwise too
    slotted = LLMEngine(model, max_slots=2, max_seq=64, device="cpu",
                        kv_dtype=kv_dtype)
    slotted.adopt(d, keep_salt=True)
    _drain(slotted)
    assert slotted.metrics.prefill_tokens_computed == 21
    assert slotted.result(rids[0]).token_ids == want[0]


def test_fork_sibling_swaps_back_on_owned_pages(model):
    prompt = _prompts((40,), seed=3)[0]
    sp = SamplingParams(max_new_tokens=12, temperature=0.8, top_k=20, n=3)
    kw = dict(PAGED, max_slots=3, page_size=8, prefix_cache=False)
    g = LLMEngine(model, **kw).generate([prompt], sp)[0]
    want = [g.token_ids] + [s.token_ids for s in g.siblings]
    eng = LLMEngine(model, **kw)
    rid = eng.submit(prompt, sp)
    group = eng.fork_rids(rid)
    while len(eng.decoding_rids()) < 3:
        eng.step()
    kid = group[1]
    assert eng.swap_out(kid)
    assert eng.swap_in(kid)
    _drain(eng)
    assert [eng.result(r).token_ids for r in group] == want
    assert not eng._fork_src and _leaked(eng) == 0


def test_jax_snapshot_with_swapped_request_resumes_by_upload(jax_model,
                                                             model):
    prompts = _prompts((20, 12), seed=5)
    kw = dict(max_slots=2, max_seq=64, kv_layout="paged", page_size=16)
    jeng = JaxEngine(jax_model, register_stats=False, **kw)
    jsp = JaxParams(max_new_tokens=14)
    rids = [jeng.submit(p, jsp) for p in prompts]
    jeng.step()
    assert jeng.swap_out(rids[0])
    snap = jeng.snapshot()
    assert snap["swapped"][0]["kv_pages"]["rows"] > 0
    assert jeng.swap_in(rids[0])
    while jeng.has_work():
        jeng.step()
    want = [jeng.result(r).token_ids for r in rids]
    margins = reference_margins(jax_model, prompts, want)
    print(f"smallest reference top-2 margin per stream: {margins}")
    assert min(margins) > 1e-3, f"near-tie in the reference: {margins}"
    eng = LLMEngine.resume(model, snap, device="cpu")
    assert eng.swapped_rids == [rids[0]]
    _drain(eng)
    pf = eng.metrics.prefill_tokens_computed
    assert eng.swap_in(rids[0])
    _drain(eng)
    assert eng.metrics.prefill_tokens_computed == pf
    assert [eng.result(r).token_ids for r in rids] == want
    assert _leaked(eng) == 0
