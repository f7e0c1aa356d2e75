"""Port best-of-n fork groups (`SamplingParams(n > 1)`,
`paddle_tpu_torch/serving/engine.py`) against the JAX engine, and the
reference's fork contracts (`tests/test_paged_kv.py` `TestCOWForking`,
`tests/test_speculative.py` `test_fork_groups_bit_identical_under_spec`)
held inside the port on `gpt_tiny`.

- Paged copy-on-write: best-of-4 over a page-aligned prompt peaks below
  1.5x one request's pages with no boundary copy; a non-aligned prompt
  copies one boundary page per sibling (n - 1) and continuation 0 is the
  request served alone; interleaved admission (`prefill_budget`) forks
  too, computing one prompt's prefill. A retried copy is counted once.
- Bitwise on the CPU: a group's streams are the same paged and slotted,
  monolithic and interleaved, with speculation on and off.
- Lifecycle: `n > max_slots` is an INVALID reject naming max_slots; a
  parent cancelled in the queue resolves every sibling rid; a stream
  attached to a promised sibling gets its first token; a parent that
  fails mid-prefill leaves its waiting siblings to prefill alone.
- Moving groups: snapshot → resume, and unqueue → adopt, continue the
  group's sampled streams bitwise.
- Across packages: a greedy n=3 group's streams equal the JAX engine's
  (where the reference's top-2 margin is above 1e-3), and a JAX engine's
  snapshot holding a fork group resumes in the port and finishes every
  rid with the JAX engine's streams.
0 leaked pages after every paged run.
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
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


def _engine(model, **kw):
    return LLMEngine(model, device="cpu", **kw)


def _leaked(eng) -> int:
    """Pages held beyond the trash page once the prefix tree's
    (legitimate) holdings are released."""
    if eng.prefix is not None:
        eng.prefix.clear()
    return eng.cache.pool.leaked()


def _group(result):
    return [result.token_ids] + [s.token_ids for s in result.siblings]


PAGED = dict(max_slots=6, max_seq=128, kv_layout="paged", page_size=8,
             prefix_cache=False)
SAMPLED = dict(max_new_tokens=8, temperature=0.8, top_k=20)


# ---------------------------------------------------------------------- #
# copy-on-write pages
# ---------------------------------------------------------------------- #

def test_bestof4_page_ratio_under_1p5(model):
    prompt = _prompts((64,))[0]
    single = _engine(model, **PAGED)
    single.generate([prompt], SamplingParams(**SAMPLED))
    one = single.cache.pool.peak_used - 1
    best = _engine(model, **PAGED)
    g = best.generate([prompt], SamplingParams(n=4, **SAMPLED))[0]
    four = best.cache.pool.peak_used - 1
    assert len(g.siblings) == 3
    # 8 shared prompt pages + one decode page per continuation
    assert (one, four) == (9, 12) and four / one < 1.5
    assert best.stats()["pages_cow_copied"] == 0      # aligned prompt
    assert best.stats()["prefill_tokens_computed"] == 64
    assert _leaked(best) == 0 and not best._fork_src


def test_fork_then_diverge_boundary_copy(model):
    prompt = _prompts((60,))[0]
    kw = dict(PAGED, page_size=16)
    solo = _engine(model, **kw).generate([prompt],
                                         SamplingParams(**SAMPLED))[0]
    eng = _engine(model, **kw)
    g = eng.generate([prompt], SamplingParams(n=4, **SAMPLED))[0]
    assert eng.metrics.pages_cow_copied == 3          # n - 1
    streams = _group(g)
    assert len(set(map(tuple, streams))) == 4         # no collapse
    # continuation 0 has the parent's salt: the request served alone
    assert g.token_ids == solo.token_ids
    assert [s.request_id for s in g.siblings] == [1, 2, 3]
    assert _leaked(eng) == 0


def test_retried_copy_counts_once(model, monkeypatch):
    """A fork whose boundary copy fails retries from scratch: no page
    leaks, the copy books once per sibling, the streams are a clean
    run's."""
    prompt = _prompts((60,))[0]
    kw = dict(PAGED, page_size=16, retry_backoff_s=0.0)
    sp = SamplingParams(n=3, **SAMPLED)
    clean = _group(_engine(model, **kw).generate([prompt], sp)[0])
    eng = _engine(model, **kw)
    real, calls = eng.cache.copy_page, []

    def flaky(src, dst):
        calls.append(dst)
        if len(calls) == 1:
            raise RuntimeError("injected copy failure")
        real(src, dst)

    monkeypatch.setattr(eng.cache, "copy_page", flaky)
    g = eng.generate([prompt], sp)[0]
    assert _group(g) == clean
    assert len(calls) == 3 and eng.metrics.pages_cow_copied == 2
    assert eng.stats()["retries"] == 1 and _leaked(eng) == 0


def test_interleaved_fork_shares_pages(model):
    prompt = _prompts((64,))[0]
    sp = SamplingParams(n=4, **SAMPLED)
    mono = _engine(model, **PAGED)
    rm = mono.generate([prompt], sp)[0]
    inter = _engine(model, prefill_budget=16, prefill_chunk=16, **PAGED)
    ri = inter.generate([prompt], sp)[0]
    assert _group(rm) == _group(ri)
    assert inter.cache.pool.peak_used <= mono.cache.pool.peak_used
    assert inter.cache.pool.peak_used - 1 <= 12
    assert inter.metrics.prefill_tokens_computed == \
        mono.metrics.prefill_tokens_computed == 64
    assert _leaked(inter) == 0


# ---------------------------------------------------------------------- #
# the bit-identity matrix
# ---------------------------------------------------------------------- #

def test_fork_group_paged_equals_slotted(model):
    """Paged forks share and copy pages; slotted siblings prefill alone;
    the streams are the same, monolithic and interleaved, with the
    prefix cache on."""
    prompts = _prompts((33, 12))
    sp = [SamplingParams(max_new_tokens=8, temperature=0.7, n=3),
          SamplingParams(max_new_tokens=6, temperature=0.9, n=2)]
    base = dict(max_slots=4, max_seq=128, prefix_block=16)
    runs = {}
    for name, kw in {"slotted": {},
                     "paged": dict(kv_layout="paged", page_size=16),
                     "slotted_inter": dict(prefill_budget=8),
                     "paged_inter": dict(kv_layout="paged", page_size=16,
                                         prefill_budget=8)}.items():
        eng = _engine(model, **base, **kw)
        runs[name] = [_group(r) for r in eng.generate(prompts, sp)]
        if eng.paged:
            assert _leaked(eng) == 0 and not eng._fork_src
    assert all(v == runs["slotted"] for v in runs.values()), runs


def test_greedy_forks_identical(model):
    eng = _engine(model, max_slots=4, max_seq=128, kv_layout="paged",
                  page_size=16)
    g = eng.generate([_prompts((20,))[0]],
                     SamplingParams(max_new_tokens=6, n=3))[0]
    assert g.token_ids == g.siblings[0].token_ids \
        == g.siblings[1].token_ids
    assert _leaked(eng) == 0


@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_fork_groups_bit_identical_under_spec(model, layout):
    prompt = _prompts([18], seed=4)[0]
    sp = SamplingParams(max_new_tokens=6, temperature=0.9, n=3)
    kw = dict(max_slots=4, max_seq=64, seed=6)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=16)
    ref = _group(_engine(model, **kw).generate([prompt], sp)[0])
    eng = _engine(model, speculate_k=2, **kw)
    assert _group(eng.generate([prompt], sp)[0]) == ref
    assert eng.stats()["spec_proposed"] > 0
    if eng.paged:
        assert _leaked(eng) == 0


# ---------------------------------------------------------------------- #
# lifecycle
# ---------------------------------------------------------------------- #

def test_n_validation(model):
    eng = _engine(model, max_slots=2, max_seq=64)
    with pytest.raises(ValueError, match="max_slots"):
        eng.submit(_prompts((4,))[0], SamplingParams(max_new_tokens=2, n=3))
    assert eng.stats()["rejected_invalid"] == 1
    with pytest.raises(ValueError):
        SamplingParams(n=0)
    rid = eng.submit(_prompts((4,))[0], SamplingParams(max_new_tokens=2,
                                                        n=2))
    assert eng.fork_rids(rid) == [rid, rid + 1]
    assert eng.fork_rids(rid + 1) == []
    assert eng.submit(_prompts((4,))[0]) == rid + 2    # ids past the group
    eng.run_until_complete(max_steps=50)
    for r in (rid, rid + 1, rid + 2):
        assert eng.result(r).finish_reason == "length"
    assert eng.fork_rids(rid) == []      # dropped with the parent's result


def test_queued_parent_cancel_resolves_group(model):
    eng = _engine(model, max_slots=3, max_seq=64, kv_layout="paged",
                  page_size=16)
    busy = [eng.submit(p, SamplingParams(max_new_tokens=30))
            for p in _prompts((8, 8, 8))]
    eng.step()
    rid = eng.submit(_prompts((8,))[0], SamplingParams(max_new_tokens=4,
                                                        n=3))
    events = []
    assert eng.attach_stream(rid + 2, lambda *e: events.append(e))
    group = eng.fork_rids(rid)
    assert len(group) == 3
    assert eng.cancel(rid)
    for r in group:
        assert eng.result(r).finish_reason == "cancelled"
    assert events == [("finished", "cancelled", None)]
    eng.run_until_complete(max_steps=100)
    for r in busy:
        eng.result(r)
    assert _leaked(eng) == 0


def test_stream_on_promised_sibling(model):
    """A sink attached to a sibling rid before its parent pops gets the
    sibling's first token and the rest of its stream."""
    eng = _engine(model, max_slots=4, max_seq=64, kv_layout="paged",
                  page_size=16)
    rid = eng.submit(_prompts((10,))[0],
                     SamplingParams(max_new_tokens=7, temperature=0.8, n=3))
    got = {}
    for k in eng.fork_rids(rid):
        got[k] = []
        assert eng.attach_stream(k, lambda *e, k=k: got[k].append(e))
    assert not eng.attach_stream(rid + 3, lambda *e: None)   # not a rid
    eng.run_until_complete(max_steps=100)
    for k, events in got.items():
        assert events[0][:2] == ("tokens", 0)
        toks = [t for e in events if e[0] == "tokens" for t in e[2]]
        assert toks == eng.result(k).token_ids and len(toks) == 7
        assert events[-1] == ("finished", "length", None)
    assert _leaked(eng) == 0


def test_parent_failing_mid_prefill_leaves_siblings_to_prefill(model):
    """Interleaved, paged: the siblings park waiting for the parent's
    stash; the parent's prefill fails for good; they prefill alone and
    finish with a clean run's streams."""
    prompt = _prompts((40,), seed=3)[0]
    sp = SamplingParams(n=3, **SAMPLED)
    kw = dict(PAGED, prefill_budget=8, max_retries=0)
    clean = _group(_engine(model, **kw).generate([prompt], sp)[0])
    eng = _engine(model, **kw)
    rid = eng.submit(prompt, sp)
    with faults.inject(faults.FaultPlan().fail_at("prefill", 2)):
        eng.run_until_complete(max_steps=200)
    assert eng.result(rid).finish_reason == "error"
    assert [eng.result(rid + i).token_ids for i in (1, 2)] == clean[1:]
    assert eng.metrics.pages_cow_copied == 0 and _leaked(eng) == 0


# ---------------------------------------------------------------------- #
# moving groups between engines
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("steps", [0, 2])
def test_snapshot_resume_group(model, steps):
    """Snapshotted with the group queued behind busy lanes (0 steps
    after its submit) or decoding (2), pickled and resumed: every rid
    of the group finishes with the uninterrupted run's stream."""
    kw = dict(max_slots=4, max_seq=96, seed=3, kv_layout="paged",
              page_size=8, prefill_budget=16)
    prompts = _prompts((20, 11, 30), seed=2)
    sps = [SamplingParams(max_new_tokens=12, temperature=0.9),
           SamplingParams(max_new_tokens=5),
           SamplingParams(max_new_tokens=10, temperature=0.8, top_k=30,
                          n=3)]

    def submit(eng):
        return [eng.submit(p, sp) for p, sp in zip(prompts, sps)]

    ref = _engine(model, **kw)
    rids = submit(ref)
    ref.run_until_complete(max_steps=300)
    group = [rids[2], rids[2] + 1, rids[2] + 2]
    want = [ref.result(r).token_ids for r in rids[:2] + group]
    eng = _engine(model, **kw)
    submit(eng)
    for _ in range(steps):
        eng.step()
    snap = pickle.loads(pickle.dumps(eng.snapshot()))
    back = LLMEngine.resume(model, snap)
    back.run_until_complete(max_steps=300)
    assert [back.result(r).token_ids for r in rids[:2] + group] == want
    assert _leaked(back) == 0


def test_unqueue_adopt_group(model):
    """A queued group's parent leaves by unqueue (no salt drawn) and is
    adopted with the origin's salt clock: its siblings materialise at
    the adopter's pop and every stream is the origin's would-be one."""
    kw = dict(max_slots=2, max_seq=64, seed=5, kv_layout="paged",
              page_size=8)
    busy_p = _prompts((9, 7), seed=1)
    prompt = _prompts((13,), seed=8)[0]
    sp = SamplingParams(max_new_tokens=6, temperature=0.9, n=2)
    ref = _engine(model, **kw)
    for p in busy_p:
        ref.submit(p, SamplingParams(max_new_tokens=20))
    g = ref.submit(prompt, sp)
    ref.run_until_complete(max_steps=200)
    want = [ref.result(g).token_ids, ref.result(g + 1).token_ids]
    eng = _engine(model, **kw)
    for p in busy_p:
        eng.submit(p, SamplingParams(max_new_tokens=20))
    rid = eng.submit(prompt, sp)
    eng.step()
    d = eng.unqueue(rid)
    assert d["fork_rids"] == [rid, rid + 1] and d["salt"] is None
    assert eng.unqueue(rid + 1) is None       # not materialised here
    other = _engine(model, **kw)
    other.advance_salt_clock(eng.salt_clock())
    assert other.adopt(d, keep_salt=True) == rid
    assert other.fork_rids(rid) == [rid, rid + 1]
    other.run_until_complete(max_steps=200)
    assert [other.result(rid).token_ids,
            other.result(rid + 1).token_ids] == want
    assert _leaked(other) == 0
    eng.run_until_complete(max_steps=200)
    assert _leaked(eng) == 0


# ---------------------------------------------------------------------- #
# across packages
# ---------------------------------------------------------------------- #

JAX_KW = dict(max_slots=4, max_seq=64, seed=1, decode_block_size=4,
              attend_impl="masked", kv_layout="paged", page_size=8,
              prefix_cache=False)


def _jax_group(jax_model, prompt, n, new):
    eng = JaxEngine(jax_model, register_stats=False, trace=False, **JAX_KW)
    g = eng.generate([prompt], JaxParams(max_new_tokens=new, n=n))[0]
    return [g.token_ids] + [s.token_ids for s in g.siblings]


def test_greedy_group_equals_jax(jax_model, model):
    prompt = _prompts((21,), seed=11)[0]
    want = _jax_group(jax_model, prompt, 3, 10)
    margins = reference_margins(jax_model, [prompt], want[:1])
    print(f"smallest reference top-2 margin: {margins}")
    assert min(margins) > 1e-3, f"near-tie in the reference: {margins}"
    for kw in ({}, dict(prefill_budget=8)):
        eng = _engine(model, **{**JAX_KW, **kw})
        g = eng.generate([prompt], SamplingParams(max_new_tokens=10, n=3))
        assert _group(g[0]) == want
        assert _leaked(eng) == 0


def test_jax_snapshot_with_group_resumes_in_port(jax_model, model):
    """A JAX engine's snapshot taken with a greedy fork group decoding
    and another group still queued: the port resumes it and finishes
    every rid of both groups with the JAX engine's streams."""
    prompts = _prompts((21, 15), seed=11)
    sp = JaxParams(max_new_tokens=10, n=3)
    kw = dict(JAX_KW, max_slots=3)
    want_eng = JaxEngine(jax_model, register_stats=False, trace=False, **kw)
    rw = want_eng.generate(prompts, sp)
    want = [[g.token_ids] + [s.token_ids for s in g.siblings] for g in rw]
    margins = reference_margins(jax_model, prompts, [w[0] for w in want])
    assert min(margins) > 1e-3, f"near-tie in the reference: {margins}"
    jeng = JaxEngine(jax_model, register_stats=False, trace=False, **kw)
    rids = [jeng.submit(p, sp) for p in prompts]
    groups = [jeng.fork_rids(r) for r in rids]
    jeng.step()
    snap = pickle.loads(pickle.dumps(jeng.snapshot()))
    assert any(r.get("fork_of") is not None for r in snap["active"])
    assert any(r.get("fork_rids") for r in snap["queued"])
    eng = LLMEngine.resume(model, snap, device="cpu")
    assert eng.fork_rids(rids[1]) == groups[1]
    eng.run_until_complete(max_steps=300)
    got = [[eng.result(r).token_ids for r in grp] for grp in groups]
    assert got == want
    assert _leaked(eng) == 0
