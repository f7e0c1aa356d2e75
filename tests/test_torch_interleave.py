"""Port chunked-prefill interleaving (`LLMEngine(prefill_budget=...)`)
against the JAX reference, and the reference's contracts
(`tests/test_interleave.py`, without the fleet) held inside the port.

- Inside the port, bitwise: interleaved ≡ monolithic for greedy AND
  sampled streams, over budgets, chunk sizes, decode block sizes,
  overlap on and off, the prefix cache on and off, both KV layouts and
  speculation;
  identical sampled prompts stay distinct (the per-request salt);
  a `prefill` fault mid-chunk recovers bitwise, and its exhaustion
  fails only that request.
- Scheduling: decode keeps emitting while a long prompt is
  mid-prefill, a long prompt is not starved by shorter arrivals (the
  aging chunk), and no overlap lookahead is dispatched while a lane is
  prefilling.
- Lifecycle: cancel and deadline reach PREFILLING lanes (slot and
  pins free at once; the deadline books its wait into queue_wait);
  the `prefilling` gauge.
- Across packages: the port under `prefill_budget` and the prefix
  cache gives the JAX engine's greedy streams (same knobs), where the
  reference's top-2 logit margin is above 1e-3 at every step.
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


def _mixed_params():
    return [SamplingParams(max_new_tokens=6),
            SamplingParams(max_new_tokens=8, temperature=0.9),
            SamplingParams(max_new_tokens=5, temperature=0.8, top_k=16),
            SamplingParams(max_new_tokens=7),
            SamplingParams(max_new_tokens=6, temperature=1.1, top_p=0.7),
            SamplingParams(max_new_tokens=9, temperature=0.9)]


def _engine(model, **kw):
    return LLMEngine(model, device="cpu", **kw)


def _run(model, prompts, params, **kw):
    eng = _engine(model, **kw)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run_until_complete(max_steps=1000)
    return [eng.result(r).token_ids for r in rids], eng


def _unpinned(prefix) -> bool:
    stack = list(prefix.root.children.values())
    while stack:
        n = stack.pop()
        if n.ref != 0:
            return False
        stack.extend(n.children.values())
    return True


# ---------------------------------------------------------------------- #
# interleaved ≡ monolithic
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def monolithic(model):
    cfg = dict(max_slots=3, max_seq=128, seed=3, prefix_block=16)
    prompts = _prompts((5, 40, 9, 70, 3, 25), seed=0)
    return cfg, prompts, _run(model, prompts, _mixed_params(), **cfg)[0]


@pytest.mark.parametrize("extra", [
    dict(prefill_budget=16, prefill_chunk=16),
    dict(prefill_budget=8, prefill_chunk=8),
    dict(prefill_budget=64, prefill_chunk=16),
    dict(prefill_budget=16, prefix_cache=False),
    dict(prefill_budget=16, decode_block_size=1, overlap=False),
    dict(prefill_budget=16, decode_block_size=2),
    dict(prefill_budget=16, kv_layout="paged", page_size=16),
    dict(prefill_budget=16, speculate_k=2),
    dict(prefill_chunk=16)])
def test_interleaved_matches_monolithic(model, monolithic, extra):
    """Mixed greedy / sampled, short / long prompts: every admission
    schedule gives the monolithic engine's streams bitwise."""
    cfg, prompts, ref = monolithic
    out, eng = _run(model, prompts, _mixed_params(), **{**cfg, **extra})
    assert out == ref
    if eng.paged:
        eng.prefix.clear()
        assert eng.cache.pool.leaked() == 0


def test_identical_sampled_prompts_stay_distinct(model):
    p = _prompts([9], seed=9)[0]
    sp = SamplingParams(max_new_tokens=10, temperature=0.9)
    cfg = dict(max_slots=3, max_seq=64, seed=2)
    a, b, c = _run(model, [p, p, p], [sp] * 3, **cfg)[0]
    assert not (a == b == c), "identical prompts collapsed"
    assert _run(model, [p, p, p], [sp] * 3, prefill_budget=8,
                **cfg)[0] == [a, b, c]


def test_prefix_cache_hit_identical_under_interleave(model):
    """A warm tree moves the chunk grid's start to the copied-prefix
    boundary: the streams do not move."""
    shared = _prompts([48], seed=5)[0]
    prompts = [np.concatenate([shared, t])
               for t in _prompts([9, 7], seed=6)]
    sp = SamplingParams(max_new_tokens=6, temperature=0.9)
    cfg = dict(max_slots=1, max_seq=128, seed=4, prefix_block=16)
    ref, _ = _run(model, prompts, [sp, sp], prefix_cache=False,
                  **{k: v for k, v in cfg.items() if k != "prefix_block"})
    out, eng = _run(model, prompts, [sp, sp], prefill_budget=16, **cfg)
    assert out == ref
    assert eng.stats()["prefix_tokens_reused"] == 48


# ---------------------------------------------------------------------- #
# scheduling
# ---------------------------------------------------------------------- #

def test_decode_not_blocked_by_long_prefill(model):
    eng = _engine(model, max_slots=2, max_seq=256, seed=0,
                  prefill_budget=16, prefill_chunk=16, decode_block_size=4)
    short = eng.submit(_prompts([5])[0], SamplingParams(max_new_tokens=40))
    eng.step()
    long_rid = eng.submit(_prompts([180], seed=2)[0],
                          SamplingParams(max_new_tokens=4))
    concurrent = 0
    for _ in range(6):
        before = eng.metrics.generated_tokens
        eng.step()
        if eng.prefilling and eng.metrics.generated_tokens > before:
            concurrent += 1
    assert concurrent >= 3, "decode waited for the long prefill"
    eng.run_until_complete(max_steps=300)
    assert eng.result(short).finish_reason == "length"
    assert eng.result(long_rid).finish_reason == "length"


def test_long_prefill_not_starved_by_shorter_arrivals(model):
    eng = _engine(model, max_slots=3, max_seq=256, seed=0,
                  prefill_budget=16, prefill_chunk=16, decode_block_size=2)
    long_rid = eng.submit(_prompts([160], seed=8)[0],
                          SamplingParams(max_new_tokens=2))
    rng = np.random.RandomState(99)
    for _ in range(14):
        for _ in range(2):
            if eng.pending < 4:
                eng.submit(rng.randint(0, 1024, (24,)),
                           SamplingParams(max_new_tokens=2))
        eng.step()
        if long_rid in eng._results:
            break
    # 160 tokens / a 16-token aging chunk per round = 10 rounds
    assert long_rid in eng._results, "long prompt starved"
    assert eng.result(long_rid).finish_reason == "length"


def test_no_lookahead_while_prefilling(model):
    """The overlap lookahead waits while a lane is prefilling (and runs
    otherwise): overlap stays on, and a second block is never
    dispatched in a round with a PREFILLING lane."""
    eng = _engine(model, max_slots=2, max_seq=256, seed=0,
                  prefill_budget=16, prefill_chunk=16, decode_block_size=2)
    seen = []
    real = eng._dispatch_block

    def spy():
        seen.append((eng._inflight is not None, bool(eng._prefilling)))
        return real()

    eng._dispatch_block = spy
    eng.submit(_prompts([5])[0], SamplingParams(max_new_tokens=40))
    eng.step()
    eng.submit(_prompts([150], seed=2)[0], SamplingParams(max_new_tokens=4))
    eng.run_until_complete(max_steps=300)
    lookaheads = [pf for ahead, pf in seen if ahead]
    assert lookaheads and not any(lookaheads)
    assert any(pf for _, pf in seen)   # blocks did run beside a prefill


def test_prefilling_gauge(model):
    eng = _engine(model, max_slots=1, max_seq=128, seed=0,
                  prefill_budget=8)
    eng.submit(_prompts([60], seed=4)[0], SamplingParams(max_new_tokens=2))
    eng.step()
    assert eng.prefilling == 1 and eng.stats()["prefilling"] == 1
    assert eng.has_work() and eng.cache.num_free == 0
    eng.run_until_complete(max_steps=200)
    assert eng.stats()["prefilling"] == 0


# ---------------------------------------------------------------------- #
# mid-prefill lifecycle and faults
# ---------------------------------------------------------------------- #

def _park_one(model, **kw):
    eng = _engine(model, max_slots=1, max_seq=256, seed=0,
                  prefill_budget=16, prefill_chunk=16, **kw)
    rid = eng.submit(_prompts([150], seed=5)[0],
                     SamplingParams(max_new_tokens=4))
    eng.step()
    assert eng.prefilling == 1
    return eng, rid


@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_cancel_mid_prefill_frees_slot_and_pins(model, layout):
    # a cached head first, so the parked lane pins a path
    kw = dict(prefix_block=16) if layout == "slotted" \
        else dict(kv_layout="paged", page_size=16)
    eng, _ = _park_one(model, **kw)
    eng.run_until_complete(max_steps=100)
    # the cached prompt's first 32 tokens and a new 118-token tail
    head = _prompts([150], seed=5)[0][:32]
    rid = eng.submit(np.concatenate([head, _prompts([118], seed=8)[0]]),
                     SamplingParams(max_new_tokens=4))
    eng.step()
    assert eng.prefilling == 1 and eng._prefilling[0].pages_copied == 2
    assert any(n.ref for n in eng.prefix.root.children.values())
    assert eng.cancel(rid)
    assert eng.cache.num_free == 1 and eng.prefilling == 0
    g = eng.result(rid)
    assert g.finish_reason == "cancelled" and g.token_ids == []
    assert _unpinned(eng.prefix)
    if eng.paged:
        eng.prefix.clear()
        assert eng.cache.pool.leaked() == 0
    out = eng.generate(_prompts([6], seed=6), SamplingParams(
        max_new_tokens=3))
    assert out[0].finish_reason == "length"


def test_deadline_mid_prefill_books_queue_wait(model):
    eng = _engine(model, max_slots=1, max_seq=256, seed=0,
                  prefill_budget=16, prefill_chunk=16)
    rid = eng.submit(_prompts([150], seed=5)[0],
                     SamplingParams(max_new_tokens=4, deadline_s=0.05))
    eng.step()
    assert eng.prefilling == 1
    before = eng.metrics.queue_wait.count
    time.sleep(0.06)
    eng.step()
    g = eng.result(rid)
    assert g.finish_reason == "deadline" and g.queue_wait_s > 0
    assert eng.metrics.queue_wait.count == before + 1
    assert eng.metrics.deadline_expired == 1 and eng.cache.num_free == 1


def test_prefill_fault_exhaustion_mid_chunk_fails_only_request(model):
    eng = _engine(model, max_slots=2, max_seq=256, seed=0,
                  prefill_budget=16, prefill_chunk=16, max_retries=0)
    # fire 3 = the long prompt's second chunk (the short's prefill is
    # fire 1, the long one's aging chunk fire 2)
    plan = faults.FaultPlan().fail_at("prefill", 3)
    with faults.inject(plan):
        rids = [eng.submit(p, SamplingParams(max_new_tokens=4))
                for p in _prompts([6, 150], seed=7)]
        eng.run_until_complete(max_steps=300)
    a, b = eng.result(rids[0]), eng.result(rids[1])
    assert a.finish_reason == "length" and len(a.token_ids) == 4
    assert b.finish_reason == "error" and b.token_ids == []
    assert "injected" in b.error
    assert eng.cache.num_free == 2 and eng.metrics.failed_requests == 1
    assert plan.postmortems[0]["detail"]["failed_rids"] == [rids[1]]


@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_prefill_fault_recovery_mid_chunk_bit_identical(model, layout):
    prompts = _prompts([150, 20], seed=5)
    sps = [SamplingParams(max_new_tokens=5, temperature=0.9),
           SamplingParams(max_new_tokens=5)]
    cfg = dict(max_slots=2, max_seq=256, seed=11, prefill_budget=16,
               prefill_chunk=16)
    if layout == "paged":
        cfg.update(kv_layout="paged", page_size=16)
    ref, _ = _run(model, prompts, sps, **cfg)
    eng = _engine(model, max_retries=1, retry_backoff_s=0.0, **cfg)
    plan = faults.FaultPlan().fail_at("prefill", 4)
    with faults.inject(plan):
        rids = [eng.submit(p, sp) for p, sp in zip(prompts, sps)]
        eng.run_until_complete(max_steps=300)
    assert [eng.result(r).token_ids for r in rids] == ref
    assert eng.metrics.recoveries == 1 and plan.injected["prefill"] == 1


# ---------------------------------------------------------------------- #
# across packages
# ---------------------------------------------------------------------- #

def test_greedy_streams_match_jax_engine_interleaved(jax_model, model):
    shared = _prompts([32], seed=12)[0]
    prompts = [np.concatenate([shared, t])
               for t in _prompts((40, 5, 21, 9), seed=13)]
    kw = dict(max_slots=2, max_seq=128, seed=1, decode_block_size=4,
              attend_impl="masked", prefill_budget=16, prefill_chunk=16,
              prefix_block=16)
    jeng = JaxEngine(jax_model, register_stats=False, trace=False, **kw)
    want = [r.token_ids for r in jeng.generate(
        prompts, JaxParams(max_new_tokens=10))]
    margins = reference_margins(jax_model, prompts, want)
    print(f"smallest reference top-2 margin per stream: {margins}")
    assert min(margins) > 1e-3, f"near-tie in the reference: {margins}"
    out, eng = _run(model, prompts, [SamplingParams(max_new_tokens=10)] * 4,
                    **kw)
    assert out == want
    assert eng.stats()["prefix_tokens_reused"] == \
        jeng.stats()["prefix_tokens_reused"] > 0
