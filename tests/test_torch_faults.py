"""Fault injection (`paddle_tpu_torch/testing/faults.py`) and the
serving engine's recovery contract, on `gpt_tiny` on the CPU.

- The port's `FaultPlan` is the JAX package's: the same `POINTS`, and
  one plan (`fail_at` schedules and crc32-keyed `fail_rate` streams)
  fires at the same call numbers in both packages.
- The reference's recovery cases (`tests/test_serving_faults.py`) held
  inside the port, for the points the port fires: a `decode_dispatch`
  or `host_sync` fault under overlap recovers with streams bitwise
  equal to a clean run (greedy and sampled lanes; slotted and paged, fp
  and int8 KV, speculation with the trunc and the int8 draft); a
  `prefill` fault recovers bit-identically; retry exhaustion fails only
  the active requests and the engine keeps serving; prefill exhaustion
  fails one request alone; a cancel keeps the survivors' streams; a
  failing draft degrades its block to plain decode (`spec_fallbacks`)
  and never fails a request or spends a retry; seeded chaos soaks end
  with every request terminal, every slot and page back, and a
  post-mortem naming every failed request.
"""
import numpy as np
import pytest

from paddle_tpu.testing import faults as jax_faults
from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.testing import faults
from port_threads import one_torch_thread  # noqa: F401

# the engine configurations every recovery case runs on
CONFIGS = {
    "slotted": {},
    "paged": dict(kv_layout="paged", page_size=16),
    "int8_kv": dict(kv_dtype="int8"),
    "paged_int8_kv": dict(kv_layout="paged", page_size=16, kv_dtype="int8"),
    "spec_trunc": dict(speculate_k=2),
    "spec_int8": dict(speculate_k=2, draft="int8"),
}


@pytest.fixture(scope="module")
def model():
    return gpt_tiny(seed=0, device="cpu")


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _mixed_params():
    """Greedy + temperature + top-k lanes: recovery must keep sampled
    streams aligned too, not just argmax ones."""
    return [SamplingParams(max_new_tokens=30),
            SamplingParams(max_new_tokens=26, temperature=0.9),
            SamplingParams(max_new_tokens=20, temperature=0.8, top_k=16),
            SamplingParams(max_new_tokens=22)]


def _engine(model, **kw):
    kw.setdefault("max_seq", 64)
    kw.setdefault("decode_block_size", 4)
    return LLMEngine(model, device="cpu", **kw)


def _generate(eng, prompts, params):
    """`generate` with a bound on the scheduler steps, so that a broken
    recovery fails instead of spinning."""
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run_until_complete(max_steps=500)
    return [eng.result(r) for r in rids]


def _run_clean(model, prompts, params, **kw):
    """Fault-free reference run (fresh engine, same seed/config)."""
    return [r.token_ids for r in _generate(_engine(model, **kw), prompts,
                                           params)]


def _drained(eng):
    assert eng.cache.num_free == eng.max_slots and not eng.has_work()
    if eng.paged:
        assert eng.cache.pool.leaked() == 0


# --------------------------------------------------------------------------- #
# the harness, against the JAX package's
# --------------------------------------------------------------------------- #

def test_points_equal_jax():
    assert faults.POINTS == jax_faults.POINTS
    assert list(faults.POINTS) == sorted(faults.POINTS)
    for p in ("decode_dispatch", "draft_dispatch", "host_sync", "prefill"):
        assert p in faults.POINTS


PLANS = {
    "fail_at": lambda m: m.FaultPlan().fail_at("decode_dispatch", 2, 5)
    .fail_at("prefill", 1).fail_at("host_sync", 3, 4),
    "fail_rate": lambda m: m.FaultPlan()
    .fail_rate("decode_dispatch", 0.15, seed=7)
    .fail_rate("host_sync", 0.1, seed=7).fail_rate("prefill", 0.3, seed=3),
    "both": lambda m: m.FaultPlan().fail_at("draft_dispatch", 2)
    .fail_rate("draft_dispatch", 0.4, seed=13)
    .fail_rate("decode_dispatch", 0.05, seed=13),
}


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_plan_fires_at_jax_call_numbers(plan_name):
    """One interleaved call sequence over four points through each
    package's plan: the same calls raise, with the same call numbers."""
    rng = np.random.RandomState(1)
    points = ["decode_dispatch", "draft_dispatch", "host_sync", "prefill"]
    calls = [points[i] for i in rng.randint(0, 4, 300)]

    def drive(module):
        plan = PLANS[plan_name](module)
        hits = []
        with module.inject(plan):
            for p in calls:
                try:
                    module.fire(p)
                except module.InjectedFault as e:
                    hits.append((e.point, e.call_no))
        return hits, plan.calls, plan.injected

    port, ref = drive(faults), drive(jax_faults)
    assert port == ref
    assert port[0]


def test_unknown_point_rejected():
    with pytest.raises(ValueError, match="unknown injection point"):
        faults.FaultPlan().fail_at("decode_dospatch", 1)
    with pytest.raises(ValueError, match="1-based"):
        faults.FaultPlan().fail_at("prefill", 0)
    with pytest.raises(ValueError, match="rate"):
        faults.FaultPlan().fail_rate("prefill", 1.5)


def test_schedule_and_counters():
    plan = faults.FaultPlan().fail_at("prefill", 2, 4)
    with faults.inject(plan):
        for expect_raise in (False, True, False, True, False):
            if expect_raise:
                with pytest.raises(faults.InjectedFault):
                    faults.fire("prefill")
            else:
                faults.fire("prefill")
    assert plan.calls["prefill"] == 5
    assert plan.injected["prefill"] == 2
    assert faults.active_plan() is None
    faults.fire("prefill")  # disarmed: no-op


# --------------------------------------------------------------------------- #
# dispatch recovery
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("point,call", [("decode_dispatch", 2),
                                        ("host_sync", 2),
                                        ("host_sync", 4)])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_dispatch_fault_recovers_bit_identical(model, config, point, call):
    """An injected dispatch or sync failure under overlap (the default):
    the in-flight blocks are discarded, the lane state re-uploaded from
    the host mirrors, and the mixed batch completes bitwise equal to a
    fault-free run."""
    prompts = _prompts([5, 16, 9, 3], seed=2)
    params = _mixed_params()
    cfg = dict(max_slots=2, seed=77, **CONFIGS[config])
    ref = _run_clean(model, prompts, params, **cfg)
    eng = _engine(model, max_retries=2, retry_backoff_s=0.0, **cfg)
    plan = faults.FaultPlan().fail_at(point, call)
    with faults.inject(plan):
        out = [r.token_ids for r in _generate(eng, prompts, params)]
    assert out == ref
    assert plan.injected[point] == 1
    m = eng.metrics
    assert m.retries == m.recoveries == 1 and m.failed_requests == 0
    assert m.host_syncs == m.decode_dispatches
    _drained(eng)


def test_retry_exhaustion_fails_active_keeps_serving(model):
    """Graceful degradation: when decode stays down past max_retries,
    only the requests that cannot make progress fail ('error', with the
    cause attached); queued requests then admit and complete."""
    prompts = _prompts([4, 6, 5, 7], seed=3)
    sp = SamplingParams(max_new_tokens=6)
    eng = _engine(model, max_slots=2, seed=5, max_retries=1,
                  retry_backoff_s=0.0)
    plan = faults.FaultPlan().fail_at("decode_dispatch", 1, 2)
    with faults.inject(plan):
        res = _generate(eng, prompts, [sp] * 4)
    assert [r.finish_reason for r in res] == \
        ["error", "error", "length", "length"]
    for r in res[:2]:
        assert "injected fault" in r.error
        assert len(r.token_ids) >= 1  # keeps the prefill token
    for r in res[2:]:
        assert r.error is None and len(r.token_ids) == 6
    m = eng.metrics
    assert m.failed_requests == 2
    assert m.requests_completed == 2  # successes only
    assert m.retries == 1 and m.recoveries == 0
    assert [rep["detail"]["failed_rids"] for rep in plan.postmortems] == \
        [[res[0].request_id, res[1].request_id]]
    assert plan.postmortems[0]["reason"] == "decode_retry_exhausted"
    assert plan.postmortems[0]["config"]["max_retries"] == 1
    _drained(eng)


def test_prefill_fault_recovers_bit_identical(model):
    """An admission-time failure retries the same slot from row 0; the
    first-token key is drawn once per request, so the recovered run is
    bit-identical even for sampled lanes."""
    prompts = _prompts([6, 11], seed=4)
    params = [SamplingParams(max_new_tokens=5, temperature=0.9),
              SamplingParams(max_new_tokens=5)]
    cfg = dict(max_slots=2, seed=21)
    ref = _run_clean(model, prompts, params, **cfg)
    eng = _engine(model, max_retries=1, retry_backoff_s=0.0, **cfg)
    plan = faults.FaultPlan().fail_at("prefill", 1)
    with faults.inject(plan):
        out = [r.token_ids for r in _generate(eng, prompts, params)]
    assert out == ref
    assert eng.metrics.recoveries == 1


@pytest.mark.parametrize("config", ["slotted", "paged"])
def test_prefill_exhaustion_fails_single_request(model, config):
    """With retries off, a failing prefill takes down ONLY the request
    being admitted; its neighbour serves normally, and its slot (and
    pages) come back."""
    prompts = _prompts([6, 11], seed=4)
    sp = SamplingParams(max_new_tokens=5)
    eng = _engine(model, max_slots=2, seed=21, max_retries=0,
                  **CONFIGS[config])
    plan = faults.FaultPlan().fail_at("prefill", 1)
    with faults.inject(plan):
        res = _generate(eng, prompts, [sp, sp])
    assert res[0].finish_reason == "error"
    assert res[0].token_ids == [] and "injected" in res[0].error
    assert res[1].finish_reason == "length"
    assert len(res[1].token_ids) == 5
    assert eng.metrics.failed_requests == 1
    assert plan.postmortems[0]["reason"] == "admission_failed"
    assert plan.postmortems[0]["detail"]["failed_rids"] == \
        [res[0].request_id]
    _drained(eng)


@pytest.mark.parametrize("overlap", [False, True])
def test_cancel_active_preserves_survivor_streams(model, overlap):
    """Freeze-on-cancel with a block possibly in flight: the cancelled
    request keeps its emitted tokens (a prefix of what it would have
    produced, its in-flight emits dropped) and frees its slot at a
    block boundary; the surviving lanes, greedy AND sampled, are
    bit-identical to a run with no cancel."""
    prompts = _prompts([5, 8, 6], seed=6)
    params = [SamplingParams(max_new_tokens=30),
              SamplingParams(max_new_tokens=30),
              SamplingParams(max_new_tokens=30, temperature=0.9)]
    cfg = dict(max_slots=3, seed=9, overlap=overlap)
    ref = _run_clean(model, prompts, params, **cfg)
    eng = _engine(model, **cfg)
    rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    for _ in range(2):
        eng.step()
    assert (eng._inflight is not None) == overlap   # a lookahead block
    assert eng.cancel(rids[1]) is True
    assert eng.cancel(rids[1]) is False   # already cancelled
    assert eng.cancel(12345) is False     # unknown
    eng.run_until_complete(max_steps=200)
    r0, r1, r2 = (eng.result(r) for r in rids)
    assert r0.token_ids == ref[0]
    assert r2.token_ids == ref[2]
    assert r1.finish_reason == "cancelled"
    assert 1 <= len(r1.token_ids) < 30
    assert r1.token_ids == ref[1][:len(r1.token_ids)]
    assert eng.metrics.requests_cancelled == 1
    _drained(eng)


# --------------------------------------------------------------------------- #
# the draft_dispatch degrade
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("draft", ["trunc", "int8"])
def test_draft_fault_degrades_to_plain_block(model, draft):
    """A failing draft costs its block the speedup only: the block runs
    the plain program, streams equal the spec-off engine's, no retry is
    spent and no request fails."""
    prompts = _prompts([5, 16, 9, 3], seed=2)
    params = _mixed_params()
    ref = _run_clean(model, prompts, params, max_slots=2, seed=77)
    eng = _engine(model, max_slots=2, seed=77, speculate_k=2, draft=draft)
    plan = faults.FaultPlan().fail_at("draft_dispatch", 1, 3, 4)
    with faults.inject(plan):
        out = [r.token_ids for r in _generate(eng, prompts, params)]
    assert out == ref
    m = eng.metrics
    assert m.spec_fallbacks == plan.injected["draft_dispatch"] == 3
    assert m.spec_blocks == m.decode_dispatches - 3
    assert m.retries == 0 and m.failed_requests == 0
    assert sorted(eng._runners) == [False, True]
    _drained(eng)


def test_spec_chaos_soak_degrades_never_strands(model):
    """Seeded-random injection over draft_dispatch AND the standard
    recovery points while a speculative engine serves mixed traffic:
    every request terminal, all slots drain back, no retry spent on a
    draft failure, and the surviving streams bit-identical to an
    undisturbed spec-OFF run."""
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, 1024, (int(rng.randint(3, 30)),))
               .astype(np.int32) for _ in range(10)]
    params = [SamplingParams(
        max_new_tokens=int(rng.randint(4, 14)),
        temperature=float(rng.choice([0.0, 0.9])))
        for _ in prompts]
    ref = _run_clean(model, prompts, params, max_slots=3, seed=23)
    plan = (faults.FaultPlan()
            .fail_rate("draft_dispatch", 0.4, seed=13)
            .fail_rate("decode_dispatch", 0.05, seed=13)
            .fail_rate("prefill", 0.05, seed=13))
    eng = _engine(model, max_slots=3, seed=23, max_retries=4,
                  retry_backoff_s=0.0, speculate_k=2)
    with faults.inject(plan):
        rids = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
        eng.run_until_complete(max_steps=2000)
    assert plan.injected.get("draft_dispatch", 0) > 0
    results = [eng.result(r) for r in rids]
    assert all(r.finish_reason in ("stop", "length", "error")
               for r in results)
    assert eng.metrics.spec_fallbacks == plan.injected["draft_dispatch"]
    _drained(eng)
    assert eng.metrics.retries <= (
        plan.injected.get("decode_dispatch", 0)
        + plan.injected.get("prefill", 0)) * eng.max_retries
    for got, want, r in zip([r.token_ids for r in results], ref, results):
        if r.finish_reason == "error":
            assert got == want[:len(got)]
        else:
            assert got == want


@pytest.mark.parametrize("config", ["slotted", "paged_int8_kv"])
def test_randomized_fault_soak(model, config):
    """Seeded-random injection across the port's three engine points
    while mixed traffic flows: every request ends terminal, slots and
    pages drain back, the counters reconcile, and every failed request
    is named by a post-mortem collected by the armed plan."""
    rng = np.random.RandomState(7)
    plan = (faults.FaultPlan()
            .fail_rate("decode_dispatch", 0.15, seed=7)
            .fail_rate("host_sync", 0.10, seed=7)
            .fail_rate("prefill", 0.10, seed=7))
    eng = _engine(model, max_slots=4, max_queue=64, max_seq=96, seed=17,
                  max_retries=1, retry_backoff_s=0.0, **CONFIGS[config])
    rids = []
    with faults.inject(plan):
        for _ in range(4):
            for _ in range(6):
                n = int(rng.randint(2, 40))
                p = rng.randint(0, 1024, (n,)).astype(np.int32)
                rids.append(eng.submit(p, SamplingParams(
                    max_new_tokens=int(rng.randint(1, 12)),
                    temperature=float(rng.choice([0.0, 0.8])))))
            for _ in range(int(rng.randint(1, 5))):
                eng.step()
        eng.run_until_complete(max_steps=2000)
    assert sum(plan.injected.values()) > 0
    results = {r: eng.result(r) for r in rids}
    assert all(results[r].finish_reason in ("stop", "length", "error")
               for r in rids)
    m = eng.metrics
    assert m.requests_submitted == len(rids) == 24
    assert m.requests_completed + m.failed_requests == len(rids)
    _drained(eng)
    failed = {r for r in rids if results[r].finish_reason == "error"}
    named = set()
    for rep in plan.postmortems:
        named.update(rep["detail"]["failed_rids"])
    assert failed == named
