"""The port's replica fleet (`paddle_tpu_torch.serving.fleet`) against
the JAX package's `EngineFleet`, the counterpart of
`tests/test_fleet_serving.py`.

- `ReplicaHealth` takes the JAX machine's states, transitions, backoffs
  and signal counts on one scripted sequence with a fake clock.
- The replica each rid routes to equals the JAX fleet's for one scripted
  submit-and-step sequence, least-loaded and prefix-affinity, slotted
  and paged (paged replicas are priced in pages).
- Greedy fleet streams equal one port engine's and the JAX fleet's
  (reference top-2 margins > 1e-3).
- An unclean kill in the snapshot gap, a quarantine through
  post-mortem signals, prefill -> decode handoffs (pages through the KV
  tier) and a snapshot / resume leave every greedy stream bitwise an
  undisturbed engine's, with 0 stranded, 0 leaked pages and 0
  unexpected captures; a JAX fleet's snapshot resumes in the port.
- The fleet exposition strict-parses with per-replica labels, and the
  trace has a process per replica.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import EngineFleet as JaxFleet
from paddle_tpu.serving import ReplicaHealth as JaxHealth
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.obs import parse_exposition
from paddle_tpu_torch.serving import (REPLICA_STATES, EngineFleet,
                                      LLMEngine, ReplicaHealth,
                                      SamplingParams)
from paddle_tpu_torch.testing import faults

from port_streams import reference_margins
from port_threads import one_torch_thread  # noqa: F401 — autouse fixture

CFG = dict(max_slots=2, max_seq=64, seed=7, prefix_block=8)
PAGED = dict(kv_layout="paged", page_size=8)


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


def _prompts(lengths, seed=0, preamble=0):
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, 1024, (preamble,)).astype(np.int32)
    return [np.concatenate([pre, rng.randint(0, 1024, (n,)).astype(
        np.int32)]) for n in lengths]


def _fleet(model, **kw):
    kw.setdefault("register_stats", False)
    kw.setdefault("quarantine_backoff_s", 0.0)
    return EngineFleet(model, device="cpu", **{**CFG, **kw})


def _jax_fleet(model, **kw):
    kw.setdefault("register_stats", False)
    kw.setdefault("quarantine_backoff_s", 0.0)
    return JaxFleet(model, **{**CFG, **kw})


def _single(model, prompts, sp, **kw):
    eng = LLMEngine(model, device="cpu", register_stats=False,
                    **{**CFG, **kw})
    return [r.token_ids for r in eng.generate(prompts, sp)]


def _clean(fleet):
    """0 leaked pages and 0 unexpected captures on every live replica."""
    for eng in fleet.live_engines():
        assert eng.watchdog.compiles_unexpected == 0
        if eng.paged:
            if eng.prefix is not None:
                eng.prefix.clear()
            assert eng.cache.pool.leaked() == 0


def _health_trace(cls):
    h = cls(quarantine_after=2, backoff_s=0.5, backoff_max_s=1.5)
    out = []

    def note(*ret):
        out.append((h.state, h.fail_streak, h.level, h.backoff(),
                    h.accepts_traffic) + ret)

    note(h.note_failure("decode_retry_exhausted", 1.0))
    h.note_success(1.5)
    note()
    note(h.note_failure("compiles_unexpected", 2.0))
    note(h.note_failure("deadline_misses", 3.0))
    note(h.ready_for_probe(3.4), h.ready_for_probe(3.5))
    h.begin_probe(3.5)
    note()
    h.probe_result(False, 4.0)
    note(h.ready_for_probe(4.9), h.ready_for_probe(5.0))
    h.begin_probe(5.0)
    h.probe_result(False, 5.5)
    note(h.note_failure("admission_failed", 5.6))   # counted, no move
    h.begin_probe(7.0)
    h.probe_result(True, 7.1)
    note()
    h.kill(8.0)
    note(h.note_failure("decode_retry_exhausted", 8.5))
    h.revive(9.0)
    note(h.ready_for_probe(9.0))
    h.begin_probe(9.0)
    h.probe_result(True, 9.1)
    h.await_canary(10.0)
    note(h.ready_for_probe(10.0))
    h.begin_drain(11.0)
    note(h.note_failure("step_exception", 11.5))
    return out, list(h.transitions), dict(h.signals)


def test_replica_health_equals_jax():
    assert _health_trace(ReplicaHealth) == _health_trace(JaxHealth)
    assert REPLICA_STATES == ("healthy", "suspect", "quarantined",
                              "recovering", "draining", "dead")
    with pytest.raises(ValueError):
        ReplicaHealth(quarantine_after=0)
    with pytest.raises(RuntimeError):
        ReplicaHealth().revive(0.0)


def _routes(fleet, params_cls, waves):
    """Submit each wave, then step the fleet once; the owner of every
    rid at its placement."""
    out = []
    for wave in waves:
        for p in wave:
            rid = fleet.submit(p, params_cls(max_new_tokens=6))
            out.append(fleet._tracked[rid].replica)
        fleet.step()
    fleet.run_until_complete(max_steps=300)
    stats = fleet.stats()
    return out, {k: stats[k] for k in ("routed_affinity", "routed_spill")}


@pytest.mark.parametrize("layout", ["slotted", "paged"])
@pytest.mark.parametrize("routing", ["least_loaded", "prefix_affinity"])
def test_routing_equals_jax(model, jax_model, routing, layout):
    kw = dict(replicas=3, routing=routing, affinity_slack=1,
              **(PAGED if layout == "paged" else {}))
    shared = _prompts([5, 9, 3, 12, 7, 4, 10, 6], seed=3, preamble=16)
    other = _prompts([11, 5, 8], seed=4)
    waves = [shared[:1], shared[1:4] + other[:1], shared[4:6] + other[1:],
             shared[6:]]
    fleet, jfleet = _fleet(model, **kw), _jax_fleet(jax_model, **kw)
    got = _routes(fleet, SamplingParams, waves)
    want = _routes(jfleet, JaxParams, waves)
    assert got == want
    assert len(set(got[0])) == 3
    if routing == "prefix_affinity":
        assert got[1]["routed_affinity"] > 0
    _clean(fleet)


def test_greedy_streams_equal_single_engine_and_jax(model, jax_model):
    # one prompt length: the reference's margin check compiles once
    prompts = _prompts([9] * 8, seed=2, preamble=8)
    sp = SamplingParams(max_new_tokens=8)
    jf = _jax_fleet(jax_model, replicas=3, routing="prefix_affinity")
    want = [r.token_ids for r in jf.generate(prompts,
                                             JaxParams(max_new_tokens=8))]
    assert min(reference_margins(jax_model, prompts, want)) > 1e-3
    assert _single(model, prompts, sp) == want
    for routing in ("least_loaded", "prefix_affinity"):
        fleet = _fleet(model, replicas=3, routing=routing)
        assert [r.token_ids for r in fleet.generate(prompts, sp)] == want
        _clean(fleet)


def test_failover_and_quarantine_bitwise(model):
    prompts = _prompts([5, 12, 9, 3, 7, 16, 4, 10, 6], seed=2)
    sp = SamplingParams(max_new_tokens=10)
    want = _single(model, prompts, sp)
    fleet = _fleet(model, replicas=3, snapshot_every=2)
    rids = [fleet.submit(p, sp) for p in prompts[:6]]
    fleet.step()
    fleet.step()
    rids += [fleet.submit(p, sp) for p in prompts[6:]]  # snapshot gap
    fleet.step()
    victim = fleet.busiest()
    fleet.kill(victim)
    fleet.revive(victim)
    fleet.run_until_complete(max_steps=400)
    assert [fleet.result(r).token_ids for r in rids] == want
    st = fleet.stats()
    assert st["failovers"] == 1 and st["canary_ok"] == 1
    assert st["requests_readmitted"] + st["requests_resubmitted"] > 0
    assert fleet.flight.reports[-1]["reason"] == "replica_failover"
    _clean(fleet)
    # post-mortems are health signals: two prefill failures on replica 0
    # quarantine it, its work fails over, its canary re-admits it
    fleet = _fleet(model, replicas=2, quarantine_after=2, max_retries=0)
    plan = faults.FaultPlan().fail_at("prefill", 1, 2)
    with faults.inject(plan):
        res = fleet.generate(prompts[:4], sp)
    assert [r.finish_reason for r in res].count("error") == 2
    trail = [(a, b) for _, a, b, _ in
             fleet._replicas[0].health.transitions]
    assert trail[:2] == [("healthy", "suspect"),
                         ("suspect", "quarantined")]
    assert fleet.stats()["quarantines"] == 1
    ok = [r.token_ids for r in res if r.finish_reason != "error"]
    assert all(t in want[:4] for t in ok)
    _clean(fleet)


def test_handoff_through_the_tier_bitwise(model):
    prompts = _prompts([20, 12, 9, 17, 7, 14], seed=8, preamble=8)
    sp = SamplingParams(max_new_tokens=12)
    want = _single(model, prompts, sp, **PAGED)
    fleet = _fleet(model, replicas=3, roles=("prefill", "decode", "decode"),
                   kv_tier=True, **PAGED)
    got = [r.token_ids for r in fleet.generate(prompts, sp)]
    assert got == want
    st = fleet.stats()
    assert st["handoffs"] > 0 and st["tier_handoffs"] == st["handoffs"]
    assert st["handoff_pages_moved"] > 0
    assert st["kv_tier_handoffs_open"] == 0
    assert st["kv_tier_publishes"] > 0
    # the adopters uploaded the pages: no decode replica prefilled
    for r in fleet._replicas[1:]:
        assert r.engine.metrics.kv_tier_hits > 0
    _clean(fleet)
    # tp > 1 is ported: each replica is a TP group of its own ranks
    # (tests/test_torch_tp_fleet.py drives it)
    tp_fleet = _fleet(model, replicas=1, tp=2)
    assert tp_fleet._replicas[0].engine.mesh.ranks == (0, 1)
    tp_fleet.close()


def test_snapshot_resume_port_and_jax(model, jax_model):
    prompts = _prompts([6, 9, 7, 11], seed=34)
    sp = SamplingParams(max_new_tokens=40)
    want = _single(model, prompts, sp)
    fleet = _fleet(model, replicas=2)
    rids = [fleet.submit(p, sp) for p in prompts]
    for _ in range(3):
        fleet.step()
    snap = fleet.snapshot()
    fleet.close()
    resumed = EngineFleet.resume(model, snap)
    resumed.run_until_complete(max_steps=300)
    assert [resumed.result(r).token_ids for r in rids] == want
    # a JAX fleet's snapshot continues in the port
    jf = _jax_fleet(jax_model, replicas=2)
    jr = [jf.submit(p, JaxParams(max_new_tokens=40)) for p in prompts]
    for _ in range(2):
        jf.step()
    jsnap = jf.snapshot()
    assert any(d["generated"] for d in jsnap["requests"])
    port = EngineFleet.resume(model, jsnap, device="cpu")
    port.run_until_complete(max_steps=300)
    assert [port.result(r).token_ids for r in jr] == want
    _clean(port)


def test_prometheus_and_trace(model):
    fleet = _fleet(model, replicas=2, routing="prefix_affinity")
    fleet.generate(_prompts([5, 9, 7], seed=1, preamble=8),
                   SamplingParams(max_new_tokens=4))
    fleet.kill(1)
    fleet.revive(1)
    for _ in range(3):
        fleet.step()                 # the canary re-admits replica 1
    parsed = parse_exposition(fleet.to_prometheus())
    assert "paddle_tpu_fleet_kills_total" in parsed
    labels = {s[1].get("replica") for s in
              parsed["paddle_tpu_replica_generated_tokens"]["samples"]}
    assert labels == {"0", "1"}
    trace = fleet.export_trace()
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("name") == "process_name"}
    assert {"replica 0", "replica 1"} <= names
    assert {k for _, k, _, _ in fleet.events()} >= {"kill", "revive",
                                                    "canary", "canary_ok"}
    fleet.close()
    with pytest.raises(RuntimeError, match="closed"):
        fleet.submit(np.arange(4), SamplingParams())
