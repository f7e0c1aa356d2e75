"""The port's fleet autoscaler (`paddle_tpu_torch.serving.autoscale`)
against the JAX package's, the counterpart of `tests/test_autoscale.py`.

- `AutoscalePolicy.decide` returns the JAX policy's decisions over one
  signal trace on a fake clock (holds, cooldowns, the dead band, the
  bounds), with the same validation.
- A `FleetAutoscaler` on a port fleet scales out under a backlog (the
  new replica enters through its canary), scales in when the load is
  gone (a graceful drain whose moved greedy streams stay bitwise), and
  replaces a replica whose heartbeat went stale (killed, removed,
  respawned): every request terminal, 0 stranded, 0 leaked pages, 0
  unexpected captures, and the controller's families strict-parse.
"""
import time

import numpy as np
import pytest

from paddle_tpu.serving import AutoscalePolicy as JaxPolicy
from paddle_tpu.serving import ScaleSignals as JaxSignals
from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.obs import parse_exposition
from paddle_tpu_torch.serving import (AutoscalePolicy, EngineFleet,
                                      FleetAutoscaler, LLMEngine,
                                      SamplingParams, ScaleSignals)
from paddle_tpu_torch.testing import faults

from port_threads import one_torch_thread  # noqa: F401 — autouse fixture

CFG = dict(max_slots=2, max_seq=64, seed=7, prefix_block=8,
           kv_layout="paged", page_size=8, device="cpu",
           register_stats=False)


@pytest.fixture(scope="module")
def model():
    return gpt_tiny(seed=0, device="cpu")


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int32) for n in lengths]


def _decisions(policy_cls, signals_cls):
    clk = _Clock()
    pol = policy_cls(min_replicas=1, max_replicas=3, out_backlog=2.0,
                     in_backlog=0.25, out_pressure=0.85, in_pressure=0.3,
                     out_hold_s=0.5, in_hold_s=2.0, out_cooldown_s=1.0,
                     in_cooldown_s=3.0, clock=clk)
    trace = [  # (dt, serving, total, backlog, occupancy)
        (0.0, 1, 1, 3.0, 0.1), (0.3, 1, 1, 3.0, 0.1),
        (0.3, 1, 1, 3.0, 0.1), (0.1, 2, 2, 0.5, 0.9),
        (0.2, 2, 2, 0.5, 0.9), (0.5, 2, 2, 0.5, 0.9),
        (0.6, 2, 2, 0.5, 0.95), (0.1, 3, 3, 5.0, 0.99),
        (1.0, 3, 3, 0.1, 0.1), (1.0, 3, 3, 1.0, 0.5),
        (0.5, 3, 3, 0.1, 0.1), (2.5, 3, 3, 0.1, 0.1),
        (0.5, 2, 2, 0.0, 0.0), (2.1, 2, 2, 0.0, 0.0),
        (1.5, 2, 2, 0.0, 0.0), (2.0, 1, 1, 0.0, 0.0),
        (5.0, 1, 1, 0.0, 0.0), (0.1, 1, 2, 4.0, 0.2),
    ]
    out = []
    for dt, serving, total, backlog, occ in trace:
        clk.t += dt
        d = pol.decide(signals_cls(replicas_serving=serving,
                                   replicas_total=total, backlog=backlog,
                                   occupancy=occ))
        if d is not None:
            pol.note_action(d)
        out.append(d)
    return out


def test_policy_decisions_equal_jax():
    got = _decisions(AutoscalePolicy, ScaleSignals)
    assert got == _decisions(JaxPolicy, JaxSignals)
    assert "out" in got and "in" in got
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(in_backlog=3.0, out_backlog=2.0)):
        with pytest.raises(ValueError):
            AutoscalePolicy(**bad)
        with pytest.raises(ValueError):
            JaxPolicy(**bad)


def _leak_free(fleet):
    for eng in fleet.live_engines():
        assert eng.watchdog.compiles_unexpected == 0
        eng.prefix.clear()
        assert eng.cache.pool.leaked() == 0


def test_scale_out_then_in_bitwise(model):
    prompts = _prompts([5, 9, 7, 11, 6, 8, 10, 4], seed=3)
    sp = SamplingParams(max_new_tokens=16)
    want = [r.token_ids for r in LLMEngine(model, **CFG).generate(
        prompts, sp)]
    fleet = EngineFleet(model, replicas=1, quarantine_backoff_s=0.0, **CFG)
    clk = _Clock()
    scaler = FleetAutoscaler(
        fleet, AutoscalePolicy(min_replicas=1, max_replicas=3,
                               out_backlog=2.0, out_hold_s=0.0,
                               out_cooldown_s=0.0, in_hold_s=0.0,
                               in_cooldown_s=0.0, clock=clk),
        clock=clk)
    rids = [fleet.submit(p, sp) for p in prompts]
    steps = 0
    while fleet.has_work():
        fleet.step()
        clk.t += 0.1
        steps += 1
        assert steps < 500
    assert [fleet.result(r).token_ids for r in rids] == want
    st = fleet.stats()
    assert scaler.scale_outs >= 1 and st["replicas_added"] >= 1
    assert st["canary_ok"] >= 1                  # spawns entered warm
    # the load is gone: the policy drains back to the floor
    for _ in range(20):
        fleet.step()
        clk.t += 0.5
    assert scaler.scale_ins >= 1
    assert fleet.stats()["replicas"] == 1
    parse_exposition(fleet.to_prometheus())
    assert any(k == "scale_in" for _, k, _, _ in fleet.events())
    _leak_free(fleet)
    fleet.close()


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy",
                                                          "sampled"])
def test_drain_moves_streams_bitwise(model, temperature):
    prompts = _prompts([5, 9, 13, 7, 11], seed=3)
    sp = SamplingParams(max_new_tokens=20, temperature=temperature,
                        top_p=0.9)
    want = [r.token_ids for r in LLMEngine(model, **CFG).generate(
        prompts, sp)]
    fleet = EngineFleet(model, replicas=1, snapshot_every=2,
                        quarantine_backoff_s=0.0, **CFG)
    rids = [fleet.submit(p, sp) for p in prompts]
    for _ in range(3):
        fleet.step()              # some decoding, some still queued
    assert fleet.add_replica() == 1
    for _ in range(50):           # the canary admits the new replica
        fleet.step()
        if fleet.replica_states() == ["healthy", "healthy"]:
            break
    assert fleet.replica_states() == ["healthy", "healthy"]
    fleet.retire_replica(0)
    fleet.run_until_complete(max_steps=300)
    # the drain moved every live stream with its salt (keep_salt and
    # the victim's salt clock): sampled streams hold too
    assert [fleet.result(r).token_ids for r in rids] == want
    st = fleet.stats()
    assert st["requests_drained"] > 0 and st["replicas"] == 1
    assert st["replicas_retired"] == 1
    with pytest.raises(RuntimeError, match="last live"):
        fleet.retire_replica(1)
    _leak_free(fleet)


def test_stale_heartbeat_replaced_without_stranding(model):
    prompts = _prompts([5, 8, 11, 6, 9, 12], seed=5)
    sp = SamplingParams(max_new_tokens=12)
    want = [r.token_ids for r in LLMEngine(model, **CFG).generate(
        prompts, sp)]
    fleet = EngineFleet(model, replicas=2, snapshot_every=1,
                        quarantine_backoff_s=0.0, **CFG)
    scaler = FleetAutoscaler(
        fleet, AutoscalePolicy(min_replicas=2, max_replicas=3,
                               out_hold_s=99.0, in_hold_s=99.0),
        heartbeat_timeout_s=0.05)
    # beats fire once per replica per round in replica order: failing
    # every 2nd call starves replica 1 while replica 0 keeps beating
    plan = faults.FaultPlan().fail_at("replica_heartbeat",
                                      *range(2, 2001, 2))
    rids = [fleet.submit(p, sp) for p in prompts]
    with faults.inject(plan):
        steps = 0
        while fleet.has_work():
            fleet.step()
            time.sleep(0.01)
            steps += 1
            assert steps < 1000
    assert scaler.preemptions_detected >= 1
    assert len(fleet.replica_states()) == 2
    assert any(k == "scale_out" and "replace" in d
               for _, k, d in scaler.events())
    assert [fleet.result(r).token_ids for r in rids] == want
    fam = parse_exposition(fleet.to_prometheus())
    assert fam["paddle_tpu_autoscaler_preemptions_total"]["samples"][0][2] \
        >= 1
    # a failed spawn degrades to the current size, never to an error
    with faults.inject(faults.FaultPlan().fail_at("replica_spawn", 1)):
        assert fleet.add_replica() == -1
    assert fleet.stats()["scale_failures"] == 1
    _leak_free(fleet)
    fleet.close()
