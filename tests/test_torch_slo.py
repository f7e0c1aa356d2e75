"""The port's SLO admission (`paddle_tpu_torch.serving.slo`) and the
front door's metrics surface (`ServerMetrics`) against the JAX
package's, the counterpart of `tests/test_server.py`'s policy cases.

- `TokenBucket` and `SLOController`: the reference's cases, on the
  port's classes (an injectable clock: no sleeping).
- One scripted `admit` / `finish` sequence on a fake clock, charged in
  tokens and in pages, gives the same `Admission` fields, shed counts
  and `snapshot()` in both packages at every step.
- `ServerMetrics.to_families` renders the same exposition text in both
  packages after the same events, and it strict-parses.
"""
import dataclasses
import math

import numpy as np
import pytest

from paddle_tpu.obs.prometheus import render_families as jax_render
from paddle_tpu.serving.server import ServerMetrics as JaxServerMetrics
from paddle_tpu.serving.slo import SLOController as JaxSLOController
from paddle_tpu.serving.slo import TenantPolicy as JaxTenantPolicy
from paddle_tpu_torch.obs import parse_exposition, render_families
from paddle_tpu_torch.serving import (SHED_REASONS, Admission,
                                      ServerMetrics, SLOController,
                                      TenantPolicy, TokenBucket)
from paddle_tpu_torch.serving import slo as port_slo

from port_threads import one_torch_thread  # noqa: F401 — autouse fixture


class TestTokenBucket:
    def test_burst_then_exact_refill_wait(self):
        b = TokenBucket(capacity=10, refill_per_s=2.0, now=0.0)
        assert b.try_take(10, now=0.0) == 0.0        # burst admits
        wait = b.try_take(4, now=0.0)                # empty: 4/2 = 2s
        assert wait == pytest.approx(2.0)
        assert b.level == 0.0                        # shed never debits
        assert b.try_take(4, now=2.0) == 0.0         # refilled exactly
        assert b.try_take(1, now=2.0) > 0.0

    def test_oversize_and_zero_rate_wait_forever(self):
        b = TokenBucket(capacity=5, refill_per_s=1.0, now=0.0)
        assert math.isinf(b.try_take(6, now=0.0))    # can never hold 6
        z = TokenBucket(capacity=5, refill_per_s=0.0, now=0.0)
        z.try_take(5, now=0.0)
        assert math.isinf(z.try_take(1, now=0.0))

    def test_refund_caps_at_capacity(self):
        b = TokenBucket(capacity=5, refill_per_s=0.0, now=0.0)
        assert b.try_take(5, now=0.0) == 0.0
        b.refund(3)
        assert b.level == 3.0
        b.refund(99)
        assert b.level == 5.0

    def test_rejects_negative_settings(self):
        with pytest.raises(ValueError):
            TokenBucket(capacity=-1, refill_per_s=1.0)
        with pytest.raises(ValueError):
            TenantPolicy(max_streams=0)


class TestSLOController:
    def _ctl(self, **kw):
        clock = {"t": 0.0}
        kw.setdefault("policies", {
            "tight": TenantPolicy(tokens_per_s=10.0, burst_tokens=30.0,
                                  max_streams=2, priority=0),
            "pro": TenantPolicy(priority=3),
        })
        ctl = SLOController(clock=lambda: clock["t"], **kw)
        return ctl, clock

    def test_budget_shed_with_honest_retry_after(self):
        ctl, clock = self._ctl()
        a1 = ctl.admit("tight", 20)
        assert a1.admitted and a1.tokens == 20
        a2 = ctl.admit("tight", 20)                  # 10 left, needs 20
        assert not a2.admitted and a2.reason == "token_budget"
        assert a2.retry_after_s == pytest.approx(1.0)  # 10 short @10/s
        clock["t"] = 1.0                             # refill catches up
        assert ctl.admit("tight", 20).admitted

    def test_stream_cap_and_finish_release(self):
        ctl, clock = self._ctl()
        a = [ctl.admit("tight", 1) for _ in range(3)]
        assert [x.admitted for x in a] == [True, True, False]
        assert a[2].reason == "stream_cap"
        ctl.finish(a[0], tokens_used=1)
        assert ctl.admit("tight", 1).admitted        # slot freed

    def test_backpressure_is_checked_first(self):
        ctl, _ = self._ctl(max_inflight=1)
        assert ctl.admit("pro", 1).admitted
        a = ctl.admit("tight", 10 ** 9)              # over budget TOO
        assert not a.admitted and a.reason == "backpressure"

    def test_finish_refunds_unused_reservation(self):
        ctl, clock = self._ctl()
        a = ctl.admit("tight", 30)                   # drains the burst
        assert a.admitted
        assert not ctl.admit("tight", 30).admitted
        ctl.finish(a, tokens_used=5)                 # 25 refunded
        assert ctl.admit("tight", 25).admitted

    def test_policy_priority_flows_into_admission(self):
        ctl, _ = self._ctl()
        assert ctl.admit("pro", 1).priority == 3
        assert ctl.admit("tight", 1).priority == 0

    def test_one_tenant_over_budget_never_blocks_another(self):
        ctl, _ = self._ctl()
        for _ in range(5):
            ctl.admit("tight", 10 ** 6)              # all shed
        assert ctl.shed[("tight", "token_budget")] == 5
        assert ctl.admit("pro", 10 ** 6).admitted    # unlimited tenant

    def test_page_unit_charging(self):
        clock = [0.0]
        slo = SLOController(
            {"t": TenantPolicy(tokens_per_s=4.0, burst_tokens=8.0)},
            charge_unit="pages", page_size=16, clock=lambda: clock[0])
        adm = slo.admit("t", 100)            # 100 tokens = 7 pages
        assert adm.admitted and adm.tokens == 7
        assert slo.admit("t", 100).reason == "token_budget"
        slo.finish(adm, tokens_used=20)      # refunds 7 - 2 = 5 pages
        assert slo.admit("t", 16 * 5).admitted

    def test_vocabulary_matches_the_reference(self):
        from paddle_tpu.serving.slo import SHED_REASONS as jax_reasons
        assert SHED_REASONS == jax_reasons
        assert set(port_slo.__all__) == {
            "TokenBucket", "TenantPolicy", "Admission", "SLOController",
            "SHED_REASONS"}


def _policies(make, unit: float = 1.0):
    """Budgets in tokens, or in pages of `unit` tokens."""
    return {"tight": make(tokens_per_s=12.0 / unit,
                          burst_tokens=40.0 / unit, max_streams=2,
                          priority=0),
            "mid": make(tokens_per_s=30.0 / unit, max_streams=5,
                        priority=1),
            "pro": make(priority=4)}


def _script(seed: int, steps: int = 200):
    """A seeded admit / finish / advance-the-clock sequence over three
    tenants and an unknown one (the default policy)."""
    rng = np.random.RandomState(seed)
    tenants = ("tight", "mid", "pro", "guest")
    out = []
    for _ in range(steps):
        r = rng.rand()
        if r < 0.55:
            out.append(("admit", tenants[rng.randint(4)],
                        int(rng.randint(1, 90))))
        elif r < 0.85:
            out.append(("finish", int(rng.randint(1 << 30)),
                        int(rng.randint(0, 90))))
        else:
            out.append(("tick", float(rng.rand() * 1.5)))
    return out


def _replay(ctl_cls, policy_cls, script, clock, **kw):
    ctl = ctl_cls(_policies(policy_cls, kw.get("page_size", 1)),
                  max_inflight=10,
                  clock=lambda: clock[0], **kw)
    live, trail = [], []
    for op in script:
        if op[0] == "admit":
            adm = ctl.admit(op[1], op[2])
            trail.append(dataclasses.asdict(adm))
            if adm.admitted:
                live.append(adm)
        elif op[0] == "finish" and live:
            adm = live.pop(op[1] % len(live))
            ctl.finish(adm, tokens_used=op[2])
        elif op[0] == "tick":
            clock[0] += op[1]
        trail.append(ctl.snapshot())
        trail.append(sorted(ctl.shed.items()))
    return trail


@pytest.mark.parametrize("unit", [dict(), dict(charge_unit="pages",
                                                page_size=8)],
                         ids=["tokens", "pages"])
@pytest.mark.parametrize("seed", range(6))
def test_decisions_equal_the_reference(seed, unit):
    script = _script(seed)
    port = _replay(SLOController, TenantPolicy, script, [0.0], **unit)
    ref = _replay(JaxSLOController, JaxTenantPolicy, script, [0.0], **unit)
    assert port == ref
    admits = [t for t in port if isinstance(t, dict) and "admitted" in t]
    reasons = {t["reason"] for t in admits if not t["admitted"]}
    # the script reaches every shed reason the controller owns
    assert reasons == set(SHED_REASONS) - {"draining"}
    assert any(t["admitted"] for t in admits)


def _metric_events(metrics, slo):
    rng = np.random.RandomState(5)
    for i in range(40):
        tenant = ("acme", "flood", "default")[i % 3]
        metrics.on_request(tenant, (200, 429, 400, 503)[rng.randint(4)])
        if i % 4 == 1:
            metrics.on_shed(tenant, SHED_REASONS[rng.randint(4)])
        if i % 7 == 3:
            metrics.on_disconnect(tenant)
        metrics.on_tokens(tenant, int(rng.randint(1, 30)))
        metrics.on_ttft(tenant, float(rng.rand() * 0.2))
        slo.admit(tenant, int(rng.randint(1, 50)))
    metrics.reattached_streams = 3
    metrics.drain_events = 1
    metrics.draining = 1


def test_server_metrics_exposition_equals_the_reference():
    port_m, port_slo_ctl = ServerMetrics(), SLOController(
        {"flood": TenantPolicy(tokens_per_s=10.0, burst_tokens=60.0)},
        clock=lambda: 0.0)
    ref_m, ref_slo = JaxServerMetrics(), JaxSLOController(
        {"flood": JaxTenantPolicy(tokens_per_s=10.0, burst_tokens=60.0)},
        clock=lambda: 0.0)
    _metric_events(port_m, port_slo_ctl)
    _metric_events(ref_m, ref_slo)
    text = render_families(port_m.to_families(port_slo_ctl))
    assert text == jax_render(ref_m.to_families(ref_slo))
    fams = parse_exposition(text)
    reqs = fams["paddle_tpu_server_requests_total"]["samples"]
    assert {lab["tenant"] for _, lab, _ in reqs} == {"acme", "flood",
                                                     "default"}
    assert fams["paddle_tpu_server_reattached_streams_total"][
        "samples"][0][2] == 3


def test_tenant_label_cardinality_is_bounded():
    m = ServerMetrics()
    for i in range(300):
        m.on_request(f"t{i}", 200)
    tenants = {t for t, _ in m.requests}
    assert len(tenants) == 257 and "_other" in tenants


def test_admission_defaults():
    a = Admission(False, "x")
    assert (a.reason, a.retry_after_s, a.priority, a.tokens) == \
        ("", 0.0, 0, 0)
