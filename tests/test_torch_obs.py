"""The port's observability layer (`paddle_tpu_torch/obs`, the profiler's
stats registry and the engine's wiring) against the JAX package's.

- The lifecycle ring: the same event tuples fed to the port's and the
  JAX package's `LifecycleTracer` serialize, reconstruct and export
  (Chrome/Perfetto) to equal dicts; the kinds are the same.
- `redact` and `parse_exposition` agree with the JAX versions on the
  JAX tests' inputs (malformed expositions raise in both).
- The engine: one greedy load (monolithic, then interleaved) on the
  port's and the JAX engine records the same sequence of event kinds
  for every request; the port records one `decode_block` event per
  processed block, and tracing changes neither the streams nor the
  host syncs.
- The exposition: the port's family names and types include every
  JAX family (the port-only ones are listed here), and the
  deterministic counters equal the JAX engine's on a paged load with a
  host swap; the strict parser accepts it.
- The capture watchdog reads 0 unexpected after a load, and 1 after a
  forced second build of the decode program.
- A decode exhaustion under a `FaultPlan` writes one flight dump with
  the JAX dump's keys.
- The stats provider is registered under the engine's name and
  unregistered by `close()` and at garbage collection.
- `python -m paddle_tpu_torch.obs --device cpu` writes a strict-parsed
  METRICS.prom and a trace.json and exits 0.
"""
import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import obs as jobs
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxParams
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import obs, profiler
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.serving import LLMEngine, SamplingParams
from paddle_tpu_torch.testing import faults

from port_threads import one_torch_thread  # noqa: F401 — autouse fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "paddle_tpu_serving"
# families the port renders and the JAX engine does not: its CUDA graph
# captures and their wall time, the prefill graph pool, and the replay
# steps of continuations
PORT_ONLY_FAMILIES = {
    f"{NS}_graph_captures_total", f"{NS}_graph_capture_seconds_total",
    f"{NS}_prefill_graph_captures_total",
    f"{NS}_prefill_graph_capture_seconds_total",
    f"{NS}_prefill_graph_pool_bytes", f"{NS}_replay_steps_total"}


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


def _events():
    """Every kind the engine emits, plus the front door's and the
    fleet's, over two requests and the engine scope."""
    return [
        (1.0, 0.0, "submitted", 7, -1, ()),
        (1.0, 0.0, "queued", 7, -1, ()),
        (1.1, 0.0, "submitted", 8, -1, ()),
        (1.2, 0.0, "fork", 8, -1, (2,)),
        (2.5, 0.5, "admitted", 7, 1, (32, 2, False)),
        (2.4, 0.3, "prefill_chunk", 7, 1, (16, 16)),
        (2.6, 0.0, "prefill_interleave", -1, -1, (3, 1, 16)),
        (2.7, 0.2, "admitted", 8, 0, (12, 0, False)),
        (3.0, 0.0, "retry", -1, -1, (1,)),
        (3.1, 0.0, "heal", -1, -1, ()),
        (3.6, 0.4, "decode_block", -1, -1,
         (8, 12, ((0, 8, 4), (1, 7, 8)))),
        (3.7, 0.0, "spec", -1, -1, (24, 17)),
        (3.8, 0.0, "swap_out", 8, 0, (2,)),
        (3.9, 0.0, "swap_in", 8, 2, (2,)),
        (4.0, 0.0, "cancel", 8, 2, ()),
        (4.1, 0.0, "handoff", 7, 1, ()),
        (4.2, 0.0, "shed", -1, -1, ("t0", "rate")),
        (4.3, 0.0, "scale_out", -1, -1, (1, "load")),
        (4.4, 0.0, "deadline", 9, -1, ()),
        (4.5, 0.0, "finished", 8, 2, ("cancelled",)),
        (4.6, 0.0, "finished", 9, -1, ("deadline",)),
    ]


def test_event_kinds_are_the_references():
    assert obs.EVENT_KINDS == jobs.trace.EVENT_KINDS
    assert obs.RESERVED_KINDS == jobs.trace.RESERVED_KINDS


def test_tracer_exports_equal_jax(tmp_path):
    rings = []
    for mod in (obs, jobs):
        tr = mod.LifecycleTracer(capacity=64)
        for ts, dur, kind, rid, slot, args in _events():
            tr.record(kind, rid, slot, dur=dur, args=args, ts=ts)
        rings.append(tr)
    port, ref = rings
    assert port.events() == ref.events()
    assert obs.serialize_events(port.events()) == \
        jobs.trace.serialize_events(ref.events())
    assert obs.request_spans(port.events()) == \
        jobs.request_spans(ref.events())
    got = port.export(str(tmp_path / "port.json"))
    want = ref.export(str(tmp_path / "jax.json"))
    assert got == want
    assert json.load(open(tmp_path / "port.json")) == \
        json.load(open(tmp_path / "jax.json"))
    with pytest.raises(ValueError, match="unknown lifecycle"):
        port.record("admited", 1)


@pytest.mark.parametrize("value", [
    {"prompt": np.arange(6, dtype=np.int32), "generated": [5, 6, 7],
     "steps": [1, 2, 3], "note": "x", "n": 4},
    np.zeros((2, 3)), np.arange(4, dtype=np.int64),
    {"detail": {"failed_rids": [1, 2], "token_ids": (3, 4), "ids": [9]},
     "f": 1.5, "b": True, "none": None, "s": np.float32(2.0)},
    [{"text": [1, 2]}, ("a", 1)],
])
def test_redact_equals_jax(value):
    assert obs.redact(value) == jobs.flight.redact(value)


@pytest.mark.parametrize("text", [
    "# HELP x_a a gauge\n# TYPE x_a gauge\nx_a 1\nx_a{b=\"c\"} 2.5\n",
    "# TYPE x summary\nx{quantile=\"0.5\"} 1\nx_sum 3\nx_count 2\n",
    "# TYPE y_total counter\ny_total{a=\"RuntimeError(\\\"{x}\\\")\"} +Inf\n",
    "no_type_declared 1\n",
    "# TYPE x gauge\n# TYPE x gauge\nx 1\n",
    "# TYPE x gauge\nx{bad-label=\"v\"} 1\n",
    "# TYPE x gauge\nx notanumber\n",
    "# TYPE x summary\nx{quantile=\"1.5\"} 1\n",
    "# TYPE x gauge\nx{a=\"v\" 1\n",
    "# TYPE x gauge\nx 1",
])
def test_parse_exposition_equals_jax(text):
    try:
        want = jobs.parse_exposition(text)
    except jobs.prometheus.ExpositionError as e:
        with pytest.raises(obs.ExpositionError):
            obs.parse_exposition(text)
        return
    assert obs.parse_exposition(text) == want


def _kinds_by_rid(events, rids):
    return {r: [e[2] for e in events if e[3] == r] for r in rids}


@pytest.mark.parametrize("knobs", [{}, dict(prefill_budget=8,
                                            prefill_chunk=4)],
                         ids=["monolithic", "interleaved"])
def test_event_kinds_per_rid_equal_jax(jax_model, model, knobs):
    prompts = _prompts([5, 19, 9, 12], seed=1)
    kw = dict(max_slots=2, max_seq=64, seed=3, **knobs)
    jeng = JaxEngine(jax_model, register_stats=False, **kw)
    jeng.generate(prompts, JaxParams(max_new_tokens=10))
    eng = LLMEngine(model, device="cpu", **kw)
    eng.generate(prompts, SamplingParams(max_new_tokens=10))
    rids = range(len(prompts))
    got = _kinds_by_rid(eng.tracer.events(), rids)
    assert got == _kinds_by_rid(jeng.tracer.events(), rids)
    assert all(k[0] == "submitted" and k[-1] == "finished"
               for k in got.values())
    blocks = [e for e in eng.tracer.events() if e[2] == "decode_block"]
    assert len(blocks) == eng.metrics.decode_dispatches \
        == eng.metrics.host_syncs
    # every block's lanes carry the tokens the block produced
    assert sum(e[5][1] for e in blocks) == eng.metrics.decode_tokens
    spans = obs.request_spans(eng.tracer.events())
    for rid in rids:
        assert sum(b["tokens"] for b in spans[rid]["decode_blocks"]) == 9
        assert spans[rid]["queue"] is not None
    eng.close()
    jeng.close()


def test_tracing_changes_no_stream_and_no_sync(model):
    prompts = _prompts([5, 16, 9], seed=4)

    def run(trace):
        eng = LLMEngine(model, max_slots=2, max_seq=64, seed=5,
                        device="cpu", trace=trace)
        toks = [r.token_ids for r in eng.generate(
            prompts, SamplingParams(max_new_tokens=12))]
        return toks, eng.metrics.host_syncs, len(eng.tracer)

    on, off = run(True), run(False)
    assert on[:2] == off[:2] and on[2] > 0 and off[2] == 0


def _swap_load(eng, prompts, sp, submit):
    rids = [submit(p) for p in prompts]
    eng.step()
    assert eng.swap_out(rids[0])
    while eng.has_work():
        eng.step()
    assert eng.swap_in(rids[0])
    while eng.has_work():
        eng.step()
    return rids


def test_exposition_families_cover_jax(jax_model, model):
    prompts = _prompts([30, 20], seed=2)
    kw = dict(max_slots=2, max_seq=64, kv_layout="paged", page_size=16,
              seed=4, prefix_cache=False)
    jeng = JaxEngine(jax_model, register_stats=False, **kw)
    _swap_load(jeng, prompts, None,
               lambda p: jeng.submit(p, JaxParams(max_new_tokens=12)))
    eng = LLMEngine(model, device="cpu", **kw)
    _swap_load(eng, prompts, None,
               lambda p: eng.submit(p, SamplingParams(max_new_tokens=12)))
    got = obs.parse_exposition(eng.to_prometheus())
    want = jobs.parse_exposition(jeng.to_prometheus())
    missing = {k for k in want if k not in got}
    assert not missing, missing
    assert {k: got[k]["type"] for k in want} == \
        {k: v["type"] for k, v in want.items()}
    assert set(got) - set(want) == PORT_ONLY_FAMILIES

    def value(fams, name):
        return sum(s[2] for s in fams[f"{NS}_{name}"]["samples"])

    for name in ("requests_submitted_total", "requests_admitted_total",
                 "requests_completed_total", "prompt_tokens_total",
                 "generated_tokens_total", "prefill_tokens_computed_total",
                 "decode_tokens_total", "swap_outs_total", "swap_ins_total",
                 "pages_swapped_out_total", "pages_swapped_in_total",
                 "swap_host_syncs_total"):
        assert value(got, name) == value(want, name), name
    assert value(got, "swap_outs_total") == 1
    assert value(got, "pages_swapped_in_total") > 0
    # the watchdog families: one decode program, nothing unexpected
    comp = {s[1]["program"]: s[2]
            for s in got[f"{NS}_compiles_total"]["samples"]}
    assert comp["decode"] == 1
    assert value(got, "compiles_unexpected") == 0
    eng.close()
    jeng.close()


def test_watchdog_counts_builds(model, monkeypatch):
    from paddle_tpu_torch.ops_cuda import _build
    # no host library (the collate, say) this process built enters here
    monkeypatch.setattr(_build, "BUILDS", {})
    eng = LLMEngine(model, max_slots=2, max_seq=64, seed=10,
                    device="cpu", prefix_block=8)
    eng.generate(_prompts([5, 9, 21], seed=10),
                 SamplingParams(max_new_tokens=6))
    wd = eng.watchdog
    counts = wd.counts()
    assert counts["decode"] == {"programs": 1, "compiles": 1,
                                "retraces": 0, "budget": 1}
    # every prompt of this load fits one floor-sized prefill program
    assert counts["prefill"]["programs"] == 1
    assert counts["prefill"]["budget"] == len(
        {max(b, 128) for b in eng._buckets})
    assert wd.compiles_unexpected == 0
    assert wd.compiles_total <= wd.budget_total
    # a forced second build (capture) of the decode program
    eng._runners.clear()
    eng.generate(_prompts([6], seed=11), SamplingParams(max_new_tokens=4))
    assert wd.counts()["decode"]["compiles"] == 2
    assert wd.compiles_unexpected == 1
    assert wd.snapshot()["compiles_unexpected"] == 1
    line = obs.digest({**eng.stats(), **wd.snapshot()})
    assert "compiles 3 (1 unexpected)" in line and "\n" not in line


def test_watchdog_budgets_speculation_and_kernel_builds(model,
                                                        monkeypatch):
    from paddle_tpu_torch.ops_cuda import _build
    eng = LLMEngine(model, max_slots=2, max_seq=64, device="cpu",
                    speculate_k=2)
    eng.generate(_prompts([5], seed=2), SamplingParams(max_new_tokens=6))
    counts = eng.watchdog.counts()
    assert counts["spec_decode"]["compiles"] == 1
    assert counts["kernel_build"]["budget"] == len(_build.kernel_names())
    monkeypatch.setitem(_build.BUILDS, "decode_attention", 1)
    assert eng.watchdog.counts()["kernel_build"]["compiles"] == 1
    assert eng.watchdog.compiles_unexpected == 0
    monkeypatch.setitem(_build.BUILDS, "decode_attention", 2)
    assert eng.watchdog.compiles_unexpected == 1


def _exhaust(engine_cls, model, params_cls, fault_mod, flight_dir, **kw):
    plan = fault_mod.FaultPlan().fail_at("decode_dispatch",
                                         1, 2, 3, 4, 5, 6)
    eng = engine_cls(model, max_slots=2, max_seq=64, seed=13,
                     max_retries=1, retry_backoff_s=0.0,
                     flight_dir=str(flight_dir), **kw)
    with fault_mod.inject(plan):
        res = eng.generate(_prompts([5, 8], seed=13),
                           params_cls(max_new_tokens=8))
    return eng, plan, res


def test_decode_exhaustion_writes_one_flight_dump(jax_model, model,
                                                  tmp_path):
    eng, plan, res = _exhaust(LLMEngine, model, SamplingParams, faults,
                              tmp_path / "port", device="cpu")
    assert {r.finish_reason for r in res} == {"error"}
    assert [r["reason"] for r in plan.postmortems] == \
        ["decode_retry_exhausted"]
    files = os.listdir(tmp_path / "port")
    assert len(files) == 1 and files[0].startswith("postmortem_0001")
    rep = json.load(open(tmp_path / "port" / files[0]))
    assert sorted(rep["detail"]["failed_rids"]) == [0, 1]
    assert any(e[2] == "retry" for e in rep["events"])
    assert rep["config"]["flight_dir"] == str(tmp_path / "port")
    jeng, jplan, _ = _exhaust(JaxEngine, jax_model, JaxParams, jfaults,
                              tmp_path / "jax", register_stats=False)
    jrep = json.load(open(tmp_path / "jax" / os.listdir(
        tmp_path / "jax")[0]))
    assert set(rep) == set(jrep)
    assert set(rep["detail"]) == set(jrep["detail"])
    assert set(jrep["config"]) - set(rep["config"]) <= {"tp"}
    assert set(jrep["metrics"]) <= set(rep["metrics"])
    eng.close()
    jeng.close()


def test_provider_registered_and_unregistered(model):
    eng = LLMEngine(model, max_slots=1, max_seq=64, device="cpu",
                    name="obs_probe_engine")
    eng.generate(_prompts([4], seed=9), SamplingParams(max_new_tokens=3))
    stats = profiler.custom_stats()["obs_probe_engine"]
    assert stats["requests_completed"] == 1
    assert stats["compiles_unexpected"] == 0
    text = obs.registry_exposition()
    fams = obs.parse_exposition(text)
    assert any(s[1]["provider"] == "obs_probe_engine"
               for s in fams["paddle_tpu_requests_completed"]["samples"])
    eng.close()
    assert "obs_probe_engine" not in profiler.custom_stats()
    eng.close()                               # unregisters once only
    gc_eng = LLMEngine(model, max_slots=1, max_seq=64, device="cpu")
    name = gc_eng.name
    assert name in profiler.custom_stats()
    del gc_eng
    gc.collect()
    assert name not in profiler.custom_stats()


def test_registry_isolates_broken_provider():
    profiler.register_stats_provider(
        "obs_t_good", lambda: {"queue_ms": 2.0, "slots_total": 4})
    profiler.register_stats_provider(
        "obs_t_bad", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    try:
        assert profiler.custom_stats()["obs_t_bad"] == \
            {"error": "RuntimeError('boom')"}
        fams = obs.parse_exposition(obs.registry_exposition())
        assert fams["paddle_tpu_slots_total"]["type"] == "gauge"
        errs = [s for s in fams["paddle_tpu_provider_error"]["samples"]
                if s[1]["provider"] == "obs_t_bad"]
        assert errs and "boom" in errs[0][1]["detail"]
    finally:
        profiler.unregister_stats_provider("obs_t_good")
        profiler.unregister_stats_provider("obs_t_bad")
    with pytest.raises(TypeError, match="callable"):
        profiler.register_stats_provider("x", 3)


def test_obs_cli_writes_strict_artifacts(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.obs", "--device", "cpu",
         "--requests", "4", "--metrics-out", str(tmp_path / "m.prom"),
         "--trace-out", str(tmp_path / "t.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "0 unexpected" in proc.stdout
    fams = obs.parse_exposition(open(tmp_path / "m.prom").read())
    assert fams[f"{NS}_requests_completed_total"]["samples"][0][2] == 4
    trace = json.load(open(tmp_path / "t.json"))
    assert trace["otherData"]["requests"] == 4
