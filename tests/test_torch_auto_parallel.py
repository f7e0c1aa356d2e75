"""`parallel.auto` of the port against the JAX package's
`parallel/auto.py`.

- The cost model and the planner are host arithmetic copied from JAX:
  given the same `ClusterSpec`, both packages rank the same plans, in
  the same order, with the same memory and step times (float
  tolerance 1e-12 relative), single- and multi-slice, and the same
  mesh factorizations.
- The port's default `ClusterSpec` holds the H100 SXM5 datasheet's
  figures, none of JAX's v5e ones.
- `analyze_model` on twin models (`gpt_tiny`, an MLP) gives JAX's
  statistics.
- `Engine` on the CPU over 8 logical ranks: JAX's plan, and two
  `fit_batch` steps on `gpt_tiny` within 2e-4 relative of JAX's
  Engine on the same weights.
- `Calibrator` recovers a ground-truth cluster from noisy step times
  (JAX's test), and `time_step_fn` timing a port step closes the loop.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import parallel as jpar
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.parallel import auto as jauto
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.parallel import auto
from port_threads import one_torch_thread  # noqa: F401

FIELDS = ("n_devices", "hbm_bytes", "peak_flops", "ici_bw", "dcn_bw",
          "mfu", "hop_latency", "n_slices")


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _stats(cls, n_params, layers=12, act=4e6, seq=1.0):
    return cls(n_params=n_params, n_layers=layers,
               flops_per_sample=6.0 * n_params * seq,
               act_bytes_per_sample=act)


def _same_plans(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.dp, g.fsdp, g.tp, g.pp, g.micro, g.dcn_axis) == \
            (w.dp, w.fsdp, w.tp, w.pp, w.micro, w.dcn_axis)
        assert g.mem_bytes == pytest.approx(w.mem_bytes, rel=1e-12)
        assert g.step_time == pytest.approx(w.step_time, rel=1e-12)


CLUSTERS = {
    "one_slice": dict(n_devices=8, hbm_bytes=16e9),
    "h100_host": dict(n_devices=8, hbm_bytes=80e9, peak_flops=989e12,
                      ici_bw=4.5e11, dcn_bw=5e10),
    "two_slices": dict(n_devices=8, n_slices=2, hbm_bytes=32e9),
    "sixteen": dict(n_devices=16, n_slices=4, hbm_bytes=24e9),
}
MODELS = {"1b": (1_000_000_000, 24, 8e6, 1.0),
          "124m_seq": (124_000_000, 12, 50e6, 1024.0),
          "2b_grad_heavy": (2_000_000_000, 32, 512 * 2048 * 8, 512.0),
          "20m_act_heavy": (20_000_000, 4, 4096 * 1024 * 64, 4096.0)}


@pytest.mark.parametrize("cluster", list(CLUSTERS))
@pytest.mark.parametrize("model", list(MODELS))
def test_planner_ranks_like_jax(cluster, model):
    # the same spec, every field given, to both packages
    kw = dataclasses.asdict(auto.ClusterSpec(**CLUSTERS[cluster]))
    n, layers, act, seq = MODELS[model]
    jp = jauto.Planner(cluster=jauto.ClusterSpec(**kw))
    pp = auto.Planner(cluster=auto.ClusterSpec(**kw))
    js = _stats(jauto.ModelStats, n, layers, act, seq)
    ps = _stats(auto.ModelStats, n, layers, act, seq)
    for gb in (32, 64, 512):
        for fn in ("plan", "plan_multislice"):
            try:
                want = getattr(jp, fn)(js, gb, top_k=50)
            except ValueError as e:
                with pytest.raises(ValueError, match="no feasible plan"):
                    getattr(pp, fn)(ps, gb, top_k=50)
                assert "no feasible plan" in str(e)
                continue
            got = getattr(pp, fn)(ps, gb, top_k=50)
            _same_plans(got, want)
            s = kw.get("n_slices", 1)
            for g, w in zip(got[:5], want[:5]):
                try:
                    wf = w.mesh_factorization(s)
                except ValueError:
                    with pytest.raises(ValueError, match="not divisible"):
                        g.mesh_factorization(s)
                    continue
                assert g.mesh_factorization(s) == wf
                assert str(g) == str(w)


def test_default_cluster_is_the_h100_datasheet():
    c = auto.ClusterSpec()
    assert (c.hbm_bytes, c.peak_flops, c.ici_bw, c.dcn_bw) == \
        (80e9, 989e12, 4.5e11, 5e10)
    j = jauto.ClusterSpec()
    # no TPU figure is left in the port's defaults
    for f in ("hbm_bytes", "peak_flops", "ici_bw", "dcn_bw"):
        assert getattr(c, f) != getattr(j, f), f
    assert [f.name for f in dataclasses.fields(c)] == list(FIELDS)


def test_analyze_model_equals_jax_on_twins():
    pt.seed(0)
    js = jauto.analyze_model(jax_gpt_tiny(), (4, 64), seq_like=True)
    ps = auto.analyze_model(gpt_tiny(seed=0, device="cpu"), (4, 64),
                            seq_like=True)
    assert dataclasses.asdict(ps) == pytest.approx(dataclasses.asdict(js))
    jm = jnn.Sequential(jnn.Linear(10, 20), jnn.Linear(20, 5))
    pm = nn.Sequential(nn.Linear(10, 20, gen=torch.Generator()),
                       nn.Linear(20, 5, gen=torch.Generator()))
    js, ps = jauto.analyze_model(jm, (1, 10)), auto.analyze_model(pm,
                                                                  (1, 10))
    assert ps.n_params == js.n_params == 10 * 20 + 20 + 20 * 5 + 5
    assert dataclasses.asdict(ps) == pytest.approx(dataclasses.asdict(js))


def test_engine_plans_and_trains_like_jax():
    pt.seed(0)
    jm = jax_gpt_tiny()
    weights = {k: np.array(v) for k, v in jm.raw_parameters().items()}
    cluster = dataclasses.asdict(auto.ClusterSpec(n_devices=8,
                                                  hbm_bytes=16e9))
    je = jauto.Engine(jm, lambda lg, y: jm.loss(lg, y),
                      jopt.AdamW(learning_rate=1e-3),
                      cluster=jauto.ClusterSpec(**cluster))
    je.prepare(sample_shape=(1, 64), global_batch=16, seq_like=True)
    ids = np.random.RandomState(0).randint(0, 1024, (16, 64))
    want = [float(je.fit_batch(ids, ids)[0]) for _ in range(2)]
    jpar.set_mesh(None)

    m = load_jax_params(gpt_tiny(seed=1, device="cpu"), weights)
    with pytest.raises(ValueError, match="world_size"):
        auto.Engine(m, lambda lg, y: m.loss(lg, y), AdamW(1e-3))
    eng = auto.Engine(m, lambda lg, y: m.loss(lg, y), AdamW(1e-3),
                      cluster=auto.ClusterSpec(**cluster))
    with pytest.raises(RuntimeError, match="prepare"):
        eng.fit_batch(ids, ids)
    eng.prepare(sample_shape=(1, 64), global_batch=16, seq_like=True)
    assert eng.plan_.degrees == je.plan_.degrees
    assert eng.mesh.size == 8
    got = [float(eng.fit_batch(ids, ids)[0]) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[1] < got[0]
    assert auto.Engine(m, None, None, world_size=4).cluster.n_devices == 4


def test_calibrator_recovers_ground_truth_and_closes_the_loop():
    stats = auto.ModelStats(n_params=124_000_000, n_layers=12,
                            flops_per_sample=6 * 124e6 * 1024,
                            act_bytes_per_sample=50e6)
    truth = auto.ClusterSpec(n_devices=8, mfu=0.45, ici_bw=1.5e10,
                             peak_flops=197e12, hbm_bytes=16e9)
    truth_cm = auto.CostModel(truth)
    plans = [auto.Plan(dp=8, fsdp=1, tp=1, pp=1),
             auto.Plan(dp=1, fsdp=8, tp=1, pp=1),
             auto.Plan(dp=2, fsdp=1, tp=4, pp=1),
             auto.Plan(dp=4, fsdp=1, tp=2, pp=1),
             auto.Plan(dp=1, fsdp=1, tp=8, pp=1)]
    rng = np.random.RandomState(0)
    meas = [(p, 512, truth_cm.step_time(stats, p, 512)
             * float(1 + 0.02 * rng.randn())) for p in plans[:4]]
    start = dataclasses.replace(truth, mfu=0.2, ici_bw=6.0e10)
    fitted = auto.Calibrator(start).fit(stats, meas)
    jstart = jauto.ClusterSpec(**dataclasses.asdict(start))
    assert abs(fitted.mfu - truth.mfu) / truth.mfu < 0.2
    assert abs(fitted.ici_bw - truth.ici_bw) / truth.ici_bw < 0.35
    jfit = jauto.Calibrator(jstart).fit(
        _stats(jauto.ModelStats, 124_000_000, 12, 50e6, 1024.0),
        [(jauto.Plan(p.dp, p.fsdp, p.tp, p.pp), gb, s)
         for p, gb, s in meas])
    assert fitted.mfu == pytest.approx(jfit.mfu, rel=1e-6)
    assert fitted.ici_bw == pytest.approx(jfit.ici_bw, rel=1e-6)
    fit_cm = auto.CostModel(fitted)
    want = sorted(plans, key=lambda p: truth_cm.step_time(stats, p, 512))
    got = sorted(plans, key=lambda p: fit_cm.step_time(stats, p, 512))
    assert [p.degrees for p in got] == [p.degrees for p in want]
    assert isinstance(auto.Calibrator(start).calibrated_planner(
        stats, meas), auto.Planner)

    g = torch.Generator().manual_seed(0)
    model = nn.Sequential(nn.Linear(256, 512, gen=g), nn.GELU(),
                          nn.Linear(512, 256, gen=g))
    tr = Trainer(model, SGD(1e-3), lambda o, y: ((o - y) ** 2).mean())
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 256).astype(
        np.float32))
    sec = auto.time_step_fn(lambda a, b: tr.train_step(a, b)[0], (x, x),
                            steps=3, warmup=1)
    assert sec > 0
    ms = auto.analyze_model(model, (64, 256))
    plan = auto.Plan(dp=1, fsdp=1, tp=1, pp=1)
    fit1 = auto.Calibrator(auto.ClusterSpec(n_devices=1), remat=False).fit(
        ms, [(plan, 64, sec)])
    pred = auto.CostModel(fit1, remat=False).step_time(ms, plan, 64)
    assert abs(pred - sec) / sec < 0.3, (pred, sec)
