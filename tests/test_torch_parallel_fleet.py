"""The port's fleet API, fleet.metrics, the metrics they read and
DataParallel, against the JAX package's.

- `fleet.init` / `distributed_model` / `distributed_trainer` build the
  mesh, ZeRO stage and Trainer options JAX's do from one strategy
  (AMP level and dtype, a GradScaler for float16, recompute,
  gradient merge; dgc refused); a fleet-built `gpt_tiny` trainer at
  stage 2 trains as a hand-built `Trainer(mesh=)` does, bitwise.
- `fleet.recompute`: value and gradient equal no recompute (fp32,
  exact) and JAX's (rtol 1e-6).
- `metric.Precision`, `Recall`, `Auc` and `accuracy` equal JAX's on
  the same scores; `fleet_metrics`' functions, `DistributedMetric` and
  `merged_accumulate` over per-rank metrics equal JAX's, with the host
  transport stubbed to a 2-worker world in both packages.
- `DataParallel` delegates its state dict and trains as its model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import metric as jmetric
from paddle_tpu import parallel as jpar
from paddle_tpu.parallel import fleet as jfleet
from paddle_tpu.parallel import fleet_metrics as JFM
from paddle_tpu_torch import metric, nn, parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.parallel import fleet
from paddle_tpu_torch.parallel import fleet_metrics as FM
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _strategy(pkg, **kw):
    cls = jpar.DistributedStrategy if pkg == "jax" else \
        parallel.DistributedStrategy
    return cls(**kw)


# --------------------------------------------------------------------------- #
# fleet
# --------------------------------------------------------------------------- #

STRATEGIES = {
    "sharding2": dict(sharding=True, sharding_configs={"stage": 2},
                      hybrid_configs={"sharding_degree": 4}),
    "amp_fp16": dict(amp=True, amp_configs={"level": "O2",
                                            "dtype": "float16"},
                     hybrid_configs={"dp_degree": 2}),
    "merge_recompute": dict(recompute=True, gradient_merge=True,
                            gradient_merge_configs={"k_steps": 2},
                            hybrid_configs={"dp_degree": 2,
                                            "sharding_degree": 2}),
}


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_fleet_builds_what_jax_builds(name):
    from paddle_tpu import nn as jnn, optimizer as jopt
    kw = STRATEGIES[name]
    jm = jfleet.init(strategy=_strategy("jax", **kw))
    m = fleet.init(strategy=_strategy("torch", **kw), world_size=8,
                   device="cpu")
    assert m is parallel.get_mesh()
    assert parallel.mesh_mod.mesh_shape(m) == \
        jpar.mesh_mod.mesh_shape(jpar.get_mesh())
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.topology() == jfleet.get_hybrid_communicate_group(
    ).topology()
    jmodel = jfleet.distributed_model(jnn.Linear(64, 64))
    model = fleet.distributed_model(nn.Linear(64, 64,
                                              gen=torch.Generator()))
    assert getattr(model, "_zero_stage", 0) == \
        getattr(jmodel, "_zero_stage", 0)
    jt = jfleet.distributed_trainer(jmodel, jopt.Adam(), lambda o, y: o)
    t = fleet.distributed_trainer(model, fleet.distributed_optimizer(
        Adam()), lambda o, y: o)
    assert t.mesh is m and jt.mesh is jm
    assert (t.amp_level, t.remat, t.grad_accum) == \
        (jt.amp_level, jt.remat, jt.grad_accum)
    assert (t.scaler is None) == (jt.scaler is None)
    if t.scaler is not None:
        assert t.scaler.init_loss_scaling == jt.scaler.init_loss_scaling
    assert str(t.amp_dtype).split(".")[-1] == jnp.dtype(jt.amp_dtype).name


def test_fleet_refuses_dgc_and_needs_init():
    s = _strategy("torch", dgc=True, hybrid_configs={"dp_degree": 2})
    fleet.init(strategy=s, device="cpu")
    with pytest.raises(ValueError, match="compression"):
        fleet.distributed_trainer(nn.Linear(4, 4, gen=torch.Generator()),
                                  Adam(), lambda o, y: o)
    parallel.set_mesh(None)
    with pytest.raises(RuntimeError, match="fleet.init"):
        fleet.distributed_model(nn.Linear(4, 4, gen=torch.Generator()))


def test_fleet_gpt_trainer_equals_hand_built():
    ids = np.random.RandomState(0).randint(0, 1024, (4, 32))
    fleet.init(strategy=_strategy("torch", **STRATEGIES["sharding2"]),
               world_size=4, device="cpu")
    m = fleet.distributed_model(gpt_tiny(seed=0, device="cpu"))
    tr = fleet.distributed_trainer(m, AdamW(1e-3),
                                   lambda lg, y: m.loss(lg, y))
    a = [float(tr.train_step(ids, ids)[0]) for _ in range(2)]
    mesh = parallel.init_mesh(fsdp=4, device="cpu")
    m2 = gpt_tiny(seed=0, device="cpu")
    parallel.apply_fsdp(m2, mesh, stage=2)
    tr2 = Trainer(m2, AdamW(1e-3), lambda lg, y: m2.loss(lg, y), mesh=mesh)
    b = [float(tr2.train_step(ids, ids)[0]) for _ in range(2)]
    assert a == b and a[1] < a[0]
    sa, sb = tr.gathered_state(), tr2.gathered_state()
    assert all(torch.equal(sa.params[k], sb.params[k]) for k in sa.params)
    # state_dict() of the sharded model holds whole tensors
    sd = tr.sync_model().state_dict()
    assert sd["wte.weight"].shape == (1024, 128)


def test_recompute_matches_plain_and_jax():
    rs0, rs1 = np.random.RandomState(0), np.random.RandomState(1)
    x = rs0.randn(4, 8).astype(np.float32)
    w = rs1.randn(8, 8).astype(np.float32)

    def block(x, w):
        return torch.tanh(x @ w)

    tw = torch.from_numpy(w).requires_grad_()
    plain = block(torch.from_numpy(x), tw)
    g1, = torch.autograd.grad(plain.sum(), tw)
    tw2 = torch.from_numpy(w).requires_grad_()
    rec = fleet.recompute(block, torch.from_numpy(x), tw2,
                          preserve_rng_state=True)
    g2, = torch.autograd.grad(rec.sum(), tw2)
    assert torch.equal(plain, rec) and torch.equal(g1, g2)
    jg = jax.grad(lambda w: jnp.sum(jfleet.recompute(
        lambda x, w: jnp.tanh(x @ w), jnp.asarray(x), w)))(jnp.asarray(w))
    np.testing.assert_allclose(g2.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------- #
# metrics and fleet.metrics
# --------------------------------------------------------------------------- #

def _scores(seed, n=200):
    rs = np.random.RandomState(seed)
    return rs.rand(n).astype(np.float32), rs.randint(0, 2, (n,))


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_metrics_match_jax(cls):
    got, want = getattr(metric, cls)(), getattr(jmetric, cls)()
    for seed in (0, 1):
        p, y = _scores(seed)
        got.update(torch.from_numpy(p), y)
        want.update(p, y)
    assert got.accumulate() == pytest.approx(want.accumulate(), rel=1e-12)
    assert got.name() == want.name()
    got.reset()
    assert got.accumulate() == 0.0
    if cls == "Auc":
        two = np.stack([1 - p, p], axis=1)
        a, b = metric.Auc(num_thresholds=255), jmetric.Auc(num_thresholds=255)
        a.update(two, y)
        b.update(two, y)
        assert a.accumulate() == pytest.approx(b.accumulate(), rel=1e-12)


def test_accuracy_function_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.rand(32, 6).astype(np.float32)
    x[0, :2] = 0.5                               # a tie: stable order
    y = rs.randint(0, 6, (32, 1))
    for k in (1, 3):
        got = metric.accuracy(torch.from_numpy(x), torch.from_numpy(y), k=k)
        want = jmetric.accuracy(x, y, k=k)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), abs=1e-7)


@pytest.fixture
def two_workers(monkeypatch):
    """Both packages' host transport as a 2-process world: a call
    returns the stacked statistics of this worker and of the stored
    other one."""
    store = {}

    def gather(x):
        return np.stack([np.asarray(x), np.asarray(store["other"])])

    monkeypatch.setattr(FM, "host_all_gather", gather)
    monkeypatch.setattr(JFM, "host_all_gather", gather)
    return store


def test_fleet_metric_functions_match_jax(two_workers, monkeypatch):
    two_workers["other"] = np.array([2.0, 7.0])
    x = np.array([3.0, 5.0])
    for fn in ("sum", "max", "min"):
        np.testing.assert_array_equal(getattr(FM, fn)(x),
                                      getattr(JFM, fn)(x))
    two_workers["other"] = np.array(10.0)
    for fn in ("acc", "mae", "rmse"):
        got = getattr(FM, fn)(np.array(30.0), np.array(40.0))
        want = getattr(JFM, fn)(np.array(30.0), np.array(40.0))
        assert got == pytest.approx(want, rel=1e-12)
    # auc: this worker's histograms and the other's, in call order
    mine, other = metric.Auc(num_thresholds=63), metric.Auc(
        num_thresholds=63)
    mine.update(*_scores(3))
    other.update(*_scores(4))

    def auc_of(mod):
        sent = iter([other._stat_pos, other._stat_neg])
        monkeypatch.setattr(mod, "host_all_gather", lambda x: np.stack(
            [np.asarray(x), next(sent)]))
        return mod.auc(mine._stat_pos, mine._stat_neg)

    got, want = auc_of(FM), auc_of(JFM)
    assert got == pytest.approx(want, rel=1e-12)
    merged = metric.Auc(num_thresholds=63)
    merged.update(*_scores(3))
    merged.update(*_scores(4))
    assert got == pytest.approx(merged.accumulate(), rel=1e-12)


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc", "Accuracy"])
def test_distributed_and_merged_metrics_match_jax(cls, monkeypatch):
    def make(mod):
        return getattr(mod, cls)()

    def feed(m, seed, torch_in):
        p, y = _scores(seed)
        if cls == "Accuracy":
            p = np.stack([1 - p, p], axis=1)
            m.update(m.compute(torch.from_numpy(p) if torch_in else p, y))
        else:
            m.update(torch.from_numpy(p) if torch_in else p, y)

    ranks_ = [make(metric) for _ in range(4)]
    jranks = [make(jmetric) for _ in range(4)]
    for i, (a, b) in enumerate(zip(ranks_, jranks)):
        feed(a, i, True)
        feed(b, i, False)
    assert FM.merged_accumulate(ranks_) == pytest.approx(
        JFM.merged_accumulate(jranks), rel=1e-12)
    d, jd = FM.DistributedMetric(make(metric)), JFM.DistributedMetric(
        make(jmetric))
    feed(d, 5, True)
    feed(jd, 5, False)
    other = make(metric)
    feed(other, 6, True)

    def accumulate(mod, dm):
        sent = iter([getattr(other, a) for a in FM._state_attrs(other)])
        monkeypatch.setattr(mod, "host_all_gather", lambda x: np.stack(
            [np.asarray(x, np.float64), np.asarray(next(sent), np.float64)]))
        return dm.accumulate()

    assert accumulate(FM, d) == pytest.approx(accumulate(JFM, jd),
                                              rel=1e-12)
    with pytest.raises(TypeError, match="additive state"):
        FM.DistributedMetric(metric.Metric())


# --------------------------------------------------------------------------- #
# DataParallel
# --------------------------------------------------------------------------- #

def test_data_parallel_wraps_and_trains_as_its_model():
    g = torch.Generator().manual_seed(0)
    inner = nn.Sequential(nn.Linear(8, 16, gen=g), nn.ReLU(),
                          nn.Linear(16, 4, gen=g))
    mesh = parallel.init_mesh(dp=4, device="cpu")
    dp = parallel.DataParallel(inner)
    assert set(dp.state_dict()) == set(inner.state_dict())
    with dp.no_sync():
        pass
    t = torch.ones(())
    assert dp.scale_loss(t) is t
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    y = np.arange(16) % 4
    tr = Trainer(dp, Adam(0.01), lambda o, t: F.cross_entropy(o, t),
                 mesh=mesh)
    a = [float(tr.train_step(x, y)[0]) for _ in range(3)]
    g = torch.Generator().manual_seed(0)
    plain = nn.Sequential(nn.Linear(8, 16, gen=g), nn.ReLU(),
                          nn.Linear(16, 4, gen=g))
    tr1 = Trainer(plain, Adam(0.01), lambda o, t: F.cross_entropy(o, t))
    b = [float(tr1.train_step(x, y)[0]) for _ in range(3)]
    np.testing.assert_allclose(a, b, rtol=1e-6)
    dp.set_state_dict(plain.state_dict())
    assert torch.equal(inner[0].weight, plain[0].weight)
    import paddle_tpu_torch as ptt
    assert ptt.DataParallel is parallel.DataParallel
    assert ptt.distributed is ptt.parallel
