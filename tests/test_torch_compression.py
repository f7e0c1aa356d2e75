"""`parallel.compression` of the port against the JAX package's
`parallel/compression.py` on conftest's virtual CPU devices.

- `compressed_psum_mean` at n = 2 and 4, list form and rank form (an
  SPMD run), against JAX's inside `shard_map`: the mean and every
  residual bitwise (so every code q: residual = local - q * scale,
  rounded once as XLA's fused multiply-subtract rounds it).
- Zero input gives zeros, no NaN; the collective counter shows the
  codes as int8 (n x numel bytes) and the scale's max as one fp32
  scalar per rank; 64 ranks raise; `zero_residuals` without a mesh;
  the strategy's dgc knobs; the fleet's refusal; error feedback kills
  the quantization bias (JAX's test, on the port).
- `compressed_grad_step` on `gpt_tiny` over dp 2 (Momentum, 8 steps)
  against JAX's on the same weights and ids: losses within 1e-3
  relative (the two packages' gradients differ in the last bits, so a
  code on a rounding edge may flip, and the flips compound: 1.5e-4
  seen at step 8); both within 5e-3 relative of
  exact dp (JAX's own bar is 25%).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu import parallel as jpar
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.parallel import compressed_grad_step as j_step
from paddle_tpu.parallel import compressed_psum_mean as j_cpm
from paddle_tpu.parallel import zero_residuals as j_zero
from paddle_tpu_torch import parallel
from paddle_tpu_torch.models import gpt_tiny, load_jax_params
from paddle_tpu_torch.nn import ranks
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.parallel import collective as C
from paddle_tpu_torch.parallel import compression as comp
from port_threads import one_torch_thread  # noqa: F401

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _jax_reduce(n):
    mesh = jpar.init_mesh(dp=n)
    return jax.jit(shard_map(
        lambda a, b: j_cpm(a, "dp", b), mesh=mesh,
        in_specs=(JP("dp"), JP("dp")), out_specs=(JP(), JP("dp"))))


def _inputs(n, seed=0, width=300):
    rs = np.random.RandomState(seed + n)
    x = (rs.randn(n, width) * rs.rand(n, 1) * 3).astype(np.float32)
    x[0, 0] = 0.5 * np.abs(x).max()         # codes on a half point
    r = (rs.randn(n, width) * 0.02).astype(np.float32)
    return x, r


@pytest.mark.parametrize("n", [2, 4])
def test_psum_mean_bitwise_against_jax(n):
    x, r = _inputs(n)
    m, res = _jax_reduce(n)(x, r)
    m, res = np.asarray(m)[0], np.asarray(res)
    xs = [torch.from_numpy(x[i]) for i in range(n)]
    rs = [torch.from_numpy(r[i]) for i in range(n)]
    mean, got = comp.compressed_psum_mean(xs, "dp", rs)
    assert np.array_equal(mean.numpy(), m)
    assert np.array_equal(torch.stack(got).numpy(), res)
    # the rank form, inside an SPMD run over the same ranks
    out = C.spmd([{"dp": i} for i in range(n)],
                 lambda i: comp.compressed_psum_mean(xs[i], "dp", rs[i]))
    for i, (mi, ri) in enumerate(out):
        assert np.array_equal(mi.numpy(), m)
        assert np.array_equal(ri.numpy(), res[i])
    # error feedback: mean + the new residuals' mean is the exact mean
    # of x + the old residuals
    np.testing.assert_allclose(mean.numpy() + res.mean(0), (x + r).mean(0),
                               rtol=1e-5, atol=1e-6)


def test_zero_input_no_nan_and_int8_on_the_wire():
    z = [torch.zeros(8) for _ in range(2)]
    m, r = comp.compressed_psum_mean(z, "dp", z)
    assert torch.equal(m, torch.zeros(8)) and all(torch.equal(x, z[0])
                                                  for x in r)
    n, width = 4, 300
    x, res = _inputs(n, seed=3, width=width)
    ranks.reset_counts()
    C.spmd([{"dp": i} for i in range(n)],
           lambda i: comp.compressed_psum_mean(
               torch.from_numpy(x[i]), "dp", torch.from_numpy(res[i])))
    assert C.wire() == {"int8": n * width, "float32": n * 4}
    assert C.counts()["all_reduce"] == 2


def test_guard_and_zero_residuals():
    comp._guard_axis_size(63)
    for n in (64, 128):
        with pytest.raises(ValueError, match="DCN axis"):
            comp._guard_axis_size(n)
    with pytest.raises(ValueError, match="DCN axis"):
        comp.compressed_psum_mean([torch.ones(2)] * 64, "dp",
                                  [torch.zeros(2)] * 64)
    parallel.set_mesh(None)
    r = comp.zero_residuals({"w": torch.ones(3, 4)}, mesh=None)
    assert r["w"].shape == (1, 3, 4) and r["w"].dtype == torch.float32
    jr = j_zero({"w": jnp.ones((3, 4))}, mesh=None)
    assert tuple(jr["w"].shape) == tuple(r["w"].shape)
    mesh = parallel.init_mesh(dp=4, device="cpu")
    assert comp.zero_residuals({"w": torch.ones(3, dtype=torch.bfloat16)},
                               mesh)["w"].shape == (4, 3)


def test_strategy_knobs_and_fleet_refusal():
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import fleet
    s = parallel.DistributedStrategy(dgc=True, dgc_configs={"axis": "dp"})
    assert s.dgc and s.dgc_configs.axis == "dp"
    s = parallel.DistributedStrategy(dgc=True, dgc_configs={
        "rampup_begin_step": 0, "rampup_step": 100, "sparsity": [0.999]})
    assert s.dgc_configs.axis == "dp"
    fleet.init(strategy=parallel.DistributedStrategy(dgc=True), world_size=2,
               device="cpu")
    try:
        with pytest.raises(ValueError, match="compressed_grad_step"):
            fleet.distributed_trainer(Linear(4, 2, gen=torch.Generator()),
                                      SGD(0.1), lambda o, y: o.mean())
        with pytest.raises(ValueError, match="dgc_configs.axis"):
            fleet.distributed_trainer(Linear(4, 2, gen=torch.Generator()),
                                      SGD(0.1), lambda o, y: o.mean())
    finally:
        fleet.init(world_size=1, device="cpu")


def test_error_feedback_kills_quantization_bias():
    rng = np.random.RandomState(5)
    g = rng.randn(2, 128).astype(np.float32) * 0.01
    g[0, 0] = 3.0
    exact = g.mean(axis=0)
    gs = [torch.from_numpy(g[i]) for i in range(2)]

    def avg_error(keep, k=50):
        res = [torch.zeros(128), torch.zeros(128)]
        acc = torch.zeros(128)
        for _ in range(k):
            m, r = comp.compressed_psum_mean(gs, "dp", res)
            res = r if keep else [torch.zeros(128), torch.zeros(128)]
            acc = acc + m
        return float((acc / k - torch.from_numpy(exact)).abs().max())

    ef, no_ef = avg_error(True), avg_error(False)
    assert ef < no_ef / 5, (ef, no_ef)


STEPS = 8


@pytest.fixture(scope="module")
def gpt_setup():
    pt.seed(0)
    weights = {k: np.array(v) for k, v in
               jax_gpt_tiny().raw_parameters().items()}
    ids = np.random.RandomState(1).randint(0, 1024, (4, 32)).astype(
        np.int32)
    return weights, ids


def _jax_losses(weights, ids, compressed):
    pt.seed(0)
    jm = jax_gpt_tiny()
    params = {k: jnp.asarray(v) for k, v in weights.items()}
    o = jopt.Momentum(learning_rate=0.1, momentum=0.9)
    state = o.init(params)

    def loss_fn(p, b):
        logits, _ = pt.functional_call(jm, p, b[0])
        return jm.loss(logits, b[1])

    batch = (jnp.asarray(ids), jnp.asarray(ids))
    out = []
    if compressed:
        mesh = jpar.init_mesh(dp=2)
        res = j_zero(params, mesh=mesh, axis="dp")
        step = jax.jit(lambda p, s, r, b: j_step(loss_fn, o, p, s, r, b,
                                                 mesh=mesh, axis="dp"))
        for _ in range(STEPS):
            params, state, res, loss = step(params, state, res, batch)
            out.append(float(loss))
    else:
        @jax.jit
        def step(p, s, b):
            loss, g = jax.value_and_grad(lambda q: loss_fn(q, b))(p)
            p2, s2 = o.update(g, s, p)
            return p2, s2, loss
        for _ in range(STEPS):
            params, state, loss = step(params, state, batch)
            out.append(float(loss))
    jpar.set_mesh(None)
    return np.array(out)


def test_gpt_tiny_compressed_steps_follow_jax(gpt_setup):
    weights, ids = gpt_setup
    want = _jax_losses(weights, ids, compressed=True)
    exact = _jax_losses(weights, ids, compressed=False)
    m = load_jax_params(gpt_tiny(seed=1, device="cpu"), weights)
    params = {k: v.detach().clone() for k, v in m.named_parameters()}
    opt = Momentum(0.1, 0.9)
    state = opt.init(params)
    mesh = parallel.init_mesh(dp=2, device="cpu")
    res = comp.zero_residuals(params, mesh, "dp")

    def loss_fn(p, b):
        logits = torch.func.functional_call(m, p, (b[0],))
        return m.loss(logits, b[1])

    batch = (torch.from_numpy(ids).long(),) * 2
    got = []
    ranks.reset_counts()
    for _ in range(STEPS):
        params, state, res, loss = comp.compressed_grad_step(
            loss_fn, opt, params, state, res, batch, mesh=mesh, axis="dp")
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(got, exact, rtol=5e-3)
    assert got[-1] < got[0]
    # the gradients crossed as int8; fp32 only as one max per tensor
    # and rank, and the losses
    n_t = len(params)
    w = C.wire()
    assert w["int8"] == STEPS * 2 * sum(p.numel() for p in params.values())
    assert w["float32"] == STEPS * 2 * 4 * (n_t + 1)
