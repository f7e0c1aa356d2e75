"""`parallel.localsgd` of the port against the JAX package's
`parallel/localsgd.py` on conftest's 8 virtual CPU devices.

- Three rounds of `LocalSGD` (k 4, dp 8, Adam 0.01 on JAX's MLP twin,
  the same weights and batch): losses within 1e-5 relative and
  parameters and Adam's moments within 1e-5 of their largest
  magnitude (each rank's 4 steps and the rank-order mean; XLA's psum
  may add in another order); the step counter counts 4 a round.
- One exchange per round: one `all_reduce` over every parameter, slot
  and loss (an fp32 model), and no gradient collective.
- `per_step_batches`: a leading k dim, checked; a round over per-step
  batches against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import parallel as jpar
from paddle_tpu.parallel.localsgd import LocalSGD as JLocalSGD
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import collective as C
from paddle_tpu_torch.parallel.localsgd import LocalSGD, local_train_steps
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _data():
    rng = np.random.RandomState(0)
    y = rng.randint(0, 4, (64,))
    x = (rng.randn(64, 8) + np.eye(4)[y] @ rng.randn(4, 8) * 2).astype(
        np.float32)
    return x, y


@pytest.fixture(scope="module")
def weights():
    pt.seed(0)
    m = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    return {k: np.array(v) for k, v in m.raw_parameters().items()}


def _jax(weights, batch, rounds, per_step=False):
    pt.seed(0)
    m = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    params = {k: jnp.asarray(v) for k, v in weights.items()}
    o = jopt.Adam(learning_rate=0.01)
    state = o.init(params)

    def loss_fn(p, b):
        out, _ = pt.functional_call(m, p, b[0])
        return jnn.functional.cross_entropy(out, b[1])

    mesh = jpar.init_mesh(dp=-1)
    lsgd = JLocalSGD(loss_fn, o, k_steps=4, mesh=mesh,
                     per_step_batches=per_step)
    losses = []
    for _ in range(rounds):
        params, state, lo = lsgd.round(params, state, batch)
        losses.append(np.asarray(lo))
    jpar.set_mesh(None)
    return losses, jax.tree_util.tree_map(np.asarray, (params, state))


def _port(weights, per_step=False):
    g = torch.Generator().manual_seed(0)
    m = load_jax_state(nn.Sequential(nn.Linear(8, 16, gen=g), nn.ReLU(),
                                     nn.Linear(16, 4, gen=g)), weights)
    params = {k: v.detach().clone() for k, v in m.named_parameters()}
    opt = Adam(0.01)
    mesh = parallel.init_mesh(dp=-1, world_size=8, device="cpu")

    def loss_fn(p, b):
        return F.cross_entropy(torch.func.functional_call(m, p, (b[0],)),
                               b[1])

    return LocalSGD(loss_fn, opt, k_steps=4, mesh=mesh,
                    per_step_batches=per_step), params, opt.init(params)


def _close(got, want, what):
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= 1e-5 * scale, what


def test_rounds_match_jax_one_exchange_each(weights):
    x, y = _data()
    want, (jparams, jstate) = _jax(weights, (jnp.asarray(x),
                                             jnp.asarray(y)), 3)
    lsgd, params, state = _port(weights)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for r in range(3):
        C.reset_counts()
        params, state, losses = lsgd.round(params, state, batch)
        assert losses.shape == (4,)
        np.testing.assert_allclose(losses.numpy(), want[r], rtol=1e-5)
        counts = C.counts()
        assert counts["all_reduce"] == 1 and sum(counts.values()) == 1
        assert state["step"] == 4 * (r + 1)
    assert want[-1][-1] < want[0][0] * 0.5
    for k, v in params.items():
        _close(v.numpy(), jparams[k], k)
        for s, t in state["slots"][k].items():
            _close(t.numpy(), jstate["slots"][k][s], f"{k}.{s}")


def test_per_step_batches(weights):
    x, y = _data()
    xs = np.stack([np.roll(x, i, axis=0) for i in range(4)])
    ys = np.stack([np.roll(y, i, axis=0) for i in range(4)])
    want, (jparams, _) = _jax(weights, (jnp.asarray(xs), jnp.asarray(ys)),
                              1, per_step=True)
    lsgd, params, state = _port(weights, per_step=True)
    params, state, losses = lsgd.round(
        params, state, (torch.from_numpy(xs), torch.from_numpy(ys)))
    np.testing.assert_allclose(losses.numpy(), want[0], rtol=1e-5)
    for k, v in params.items():
        _close(v.numpy(), jparams[k], k)
    with pytest.raises(ValueError, match="k_steps 4"):
        local_train_steps(lsgd.loss_fn, lsgd.optimizer, params, state,
                          (torch.from_numpy(xs[:3]),
                           torch.from_numpy(ys[:3])), 4, mesh=lsgd.mesh,
                          per_step_batches=True)
    parallel.set_mesh(None)
    with pytest.raises(ValueError, match="mesh with a 'dp' axis"):
        local_train_steps(lsgd.loss_fn, lsgd.optimizer, params, state,
                          (torch.from_numpy(x), torch.from_numpy(y)), 4,
                          mesh=None)
