"""Mixture of experts of the port (`parallel/moe.py`) against the JAX
package's `MoELayer` on conftest's 8 virtual devices, same weights
(carried by `load_jax_state`) and numpy tokens; the gate's noise off
(noise_std 0: JAX draws it from its own generator).

- Dense (no mesh): the output and the aux loss within 1e-5 relative
  (atol 1e-6) of JAX's, and of the reference's per-token numpy loop.
- ep 8 (the expert-parallel route: each rank gates its tokens, two
  all_to_alls, an all_gather) with a capacity that drops no token:
  equal to the dense route within 1e-5 and to JAX's ep 8 output;
  the collectives counted.
- The aux loss: gshard's load-balancing formula, the mean over the ep
  ranks under ep.
- Capacity drops: with capacity 4 per expert at most 8 tokens are
  routed, and the dropped tokens are JAX's.
- Training: a net of an MoE layer and a head, cross-entropy, 3 Adam
  steps at ep 4 under `Trainer(mesh=)`: losses within 2e-5 relative of
  JAX's Trainer at ep 4, parameters within 1e-4. With 0.01 x the aux
  loss added (dp 2 x ep 4: finite, falling), the first step's loss is
  the cross-entropy plus 0.01 x that forward's aux loss. (JAX's Trainer
  reads `aux_loss` in the loss function as the layer's stored buffer,
  not the traced forward's, so the aux term is compared inside the
  port only.)
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import parallel as jpar
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.parallel.moe import MoELayer as JMoE
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import ranks
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel.moe import MoELayer, gshard_dispatch
from paddle_tpu_torch.parallel.sharding import model_splits
from port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _pair(d_model=8, d_hidden=16, e=4, top_k=2, cap_f=8.0, gate="gshard"):
    """(JAX layer, port layer) with the JAX layer's weights, eval, no
    noise, the same capacity factor in training and eval."""
    pt.seed(0)
    j = JMoE(d_model, d_hidden, e, top_k=top_k, capacity_factor=cap_f,
             gate_type=gate)
    p = MoELayer(d_model, d_hidden, e, top_k=top_k, capacity_factor=cap_f,
                 gate_type=gate, gen=torch.Generator())
    load_jax_state(p, {k: np.array(v) for k, v in
                       j.raw_parameters().items()})
    for layer in (j, p):
        layer.gate.noise_std = 0.0
        layer.gate.eval_capacity_factor = cap_f
        layer.eval()
    return j, p


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6, err_msg=what)


def _per_token_reference(x, layer):
    """The reference test's numpy loop (tests/test_sequence_moe.py:172):
    top-k with capacity, renormalised gates, exact-gelu experts."""
    from scipy.special import erf
    g, ex = layer.gate, layer.experts
    w = g.weight.detach().double().numpy()
    w1, b1 = ex.w1.detach().double().numpy(), ex.b1.detach().double().numpy()
    w2, b2 = ex.w2.detach().double().numpy(), ex.b2.detach().double().numpy()
    s, e = x.shape[0], w.shape[1]
    cap = g.capacity(s)
    logits = x.astype(np.float64) @ w
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    counts, sel, remaining = np.zeros(e, np.int64), np.zeros((s, e)), \
        probs.copy()
    for _ in range(g.top_k):
        idx = remaining.argmax(-1)
        for t in range(s):
            if counts[idx[t]] < cap:
                sel[t, idx[t]] = probs[t, idx[t]]
            counts[idx[t]] += 1
        remaining[np.arange(s), idx] = 0.0
    den = sel.sum(-1, keepdims=True)
    gates = np.where(den > 0, sel / np.maximum(den, 1e-9), 0.0)
    out = np.zeros((s, w2.shape[2]))
    for t in range(s):
        for ei in range(e):
            if gates[t, ei] > 0:
                h = x[t].astype(np.float64) @ w1[ei] + b1[ei]
                h = 0.5 * h * (1 + erf(h / np.sqrt(2)))
                out[t] += gates[t, ei] * (h @ w2[ei] + b2[ei])
    return out


def test_dense_matches_jax_and_the_per_token_loop():
    j, p = _pair()
    x = np.random.RandomState(0).randn(2, 8, 8).astype(np.float32)
    want = np.asarray(j(jax.numpy.asarray(x)))
    got = p(torch.from_numpy(x))
    _close(got.detach(), want, "out")
    _close(float(p.aux_loss.detach()), float(j.aux_loss), "aux")
    np.testing.assert_allclose(got.detach().numpy().reshape(16, 8),
                               _per_token_reference(x.reshape(16, 8), p),
                               rtol=1e-4, atol=1e-5)


def test_ep8_matches_dense_and_jax():
    j, p = _pair(e=8, cap_f=16.0)
    x = np.random.RandomState(1).randn(4, 16, 8).astype(np.float32)
    dense = p(torch.from_numpy(x)).detach()
    dense_aux = float(p.aux_loss.detach())
    mesh = parallel.init_mesh(ep=8, device="cpu")
    ranks.reset_counts()
    ep = p(torch.from_numpy(x)).detach()
    c = ranks.counts()
    assert (c["all_to_all"], c["all_gather"], c["all_reduce"]) == (2, 1, 1)
    _close(ep, dense, "ep vs dense")
    jpar.init_mesh(ep=8)
    j_out, j_upd = jax.jit(lambda prm, xx: pt.functional_call(
        j, prm, xx, training=False))(j.raw_parameters(),
                                     jax.numpy.asarray(x))
    _close(ep, np.asarray(j_out), "ep vs JAX ep")
    # the aux loss: the mean over the ep ranks of each rank's gshard aux
    flat = torch.from_numpy(x).reshape(64, 8)
    per = [gshard_dispatch(flat[i * 8:(i + 1) * 8], p.gate.weight, top_k=2,
                           capacity=p.gate.capacity(8))[2]
           for i in range(8)]
    aux = float(p.aux_loss.detach())
    _close(aux, float(sum(per) / 8), "aux over ep")
    _close(aux, float(j_upd["_aux"]), "aux vs JAX")
    assert aux != dense_aux
    del mesh


def test_capacity_drops_match_jax():
    j, p = _pair(e=2, top_k=1, cap_f=0.01)
    x = np.random.RandomState(2).randn(1, 64, 8).astype(np.float32)
    got = p(torch.from_numpy(x)).detach().numpy().reshape(64, 8)
    want = np.asarray(j(jax.numpy.asarray(x))).reshape(64, 8)
    routed = np.abs(got).sum(-1) > 1e-6
    assert routed.sum() <= 8                  # capacity max(4, ...) = 4
    np.testing.assert_array_equal(routed, np.abs(want).sum(-1) > 1e-6)
    _close(got, want)


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.moe = JMoE(8, 16, 4, capacity_factor=8.0)
        self.moe.gate.noise_std = 0.0
        self.head = jnn.Linear(8, 4)

    def forward(self, x):
        return self.head(self.moe(x).mean(axis=1))


class _PNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.moe = MoELayer(8, 16, 4, capacity_factor=8.0, gen=g)
        self.moe.gate.noise_std = 0.0
        self.head = nn.Linear(8, 4, gen=g)

    def forward(self, x):
        return self.head(self.moe(x).mean(dim=1))


def test_moe_trains_under_ep_like_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(8, 4, 8).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 4, (8,))
    pt.seed(0)
    jm = _JNet()
    weights = {k: np.array(v) for k, v in jm.raw_parameters().items()}
    jt = JaxTrainer(jm, jopt.Adam(learning_rate=0.01),
                    lambda o, t: jnn.functional.cross_entropy(o, t),
                    mesh=jpar.init_mesh(ep=4), donate=False)
    want = [float(jt.train_step(x, y)[0]) for _ in range(3)]

    def port(mesh_kw, steps=3, aux=0.0):
        m = load_jax_state(_PNet(), weights)
        mesh = parallel.init_mesh(**mesh_kw, device="cpu")
        tr = Trainer(m, Adam(0.01), lambda o, t: F.cross_entropy(o, t)
                     + aux * m.moe.aux_loss, mesh=mesh)
        return [float(tr.train_step(x, y)[0]) for _ in range(steps)], tr

    got, tr = port(dict(ep=4))
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert model_splits(tr.model, tr.mesh)["moe.experts.w1"] == \
        [(0, "ep", 1)]
    st = tr.gathered_state()
    for k, v in jt.state.params.items():
        v = np.asarray(v)
        assert np.abs(st.params[k].numpy() - v).max() < 1e-4 * max(
            1.0, np.abs(v).max()), k
    with_aux, _ = port(dict(ep=4), steps=1, aux=0.01)
    m = load_jax_state(_PNet(), weights)
    m.moe(torch.from_numpy(x))
    np.testing.assert_allclose(with_aux[0], got[0] + 0.01 * float(
        m.moe.aux_loss.detach()), rtol=1e-6)
    losses, _ = port(dict(dp=2, ep=4), steps=6, aux=0.01)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_noisy_gate_ep_draws_the_dense_routes_noise():
    """gshard noise in training, drawn from the Trainer's key: at ep 4
    each rank keeps its rows of one draw over all tokens, so the ep
    route gates as the dense route does (cross-entropy losses within
    1e-5 relative over 3 Adam steps; the aux loss is each route's own),
    and another key gives another loss."""
    x = np.random.RandomState(3).randn(8, 4, 8).astype(np.float32)
    y = np.random.RandomState(4).randint(0, 4, (8,))

    def run(mesh, seed=0):
        m = _PNet()
        m.moe.gate.noise_std = 1.0
        tr = Trainer(m, Adam(0.01), lambda o, t: F.cross_entropy(o, t),
                     mesh=mesh)
        tr.init_state(rng_seed=seed)
        return [float(tr.train_step(x, y)[0]) for _ in range(3)]

    dense = run(None)
    np.testing.assert_allclose(run(parallel.init_mesh(ep=4, device="cpu")),
                               dense, rtol=1e-5)
    parallel.set_mesh(None)
    assert run(None, seed=1)[0] != dense[0]
