"""Pipeline parallelism of the port (`parallel/pipeline.py`) against the
JAX package's `pipeline_apply` on conftest's 8 virtual devices, same
weights and numpy inputs.

- `stack_block_params` / `unstack_block_params` and
  `PipelineStack.stacked_params` / `load_stacked_params` round trips
  (interleaved too), bitwise.
- `interleave_order`, `bubble_fraction` and `_num_ticks` equal JAX's
  over a grid of (num_micro, pp, v).
- The transformer-shaped block of `tests/test_pipeline_scale.py:241`
  (LayerNorm, causal self-attention through the flash kernels' plain
  versions, MLP) stacked 8 deep at pp 4, num_micro 4, v 1 and v 2:
  the loss sum(out^2) within 1e-5 relative and every stacked
  gradient within 1e-5 of its largest magnitude of JAX's (JAX's own
  bar against its sequential stack: rtol 1e-3, atol 1e-4); the ticks (one
  ppermute each) equal `_num_ticks`; at pp 1 with an `out_fn`, JAX's
  result.
- `PipelineStack.pipeline_forward` with num_micro 3 (not a multiple of
  pp: all-reduced, not scattered) equals the sequential stack.
- `PipelineStack` in `Trainer(mesh=)` at pp 4 (the reference's PPNet:
  a linear, 4 pipelined residual blocks, a head; Adam, 3 steps):
  losses within 2e-5 relative of JAX's Trainer, parameters within
  1e-4; num_micro from the fleet strategy's accumulate_steps.
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
from paddle_tpu.parallel import pipeline as jpp
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import ranks
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import pipeline as pp
from port_threads import one_torch_thread  # noqa: F401

H, HEADS, S = 16, 2, 8


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


class _JBlock(jnn.Layer):
    def __init__(self, i=0):
        super().__init__()
        pt.seed(200 + i)
        self.ln1 = jnn.LayerNorm(H)
        self.qkv = jnn.Linear(H, 3 * H)
        self.proj = jnn.Linear(H, H)
        self.ln2 = jnn.LayerNorm(H)
        self.fc1 = jnn.Linear(H, 2 * H)
        self.fc2 = jnn.Linear(2 * H, H)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv(self.ln1(x)).reshape(b, s, 3, HEADS, h // HEADS)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        a = jnn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, training=False)
        x = x + self.proj(a.reshape(b, s, h))
        return x + self.fc2(jnn.functional.gelu(self.fc1(self.ln2(x))))


class _PBlock(torch.nn.Module):
    def __init__(self, i=0):
        super().__init__()
        g = torch.Generator().manual_seed(200 + i)
        self.ln1 = nn.LayerNorm(H)
        self.qkv = nn.Linear(H, 3 * H, gen=g)
        self.proj = nn.Linear(H, H, gen=g)
        self.ln2 = nn.LayerNorm(H)
        self.fc1 = nn.Linear(H, 2 * H, gen=g)
        self.fc2 = nn.Linear(2 * H, H, gen=g)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv(self.ln1(x)).reshape(b, s, 3, HEADS, h // HEADS)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           training=False)
        x = x + self.proj(a.reshape(b, s, h))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


def test_stack_roundtrips():
    blocks = [_PBlock(i) for i in range(4)]
    st = pp.stack_block_params(blocks)
    assert tuple(st["qkv.weight"].shape) == (4, H, 3 * H)
    others = [_PBlock(10 + i) for i in range(4)]
    pp.unstack_block_params(st, others)
    assert torch.equal(others[2].fc1.weight, blocks[2].fc1.weight)
    parallel.init_mesh(pp=2, device="cpu")
    stack = pp.PipelineStack(_PBlock, num_layers=4, num_micro=2,
                             virtual_degree=2)
    before = [b.qkv.weight.detach().clone() for b in stack.blocks]
    rows = stack.stacked_params()
    order = pp.interleave_order(4, 2, 2)
    assert torch.equal(rows["qkv.weight"][1], before[order[1]])
    with torch.no_grad():
        for b in stack.blocks:
            b.qkv.weight.zero_()
    stack.load_stacked_params(rows)
    assert all(torch.equal(b.qkv.weight, w)
               for b, w in zip(stack.blocks, before))


def test_schedule_arithmetic_is_jax():
    for m in (1, 2, 3, 4, 5, 7, 8, 16):
        for p_ in (1, 2, 4):
            for v in (1, 2, 3):
                assert pp._num_ticks(m, p_, v) == jpp._num_ticks(m, p_, v)
                assert pp.bubble_fraction(m, p_, v) == \
                    jpp.bubble_fraction(m, p_, v)
                if (4 * 3 * 2) % (p_ * v) == 0:
                    assert pp.interleave_order(24, p_, v) == \
                        jpp.interleave_order(24, p_, v)
    assert pp.interleave_order(8, pp=2, virtual_degree=2) == \
        [0, 1, 4, 5, 2, 3, 6, 7]
    with pytest.raises(ValueError):
        pp.interleave_order(6, 4, 1)


@pytest.mark.parametrize("v", [1, 2])
def test_transformer_block_schedule_matches_jax(v):
    jmesh = jpar.init_mesh(dp=-1, pp=4)
    jstack = jpp.PipelineStack(_JBlock, num_layers=8, num_micro=4,
                               virtual_degree=v)
    x = np.random.RandomState(7).randn(8, S, H).astype(np.float32)
    jsp = jstack.stacked_params()

    def jloss(p, x):
        out = jpp.pipeline_apply(jstack._template, p, x, num_micro=4,
                                 mesh=jmesh, virtual_degree=v)
        return jax.numpy.sum(out ** 2)

    l_want, g_want = jax.jit(jax.value_and_grad(jloss))(
        jsp, jax.numpy.asarray(x))

    mesh = parallel.init_mesh(pp=4, device="cpu")
    stack = pp.PipelineStack(_PBlock, num_layers=8, num_micro=4,
                             virtual_degree=v)
    sp = {k: torch.from_numpy(np.array(a)).requires_grad_()
          for k, a in jsp.items()}
    ranks.reset_counts()
    out = pp.pipeline_apply(stack._template, sp, torch.from_numpy(x), 4,
                            mesh=mesh, virtual_degree=v)
    assert ranks.counts()["ppermute"] == pp._num_ticks(4, 4, v)
    loss = (out ** 2).sum()
    grads = dict(zip(sp, torch.autograd.grad(loss, list(sp.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(l_want),
                               rtol=1e-5)
    assert set(grads) == set(g_want)
    for k, want in g_want.items():
        want = np.asarray(want)
        err = np.abs(grads[k].numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (k, err)


def test_pp1_out_fn_and_odd_num_micro():
    jpar.init_mesh(dp=-1)
    jstack = jpp.PipelineStack(_JBlock, num_layers=2, num_micro=2)
    x = np.random.RandomState(4).randn(4, S, H).astype(np.float32)
    jsp = jstack.stacked_params()
    want = np.asarray(jpp.pipeline_apply(
        jstack._template, jsp, jax.numpy.asarray(x), 2,
        mesh=jpar.get_mesh(), out_fn=lambda o: o + 7.0))
    stack = pp.PipelineStack(_PBlock, num_layers=2, num_micro=2)
    sp = {k: torch.from_numpy(np.array(a)) for k, a in jsp.items()}
    got = pp.pipeline_apply(stack._template, sp, torch.from_numpy(x), 2,
                            out_fn=lambda o: o + 7.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    mesh = parallel.init_mesh(pp=4, device="cpu")
    stack = pp.PipelineStack(_PBlock, num_layers=4, num_micro=3)
    x6 = torch.from_numpy(np.random.RandomState(2).randn(6, S, H).astype(
        np.float32))
    ranks.reset_counts()
    got = stack.pipeline_forward(x6, mesh=mesh)
    c = ranks.counts()
    assert c["all_reduce"] == 1 and c["reduce_scatter"] == 0
    torch.testing.assert_close(got, stack(x6), rtol=1e-5, atol=1e-6)


class _JResBlock(jnn.Layer):
    def __init__(self, i=0):
        super().__init__()
        self.fc = jnn.Linear(16, 16)

    def forward(self, x):
        return x + jnn.functional.gelu(self.fc(x))


class _PResBlock(torch.nn.Module):
    def __init__(self, i=0):
        super().__init__()
        self.fc = nn.Linear(16, 16, gen=torch.Generator().manual_seed(i))

    def forward(self, x):
        return x + F.gelu(self.fc(x))


class _JPPNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.inp = jnn.Linear(8, 16)
        self.stack = jpp.PipelineStack(_JResBlock, 4, num_micro=2)
        self.head = jnn.Linear(16, 4)

    def forward(self, x):
        return self.head(self.stack.pipeline_forward(self.inp(x)))


class _PPNet(torch.nn.Module):
    def __init__(self, num_micro=2):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.inp = nn.Linear(8, 16, gen=g)
        self.stack = pp.PipelineStack(_PResBlock, 4, num_micro=num_micro)
        self.head = nn.Linear(16, 4, gen=g)

    def forward(self, x):
        return self.head(self.stack.pipeline_forward(self.inp(x)))


def test_pipeline_stack_in_the_trainer_matches_jax():
    x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 4, (8,))
    pt.seed(3)
    jm = _JPPNet()
    weights = {k: np.array(v) for k, v in jm.raw_parameters().items()}
    jt = JaxTrainer(jm, jopt.Adam(learning_rate=0.01),
                    lambda o, t: jnn.functional.cross_entropy(o, t),
                    mesh=jpar.init_mesh(dp=-1, pp=4), donate=False)
    want = [float(jt.train_step(x, y)[0]) for _ in range(3)]
    m = load_jax_state(_PPNet(), weights)
    tr = Trainer(m, Adam(0.01), lambda o, t: F.cross_entropy(o, t),
                 mesh=parallel.init_mesh(pp=4, device="cpu"))
    ranks.reset_counts()
    got = [float(tr.train_step(x, y)[0]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert ranks.counts()["ppermute"] == 3 * pp._num_ticks(2, 4, 1)
    st = tr.gathered_state()
    for k, v in jt.state.params.items():
        v = np.asarray(v)
        assert np.abs(st.params[k].numpy() - v).max() < 1e-4 * max(
            1.0, np.abs(v).max()), k


def test_num_micro_from_the_strategy():
    from paddle_tpu_torch.parallel import fleet
    fleet.init(strategy=parallel.DistributedStrategy(
        pipeline=True, pipeline_configs={"accumulate_steps": 4}),
        world_size=1, device="cpu")
    stack = pp.PipelineStack(_PResBlock, num_layers=4)
    assert stack._resolve_micro() == 4 and stack._resolve_micro(2) == 2
    assert pp.PipelineStack(_PResBlock, 4, num_micro=8)._resolve_micro() \
        == 8
    fleet.init(strategy=parallel.DistributedStrategy(), world_size=1,
               device="cpu")
    assert stack._resolve_micro() == 1
