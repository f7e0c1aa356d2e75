"""Synced batch norm under `Trainer(mesh=)` against the JAX Trainer at
dp 4 on conftest's virtual devices, on a few-channel ResNet (stem
conv-BN-ReLU, a BasicBlock, a strided BasicBlock with its downsample
branch, pool and head: 6 batch norms, NHWC), same weights and images.

JAX's batch norm over a sharded batch reduces over the global batch;
the port averages each rank's shifted moments over the data ranks in
rank order mid-forward (`nn.ranks.sync_moments`), runs one backward
over the four ranks and all-reduces their gradients. fp32 throughout:
- 3 Momentum steps: losses within 1e-5 relative, running statistics
  within 1e-5 of their largest magnitude, parameters within 1e-4;
- one SGD step at lr 1: the gradients (p0 - p1) within 1e-4 of the
  largest magnitude, per tensor;
- `grad_accum=2` under the mesh (statistics threaded through the two
  microbatches, each split over the ranks) against JAX's;
- inside the port: dp 4 equals one rank's whole-batch step (sync batch
  norm is the global batch's), remat equals no remat bitwise, and
  `SyncBatchNorm.convert_sync_batchnorm` keeps the weights and the
  results; one statistics all-reduce per batch norm per forward.
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
from paddle_tpu.models.resnet import BasicBlock as JBlock
from paddle_tpu_torch import nn, parallel
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.models.resnet import BasicBlock
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import ranks
from paddle_tpu_torch.optimizer import SGD, Momentum
from port_resnet import images, numpy_tree, rel_err
from port_threads import one_torch_thread  # noqa: F401

FMT = "NHWC"
N_BN = 6


@pytest.fixture(autouse=True)
def _clear_meshes():
    yield
    jpar.set_mesh(None)
    parallel.set_mesh(None)


def _tiny_resnet(pkg):
    n = jnn if pkg == "jax" else nn
    kw = {"data_format": FMT}
    if pkg == "jax":
        g, blk = {}, JBlock
    else:
        gen = torch.Generator().manual_seed(0)
        g = {"gen": gen}

        def blk(*a, **k):
            return BasicBlock(a[0], a[1], gen, *a[2:], **k)
    down = n.Sequential(n.Conv2D(8, 16, 1, stride=2, bias_attr=False,
                                 **kw, **g), n.BatchNorm2D(16, **kw))
    return n.Sequential(
        n.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw, **g),
        n.BatchNorm2D(8, **kw), n.ReLU(),
        blk(8, 8, data_format=FMT),
        blk(8, 16, 2, down, data_format=FMT),
        n.AdaptiveAvgPool2D(1, **kw), n.Flatten(), n.Linear(16, 5, **g))


@pytest.fixture(scope="module")
def weights():
    pt.seed(3)
    m = _tiny_resnet("jax")
    return numpy_tree(m.raw_parameters()), numpy_tree(m.raw_buffers())


def _batch():
    return images(16, 8, FMT, classes=5, seed=4)


def _jax_run(weights, steps, opt, dp=4, accum=1):
    params, buffers = weights
    m = _tiny_resnet("jax")
    m.load_raw_parameters({k: jax.numpy.asarray(v)
                           for k, v in params.items()})
    m.load_raw_buffers({k: jax.numpy.asarray(v) for k, v in buffers.items()})
    mesh = jpar.init_mesh(dp=dp) if dp > 1 else None
    tr = JaxTrainer(m, opt, lambda o, y: jnn.functional.cross_entropy(o, y),
                    mesh=mesh, donate=False, grad_accum=accum)
    x, y = _batch()
    losses = [float(tr.train_step(x, y)[0]) for _ in range(steps)]
    jpar.set_mesh(None)
    return losses, numpy_tree(tr.state.params), numpy_tree(tr.state.buffers)


def _port_trainer(weights, opt, dp=4, accum=1, remat=False, convert=False):
    params, buffers = weights
    m = load_jax_state(_tiny_resnet("torch"), params, buffers)
    if convert:
        m = nn.SyncBatchNorm.convert_sync_batchnorm(m)
    mesh = parallel.init_mesh(dp=dp, device="cpu") if dp > 1 else None
    return Trainer(m, opt, lambda o, y: F.cross_entropy(o, y), mesh=mesh,
                   grad_accum=accum, remat=remat)


def _port_run(weights, steps, opt, **kw):
    tr = _port_trainer(weights, opt, **kw)
    x, y = _batch()
    losses = [float(tr.train_step(x, y)[0]) for _ in range(steps)]
    st = tr.gathered_state()
    return losses, st.params, st.buffers


def _close(got, want, tol):
    for k, v in want.items():
        assert rel_err(got[k], v) < tol, (k, rel_err(got[k], v))


def test_three_momentum_steps_match_jax_at_dp4(weights):
    want = _jax_run(weights, 3, jopt.Momentum(0.1, 0.9))
    ranks.reset_counts()
    got = _port_run(weights, 3, Momentum(0.1, 0.9))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[0][-1] < got[0][0]
    _close(got[2], want[2], 1e-5)            # running statistics
    _close(got[1], want[1], 1e-4)
    # per step: one moments all-reduce per batch norm, one count
    # all-reduce, one gradient all-reduce per parameter
    nparams = len(weights[0])
    assert ranks.counts()["all_reduce"] == 3 * (N_BN + 1 + nparams)


def test_gradients_match_jax_at_dp4(weights):
    p0 = weights[0]
    _, jp, jb = _jax_run(weights, 1, jopt.SGD(learning_rate=1.0))
    _, tp, tb = _port_run(weights, 1, SGD(1.0))
    for k in p0:
        want = p0[k] - jp[k]
        got = p0[k] - tp[k].numpy()
        assert np.abs(got - want).max() < 1e-4 * np.abs(want).max(), k
    _close(tb, jb, 1e-5)


def test_grad_accum_under_the_mesh_matches_jax(weights):
    want = _jax_run(weights, 2, jopt.Momentum(0.1, 0.9), accum=2)
    got = _port_run(weights, 2, Momentum(0.1, 0.9), accum=2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    _close(got[2], want[2], 1e-5)
    _close(got[1], want[1], 1e-4)


def test_inside_the_port_dp4_is_the_whole_batch_step(weights):
    one = _port_run(weights, 2, Momentum(0.1, 0.9), dp=1)
    dp4 = _port_run(weights, 2, Momentum(0.1, 0.9))
    np.testing.assert_allclose(dp4[0], one[0], rtol=1e-6)
    _close(dp4[1], one[1], 1e-5)
    _close(dp4[2], one[2], 1e-6)
    remat = _port_run(weights, 2, Momentum(0.1, 0.9), remat=True)
    assert remat[0] == dp4[0]
    assert all(torch.equal(remat[1][k], dp4[1][k]) for k in dp4[1])
    assert all(torch.equal(remat[2][k], dp4[2][k]) for k in dp4[2])
    conv = _port_run(weights, 2, Momentum(0.1, 0.9), convert=True)
    assert conv[0] == dp4[0]


def test_convert_sync_batchnorm_keeps_weights():
    m = _tiny_resnet("torch")
    before = {k: v.clone() for k, v in m.state_dict().items()}
    c = nn.SyncBatchNorm.convert_sync_batchnorm(m)
    bns = [x for x in c.modules() if isinstance(x, nn.BatchNorm2D)]
    assert not bns                              # every one converted
    syncs = [x for x in c.modules() if isinstance(x, nn.SyncBatchNorm)]
    assert len(syncs) == N_BN
    after = c.state_dict()
    assert set(after) == set(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    # the JAX package converts the same layers
    jm = jnn.SyncBatchNorm.convert_sync_batchnorm(_tiny_resnet("jax"))
    jsync = [x for _, x in jm.named_sublayers()
             if isinstance(x, jnn.SyncBatchNorm)]
    assert len(jsync) == N_BN
    one = nn.BatchNorm2D(4)
    assert isinstance(nn.SyncBatchNorm.convert_sync_batchnorm(one),
                      nn.SyncBatchNorm)
