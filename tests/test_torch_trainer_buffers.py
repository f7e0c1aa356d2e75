"""The port Trainer's buffer step (BatchNorm's running statistics)
against the JAX Trainer's, and the ResNet layout identities inside the
port.

On a small conv net (Conv-BN-ReLU-Pool twice, the head; the JAX
Trainer's threading of the statistics does not depend on the model),
same weights and numpy batches, fp32, within 1e-5 relative:
`grad_accum=2` threads the statistics through the microbatches, a step
the GradScaler rejects still writes them, `eval_step` leaves them, all
as in JAX. On ResNet-18 inside the port: remat is bitwise no remat for
the losses, parameters and buffers of 3 steps; `stem_s2d` equals
`conv1` and NHWC equals NCHW (fp32: logits within 2e-5 and gradients
within 1e-4 of the largest magnitude, other summation orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import load_jax_state, resnet18
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from port_resnet import f32, images, numpy_tree, rel_err, worst
from port_threads import one_torch_thread  # noqa: F401

KW = dict(num_classes=10, data_format="NHWC", stem_s2d=True)


def _ce(out, y):
    return F.cross_entropy(out, y)


def _jce(out, y):
    return jnn.functional.cross_entropy(out, y)


def test_stem_s2d_and_nhwc_equal_plain_inside_the_port():
    """One weight set in three layouts: NCHW conv1, NHWC conv1 and NHWC
    space-to-depth give the same logits and gradients (fp32)."""
    plain = resnet18(num_classes=10, device="cpu", seed=5)
    x, y = images(8, 32, "NCHW", seed=6)
    outs, grads = [], []
    for fmt, s2d in (("NCHW", False), ("NHWC", False), ("NHWC", True)):
        m = resnet18(num_classes=10, device="cpu", seed=9, data_format=fmt,
                     stem_s2d=s2d)
        m.load_state_dict(plain.state_dict())
        m.train()
        xi = x if fmt == "NCHW" else x.transpose(0, 2, 3, 1).copy()
        out = m(torch.from_numpy(xi))
        F.cross_entropy(out, torch.from_numpy(y)).backward()
        outs.append(out.detach())
        grads.append({k: p.grad for k, p in m.named_parameters()})
    for o, g in zip(outs[1:], grads[1:]):
        assert rel_err(o, outs[0]) < 2e-5
        assert worst(g, grads[0])[0] < 1e-4


# --------------------------------------------------------------------------- #
# the Trainer's buffer step, on a small conv net
# --------------------------------------------------------------------------- #

def _small(pkg):
    """Conv-BN-ReLU-Pool-Conv-BN-ReLU-AvgPool-Flatten-Linear in either
    package (names equal)."""
    n = jnn if pkg == "jax" else nn
    g = {} if pkg == "jax" else {"gen": torch.Generator().manual_seed(0)}
    return n.Sequential(
        n.Conv2D(3, 8, 3, padding=1, data_format="NHWC", **g),
        n.BatchNorm2D(8, data_format="NHWC"), n.ReLU(),
        n.MaxPool2D(2, 2, data_format="NHWC"),
        n.Conv2D(8, 8, 3, padding=1, data_format="NHWC", **g),
        n.BatchNorm2D(8, data_format="NHWC"), n.ReLU(),
        n.AdaptiveAvgPool2D(1, data_format="NHWC"), n.Flatten(),
        (n.Linear(8, 5) if pkg == "jax" else n.Linear(8, 5, **g)))


@pytest.fixture(scope="module")
def small():
    import paddle_tpu as pt
    pt.seed(0)
    jm = _small("jax")
    P, B = numpy_tree(jm.raw_parameters()), numpy_tree(jm.raw_buffers())
    x = (np.random.RandomState(0).randn(8, 8, 8, 3) * 2 + 1).astype(
        np.float32)
    y = np.random.RandomState(1).randint(0, 5, (8,))
    return jm, P, B, x, y


def _port_small(P, B):
    return load_jax_state(_small("port"), P, B)


@pytest.mark.parametrize("accum", [1, 2])
def test_grad_accum_threads_the_stats_as_jax(small, accum):
    """With grad_accum=2, microbatch 2 normalises with the statistics
    microbatch 1 left, and both updates land, as in the JAX scan."""
    jm, P, B, x, y = small
    jt = JaxTrainer(jm, jopt.Momentum(0.05, 0.9), _jce, grad_accum=accum,
                    donate=False)
    _, jl = jt.train_steps(x, y, steps=2)
    tr = Trainer(_port_small(P, B), Momentum(0.05, 0.9), _ce,
                 grad_accum=accum)
    _, pl = tr.train_steps(x, y, steps=2)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5)
    assert worst(tr.state.buffers, jt.state.buffers)[0] < 1e-5
    assert worst(tr.state.params, jt.state.params)[0] < 1e-5
    if accum == 2:                 # the threaded stats differ from one
        one = Trainer(_port_small(P, B), Momentum(0.05, 0.9), _ce)
        one.train_steps(x, y, steps=2)
        assert worst(one.state.buffers, jt.state.buffers)[0] > 1e-3


def test_rejected_step_still_writes_the_stats_as_jax(small):
    """A GradScaler step whose gradients are not finite (the loss times
    inf) is rejected: parameters and slots stay. The BatchNorm
    statistics of its forward are written all the same, as JAX's
    unconditional merge does."""
    jm, P, B, x, y = small
    jt = JaxTrainer(jm, jopt.Momentum(0.05, 0.9),
                    lambda o, t: _jce(o, t) * jnp.inf, donate=False,
                    scaler=jamp.GradScaler())
    jt.train_step(x, y)
    tr = Trainer(_port_small(P, B), Momentum(0.05, 0.9),
                 lambda o, t: _ce(o, t) * float("inf"),
                 scaler=amp.GradScaler())
    tr.train_step(x, y)
    assert float(tr.state.scaler_state["bad_steps"]) == \
        float(jt.state.scaler_state["bad_steps"]) == 1
    for k, v in P.items():                     # rejected in both
        assert np.array_equal(f32(tr.state.params[k]), v), k
        assert np.array_equal(np.asarray(jt.state.params[k]), v), k
    assert tr.state.opt_state["step"] == 0
    assert worst(tr.state.buffers, jt.state.buffers)[0] < 1e-5
    for k in B:
        assert not np.array_equal(f32(tr.state.buffers[k]), B[k]), k


def test_eval_step_leaves_the_stats(small):
    jm, P, B, x, y = small
    jt = JaxTrainer(jm, jopt.Momentum(0.05, 0.9), _jce, donate=False)
    jt.train_steps(x, y, steps=1)
    jloss, jout = jt.eval_step(x, y)
    tr = Trainer(_port_small(P, B), Momentum(0.05, 0.9), _ce)
    tr.train_steps(x, y, steps=1)
    before = {k: v.clone() for k, v in tr.state.buffers.items()}
    loss, out = tr.eval_step(x, y)
    for k, v in tr.state.buffers.items():
        assert torch.equal(v, before[k]), k
    assert rel_err(out, jout) < 1e-5
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_remat_is_bitwise_no_remat():
    """Parameters, buffers and losses, 3 steps of ResNet-18 fp32: the
    recomputed forward writes no statistics of its own."""
    x, y = images(8, 32)
    runs = []
    for remat in (False, True):
        tr = Trainer(resnet18(device="cpu", **KW), Momentum(1e-3, 0.9), _ce,
                     remat=remat)
        _, losses = tr.train_steps(x, y, steps=3)
        runs.append((losses, tr.state))
    (l0, s0), (l1, s1) = runs
    assert torch.equal(l0, l1)
    for k in s0.params:
        assert torch.equal(s0.params[k], s1.params[k]), k
    for k in s0.buffers:
        assert torch.equal(s0.buffers[k], s1.buffers[k]), k


def test_module_in_train_mode_outside_the_trainer_updates_itself(small):
    """Outside the Trainer the model's own buffers move; under it they
    stay where they were (the state holds the new ones)."""
    _, P, B, x, y = small
    m = _port_small(P, B)
    tr = Trainer(m, Momentum(0.05, 0.9), _ce)
    tr.train_steps(x, y, steps=1)
    for k, v in m.named_buffers():
        assert np.array_equal(f32(v), B[k]), k
    m.train()
    m(torch.from_numpy(x))
    for k, v in m.named_buffers():
        assert not np.array_equal(f32(v), B[k]), k
