"""The port's ResNet-18 against the JAX package's, and the port's
Trainer buffer semantics (BatchNorm statistics).

Same weights (the JAX model's `raw_parameters()` / `raw_buffers()`
carried over by `load_jax_state`), same numpy batches (seeded), fp32:
- the training and eval forwards (NHWC with `stem_s2d`, and NCHW);
- 3 `Trainer` steps of Momentum(1e-3, 0.9) at 8 x 32 x 32: the losses,
  every parameter, every BatchNorm buffer and every velocity slot. At
  32 x 32 `layer4` sees a 1 x 1 plane, so batch norm there normalises
  over the batch alone and amplifies rounding: the first step's
  gradients agree within 3e-5, but at lr 1e-2 the loss falls 200x in
  three steps and the third step's gradients differ by 1% between the
  packages (as between any two summation orders), so the lockstep runs
  at 1e-3;
- a JAX train state resumed in the port and stepped on in lockstep.
Tolerances: logits and losses within 1e-4 relative (a loss near 0
within 2e-5 of the first one absolute); after 3 steps each
parameter, buffer and slot within 1e-3 of its largest magnitude and
each parameter within 1e-2 of how far it moved (the errors seen are
3e-5 and 6e-4: the two packages sum every convolution and reduction in
other orders, and the differences grow through three steps of a
20-layer network).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.models import resnet18 as jax_resnet18
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import (from_jax_train_state, load_jax_state,
                                     resnet18)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from port_resnet import (f32, images, jax_model, numpy_tree, port_twin,
                         rel_err, worst, worst_move)
from port_threads import one_torch_thread  # noqa: F401

KW = dict(num_classes=10, data_format="NHWC", stem_s2d=True)
LR, STEPS = 1e-3, 3


@pytest.fixture(scope="module")
def jax_r18():
    return jax_model(jax_resnet18, **KW)


@pytest.fixture(scope="module")
def batch():
    return images(8, 32)


def _ce(out, y):
    return F.cross_entropy(out, y)


def _jce(out, y):
    return jnn.functional.cross_entropy(out, y)


@pytest.fixture(scope="module")
def jax_run(jax_r18, batch):
    """The JAX Trainer's 3 steps and, from that state, 2 more."""
    jm, _, _ = jax_r18
    tr = JaxTrainer(jm, jopt.Momentum(LR, 0.9), _jce, donate=False)
    _, losses = tr.train_steps(*batch, steps=STEPS)
    tree = numpy_tree(tr.state.tree())
    _, more = tr.train_steps(*batch, steps=2)
    return {"losses": np.array(losses), "tree": tree,
            "more": np.array(more), "final": numpy_tree(tr.state.tree())}


def _losses_close(got, want):
    """Each within 1e-4 relative, or 2e-5 x the first loss absolute (the
    loss falls ~200x in three steps on one batch)."""
    want = np.asarray(want)
    np.testing.assert_allclose(f32(got), want, rtol=1e-4,
                               atol=2e-5 * abs(want[0]))


def test_forward_matches_jax(jax_r18):
    """Training mode (batch statistics and their updates) and eval mode,
    NHWC + stem_s2d, logits within 1e-4 relative."""
    jm, P, B = jax_r18
    x, _ = images(8, 32, seed=3)
    out, upd = jax_functional_call(jm, jm.raw_parameters(), jnp.asarray(x),
                                   buffers=jm.raw_buffers(), training=True)
    m = port_twin(resnet18, P, B, **KW)
    m.train()
    assert rel_err(m(torch.from_numpy(x)), out) < 1e-4
    assert worst(dict(m.named_buffers()), upd)[0] < 1e-4
    load_jax_state(m, P, B)
    jm.eval()
    m.eval()
    assert rel_err(m(torch.from_numpy(x)), jm(jnp.asarray(x))) < 1e-4
    jm.train()


def test_nchw_forward_matches_jax():
    jm, P, B = jax_model(jax_resnet18, seed=1, num_classes=10)
    x, _ = images(8, 32, "NCHW", seed=4)
    out, _ = jax_functional_call(jm, jm.raw_parameters(), jnp.asarray(x),
                                 buffers=jm.raw_buffers(), training=True)
    m = port_twin(resnet18, P, B, num_classes=10)
    m.train()
    assert rel_err(m(torch.from_numpy(x)), out) < 1e-4


def test_trainer_steps_match_jax(jax_r18, batch, jax_run):
    _, P, B = jax_r18
    m = port_twin(resnet18, P, B, **KW)
    tr = Trainer(m, Momentum(LR, 0.9), _ce)
    _, losses = tr.train_steps(*batch, steps=STEPS)
    _losses_close(losses, jax_run["losses"])
    t = jax_run["tree"]
    assert losses[-1] < losses[0]
    # and small beside how far each parameter moved
    assert worst_move(tr.state.params, t["params"], P)[0] < 1e-2
    assert worst(tr.state.params, t["params"])[0] < 1e-3
    assert worst(tr.state.buffers, t["buffers"])[0] < 1e-3
    slots = {k: s["velocity"] for k, s in tr.state.opt_state["slots"].items()}
    assert worst(slots, {k: s["velocity"]
                         for k, s in t["opt_state"]["slots"].items()})[0] \
        < 1e-3
    for k, v in tr.state.buffers.items():
        assert v.dtype == torch.float32
        assert not torch.equal(v, torch.from_numpy(B[k])), k   # moved
    tr.sync_model()
    assert worst(dict(m.named_buffers()), t["buffers"])[0] < 1e-3


def test_resume_jax_train_state(jax_r18, batch, jax_run):
    """The JAX state after 3 steps (params, BN buffers, velocity, step)
    resumed in the port: 2 more steps track JAX's."""
    _, P, B = jax_r18
    m = port_twin(resnet18, P, B, **KW)
    opt = Momentum(LR, 0.9)
    tr = Trainer(m, opt, _ce)
    st = from_jax_train_state(jax_run["tree"], optimizer=opt, model=m)
    assert st.step == STEPS and st.opt_state["step"] == STEPS
    assert set(st.buffers) == set(B)
    tr.load_state(st)
    _, more = tr.train_steps(*batch, steps=2)
    _losses_close(more, jax_run["more"])
    f = jax_run["final"]
    assert worst(tr.state.params, f["params"])[0] < 1e-3
    assert worst(tr.state.buffers, f["buffers"])[0] < 1e-3


def test_bridge_checks_names_and_shapes(jax_r18, jax_run):
    _, P, B = jax_r18
    m = resnet18(device="cpu", **KW)
    bad = dict(P)
    bad["fc.weightx"] = bad.pop("fc.weight")
    with pytest.raises(KeyError, match="fc.weight"):
        load_jax_state(m, bad, B)
    bad = {**P, "fc.bias": np.zeros(11, np.float32)}
    with pytest.raises(ValueError, match="fc.bias"):
        load_jax_state(m, bad, B)
    with pytest.raises(KeyError, match="_variance"):
        load_jax_state(m, P, {k: v for k, v in B.items()
                              if k != "bn1._variance"})
    with pytest.raises(ValueError, match="_mean"):
        load_jax_state(m, P, {**B, "bn1._mean": np.zeros(3, np.float32)})
    before = m.fc.weight.detach().clone()
    with pytest.raises(KeyError):
        load_jax_state(m, {**P, "extra": np.zeros(1)}, B)
    assert torch.equal(m.fc.weight, before)        # nothing copied
    tree = jax_run["tree"]
    with pytest.raises(KeyError, match="_mean"):
        from_jax_train_state({**tree, "buffers": {}}, model=m,
                             optimizer=Momentum(LR))
    other = resnet18(device="cpu", num_classes=7)
    with pytest.raises(ValueError, match="fc"):
        from_jax_train_state(tree, model=other, optimizer=Momentum(LR))
