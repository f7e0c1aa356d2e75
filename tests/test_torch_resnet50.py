"""ResNet-50 at bench.py's configuration (NHWC, `stem_s2d`, 1000
classes, Momentum, cross-entropy; the port's Trainer with bench's
`loop_unroll=2`, which changes nothing there, the JAX one with 1, which
halves its compile) trained by the port's Trainer in lockstep with the
JAX package's, at 8 x 32 x 32 on the CPU.

The lockstep runs in float64 on both sides (JAX under
`jax.enable_x64`, the port's model `.double()`), from the same weights
and batch, at Momentum(1e-2, 0.9) for two steps: both losses within
1e-9 relative, every parameter, BatchNorm buffer and velocity slot
within 1e-6 of its largest magnitude (the errors seen are below 1e-7).
Why not fp32: a randomly initialised ResNet-50's gradient is
ill-conditioned in fp32. Each package's fp32 gradient differs from the
fp64 one by 20-50% in some layer4 tensors (measured on this batch, and
at 64 x 64 and batch 64 as well), and the two differ from each other
by as much, so an fp32 step comparison could only be loose. fp64 runs
the same code (every op is dtype-generic) and holds it tightly. The
fp32 forward is held in `test_torch_resnet_family.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.trainer import Trainer as JaxTrainer
from paddle_tpu.framework.trainer import TrainState as JaxTrainState
from paddle_tpu.models import resnet50 as jax_resnet50
from paddle_tpu_torch.framework import Trainer
from paddle_tpu_torch.models import resnet50
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from port_resnet import images, jax_model, numpy_tree, port_twin, worst
from port_threads import one_torch_thread  # noqa: F401

KW = dict(num_classes=1000, data_format="NHWC", stem_s2d=True)
LR, STEPS = 1e-2, 2


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@pytest.fixture(scope="module")
def runs():
    jm, P, B = jax_model(jax_resnet50, **KW)
    x, y = images(8, 32, classes=1000)
    with jax.enable_x64(True):
        jt = JaxTrainer(jm, jopt.Momentum(LR, 0.9),
                        lambda o, t: jnn.functional.cross_entropy(o, t),
                        donate=False)
        st = jt.init_state()
        jt.state = JaxTrainState(_f64(st.params), _f64(st.buffers),
                                 _f64(st.opt_state), st.scaler_state,
                                 st.rng_key, st.step)
        _, jl = jt.train_steps(x.astype(np.float64), y, steps=STEPS)
        jax_tree = numpy_tree(jt.state.tree())
    m = port_twin(resnet50, P, B, **KW).double()
    tr = Trainer(m, Momentum(LR, 0.9), lambda o, t: F.cross_entropy(o, t),
                 loop_unroll=2)
    _, pl = tr.train_steps(torch.from_numpy(x).double(), y, steps=STEPS)
    return {"jax": jax_tree, "jl": np.array(jl), "port": tr.state,
            "pl": pl, "B": B}


def test_losses_match_jax(runs):
    np.testing.assert_allclose(runs["pl"].numpy(), runs["jl"], rtol=1e-9)
    assert runs["pl"][-1] < runs["pl"][0]


def test_parameters_match_jax(runs):
    assert worst(runs["port"].params, runs["jax"]["params"])[0] < 1e-6


def test_batchnorm_buffers_match_jax(runs):
    st = runs["port"]
    assert len(st.buffers) == 106 and set(st.buffers) == set(runs["B"])
    assert worst(st.buffers, runs["jax"]["buffers"])[0] < 1e-6
    for k, v in st.buffers.items():            # they moved
        assert not np.array_equal(v.numpy(), runs["B"][k]), k


def test_velocity_slots_match_jax(runs):
    st, j = runs["port"], runs["jax"]
    assert st.opt_state["step"] == STEPS == int(j["opt_state"]["step"])
    assert worst({k: s["velocity"] for k, s in st.opt_state["slots"].items()},
                 {k: s["velocity"]
                  for k, s in j["opt_state"]["slots"].items()})[0] < 1e-6
