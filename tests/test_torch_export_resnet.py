"""A ResNet-18 cut to a few channels and one block a stage for two
stages (a stem Conv2D(3, 8) with BatchNorm, ReLU and max pool, then
ResNet-18's BasicBlock(8, 8) and BasicBlock(8, 16, stride 2) with its
1x1 downsample, average pool and Linear(16, 10)) on 32 x 32 images
through the port's `jit.to_static` and `jit.save` / `jit.load`, against
the same network of the JAX package carrying the same weights
(`load_jax_state`), fp32 on the CPU: in train mode the captured
program's BatchNorm statistics land in the port layer's own buffers and
equal the updates of JAX's `functional_call` within 1e-4 of their
largest magnitude; the saved eval program, reloaded with a dynamic
batch, equals JAX's eval forward within 1e-4 of the largest magnitude
(the convolutions sum in other orders) and the port's eager forward at
batch 1 within 1e-5."""
import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.models.resnet import BasicBlock as JaxBasicBlock
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch import jit
from paddle_tpu_torch.core import make_generator
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.models.resnet import BasicBlock
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.nn.layers_common import Flatten, ReLU, Sequential
from paddle_tpu_torch.nn.layers_conv import Conv2D
from paddle_tpu_torch.nn.layers_norm import BatchNorm2D
from paddle_tpu_torch.nn.layers_pooling import AdaptiveAvgPool2D, MaxPool2D
from paddle_tpu_torch.static import InputSpec
from port_resnet import images, numpy_tree, rel_err
from port_threads import one_torch_thread  # noqa: F401


def _jax_net():
    pt.seed(0)
    down = jnn.Sequential(jnn.Conv2D(8, 16, 1, stride=2, bias_attr=False),
                          jnn.BatchNorm2D(16))
    return jnn.Sequential(
        jnn.Conv2D(3, 8, 3, padding=1, bias_attr=False), jnn.BatchNorm2D(8),
        jnn.ReLU(), jnn.MaxPool2D(3, stride=2, padding=1),
        JaxBasicBlock(8, 8), JaxBasicBlock(8, 16, 2, down),
        jnn.AdaptiveAvgPool2D(1), jnn.Flatten(), jnn.Linear(16, 10))


def _port_net():
    gen = make_generator(123)
    down = Sequential(Conv2D(8, 16, 1, stride=2, bias_attr=False, gen=gen),
                      BatchNorm2D(16))
    return Sequential(
        Conv2D(3, 8, 3, padding=1, bias_attr=False, gen=gen), BatchNorm2D(8),
        ReLU(), MaxPool2D(3, stride=2, padding=1),
        BasicBlock(8, 8, gen), BasicBlock(8, 16, gen, 2, down),
        AdaptiveAvgPool2D(1), Flatten(), Linear(16, 10, gen=gen))


def test_resnet18_train_buffers_and_saved_eval(tmp_path):
    jm = _jax_net()
    pm = load_jax_state(_port_net(), numpy_tree(jm.raw_parameters()),
                        numpy_tree(jm.raw_buffers()))
    x, _ = images(3, 32, fmt="NCHW")

    def forward(params, buffers, x, training):
        return jax_functional_call(jm, params, x, buffers=buffers,
                                   training=training)
    forward = jax.jit(forward, static_argnums=3)
    out, updates = forward(jm.raw_parameters(), jm.raw_buffers(),
                           jnp.asarray(x), True)
    pm.train()
    got = jit.to_static(pm)(x)
    assert rel_err(got, out) <= 1e-4
    mine = dict(pm.named_buffers())
    assert len(updates) == 12 and set(updates) <= set(mine)
    for k, v in updates.items():
        assert rel_err(mine[k], v) <= 1e-4, k
    # the saved eval program (over the updated statistics)
    jm.load_raw_buffers(updates)
    pm.eval()
    prefix = str(tmp_path / "resnet")
    jit.save(pm, prefix, input_spec=[InputSpec([None, 3, 32, 32])])
    loaded = jit.load(prefix, device="cpu")
    want, _ = forward(jm.raw_parameters(), jm.raw_buffers(),
                      jnp.asarray(x), False)
    assert rel_err(loaded(x), want) <= 1e-4
    assert rel_err(loaded(x[:1]), pm(jit._as_tensor(x[:1]))) <= 1e-5
