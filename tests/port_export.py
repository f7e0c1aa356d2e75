"""Helpers of the port's export and Predictor tests: JAX's `_mlp` of
`tests/test_jit_export.py` (Linear(8, 16), BatchNorm1D(16),
Linear(16, 4) from `paddle_tpu.seed(7)`), its port twin carrying the
same weights, and seeded inputs."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu_torch.core import make_generator
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.nn.layers_norm import BatchNorm1D
from port_resnet import numpy_tree


def jax_mlp():
    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(8, 16)
            self.bn = jnn.BatchNorm1D(16)
            self.fc2 = jnn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(jnn.functional.relu(self.bn(self.fc1(x))))

    pt.seed(7)
    return MLP()


class PortMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = make_generator(0)
        self.fc1 = Linear(8, 16, gen=gen)
        self.bn = BatchNorm1D(16)
        self.fc2 = Linear(16, 4, gen=gen)

    def forward(self, x):
        return self.fc2(F.relu(self.bn(self.fc1(x))))


@pytest.fixture
def mlps():
    """(JAX MLP, its port twin), both in eval mode."""
    jm = jax_mlp()
    pm = load_jax_state(PortMLP(), numpy_tree(jm.raw_parameters()),
                        numpy_tree(jm.raw_buffers()))
    jm.eval()
    pm.eval()
    return jm, pm


def x8(bs, seed=0, shift=0.0):
    return np.random.RandomState(seed).randn(bs, 8).astype("float32") \
        + shift
