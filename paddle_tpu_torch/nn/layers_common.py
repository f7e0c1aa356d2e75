"""Common layers: the counterpart of `paddle_tpu/nn/layers_common.py`
beside `layers.py` (Linear, Embedding, Dropout, GELU): `Identity`,
`Flatten`, `Dropout2D` / `Dropout3D` / `AlphaDropout`, the containers
`Sequential`, `LayerList`, `LayerDict` and `ParameterList`, and the
activation layers (`_act_layer`'s thin wrappers over `functional`,
`PReLU`, `RReLU`, `ThresholdedReLU`).

The containers name their children "0", "1", ... (or as given by an
OrderedDict, a dict or (name, layer) pairs), so a model's parameter
names are the JAX ones (`layer1.0.conv1.weight`, `layers.3.attn.qkv.
weight`). They are torch's `Sequential`, `ModuleList`, `ModuleDict` and
`ParameterList`, whose surfaces cover the reference's (`append`,
`extend`, `insert`, slicing; `keys`, `values`, `items`, `update`).
"""
from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from . import functional as F

__all__ = [
    "Identity", "Flatten", "Dropout2D", "Dropout3D", "AlphaDropout",
    "Sequential", "LayerList", "LayerDict", "ParameterList",
    "ReLU", "ReLU6", "LeakyReLU", "ELU", "SELU", "CELU", "Silu",
    "Swish", "Mish", "Sigmoid", "LogSigmoid", "Hardsigmoid", "Hardswish",
    "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink", "Softplus",
    "Softsign", "Tanh", "PReLU", "RReLU", "GLU", "Maxout", "Softmax",
    "LogSoftmax", "ThresholdedReLU",
]


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


# --------------------------------------------------------------------------- #
# containers
# --------------------------------------------------------------------------- #

class Sequential(nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class LayerList(nn.ModuleList):
    """Children "0", "1", ...; `insert` renumbers them."""


class LayerDict(nn.ModuleDict):
    """Children by name, from a dict or (name, layer) pairs."""


class ParameterList(nn.ParameterList):
    """Parameters "0", "1", ..."""


# --------------------------------------------------------------------------- #
# activation layers
# --------------------------------------------------------------------------- #

def _act_layer(fname, cls_name):
    """A layer whose forward is `functional.<fname>(x, *args,
    **kwargs)` with the arguments given at construction."""
    fn = getattr(F, fname)

    class _Act(nn.Module):
        def __init__(self, *args, **kwargs):
            super().__init__()
            kwargs.pop("name", None)
            self._args = args
            self._kwargs = kwargs

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)

    _Act.__name__ = cls_name
    _Act.__qualname__ = cls_name
    return _Act


ReLU = _act_layer("relu", "ReLU")
ReLU6 = _act_layer("relu6", "ReLU6")
LeakyReLU = _act_layer("leaky_relu", "LeakyReLU")
ELU = _act_layer("elu", "ELU")
SELU = _act_layer("selu", "SELU")
CELU = _act_layer("celu", "CELU")
Silu = _act_layer("silu", "Silu")
Swish = _act_layer("swish", "Swish")
Mish = _act_layer("mish", "Mish")
Sigmoid = _act_layer("sigmoid", "Sigmoid")
LogSigmoid = _act_layer("log_sigmoid", "LogSigmoid")
Hardsigmoid = _act_layer("hardsigmoid", "Hardsigmoid")
Hardswish = _act_layer("hardswish", "Hardswish")
Hardtanh = _act_layer("hardtanh", "Hardtanh")
Hardshrink = _act_layer("hardshrink", "Hardshrink")
Softshrink = _act_layer("softshrink", "Softshrink")
Tanhshrink = _act_layer("tanhshrink", "Tanhshrink")
Softplus = _act_layer("softplus", "Softplus")
Softsign = _act_layer("softsign", "Softsign")
Tanh = _act_layer("tanh", "Tanh")
GLU = _act_layer("glu", "GLU")
Maxout = _act_layer("maxout", "Maxout")
Softmax = _act_layer("softmax", "Softmax")
LogSoftmax = _act_layer("log_softmax", "LogSoftmax")


class PReLU(nn.Module):
    """One learned slope (or `num_parameters`, one per channel), all
    starting at `init`."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = nn.Parameter(torch.full((num_parameters,),
                                              float(init)))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self.data_format)


class RReLU(nn.Module):
    def __init__(self, lower=1.0 / 8, upper=1.0 / 3, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class ThresholdedReLU(nn.Module):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return torch.where(x > self.threshold, x, 0.0)
