"""`ReLU`, `Flatten` and `Sequential`: the subset of
`paddle_tpu/nn/layers_common.py` the ResNet family is built from.
`Sequential` names its children "0", "1", ... (or as given by an
OrderedDict or (name, layer) pairs), so a ResNet's parameter names are
the JAX ones (`layer1.0.conv1.weight`)."""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

from . import functional as F

__all__ = ["ReLU", "Flatten", "Sequential"]


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


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
