"""Convolution layers: the counterpart of `paddle_tpu/nn/layers_conv.py`
(`Conv1D`, `Conv2D`, `Conv3D`).

The weight is (out, in/groups, *k), the reference's layout and torch's
alike, so a JAX state dict carries over as it is. The default
initializer of weight and bias is Uniform(±1/sqrt(fan_in)), fan_in =
in/groups · prod(k); `weight_attr` / `bias_attr` take an
`initializer.Initializer`, `bias_attr=False` drops the bias. Random
initializers draw from the generator `gen`, or from the default
generator (reproducible under `seed`) when it is None.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from . import functional as F
from . import initializer as I

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(v) if len(v) != 1 else tuple(v) * n
    return (v,) * n


class _ConvNd(nn.Module):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, nd,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format=None, gen: Optional[torch.Generator] = None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode {padding_mode!r}: only 'zeros' is ported")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, nd)
        self.stride = _ntuple(stride, nd)
        self.padding = padding
        self.dilation = _ntuple(dilation, nd)
        self.groups = groups
        self.data_format = data_format
        shape = (out_channels, in_channels // groups, *self.kernel_size)
        fan_in = in_channels // groups * int(np.prod(self.kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        w_init = weight_attr if isinstance(weight_attr, I.Initializer) \
            else I.Uniform(-bound, bound)
        self.weight = nn.Parameter(w_init(shape, gen))
        if bias_attr is not False:
            b_init = bias_attr if isinstance(bias_attr, I.Initializer) \
                else I.Uniform(-bound, bound)
            self.bias = nn.Parameter(b_init((out_channels,), gen))
        else:
            self.bias = None

    def forward(self, x):
        return type(self)._fn(x, self.weight, self.bias, self.stride,
                              self.padding, self.dilation, self.groups,
                              self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}, data_format={self.data_format}")


class Conv1D(_ConvNd):
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 gen=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, gen)


class Conv2D(_ConvNd):
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 gen=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, gen)


class Conv3D(_ConvNd):
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 gen=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, gen)
