"""Pooling layers: the counterpart of `MaxPool2D`, `AvgPool2D` and
`AdaptiveAvgPool2D` of `paddle_tpu/nn/layers_pooling.py`, over
`functional.max_pool2d` / `avg_pool2d` / `adaptive_avg_pool2d`. The
1-D and 3-D pools and `return_mask` are not ported yet."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        if return_mask:
            raise NotImplementedError("MaxPool2D return_mask is not ported "
                                      "yet")
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.data_format)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format=None, name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     self.data_format or "NCHW")
