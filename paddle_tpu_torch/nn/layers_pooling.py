"""Pooling layers: the counterpart of `paddle_tpu/nn/layers_pooling.py`
(the 1-D, 2-D and 3-D average and max pools, `MaxPool*D(return_mask=
True)`, and the adaptive average and max pools) over the pools of
`functional`. `return_mask` is JAX's: the flat argmax index for a 2-D
NCHW max pool, an error for the other ranks, and all zeros for the
adaptive max pools."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, return_mask=False, divisor_override=None,
                 data_format=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.return_mask = return_mask
        self.divisor_override = divisor_override
        self.data_format = data_format

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         data_format="NCL")

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode, self.data_format)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override=divisor_override,
                         data_format=data_format)

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         return_mask=return_mask, data_format="NCL")

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         return_mask=return_mask, data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.data_format,
                            return_mask=self.return_mask)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         return_mask=return_mask, data_format=data_format)

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format)


class _AdaptivePool(nn.Module):
    def __init__(self, output_size, return_mask=False, data_format=None,
                 name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask
        self.data_format = data_format


class AdaptiveAvgPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def __init__(self, output_size, data_format=None, name=None):
        super().__init__(output_size, data_format=data_format)

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     self.data_format or "NCHW")


class AdaptiveAvgPool3D(_AdaptivePool):
    def __init__(self, output_size, data_format=None, name=None):
        super().__init__(output_size, data_format=data_format)

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size,
                                     self.data_format or "NCDHW")


class AdaptiveMaxPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)
