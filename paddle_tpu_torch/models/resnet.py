"""The ResNet family of the PyTorch/CUDA port: the counterpart of
`paddle_tpu/models/resnet.py` (`BasicBlock`, `BottleneckBlock`,
`ResNet`, and `resnet18` ... `resnext152_32x4d`).

Names, shapes and layouts are JAX's, so `named_parameters()` and
`named_buffers()` equal the JAX `raw_parameters()` / `raw_buffers()`
keys and a JAX model carries over with `models.weights.load_jax_state`.
Convolutions take Kaiming-normal (relu) weights and no bias, the head
`fc` XavierUniform with bias 0, BatchNorm weight 1 and bias 0, all
drawn in fp32 on the CPU from one generator seeded by `seed`, then moved
to `device` (the card by default: `core.resolve_device` raises without
one) with the parameters in `dtype` (the BatchNorm buffers stay fp32).

`data_format="NHWC"` runs every layer channels-last (the input is
(N, H, W, 3)); `stem_s2d=True` computes the 7x7/s2 stem as a 4x4/s1
convolution over a 2x2 space-to-depth view of the input, the
(64, 3, 7, 7) weight zero-padded to 8x8 and folded to (64, 12, 4, 4)
on every forward (under autograd, so the gradient reaches the
reference-layout weight). Both are the same model as the plain NCHW
one, up to summation order. `pretrained=True` raises: there are no
downloads.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import DeviceLike, make_generator, resolve_device, resolve_dtype
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layers import Linear
from ..nn.layers_common import ReLU, Sequential
from ..nn.layers_conv import Conv2D
from ..nn.layers_norm import BatchNorm2D
from ..nn.layers_pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "wide_resnet101_2", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d"]


def _conv3x3(cin, cout, gen, stride=1, groups=1, dilation=1,
             data_format="NCHW"):
    return Conv2D(cin, cout, 3, stride=stride, padding=dilation,
                  groups=groups, dilation=dilation, bias_attr=False,
                  weight_attr=I.KaimingNormal(nonlinearity="relu"),
                  data_format=data_format, gen=gen)


def _conv1x1(cin, cout, gen, stride=1, data_format="NCHW"):
    return Conv2D(cin, cout, 1, stride=stride, bias_attr=False,
                  weight_attr=I.KaimingNormal(nonlinearity="relu"),
                  data_format=data_format, gen=gen)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, gen, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, data_format="NCHW"):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes, gen, stride,
                              data_format=data_format)
        self.bn1 = BatchNorm2D(planes, data_format=data_format)
        self.relu = ReLU()
        self.conv2 = _conv3x3(planes, planes, gen, data_format=data_format)
        self.bn2 = BatchNorm2D(planes, data_format=data_format)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, gen, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, data_format="NCHW"):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv1x1(inplanes, width, gen, data_format=data_format)
        self.bn1 = BatchNorm2D(width, data_format=data_format)
        self.conv2 = _conv3x3(width, width, gen, stride, groups, dilation,
                              data_format=data_format)
        self.bn2 = BatchNorm2D(width, data_format=data_format)
        self.conv3 = _conv1x1(width, planes * self.expansion, gen,
                              data_format=data_format)
        self.bn3 = BatchNorm2D(planes * self.expansion,
                               data_format=data_format)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


_LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
           101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class ResNet(nn.Module):
    """The reference's ResNet (`with_pool` and `num_classes` switches
    kept), built on `device` from `seed`."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW",
                 stem_s2d=False, seed: int = 0, device: DeviceLike = None,
                 dtype=None):
        super().__init__()
        dev = resolve_device(device)         # fail fast, before the init
        gen = make_generator(seed)
        self.data_format = data_format
        self.stem_s2d = stem_s2d
        layers = _LAYERS[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False,
                            weight_attr=I.KaimingNormal(nonlinearity="relu"),
                            data_format=data_format, gen=gen)
        self.bn1 = BatchNorm2D(self.inplanes, data_format=data_format)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0], gen)
        self.layer2 = self._make_layer(block, 128, layers[1], gen, stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], gen, stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], gen, stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1, data_format=data_format)
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, gen=gen)
        self.to(device=dev)
        dt = resolve_dtype(dtype)
        for p in self.parameters():
            p.data = p.data.to(dt)

    def _make_layer(self, block, planes, blocks, gen, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                _conv1x1(self.inplanes, planes * block.expansion, gen,
                         stride, data_format=self.data_format),
                BatchNorm2D(planes * block.expansion,
                            data_format=self.data_format))
        layers = [block(self.inplanes, planes, gen, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        data_format=self.data_format)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, gen,
                                groups=self.groups,
                                base_width=self.base_width,
                                data_format=self.data_format))
        return Sequential(*layers)

    def _stem_conv(self, x):
        """conv1, or with `stem_s2d` the same 7x7/s2 convolution as a
        4x4/s1 one over the 2x2 space-to-depth view (kernel padded 7 -> 8
        at the top and left, then block-folded; padding (2, 1))."""
        if not self.stem_s2d:
            return self.conv1(x)
        w = self.conv1.weight
        co, ci, kh, kw = w.shape
        w8 = torch.nn.functional.pad(w, (1, 0, 1, 0))
        kh2, kw2 = (kh + 1) // 2, (kw + 1) // 2
        w2 = w8.reshape(co, ci, kh2, 2, kw2, 2).permute(
            0, 3, 5, 1, 2, 4).reshape(co, 4 * ci, kh2, kw2)
        if self.data_format == "NHWC":
            n, h, wd, c = x.shape
            x2 = x.reshape(n, h // 2, 2, wd // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n, h // 2, wd // 2, 4 * c)
        else:
            n, c, h, wd = x.shape
            x2 = x.reshape(n, c, h // 2, 2, wd // 2, 2).permute(
                0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2, wd // 2)
        return F.conv2d(x2, w2, stride=1, padding=[(2, 1), (2, 1)],
                        data_format=self.data_format)

    def forward(self, x):
        x = self.relu(self.bn1(self._stem_conv(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained, **kwargs):
    if pretrained:
        raise ValueError("pretrained=True: there are no downloads; carry "
                         "weights over with models.weights.load_jax_state")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4,
                   **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, groups=64, width=4,
                   **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=32, width=4,
                   **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, groups=64, width=4,
                   **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, groups=32, width=4,
                   **kwargs)
