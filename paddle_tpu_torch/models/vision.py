"""Classic vision models of the PyTorch/CUDA port: the counterpart of
`paddle_tpu/models/vision.py` (`LeNet`, `AlexNet`, `VGG` with `vgg11`
... `vgg19`, `MobileNetV1` / `MobileNetV2` with `mobilenet_v1` /
`mobilenet_v2`, and the shared conv-bn helper `_conv_bn`).

Module and parameter names are JAX's, so `named_parameters()` and
`named_buffers()` equal the JAX `raw_parameters()` / `raw_buffers()`
keys and a JAX model carries over with `models.load_jax_state`. Each
layer takes its default initializer (the JAX layer's law), drawn in
fp32 on the CPU from one generator seeded by `seed`; the model then
moves to `device` (the card by default: `core.resolve_device` raises
without one) with its parameters in `dtype` (BatchNorm buffers stay
fp32). `pretrained=True` raises: there are no downloads.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import DeviceLike, make_generator, resolve_device, resolve_dtype
from ..nn.layers import Dropout, Linear
from ..nn.layers_common import (Flatten, Hardswish, ReLU, ReLU6,
                                Sequential)
from ..nn.layers_conv import Conv2D
from ..nn.layers_norm import BatchNorm2D
from ..nn.layers_pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["LeNet", "AlexNet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class _Zoo(nn.Module):
    """A model of the zoo: `_start` resolves the device before anything
    is drawn and gives the seeded generator the layers draw from;
    `_place` moves the built model and casts its parameters."""

    def _start(self, seed: int, device: DeviceLike) -> torch.Generator:
        self._device = resolve_device(device)     # fail fast
        return make_generator(seed)

    def _place(self, dtype):
        self.to(device=self._device)
        dt = resolve_dtype(dtype)
        for p in self.parameters():
            p.data = p.data.to(dt)
        del self._device


def _no_download(pretrained: bool):
    if pretrained:
        raise ValueError("pretrained=True: there are no downloads; carry "
                         "weights over with models.load_jax_state")


class LeNet(_Zoo):
    def __init__(self, num_classes=10, in_channels=1, seed: int = 0,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        self.features = Sequential(
            Conv2D(in_channels, 6, 3, stride=1, padding=1, gen=g), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, gen=g), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(Flatten(), Linear(400, 120, gen=g),
                                 Linear(120, 84, gen=g),
                                 Linear(84, num_classes, gen=g))
        self.num_classes = num_classes
        self._place(dtype)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.fc(x)
        return x


class AlexNet(_Zoo):
    def __init__(self, num_classes=1000, dropout=0.5, seed: int = 0,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, gen=g), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2, gen=g), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1, gen=g), ReLU(),
            Conv2D(384, 256, 3, padding=1, gen=g), ReLU(),
            Conv2D(256, 256, 3, padding=1, gen=g), ReLU(),
            MaxPool2D(3, 2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        self.classifier = Sequential(
            Dropout(dropout), Flatten(),
            Linear(256 * 36, 4096, gen=g), ReLU(),
            Dropout(dropout), Linear(4096, 4096, gen=g), ReLU(),
            Linear(4096, num_classes, gen=g))
        self._place(dtype)

    def forward(self, x):
        return self.classifier(self.avgpool(self.features(x)))


_VGG_CFGS = {
    11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
         "M"],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
         512, "M", 512, 512, 512, 512, "M"],
}


class VGG(_Zoo):
    """`features` is a `Sequential` or, as the constructors pass it, a
    callable `gen -> Sequential` (so the whole model draws from one
    seeded generator)."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 seed: int = 0, device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        self.features = features if isinstance(features, nn.Module) \
            else features(g)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        self.classifier = Sequential(
            Flatten(), Linear(512 * 49, 4096, gen=g), ReLU(), Dropout(),
            Linear(4096, 4096, gen=g), ReLU(), Dropout(),
            Linear(4096, num_classes, gen=g))
        self._place(dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        return self.classifier(x)


def _make_vgg_layers(cfg, batch_norm=False, gen=None):
    layers = []
    cin = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(cin, v, 3, padding=1, gen=gen))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(ReLU())
            cin = v
    return Sequential(*layers)


def _vgg(depth, pretrained, batch_norm, **kwargs):
    _no_download(pretrained)
    return VGG(lambda g: _make_vgg_layers(_VGG_CFGS[depth], batch_norm, g),
               **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg(11, pretrained, batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg(13, pretrained, batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg(16, pretrained, batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg(19, pretrained, batch_norm, **kwargs)


_ACTS = {"relu": ReLU, "relu6": ReLU6, "hardswish": Hardswish}


def _conv_bn(cin, cout, k, stride=1, padding=0, groups=1, act="relu",
             gen=None):
    """Conv + BN (+ act). `act`: a name, an activation class, or None
    (no activation): the one conv-bn helper of the zoo's files."""
    layers = [Conv2D(cin, cout, k, stride=stride, padding=padding,
                     groups=groups, bias_attr=False, gen=gen),
              BatchNorm2D(cout)]
    if act is not None:
        layers.append(_ACTS[act]() if isinstance(act, str) else act())
    return Sequential(*layers)


class MobileNetV1(_Zoo):
    """The depthwise-separable stack."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 seed: int = 0, device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        self.scale = scale
        self.num_classes = num_classes

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        blocks = [_conv_bn(3, c(32), 3, stride=2, padding=1, gen=g)]
        for cin, cout, s in cfg:
            blocks.append(Sequential(
                _conv_bn(c(cin), c(cin), 3, stride=s, padding=1,
                         groups=c(cin), gen=g),
                _conv_bn(c(cin), c(cout), 1, gen=g)))
        self.features = Sequential(*blocks)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Sequential(Flatten(),
                                 Linear(c(1024), num_classes, gen=g))
        self.with_pool = with_pool
        self._place(dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x)
        return x


class _InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand_ratio, gen=None):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(cin, hidden, 1, act="relu6", gen=gen))
        layers += [
            _conv_bn(hidden, hidden, 3, stride=stride, padding=1,
                     groups=hidden, act="relu6", gen=gen),
            Conv2D(hidden, cout, 1, bias_attr=False, gen=gen),
            BatchNorm2D(cout),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(_Zoo):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 seed: int = 0, device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

        def c(ch):
            return max(int(ch * scale), 8)

        cin = c(32)
        feats = [_conv_bn(3, cin, 3, stride=2, padding=1, act="relu6",
                          gen=g)]
        for t, ch, n, s in cfg:
            cout = c(ch)
            for i in range(n):
                feats.append(_InvertedResidual(cin, cout,
                                               s if i == 0 else 1, t, gen=g))
                cin = cout
        self.last_ch = c(1280) if scale > 1.0 else 1280
        feats.append(_conv_bn(cin, self.last_ch, 1, act="relu6", gen=g))
        self.features = Sequential(*feats)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Flatten(), Dropout(0.2),
                Linear(self.last_ch, num_classes, gen=g))
        self._place(dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_download(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_download(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
