"""The other classic vision families of the PyTorch/CUDA port: the
counterpart of `paddle_tpu/models/vision_extra.py` (`MobileNetV3Small`
/ `Large`, `DenseNet` 121 / 161 / 169 / 201, `InceptionV3`,
`ShuffleNetV2` x0.25 ... x2.0, `SqueezeNet` 1.0 / 1.1, `GoogLeNet`).

The same block topologies, channel schedules and heads, under JAX's
module and parameter names (`models.load_jax_state` carries a JAX
model over); the concatenations and the channel shuffle, which the JAX
file writes with `jnp`, are `torch.cat` and a reshape-transpose. Seeds,
devices and dtypes as in `models.vision`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import DeviceLike
from ..nn.layers import Dropout, Linear
from ..nn.layers_common import (Flatten, Hardsigmoid, Hardswish, ReLU,
                                Sequential)
from ..nn.layers_conv import Conv2D
from ..nn.layers_norm import BatchNorm2D
from ..nn.layers_pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .vision import _conv_bn, _no_download, _Zoo

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "InceptionV3", "inception_v3",
           "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_5",
           "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "SqueezeNet", "squeezenet1_0",
           "squeezenet1_1", "GoogLeNet", "googlenet"]


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv_bn_act(cin, cout, k, stride=1, padding=0, groups=1, act=None,
                 gen=None):
    # the shared helper with NO activation by default (the depthwise
    # convolutions of these families have none unless stated)
    return _conv_bn(cin, cout, k, stride=stride, padding=padding,
                    groups=groups, act=act, gen=gen)


# --------------------------------------------------------------------------- #
# MobileNetV3
# --------------------------------------------------------------------------- #

class _SqueezeExcite(nn.Module):
    def __init__(self, channels, reduction=4, gen=None):
        super().__init__()
        mid = _make_divisible(channels // reduction)
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(channels, mid, 1, gen=gen)
        self.relu = ReLU()
        self.fc2 = Conv2D(mid, channels, 1, gen=gen)
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _MBV3Block(nn.Module):
    def __init__(self, cin, exp, cout, k, stride, use_se, act, gen=None):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        layers = []
        if exp != cin:
            layers.append(_conv_bn_act(cin, exp, 1, act=act, gen=gen))
        layers.append(_conv_bn_act(exp, exp, k, stride=stride,
                                   padding=k // 2, groups=exp, act=act,
                                   gen=gen))
        if use_se:
            layers.append(_SqueezeExcite(exp, gen=gen))
        layers.append(_conv_bn_act(exp, cout, 1, act=None, gen=gen))
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_MBV3_SMALL = [  # k, exp, out, se, act, stride
    (3, 16, 16, True, ReLU, 2), (3, 72, 24, False, ReLU, 2),
    (3, 88, 24, False, ReLU, 1), (5, 96, 40, True, Hardswish, 2),
    (5, 240, 40, True, Hardswish, 1), (5, 240, 40, True, Hardswish, 1),
    (5, 120, 48, True, Hardswish, 1), (5, 144, 48, True, Hardswish, 1),
    (5, 288, 96, True, Hardswish, 2), (5, 576, 96, True, Hardswish, 1),
    (5, 576, 96, True, Hardswish, 1)]

_MBV3_LARGE = [
    (3, 16, 16, False, ReLU, 1), (3, 64, 24, False, ReLU, 2),
    (3, 72, 24, False, ReLU, 1), (5, 72, 40, True, ReLU, 2),
    (5, 120, 40, True, ReLU, 1), (5, 120, 40, True, ReLU, 1),
    (3, 240, 80, False, Hardswish, 2), (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1), (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1), (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2), (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1)]


class _MobileNetV3(_Zoo):
    def __init__(self, cfg, last_exp, last_ch, num_classes=1000,
                 scale=1.0, dropout=0.2, seed: int = 0,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        cin = _make_divisible(16 * scale)
        blocks = [_conv_bn_act(3, cin, 3, stride=2, padding=1,
                               act=Hardswish, gen=g)]
        for k, exp, cout, se, act, stride in cfg:
            exp_s = _make_divisible(exp * scale)
            cout_s = _make_divisible(cout * scale)
            blocks.append(_MBV3Block(cin, exp_s, cout_s, k, stride, se,
                                     act, gen=g))
            cin = cout_s
        exp_s = _make_divisible(last_exp * scale)
        blocks.append(_conv_bn_act(cin, exp_s, 1, act=Hardswish, gen=g))
        self.features = Sequential(*blocks)
        self.pool = AdaptiveAvgPool2D(1)
        self.head = Sequential(Flatten(), Linear(exp_s, last_ch, gen=g),
                               Hardswish(), Dropout(dropout),
                               Linear(last_ch, num_classes, gen=g))
        self._place(dtype)

    def forward(self, x):
        return self.head(self.pool(self.features(x)))


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, num_classes=1000, scale=1.0, **kw):
        super().__init__(_MBV3_SMALL, 576, 1024, num_classes, scale, **kw)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, num_classes=1000, scale=1.0, **kw):
        super().__init__(_MBV3_LARGE, 960, 1280, num_classes, scale, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    _no_download(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    _no_download(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)


# --------------------------------------------------------------------------- #
# DenseNet
# --------------------------------------------------------------------------- #

class _DenseLayer(nn.Module):
    def __init__(self, cin, growth, bn_size, gen=None):
        super().__init__()
        self.fn = Sequential(
            BatchNorm2D(cin), ReLU(),
            Conv2D(cin, bn_size * growth, 1, bias_attr=False, gen=gen),
            BatchNorm2D(bn_size * growth), ReLU(),
            Conv2D(bn_size * growth, growth, 3, padding=1, bias_attr=False,
                   gen=gen))

    def forward(self, x):
        return torch.cat([x, self.fn(x)], dim=1)


class _Transition(nn.Module):
    def __init__(self, cin, cout, gen=None):
        super().__init__()
        self.fn = Sequential(BatchNorm2D(cin), ReLU(),
                             Conv2D(cin, cout, 1, bias_attr=False, gen=gen),
                             AvgPool2D(2, 2))

    def forward(self, x):
        return self.fn(x)


_DENSENET_CFG = {121: (64, 32, (6, 12, 24, 16)),
                 161: (96, 48, (6, 12, 36, 24)),
                 169: (64, 32, (6, 12, 32, 32)),
                 201: (64, 32, (6, 12, 48, 32))}


class DenseNet(_Zoo):
    def __init__(self, layers=121, num_classes=1000, bn_size=4,
                 seed: int = 0, device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        init_ch, growth, blocks = _DENSENET_CFG[layers]
        feats = [Conv2D(3, init_ch, 7, stride=2, padding=3, bias_attr=False,
                        gen=g), BatchNorm2D(init_ch), ReLU(),
                 MaxPool2D(3, 2, padding=1)]
        ch = init_ch
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, gen=g))
                ch += growth
            if i != len(blocks) - 1:
                feats.append(_Transition(ch, ch // 2, gen=g))
                ch //= 2
        feats += [BatchNorm2D(ch), ReLU()]
        self.features = Sequential(*feats)
        self.pool = AdaptiveAvgPool2D(1)
        self.classifier = Sequential(Flatten(),
                                     Linear(ch, num_classes, gen=g))
        self._place(dtype)

    def forward(self, x):
        return self.classifier(self.pool(self.features(x)))


def _densenet(depth, pretrained, **kw):
    _no_download(pretrained)
    return DenseNet(depth, **kw)


def densenet121(pretrained=False, **kw):
    return _densenet(121, pretrained, **kw)


def densenet161(pretrained=False, **kw):
    return _densenet(161, pretrained, **kw)


def densenet169(pretrained=False, **kw):
    return _densenet(169, pretrained, **kw)


def densenet201(pretrained=False, **kw):
    return _densenet(201, pretrained, **kw)


# --------------------------------------------------------------------------- #
# Inception v3
# --------------------------------------------------------------------------- #

def _bconv(cin, cout, k, stride=1, padding=0, gen=None):
    return _conv_bn_act(cin, cout, k, stride=stride, padding=padding,
                        act=ReLU, gen=gen)


class _InceptionA(nn.Module):
    def __init__(self, cin, pool_ch, gen=None):
        super().__init__()
        self.b1 = _bconv(cin, 64, 1, gen=gen)
        self.b5 = Sequential(_bconv(cin, 48, 1, gen=gen),
                             _bconv(48, 64, 5, padding=2, gen=gen))
        self.b3 = Sequential(_bconv(cin, 64, 1, gen=gen),
                             _bconv(64, 96, 3, padding=1, gen=gen),
                             _bconv(96, 96, 3, padding=1, gen=gen))
        self.bp = Sequential(AvgPool2D(3, 1, padding=1),
                             _bconv(cin, pool_ch, 1, gen=gen))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                         dim=1)


class _InceptionB(nn.Module):
    def __init__(self, cin, gen=None):
        super().__init__()
        self.b3 = _bconv(cin, 384, 3, stride=2, gen=gen)
        self.b3d = Sequential(_bconv(cin, 64, 1, gen=gen),
                              _bconv(64, 96, 3, padding=1, gen=gen),
                              _bconv(96, 96, 3, stride=2, gen=gen))
        self.pool = MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], dim=1)


class _InceptionC(nn.Module):
    def __init__(self, cin, c7, gen=None):
        super().__init__()
        self.b1 = _bconv(cin, 192, 1, gen=gen)
        self.b7 = Sequential(
            _bconv(cin, c7, 1, gen=gen),
            _bconv(c7, c7, (1, 7), padding=(0, 3), gen=gen),
            _bconv(c7, 192, (7, 1), padding=(3, 0), gen=gen))
        self.b7d = Sequential(
            _bconv(cin, c7, 1, gen=gen),
            _bconv(c7, c7, (7, 1), padding=(3, 0), gen=gen),
            _bconv(c7, c7, (1, 7), padding=(0, 3), gen=gen),
            _bconv(c7, c7, (7, 1), padding=(3, 0), gen=gen),
            _bconv(c7, 192, (1, 7), padding=(0, 3), gen=gen))
        self.bp = Sequential(AvgPool2D(3, 1, padding=1),
                             _bconv(cin, 192, 1, gen=gen))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                         dim=1)


class _InceptionD(nn.Module):
    def __init__(self, cin, gen=None):
        super().__init__()
        self.b3 = Sequential(_bconv(cin, 192, 1, gen=gen),
                             _bconv(192, 320, 3, stride=2, gen=gen))
        self.b7 = Sequential(
            _bconv(cin, 192, 1, gen=gen),
            _bconv(192, 192, (1, 7), padding=(0, 3), gen=gen),
            _bconv(192, 192, (7, 1), padding=(3, 0), gen=gen),
            _bconv(192, 192, 3, stride=2, gen=gen))
        self.pool = MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], dim=1)


class _InceptionE(nn.Module):
    def __init__(self, cin, gen=None):
        super().__init__()
        self.b1 = _bconv(cin, 320, 1, gen=gen)
        self.b3_stem = _bconv(cin, 384, 1, gen=gen)
        self.b3_a = _bconv(384, 384, (1, 3), padding=(0, 1), gen=gen)
        self.b3_b = _bconv(384, 384, (3, 1), padding=(1, 0), gen=gen)
        self.bd_stem = Sequential(_bconv(cin, 448, 1, gen=gen),
                                  _bconv(448, 384, 3, padding=1, gen=gen))
        self.bd_a = _bconv(384, 384, (1, 3), padding=(0, 1), gen=gen)
        self.bd_b = _bconv(384, 384, (3, 1), padding=(1, 0), gen=gen)
        self.bp = Sequential(AvgPool2D(3, 1, padding=1),
                             _bconv(cin, 192, 1, gen=gen))

    def forward(self, x):
        s3 = self.b3_stem(x)
        sd = self.bd_stem(x)
        return torch.cat([self.b1(x), self.b3_a(s3), self.b3_b(s3),
                          self.bd_a(sd), self.bd_b(sd), self.bp(x)], dim=1)


class InceptionV3(_Zoo):
    """299 x 299 input."""

    def __init__(self, num_classes=1000, dropout=0.5, seed: int = 0,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        self.stem = Sequential(
            _bconv(3, 32, 3, stride=2, gen=g), _bconv(32, 32, 3, gen=g),
            _bconv(32, 64, 3, padding=1, gen=g), MaxPool2D(3, 2),
            _bconv(64, 80, 1, gen=g), _bconv(80, 192, 3, gen=g),
            MaxPool2D(3, 2))
        self.blocks = Sequential(
            _InceptionA(192, 32, gen=g), _InceptionA(256, 64, gen=g),
            _InceptionA(288, 64, gen=g), _InceptionB(288, gen=g),
            _InceptionC(768, 128, gen=g), _InceptionC(768, 160, gen=g),
            _InceptionC(768, 160, gen=g), _InceptionC(768, 192, gen=g),
            _InceptionD(768, gen=g), _InceptionE(1280, gen=g),
            _InceptionE(2048, gen=g))
        self.pool = AdaptiveAvgPool2D(1)
        self.head = Sequential(Dropout(dropout), Flatten(),
                               Linear(2048, num_classes, gen=g))
        self._place(dtype)

    def forward(self, x):
        return self.head(self.pool(self.blocks(self.stem(x))))


def inception_v3(pretrained=False, **kw):
    _no_download(pretrained)
    return InceptionV3(**kw)


# --------------------------------------------------------------------------- #
# ShuffleNet v2
# --------------------------------------------------------------------------- #

def _channel_shuffle(x, groups):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


class _ShuffleUnit(nn.Module):
    def __init__(self, cin, cout, stride, gen=None):
        super().__init__()
        self.stride = stride
        branch = cout // 2
        if stride == 1:
            self.right = Sequential(
                _conv_bn_act(cin // 2, branch, 1, act=ReLU, gen=gen),
                _conv_bn_act(branch, branch, 3, stride=1, padding=1,
                             groups=branch, gen=gen),
                _conv_bn_act(branch, branch, 1, act=ReLU, gen=gen))
            self.left = None
        else:
            self.left = Sequential(
                _conv_bn_act(cin, cin, 3, stride=stride, padding=1,
                             groups=cin, gen=gen),
                _conv_bn_act(cin, branch, 1, act=ReLU, gen=gen))
            self.right = Sequential(
                _conv_bn_act(cin, branch, 1, act=ReLU, gen=gen),
                _conv_bn_act(branch, branch, 3, stride=stride, padding=1,
                             groups=branch, gen=gen),
                _conv_bn_act(branch, branch, 1, act=ReLU, gen=gen))

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self.right(x[:, half:])], dim=1)
        else:
            out = torch.cat([self.left(x), self.right(x)], dim=1)
        return _channel_shuffle(out, 2)


_SHUFFLE_CFG = {0.25: (24, 48, 96, 512), 0.5: (48, 96, 192, 1024),
                1.0: (116, 232, 464, 1024), 1.5: (176, 352, 704, 1024),
                2.0: (244, 488, 976, 2048)}


class ShuffleNetV2(_Zoo):
    def __init__(self, scale=1.0, num_classes=1000, seed: int = 0,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        c1, c2, c3, cend = _SHUFFLE_CFG[scale]
        self.stem = Sequential(
            _conv_bn_act(3, 24, 3, stride=2, padding=1, act=ReLU, gen=g),
            MaxPool2D(3, 2, padding=1))
        stages = []
        cin = 24
        for cout, repeat in ((c1, 4), (c2, 8), (c3, 4)):
            stages.append(_ShuffleUnit(cin, cout, stride=2, gen=g))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(cout, cout, stride=1, gen=g))
            cin = cout
        self.stages = Sequential(*stages)
        self.tail = _conv_bn_act(cin, cend, 1, act=ReLU, gen=g)
        self.pool = AdaptiveAvgPool2D(1)
        self.fc = Sequential(Flatten(), Linear(cend, num_classes, gen=g))
        self._place(dtype)

    def forward(self, x):
        return self.fc(self.pool(self.tail(self.stages(self.stem(x)))))


def _shufflenet(scale, pretrained, **kw):
    _no_download(pretrained)
    return ShuffleNetV2(scale, **kw)


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _shufflenet(0.25, pretrained, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _shufflenet(0.5, pretrained, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _shufflenet(1.0, pretrained, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _shufflenet(1.5, pretrained, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _shufflenet(2.0, pretrained, **kw)


# --------------------------------------------------------------------------- #
# SqueezeNet
# --------------------------------------------------------------------------- #

class _Fire(nn.Module):
    def __init__(self, cin, squeeze, e1, e3, gen=None):
        super().__init__()
        self.squeeze = Sequential(Conv2D(cin, squeeze, 1, gen=gen), ReLU())
        self.e1 = Sequential(Conv2D(squeeze, e1, 1, gen=gen), ReLU())
        self.e3 = Sequential(Conv2D(squeeze, e3, 3, padding=1, gen=gen),
                             ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return torch.cat([self.e1(s), self.e3(s)], dim=1)


class SqueezeNet(_Zoo):
    def __init__(self, version="1.0", num_classes=1000, dropout=0.5,
                 seed: int = 0, device: DeviceLike = None, dtype=None):
        super().__init__()
        version = str(version)
        if version not in ("1.0", "1.1"):
            raise ValueError(f"unknown SqueezeNet version {version!r}")
        g = self._start(seed, device)
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, gen=g), ReLU(), MaxPool2D(3, 2),
                _Fire(96, 16, 64, 64, gen=g), _Fire(128, 16, 64, 64, gen=g),
                _Fire(128, 32, 128, 128, gen=g), MaxPool2D(3, 2),
                _Fire(256, 32, 128, 128, gen=g),
                _Fire(256, 48, 192, 192, gen=g),
                _Fire(384, 48, 192, 192, gen=g),
                _Fire(384, 64, 256, 256, gen=g),
                MaxPool2D(3, 2), _Fire(512, 64, 256, 256, gen=g))
        else:  # 1.1
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, gen=g), ReLU(), MaxPool2D(3, 2),
                _Fire(64, 16, 64, 64, gen=g), _Fire(128, 16, 64, 64, gen=g),
                MaxPool2D(3, 2), _Fire(128, 32, 128, 128, gen=g),
                _Fire(256, 32, 128, 128, gen=g), MaxPool2D(3, 2),
                _Fire(256, 48, 192, 192, gen=g),
                _Fire(384, 48, 192, 192, gen=g),
                _Fire(384, 64, 256, 256, gen=g),
                _Fire(512, 64, 256, 256, gen=g))
        self.head = Sequential(Dropout(dropout),
                               Conv2D(512, num_classes, 1, gen=g), ReLU(),
                               AdaptiveAvgPool2D(1), Flatten())
        self._place(dtype)

    def forward(self, x):
        return self.head(self.features(x))


def squeezenet1_0(pretrained=False, **kw):
    _no_download(pretrained)
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(pretrained=False, **kw):
    _no_download(pretrained)
    return SqueezeNet("1.1", **kw)


# --------------------------------------------------------------------------- #
# GoogLeNet
# --------------------------------------------------------------------------- #

class _Inception(nn.Module):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, proj, gen=None):
        super().__init__()
        self.b1 = Sequential(Conv2D(cin, c1, 1, gen=gen), ReLU())
        self.b3 = Sequential(Conv2D(cin, c3r, 1, gen=gen), ReLU(),
                             Conv2D(c3r, c3, 3, padding=1, gen=gen), ReLU())
        self.b5 = Sequential(Conv2D(cin, c5r, 1, gen=gen), ReLU(),
                             Conv2D(c5r, c5, 5, padding=2, gen=gen), ReLU())
        self.bp = Sequential(MaxPool2D(3, 1, padding=1),
                             Conv2D(cin, proj, 1, gen=gen), ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b3(x), self.b5(x), self.bp(x)],
                         dim=1)


class GoogLeNet(_Zoo):
    """The main trunk (the training-time auxiliary classifiers left
    out, as in JAX)."""

    def __init__(self, num_classes=1000, dropout=0.4, seed: int = 0,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        g = self._start(seed, device)
        self.stem = Sequential(
            Conv2D(3, 64, 7, stride=2, padding=3, gen=g), ReLU(),
            MaxPool2D(3, 2, padding=1),
            Conv2D(64, 64, 1, gen=g), ReLU(),
            Conv2D(64, 192, 3, padding=1, gen=g), ReLU(),
            MaxPool2D(3, 2, padding=1))
        self.blocks = Sequential(
            _Inception(192, 64, 96, 128, 16, 32, 32, gen=g),
            _Inception(256, 128, 128, 192, 32, 96, 64, gen=g),
            MaxPool2D(3, 2, padding=1),
            _Inception(480, 192, 96, 208, 16, 48, 64, gen=g),
            _Inception(512, 160, 112, 224, 24, 64, 64, gen=g),
            _Inception(512, 128, 128, 256, 24, 64, 64, gen=g),
            _Inception(512, 112, 144, 288, 32, 64, 64, gen=g),
            _Inception(528, 256, 160, 320, 32, 128, 128, gen=g),
            MaxPool2D(3, 2, padding=1),
            _Inception(832, 256, 160, 320, 32, 128, 128, gen=g),
            _Inception(832, 384, 192, 384, 48, 128, 128, gen=g))
        self.head = Sequential(AdaptiveAvgPool2D(1), Flatten(),
                               Dropout(dropout),
                               Linear(1024, num_classes, gen=g))
        self._place(dtype)

    def forward(self, x):
        return self.head(self.blocks(self.stem(x)))


def googlenet(pretrained=False, **kw):
    _no_download(pretrained)
    return GoogLeNet(**kw)
