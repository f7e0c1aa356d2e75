"""Weight initializers: the counterpart of `paddle_tpu/nn/initializer.py`.

Each initializer is a callable `(shape, gen=None, dtype=torch.float32)
-> tensor` that draws on the CPU from the `torch.Generator` it is given,
or, given none, from the default generator (`core.default_generator()`:
a fresh generator per draw, reproducible under `paddle_tpu_torch.seed`),
as the JAX initializers draw from the global generator without a key;
`Constant` draws nothing. The
laws are the JAX package's: `Normal(mean, std)`, `Uniform(low, high)`,
Xavier from (fan_in + fan_out), Kaiming from fan_in and
`calculate_gain`, with `_fans` reading a conv kernel as (out, in, *k).
The draws themselves are torch's, not JAX's bits: a test carries
weights across instead of re-drawing them.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import core

__all__ = ["Initializer", "Constant", "Zeros", "Ones", "Normal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "calculate_gain"]


def calculate_gain(nonlinearity: str, param=None) -> float:
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        neg = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + neg ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")


def _fans(shape):
    """(fan_in, fan_out); a conv kernel (out, in, *k) multiplies both by
    its receptive field."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    needs_generator = True

    def __call__(self, shape, gen: Optional[torch.Generator] = None,
                 dtype=torch.float32) -> torch.Tensor:
        if self.needs_generator and gen is None:
            gen = core.default_generator().next_generator("cpu")
        return self._generate(tuple(shape), gen).to(dtype)

    def _generate(self, shape, gen) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    needs_generator = False

    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape, gen):
        return torch.full(shape, float(self.value))


class Zeros(Constant):
    def __init__(self):
        super().__init__(0.0)


class Ones(Constant):
    def __init__(self):
        super().__init__(1.0)


def _normal(shape, std, gen, mean=0.0):
    return torch.empty(shape).normal_(mean, std, generator=gen)


def _uniform(shape, low, high, gen):
    return torch.empty(shape).uniform_(low, high, generator=gen)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, gen):
        return _normal(shape, self.std, gen, self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape, gen):
        return _uniform(shape, self.low, self.high, gen)


class XavierNormal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, shape, gen):
        fan_in, fan_out = _fans(shape)
        return _normal(shape, self.gain * math.sqrt(2.0 / (fan_in + fan_out)),
                       gen)


class XavierUniform(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, shape, gen):
        fan_in, fan_out = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(shape, -limit, limit, gen)


class KaimingNormal(Initializer):
    def __init__(self, negative_slope=0.0, nonlinearity="relu", fan_in=None):
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity
        self.fan_in = fan_in

    def _generate(self, shape, gen):
        fan_in = self.fan_in or _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return _normal(shape, gain / math.sqrt(fan_in), gen)


class KaimingUniform(Initializer):
    def __init__(self, negative_slope=0.0, nonlinearity="relu", fan_in=None):
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity
        self.fan_in = fan_in

    def _generate(self, shape, gen):
        fan_in = self.fan_in or _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fan_in)
        return _uniform(shape, -limit, limit, gen)
