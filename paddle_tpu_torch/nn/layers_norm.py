"""Batch norm: the counterpart of the BatchNorm classes of
`paddle_tpu/nn/layers_norm.py`.

The running statistics are buffers named `_mean` and `_variance`, as in
JAX, so `named_buffers()` equals the JAX `raw_buffers()` keys;
`momentum=0.9` in the reference's sense (new = 0.9·old + 0.1·batch,
with the biased batch variance: `functional.batch_norm`). Weight and
bias start at 1 and 0 (`weight_attr` / `bias_attr=False` drops them);
`use_global_stats=True` normalises with the running stats even in
training.

Where the new statistics go. Outside a `Trainer`, a BatchNorm in
training mode writes them into its own buffers, as JAX's
`_update_buffer` does. Under the Trainer they must not: the forward
runs over the state's buffers (`torch.func.functional_call`), and
`torch.utils.checkpoint` runs it a second time inside the backward, so
an in-place write would land twice. The Trainer therefore hands every
BatchNorm of its model a `StatSink` (`collect_stats`) around the
forward and the backward; a BatchNorm records its first new statistics
of the step there and writes nothing (the recomputed forward's equal
values are dropped), and the Trainer installs them after the backward,
as the JAX Trainer merges `functional_call`'s buffer updates. The sink
hangs on the modules, not on a thread: the CUDA backward, recompute
included, runs on autograd's own thread.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
from torch import nn

from . import functional as F

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "StatSink", "collect_stats"]


class StatSink:
    """The new running statistics of one forward, by BatchNorm module:
    {module: (new_mean, new_var)}, the first record of each kept."""

    def __init__(self):
        self.updates: Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]] = {}

    def record(self, module, new_mean, new_var):
        self.updates.setdefault(module, (new_mean, new_var))


@contextlib.contextmanager
def collect_stats(model: nn.Module):
    """Hand every BatchNorm of `model` one `StatSink` for the duration;
    yields the sink."""
    mods = [m for m in model.modules() if isinstance(m, _BatchNormBase)]
    sink = StatSink()
    for m in mods:
        m._stat_sink = sink
    try:
        yield sink
    finally:
        for m in mods:
            m._stat_sink = None


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else \
            nn.Parameter(torch.ones(num_features))
        self.bias = None if bias_attr is False else \
            nn.Parameter(torch.zeros(num_features))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))
        self._stat_sink = None

    def forward(self, x):
        training = self.training and self.use_global_stats is not True
        out, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self.momentum, epsilon=self.epsilon,
            data_format=self.data_format,
            use_global_stats=self.use_global_stats)
        if training:
            new_mean, new_var = new_mean.detach(), new_var.detach()
            if self._stat_sink is not None:
                self._stat_sink.record(self, new_mean, new_var)
            else:
                with torch.no_grad():
                    self._mean.copy_(new_mean)
                    self._variance.copy_(new_var)
        return out

    def extra_repr(self):
        return (f"num_features={self.num_features}, momentum={self.momentum}"
                f", data_format={self.data_format}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)
