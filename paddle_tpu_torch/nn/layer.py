"""`Parameter` and `functional_call`: the counterparts of
`paddle_tpu/nn/layer.py`'s.

`functional_call(layer, params, *args, buffers=, rngs=, training=)`
runs `layer(*args)` with the flat {path: tensor} `params` (and
`buffers`) in place of its own (`torch.func.functional_call`) and
returns `(output, buffer_updates)`, as the reference does: a BatchNorm
in training records its new running statistics into the updates (its
`StatSink`, `nn.layers_norm.collect_stats`) instead of writing them,
so the call is pure. `rngs` is the dropout key, a tuple of integers
(`nn.rng.rng_context`); `training` sets every module's mode for the
call only.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from . import rng
from .layers_norm import collect_stats

__all__ = ["Parameter", "functional_call"]

Parameter = nn.Parameter


def functional_call(layer: nn.Module, params: Optional[Dict[str, torch.Tensor]],
                    *args, buffers: Optional[Dict[str, torch.Tensor]] = None,
                    rngs=None, training: Optional[bool] = None, **kwargs):
    modes = [(m, m.training) for m in layer.modules()]
    if training is not None:
        layer.train(training)
    key = () if rngs is None else (
        tuple(rngs) if isinstance(rngs, (tuple, list)) else (rngs,))
    paths = {m: p for p, m in layer.named_modules()}
    try:
        with collect_stats(layer) as sink, (
                rng.rng_context(*key) if rngs is not None
                else contextlib.nullcontext()):
            out = torch.func.functional_call(
                layer, {**(params or {}), **(buffers or {})}, args, kwargs)
        updates = {}
        for m, (mean, var) in sink.updates.items():
            pre = f"{paths[m]}." if paths[m] else ""
            updates[pre + "_mean"], updates[pre + "_variance"] = mean, var
        return out, updates
    finally:
        for m, mode in modes:
            m.training = mode
