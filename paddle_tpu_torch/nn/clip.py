"""Gradient clipping of the PyTorch/CUDA port: the counterpart of
`paddle_tpu/nn/utils_clip.py`.

Each clip is `(grads: dict) -> dict`, out of place, applied by the
optimizer's `update` before the master-weight cast (so under O2 it sees
the bf16 or fp16 gradients). Norms are taken in fp32 with
`torch._foreach_norm`, one call per (device, dtype) group; a scale
min(1, c / max(n, 1e-12)) multiplies each gradient in fp32 and the
product is rounded once to the gradient's dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..core import fp32_norms, mul_fp32

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]

Grads = Dict[str, torch.Tensor]


def _scale(n: torch.Tensor, clip_norm: float) -> torch.Tensor:
    return torch.clamp(clip_norm / torch.clamp(n, min=1e-12), max=1.0)


class ClipGradBase:
    def __call__(self, grads: Grads) -> Grads:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each entry clipped to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        names = list(grads)
        out = torch._foreach_clamp_min([grads[k] for k in names], self.min)
        torch._foreach_clamp_max_(out, self.max)
        return dict(zip(names, out))


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by min(1, clip_norm / its own L2 norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        names = list(grads)
        gs = [grads[k] for k in names]
        scales = [_scale(n, self.clip_norm) for n in fp32_norms(gs)]
        return {k: mul_fp32([g], s)[0] for k, g, s in zip(names, gs, scales)}


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by min(1, clip_norm / the global L2 norm of
    all of them). `axes` (a cross-device sum of the squared norm) is
    sharded training's, which the port does not have yet."""

    def __init__(self, clip_norm, group_name: str = "default",
                 axes: Optional[Sequence[str]] = None):
        if axes:
            raise NotImplementedError(
                "ClipGradByGlobalNorm(axes=...) sums the norm over mesh "
                "axes: sharded training is not ported yet (ROADMAP Queue "
                "1, item 13)")
        self.clip_norm = clip_norm
        self.axes = ()

    def __call__(self, grads):
        names = list(grads)
        if not names:
            return {}
        gs = [grads[k] for k in names]
        norms = fp32_norms(gs)
        dev = norms[0].device
        sq = torch.stack([n.to(dev) for n in norms]).square().sum()
        scale = _scale(torch.sqrt(sq), self.clip_norm)
        return dict(zip(names, mul_fp32(gs, scale)))
