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
from . import ranks

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
    all of them). `axes`: the squared norm is summed over those mesh
    axes' ranks before the scale (`paddle_tpu/nn/utils_clip.py:47`'s
    psum), so a rank's slices make up the norm of the unsharded
    gradients; that needs the rank's collective, inside an SPMD run
    (`nn.ranks`), and raises elsewhere. Inside the Trainer's ZeRO update
    a clip without `axes` sums over the partitions too, as JAX's GSPMD
    step takes the norm of the whole gradients."""

    def __init__(self, clip_norm, group_name: str = "default",
                 axes: Optional[Sequence[str]] = None):
        self.clip_norm = clip_norm
        self.axes = tuple(axes) if axes else ()

    def __call__(self, grads):
        names = list(grads)
        ctx = ranks.current()
        axes = self.axes or (ctx.update_axes if ctx is not None else ())
        if not names and not axes:
            return {}
        gs = [grads[k] for k in names]
        norms = fp32_norms(gs)
        dev = norms[0].device if norms else None
        sq = torch.stack([n.to(dev) for n in norms]).square().sum() \
            if norms else torch.zeros(())
        if axes:
            sq = ranks.collective("all_reduce", sq, axes, op="sum")
        scale = _scale(torch.sqrt(sq), self.clip_norm)
        return dict(zip(names, mul_fp32(gs, scale)))
