"""Error-feedback compressed gradient reduction: the counterpart of
`paddle_tpu/parallel/compression.py` (the reference's Deep Gradient
Compression, `fleet/meta_optimizers/dgc_optimizer.py`).

DGC trades gradient precision for bytes on a slow link and keeps a
residual per rank, so the dropped precision comes back the next step
(error feedback). As in the JAX package the capability is dense int8
quantization with one shared scale per tensor, step for step:

  1. local = (x + residual) in fp32
  2. m     = max over the ranks of max|local|
  3. qmax  = floor(127 / n); scale = m / qmax (1 where m is 0)
  4. q     = clip(round(local / scale), -qmax, qmax) as int8 (round
             half to even)
  5. total = the int8 sum over the ranks, in rank order (n * qmax <=
             127: it stays in int8, so int8 is what the sum moves)
  6. mean  = total * scale / n; residual' = local - q * scale, fp32,
             rounded once (as XLA's fused multiply-subtract)

and, as in the JAX package's compiled program, each division by a
constant (qmax, n) is a product with the constant's fp32 reciprocal,
so the port's results are JAX's bit for bit on the CPU.

`compressed_psum_mean` comes in the collectives' two forms: the list
form takes the ranks' tensors and residuals in rank order and returns
(mean, [residuals]); the rank form runs inside an SPMD run
(`collective.spmd`) on one rank's tensor and residual. Both move the
scale's max as fp32 and the codes as int8 (`collective.wire()`).
`compressed_grads` runs each rank of the axis on its rows of the batch
(no gradient collective) and reduces every gradient so;
`compressed_grad_step` adds the optimizer's update. Over a mesh whose
ranks span processes (`parallel.env`) each process runs its own ranks,
the maxima and the int8 codes cross the processes
(`collective.exchange_ranks`) and every process sums all ranks' codes
in global rank order; each process keeps its own ranks' residual rows.
Over 64 ranks or more a code keeps less than one bit
(`_guard_axis_size` raises): compress the slow axis only.
`fleet.distributed_trainer` refuses `strategy.dgc` and points here.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..nn import ranks as _ranks
from .mesh import Mesh, get_mesh

__all__ = ["compressed_psum_mean", "zero_residuals", "compressed_grads",
           "compressed_grad_step"]


def _guard_axis_size(n: int) -> None:
    """|q| <= floor(127/n) keeps the n-rank sum inside int8; past n = 63
    that leaves less than one bit (and 0 at n >= 128: a NaN)."""
    if n > 63:
        raise ValueError(
            f"compressed reduction over {n} shards leaves <1 bit of "
            f"quantization range; compress the (small) DCN axis only")


def _recip(c: float) -> float:
    """1 / c rounded to fp32: XLA's program divides by a constant as a
    product with its fp32 reciprocal, so the port's arithmetic does."""
    return float(np.float32(1.0 / c))


def _scale(m: torch.Tensor, n: int):
    qmax = float(math.floor(127.0 / n))
    return torch.where(m > 0, m * _recip(qmax), torch.ones_like(m)), qmax


def _mean(total: torch.Tensor, scale: torch.Tensor, n: int):
    return total.to(torch.float32) * scale * _recip(n)


def _codes(local: torch.Tensor, scale: torch.Tensor, qmax: float):
    return torch.clamp(torch.round(local / scale), -qmax, qmax).to(
        torch.int8)


def _residual(local, q, scale):
    """local - q * scale rounded once to fp32: the exact value (a code
    times an fp32 scale, minus an fp32 within 2^8 scales of it, fits
    fp64's 53 bits) as the JAX package's XLA program gives it, which
    fuses the multiply and the subtract."""
    return (local.to(torch.float64) - q.to(torch.float64)
            * scale.to(torch.float64)).to(torch.float32)


def compressed_psum_mean(x, axis: str, residual):
    """Mean of `x` over the ranks of `axis` with int8 codes on the wire
    and error feedback. List form: `x` and `residual` are the ranks'
    tensors in rank order; returns (mean, [new residuals]). Rank form,
    inside an SPMD run: this rank's tensor and residual; returns (mean,
    new residual). The mean has x's dtype, the residuals are fp32."""
    if isinstance(x, (list, tuple)):
        n = len(x)
        _guard_axis_size(n)
        locs = [(a + r).to(torch.float32) for a, r in zip(x, residual)]
        m = _ranks.combine("all_reduce", [loc.abs().max() for loc in locs],
                           op="max")
        scale, qmax = _scale(m, n)
        qs = [_codes(loc, scale, qmax) for loc in locs]
        total = _ranks.combine("all_reduce", qs)
        mean = _mean(total, scale, n)
        return mean.to(x[0].dtype), [_residual(loc, q, scale)
                                     for loc, q in zip(locs, qs)]
    n = _ranks.axis_info(axis)[1]
    _guard_axis_size(n)
    local = (x + residual).to(torch.float32)
    m = _ranks.collective("all_reduce", local.abs().max(), (axis,),
                          op="max")
    scale, qmax = _scale(m, n)
    q = _codes(local, scale, qmax)
    total = _ranks.collective("all_reduce", q, (axis,))
    mean = _mean(total, scale, n)
    return mean.to(x.dtype), _residual(local, q, scale)


def _default_axis() -> str:
    from .fleet import get_strategy
    return get_strategy().dgc_configs.axis


def zero_residuals(params: Dict[str, torch.Tensor],
                   mesh: Optional[Mesh] = None,
                   axis: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The error-feedback state: per gradient tensor, one fp32 residual
    per rank of `axis` (a leading dim of the axis' size; 1 without a
    mesh), on the parameter's device."""
    mesh = mesh or get_mesh()
    axis = axis or _default_axis()
    n = mesh.shape.get(axis, 1) if mesh is not None else 1
    return {k: torch.zeros((n,) + tuple(p.shape), dtype=torch.float32,
                           device=p.device) for k, p in params.items()}


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _rows(batch, i: int, n: int, dim: int = 0):
    """Rank i's rows of every leaf of `batch` (its dim `dim` split in n)."""
    def take(t):
        if t.shape[dim] % n:
            raise ValueError(f"batch dim {t.shape[dim]} does not split "
                             f"over {n} ranks")
        return t.chunk(n, dim=dim)[i]
    return _tree_map(take, batch)


def axis_ranks(mesh: Mesh, axis: str) -> List[int]:
    """The ranks of `axis` this process runs, for the compressed and
    LocalSGD exchanges: the axis' ranks at the other axes' coordinate
    0 (the others repeat them); over several processes every other
    axis must be 1."""
    n = mesh.shape.get(axis, 1)
    if not mesh.spans_processes:
        return list(range(n))
    others = {a: v for a, v in mesh.shape.items() if a != axis and v > 1}
    if others:
        raise NotImplementedError(
            f"an exchange over {axis!r} across processes with other "
            f"axes {others}: ROADMAP item 18")
    return [i for i in range(n)
            if mesh.rank_at({axis: i}) in mesh.local_ranks()]


def global_parts(local: List[list]) -> List[list]:
    """Every rank's lists in global rank order from this process's
    ranks' (`local`, rank order): the lists themselves in one process,
    an exchange over the processes otherwise."""
    from .collective import exchange_ranks
    return [lst for proc in exchange_ranks(local) for lst in proc]


def compressed_grads(loss_fn: Callable, params: Dict[str, torch.Tensor],
                     residuals: Dict[str, torch.Tensor], batch,
                     mesh: Optional[Mesh] = None,
                     axis: Optional[str] = None):
    """Data-parallel gradients of `loss_fn(params, batch)` (a scalar
    loss of the parameter dict and the batch) reduced over `axis` with
    `compressed_psum_mean`. Every leaf of `batch` has the global batch
    as its leading dim, split over the axis' ranks in rank order;
    `residuals` come from `zero_residuals`. Each rank differentiates
    its rows' loss alone (no gradient collective). Returns (grads,
    new_residuals, mean_loss): the mean gradients in the parameters'
    dtypes, the residuals with each rank's row replaced, the loss
    averaged over the ranks."""
    mesh = mesh or get_mesh()
    axis = axis or _default_axis()
    if mesh is None or mesh.shape.get(axis, 1) < 2:
        raise ValueError(f"mesh with {axis!r} degree >= 2 required")
    n = mesh.shape[axis]
    _guard_axis_size(n)
    local_ids = axis_ranks(mesh, axis)
    names = [k for k, v in params.items() if v.is_floating_point()]
    locs, losses = [], []
    for i in local_ids:
        leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                  for k, v in params.items()}
        loss = loss_fn(leaves, _rows(batch, i, n))
        gs = torch.autograd.grad(loss, [leaves[k] for k in names],
                                 allow_unused=True)
        locs.append([((g if g is not None else torch.zeros_like(leaves[k]))
                      + residuals[k][i]).to(torch.float32)
                     for k, g in zip(names, gs)])
        losses.append(loss.detach().to(torch.float32))
    # the shared scales: every rank's maxima (one fp32 scalar per
    # tensor) with its loss, max over the ranks in rank order
    stats = global_parts([[torch.stack([x.abs().max() for x in loc]
                                       + [loss])]
                          for loc, loss in zip(locs, losses)])
    stats = [s[0] for s in stats]
    grads, new_res = {}, {k: residuals[k].clone() for k in names}
    scales = []
    for j, k in enumerate(names):
        m = _ranks.combine("all_reduce", [s[j] for s in stats], op="max")
        scales.append(_scale(m, n))
    codes = [[_codes(x, *scales[j]) for j, x in enumerate(loc)]
             for loc in locs]
    every = global_parts(codes)
    for j, k in enumerate(names):
        scale = scales[j][0]
        total = _ranks.combine("all_reduce", [c[j] for c in every])
        grads[k] = _mean(total, scale, n).to(params[k].dtype)
        for i, loc, c in zip(local_ids, locs, codes):
            new_res[k][i] = _residual(loc[j], c[j], scale)
    loss = _ranks.combine("all_reduce", [s[-1] for s in stats], op="avg")
    return grads, new_res, loss


def compressed_grad_step(loss_fn: Callable, optimizer,
                         params: Dict[str, torch.Tensor], opt_state,
                         residuals: Dict[str, torch.Tensor], batch,
                         mesh: Optional[Mesh] = None,
                         axis: Optional[str] = None):
    """One training step over the compressed reduction: `compressed_grads`,
    then the optimizer's update of `params` and `opt_state` in place
    (any rule of `optimizer`). Returns (params, opt_state, residuals,
    mean_loss), as the JAX package does."""
    grads, residuals, loss = compressed_grads(
        loss_fn, params, residuals, batch, mesh=mesh, axis=axis)
    params, opt_state = optimizer.update(grads, opt_state, params)
    return params, opt_state, residuals, loss
