"""Local SGD: per-rank training with periodic parameter averaging, the
counterpart of `paddle_tpu/parallel/localsgd.py` (the reference's
`fleet/meta_optimizers/localsgd_optimizer.py`).

One round: every rank of the dp axis takes k optimizer steps on its own
rows of the batch with its own copy of the parameters and optimizer
slots, and no gradient collective; then one mean over the ranks of the
parameters, the slots and the losses, in rank order. The step counter
is not averaged (every rank counted the same k). The mean is one
`all_reduce` per dtype of the state (one for an fp32 model: the
`collective.counts()` of a round), over every leaf flattened into one
buffer. Over a mesh whose ranks span processes (`parallel.env`) each
process runs its own ranks and the buffers cross the processes
(`collective.exchange_ranks`), so every process averages all ranks'
states in global rank order.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..nn import ranks as _ranks
from .compression import _leaves, _rows, axis_ranks, global_parts
from .mesh import Mesh, get_mesh

__all__ = ["local_train_steps", "LocalSGD"]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _state_leaves(params, opt_state) -> List[torch.Tensor]:
    """The averaged leaves, in a fixed order: the parameters, then every
    optimizer slot (not the step counter)."""
    slots = opt_state.get("slots", {}) if isinstance(opt_state, dict) \
        else opt_state
    return list(params.values()) + _leaves(slots)


def local_train_steps(loss_fn: Callable, optimizer,
                      params: Dict[str, torch.Tensor], opt_state, batch,
                      k_steps: int, mesh: Optional[Mesh] = None,
                      axis: str = "dp", per_step_batches: bool = False):
    """One LocalSGD round: k steps of `loss_fn(params, batch)` and
    `optimizer` on each rank of `axis` (its rows of every batch leaf's
    leading dim), then the rank mean of parameters and slots, written
    into `params` and `opt_state` in place. Returns (params, opt_state,
    mean_losses[k]). `per_step_batches=True`: every batch leaf has a
    leading k_steps dim, one batch per step; else the one batch is used
    k times."""
    mesh = mesh or get_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise ValueError(f"mesh with a {axis!r} axis required")
    if per_step_batches:
        for leaf in _leaves(batch):
            if leaf.shape[0] != k_steps:
                raise ValueError(
                    f"per_step_batches: leading dim {leaf.shape[0]} != "
                    f"k_steps {k_steps}")
    n = mesh.shape[axis]
    local_ids = axis_ranks(mesh, axis)
    names = [k for k, v in params.items() if v.is_floating_point()]
    states = []
    for i in local_ids:
        p, s = _clone(params), _clone(opt_state)
        losses = []
        for t in range(k_steps):
            b = _rows(batch, i, n, dim=1) if per_step_batches else \
                _rows(batch, i, n)
            if per_step_batches:
                b = _tree_index(b, t)
            leaves = {k: v.detach().requires_grad_(v.is_floating_point())
                      for k, v in p.items()}
            loss = loss_fn(leaves, b)
            gs = torch.autograd.grad(loss, [leaves[k] for k in names],
                                     allow_unused=True)
            optimizer.update({k: g if g is not None else
                              torch.zeros_like(p[k])
                              for k, g in zip(names, gs)}, s, p)
            losses.append(loss.detach().to(torch.float32))
        states.append((p, s, torch.stack(losses)))
    # the round's one exchange: per dtype, every rank's leaves flattened
    # into one buffer, averaged over the ranks in rank order
    mine = [_state_leaves(p, s) + [lo] for p, s, lo in states]
    dtypes = list(dict.fromkeys(t.dtype for t in mine[0]))
    bufs = [[torch.cat([t.reshape(-1) for t in lv if t.dtype == dt])
             for dt in dtypes] for lv in mine]
    every = global_parts(bufs)
    means = {dt: _ranks.combine("all_reduce", [b[j] for b in every],
                                op="avg") for j, dt in enumerate(dtypes)}
    offs = dict.fromkeys(dtypes, 0)
    targets = _state_leaves(params, opt_state) + [None]
    out_losses = None
    with torch.no_grad():
        for t, tgt in zip(mine[0], targets):
            o = offs[t.dtype]
            val = means[t.dtype][o:o + t.numel()].view(t.shape)
            offs[t.dtype] = o + t.numel()
            if tgt is None:
                out_losses = val.clone()
            else:
                tgt.copy_(val)
    if isinstance(opt_state, dict) and "step" in opt_state:
        opt_state["step"] = states[0][1]["step"]
    return params, opt_state, out_losses


def _tree_index(tree, t: int):
    if isinstance(tree, torch.Tensor):
        return tree[t]
    if isinstance(tree, dict):
        return {k: _tree_index(v, t) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_index(v, t) for v in tree)
    return tree


class LocalSGD:
    """(loss, optimizer, mesh) bound for repeated rounds, the
    LocalSGDOptimizer analog; `k_steps` follows the reference's
    localsgd_configs."""

    def __init__(self, loss_fn: Callable, optimizer, k_steps: int = 4,
                 mesh: Optional[Mesh] = None, axis: str = "dp",
                 per_step_batches: bool = False):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.k_steps = k_steps
        self.mesh = mesh or get_mesh()
        self.axis = axis
        self.per_step_batches = per_step_batches

    def round(self, params, opt_state, batch):
        return local_train_steps(
            self.loss_fn, self.optimizer, params, opt_state, batch,
            self.k_steps, mesh=self.mesh, axis=self.axis,
            per_step_batches=self.per_step_batches)
