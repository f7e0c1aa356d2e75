"""The fleet API: the counterpart of `paddle_tpu/parallel/fleet.py` (the
reference's fleet/base/fleet_base.py:139).

`init(strategy=)` builds THE mesh from the strategy's hybrid degrees
(dp, `sharding_degree` as fsdp, `mp_degree` as tp, `pp_degree`,
`sep_degree` as sp, `ep_degree`: `world_size` logical ranks on
`device`, see `mesh.py`);
`distributed_model` applies the ZeRO stage and places the model;
`distributed_trainer` returns a `Trainer` over the mesh with the
strategy's AMP, loss scaling, recompute and gradient merge. One path
replaces the reference's four wrapper classes.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import DeviceLike
from . import env as _env
from . import fleet_metrics as metrics  # noqa: F401 - fleet.metrics.*
from .mesh import HybridCommunicateGroup, get_mesh, init_mesh
from .sharding import apply_fsdp, shard_model
from .strategy import DistributedStrategy

__all__ = ["init", "get_strategy", "distributed_model",
           "distributed_optimizer", "distributed_trainer",
           "get_hybrid_communicate_group", "recompute", "metrics"]

_strategy: Optional[DistributedStrategy] = None


def init(is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, role_maker=None,
         log_level="INFO", world_size: Optional[int] = None,
         device: DeviceLike = None):
    """The mesh of `strategy.hybrid_configs` (dp_degree -1 takes the
    ranks of `world_size` the other degrees leave), made current."""
    global _strategy
    _strategy = strategy or DistributedStrategy()
    _env.init_parallel_env()
    h = _strategy.hybrid_configs
    return init_mesh(dp=h.dp_degree, fsdp=h.sharding_degree,
                     tp=h.mp_degree, pp=h.pp_degree, sp=h.sep_degree,
                     ep=h.ep_degree, world_size=world_size, device=device)


def get_strategy() -> DistributedStrategy:
    return _strategy or DistributedStrategy()


def get_hybrid_communicate_group():
    return HybridCommunicateGroup()


def distributed_model(model: nn.Module) -> nn.Module:
    """The model with the strategy's ZeRO stage applied
    (`sharding_configs.stage`, `min_param_size`) and placed on the
    mesh's device."""
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("call fleet.init() first")
    s = get_strategy()
    if s.sharding and s.sharding_configs.stage >= 1:
        apply_fsdp(model, mesh, stage=s.sharding_configs.stage,
                   min_size=s.sharding_configs.min_param_size)
    shard_model(model, mesh)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer as it is: the Trainer runs its rule on each
    partition, and a global-norm clip sums over them."""
    return optimizer


def distributed_trainer(model: nn.Module, optimizer, loss_fn, **trainer_kw):
    """A Trainer over the fleet mesh with the strategy's options:
    `amp_configs` (level, dtype; a GradScaler for float16 with dynamic
    loss scaling), `recompute` (remat), `gradient_merge` (grad_accum =
    k_steps unless given)."""
    from ..amp import GradScaler
    from ..framework.trainer import Trainer
    s = get_strategy()
    amp_level, scaler = None, None
    if s.amp:
        amp_level = s.amp_configs.level
        if s.amp_configs.dtype == "float16" and \
                s.amp_configs.use_dynamic_loss_scaling:
            scaler = GradScaler(
                init_loss_scaling=s.amp_configs.init_loss_scaling)
    if s.gradient_merge and "grad_accum" not in trainer_kw:
        trainer_kw["grad_accum"] = s.gradient_merge_configs.k_steps
    if s.dgc:
        raise ValueError(
            "strategy.dgc compresses an explicit gradient reduction; the "
            "Trainer's reduction is its own. Step with "
            "parallel.compression.compressed_grad_step (it reads "
            "dgc_configs.axis) instead of a fleet Trainer")
    return Trainer(model, optimizer, loss_fn, mesh=get_mesh(),
                   amp_level=amp_level, amp_dtype=s.amp_configs.dtype,
                   scaler=scaler, remat=s.recompute, **trainer_kw)


def recompute(function, *args, static_argnums=(), **kwargs):
    """Activation checkpointing of one block (the reference's
    fleet.utils.recompute): `torch.utils.checkpoint` without reentry.
    The forward keeps no residuals and the backward runs the block
    again; dropout draws from the installed key, so the recomputed
    masks are the same. `static_argnums`, `preserve_rng_state` and
    `use_reentrant` are accepted for parity."""
    kwargs.pop("preserve_rng_state", None)
    kwargs.pop("use_reentrant", None)
    return torch.utils.checkpoint.checkpoint(function, *args,
                                             use_reentrant=False, **kwargs)
