"""ZeRO partitions over a mesh's fsdp ranks: the counterpart of
`paddle_tpu/parallel/sharding.py`.

The JAX package writes ZeRO as specs (`fsdp_extend_spec` puts the
"fsdp" axis on a dim of a parameter's or a slot's spec) and lets GSPMD
place the pieces. Here the pieces are tensors of their own: a
`Sharded` holds one tensor per fsdp rank (`parts[j]`, the j-th slice
along `dim`), so each rank's bytes can be counted, as `nn.tp`'s
`ShardedParams` holds a rank's serving shard. Entries the spec leaves
replicated (no dim divisible by the fsdp size, a slot of another
shape) are one tensor, one storage shared by every rank.

The stages, as `Trainer(mesh=)` runs them (`apply_fsdp` sets the stage
on the model):
- 0: parameters, gradients and optimizer slots whole; the ranks'
  gradients all-reduced.
- 1: the slots split over the fsdp ranks along the dim
  `fsdp_extend_spec` picks; the gradients all-reduced; each fsdp rank
  updates its slice and the parameters are all-gathered.
- 2: as 1, with the gradients reduce-scattered: a rank keeps only the
  slice of the summed gradients it updates.
- 3: the parameters split too (those of at least `min_size` elements);
  a rank's forward all-gathers each one before use, and its slices are
  all the state keeps between steps.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .mesh import Mesh, P, mesh_shape

__all__ = ["fsdp_extend_spec", "apply_fsdp", "shard_model", "Sharded",
           "param_specs", "zero_stage", "partition_dim", "state_partitions",
           "shard_train_state", "gather_train_state", "rank_bytes",
           "fsdp_size"]


def fsdp_extend_spec(spec: Optional[P], shape, mesh: Mesh,
                     axis: str = "fsdp", prefer_dims=None) -> Optional[P]:
    """Add the fsdp axis to a spec on the largest divisible unsharded
    dim (`paddle_tpu/parallel/sharding.py:43`). `prefer_dims` (a
    Parameter's `fsdp_dims` hint: lookup tables name their vocab dim)
    are tried first, where the axis may stack onto an existing one
    (P(("tp", "fsdp"), ...))."""
    ms = mesh_shape(mesh)
    size = ms.get(axis, 1)
    if size <= 1 or len(shape) == 0:
        return spec
    entries = list(spec) if spec is not None else []
    entries += [None] * (len(shape) - len(entries))
    used = set()
    for e in entries:
        if isinstance(e, tuple):
            used.update(e)
        elif e is not None:
            used.add(e)
    if axis in used:
        return spec
    for i in (prefer_dims or ()):
        e = entries[i]
        existing = () if e is None else \
            (tuple(e) if isinstance(e, tuple) else (e,))
        shard = int(np.prod([ms.get(a, 1) for a in existing])) if existing \
            else 1
        if shape[i] % (shard * size) == 0:
            entries[i] = existing + (axis,) if existing else axis
            return P(*entries)
    best, best_dim = -1, None
    for i, d in enumerate(shape):
        if entries[i] is None and d % size == 0 and d > best:
            best, best_dim = d, i
    if best_dim is None:
        return spec
    entries[best_dim] = axis
    return P(*entries)


_GPT_SPECS = {"vocab": P("tp", None), "vocab_col": P(None, "tp"),
              "row": P("tp", None)}


def param_specs(model: nn.Module) -> Dict[str, Optional[P]]:
    """{name: spec} of the trainable parameters: a Parameter's `.spec`
    (set by `apply_fsdp`); a GPT's parameters start from the JAX
    package's TP specs (`models.gpt.tp_param_specs`: columns P(None,
    "tp"), rows and the vocab P("tp", None), column biases P("tp")),
    which steer where the fsdp axis goes."""
    from ..models.gpt import GPT, tp_param_specs
    base: Dict[str, P] = {}
    if isinstance(model, GPT):
        named = dict(model.named_parameters())
        for k, kind in tp_param_specs(model.cfg, named).items():
            if kind[0] in ("qkv", "col"):
                base[k] = P("tp") if named[k].dim() == 1 else P(None, "tp")
            else:
                base[k] = _GPT_SPECS[kind[0]]
    return {k: getattr(p, "spec", None) or base.get(k)
            for k, p in model.named_parameters() if p.requires_grad}


def zero_stage(model: nn.Module) -> int:
    return int(getattr(model, "_zero_stage", 0))


def apply_fsdp(model: nn.Module, mesh: Mesh, stage: int = 3,
               min_size: int = 1024):
    """The group_sharded entry (`paddle_tpu/parallel/sharding.py:87`):
    stage 1 or 2 shards the optimizer slots only; stage 3 the
    parameters of at least `min_size` elements too (their `.spec` gains
    the fsdp axis)."""
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"ZeRO stage must be 0-3, got {stage}")
    model._zero_stage = int(stage)
    if stage >= 3:
        specs = param_specs(model)
        for name, p in model.named_parameters():
            if p.requires_grad and p.numel() >= min_size:
                p.spec = fsdp_extend_spec(
                    specs.get(name), tuple(p.shape), mesh,
                    prefer_dims=getattr(p, "fsdp_dims", None))
    return model


def shard_model(model: nn.Module, mesh: Mesh):
    """Place the model on the mesh: its parameters and buffers on the
    mesh's device, one storage every rank shares (the Trainer keeps the
    partitions its stage asks for)."""
    model.to(mesh.device)
    return model


def fsdp_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.shape.get("fsdp", 1)


def partition_dim(spec: Optional[P], axis: str = "fsdp") -> Optional[int]:
    """The dim of `spec` that carries `axis`, or None."""
    for i, e in enumerate(spec or ()):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i
    return None


class Sharded:
    """One tensor split over the fsdp ranks: `parts[j]` is rank j's
    slice along `dim`, a tensor of its own."""

    def __init__(self, parts: Sequence[torch.Tensor], dim: int):
        self.parts = list(parts)
        self.dim = int(dim)

    @classmethod
    def split(cls, t: torch.Tensor, n: int, dim: int) -> "Sharded":
        return cls([c.clone() for c in t.detach().chunk(n, dim=dim)], dim)

    @property
    def shape(self):
        s = list(self.parts[0].shape)
        s[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    def full(self) -> torch.Tensor:
        """The whole tensor (a copy; no collective is counted)."""
        return torch.cat(self.parts, dim=self.dim)

    def __repr__(self):
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, dim="
                f"{self.dim}, parts={len(self.parts)})")


def _whole(t):
    return t.full() if isinstance(t, Sharded) else t


def state_partitions(state, model: nn.Module, mesh: Mesh) -> Dict:
    """Where each entry of a TrainState is split (the counterpart of
    `state_shardings`, `paddle_tpu/parallel/sharding.py:125`):
    {"params": {name: dim or None}, "slots": {name: {slot: dim or
    None}}}; None is one tensor every rank shares."""
    stage = zero_stage(model)
    specs = param_specs(model)
    n = fsdp_size(mesh)
    out = {"params": {}, "slots": {}}
    for k, v in state.params.items():
        d = partition_dim(specs.get(k)) if stage >= 3 and n > 1 else None
        out["params"][k] = d
    for k, slots in state.opt_state["slots"].items():
        pshape = tuple(state.params[k].shape)
        out["slots"][k] = {}
        for sk, sv in slots.items():
            d = None
            if stage >= 1 and n > 1 and tuple(sv.shape) == pshape:
                d = partition_dim(fsdp_extend_spec(specs.get(k), pshape,
                                                   mesh))
            out["slots"][k][sk] = d
    return out


def shard_train_state(state, model: nn.Module, mesh: Mesh):
    """`state` (whole tensors) laid out for the model's ZeRO stage: each
    split entry a `Sharded` over the fsdp ranks, in place in the
    state's dicts; returns the state."""
    parts = state_partitions(state, model, mesh)
    n = fsdp_size(mesh)
    for k, d in parts["params"].items():
        if d is not None:
            state.params[k] = Sharded.split(_whole(state.params[k]), n, d)
    for k, slots in parts["slots"].items():
        for sk, d in slots.items():
            if d is not None:
                v = _whole(state.opt_state["slots"][k][sk])
                state.opt_state["slots"][k][sk] = Sharded.split(v, n, d)
    return state


def gather_train_state(state):
    """A TrainState of whole tensors (fresh copies of split entries)."""
    from ..framework.trainer import TrainState
    return TrainState(
        {k: _whole(v) for k, v in state.params.items()},
        dict(state.buffers),
        {"step": state.opt_state["step"],
         "slots": {k: {sk: _whole(sv) for sk, sv in s.items()}
                   for k, s in state.opt_state["slots"].items()}},
        dict(state.scaler_state), state.rng_key, state.step)


def _nbytes(t, j: int) -> int:
    if isinstance(t, Sharded):
        t = t.parts[j]
    return t.numel() * t.element_size()


def rank_bytes(state, mesh: Mesh) -> List[Dict[str, int]]:
    """Per data rank (dp x fsdp, row-major): the bytes of parameters and
    optimizer slots it holds. A split entry counts its slice; a
    replicated one counts whole on every rank (one storage here, a copy
    per device in JAX)."""
    out = []
    for c in mesh.ranks_over(("dp", "fsdp")):
        j = c.get("fsdp", 0)
        out.append({
            "params": sum(_nbytes(v, j) for v in state.params.values()),
            "slots": sum(_nbytes(sv, j)
                         for s in state.opt_state["slots"].values()
                         for sv in s.values())})
    return out
