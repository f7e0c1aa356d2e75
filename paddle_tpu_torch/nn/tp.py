"""Tensor-parallel groups of ranks in one process, and their collectives.

The serving counterpart of the JAX package's `tp` mesh axis
(`paddle_tpu/serving/sharded_kv.py`: `make_tp_mesh`, `mesh_fingerprint`).
A `TPGroup` is `tp` ranks driven by one Python process, as the
reference's single-controller mesh is: each rank owns its shard of the
weights and of the KV slabs as tensors of its own, and ranks meet only
in `all_reduce` and `all_gather`. Every rank of a group lives on one
device (the card, or the CPU): the ranks' kernels then run inside the
same CUDA graph as an unsharded engine's, and a collective is a sum or
a concatenation on that device. A group over several devices raises
(ROADMAP.md, Queue 1 item 18: collectives across cards).

Logical rank ids keep groups apart: an `EngineFleet` gives replica i
the ranks `[i*k, (i+1)*k)`, as the reference gives it devices, and a
group's fingerprint (its degree and rank ids) ends every program key
of its engine.

Collective counts: a group bound to a device (`bind`) counts its
all-reduces and all-gathers in two launch counters, so a CUDA graph's
replay adds the collectives its capture recorded
(`serving/graphs.py`), as it adds kernel launches.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..core import resolve_device
from ..ops_cuda.decode_attention import _LaunchCounter

__all__ = ["TPGroup", "ShardedParams", "make_tp_mesh", "mesh_fingerprint",
           "all_reduce", "all_gather", "require_tp_heads",
           "MULTI_DEVICE_ITEM"]

# where ROADMAP.md tracks TP over several cards
MULTI_DEVICE_ITEM = "ROADMAP.md, Queue 1 item 18"


class TPGroup:
    """`tp` ranks with logical ids `ranks`, all on one device (`devices`
    None: the device of whoever binds the group). Picklable: a snapshot
    or a pickled engine config carries the degree, the rank ids and the
    devices' names, never counters."""

    def __init__(self, tp: int, devices: Optional[Sequence] = None,
                 ranks: Optional[Sequence[int]] = None):
        self.tp = int(tp)
        self.ranks = tuple(int(r) for r in (ranks if ranks is not None
                                            else range(self.tp)))
        self.devices = None if devices is None else \
            tuple(resolve_device(d) for d in devices)
        self.all_reduces: Optional[_LaunchCounter] = None
        self.all_gathers: Optional[_LaunchCounter] = None

    @property
    def device(self) -> Optional[torch.device]:
        return None if self.devices is None else self.devices[0]

    def bind(self, device) -> "TPGroup":
        """This group's ranks on `device`, with fresh collective
        counters: what an engine serves on. Raises when the group names
        another device."""
        dev = resolve_device(device)
        if self.devices is not None and self.device != dev:
            raise ValueError(f"TP group on {self.device}, engine on {dev}")
        out = TPGroup(self.tp, (dev,) * self.tp, self.ranks)
        out.all_reduces = _LaunchCounter()
        out.all_gathers = _LaunchCounter()
        return out

    @property
    def collectives(self) -> int:
        """All-reduces plus all-gathers counted so far (0 unbound)."""
        return sum(c.count for c in (self.all_reduces, self.all_gathers)
                   if c is not None)

    def __reduce__(self):
        devs = None if self.devices is None else \
            tuple(str(d) for d in self.devices)
        return (TPGroup, (self.tp, devs, self.ranks))

    def __repr__(self):
        return (f"TPGroup(tp={self.tp}, ranks={self.ranks}, "
                f"device={self.device})")


def make_tp_mesh(tp: int, devices: Optional[Sequence] = None,
                 ranks: Optional[Sequence[int]] = None) -> TPGroup:
    """A TP group of `tp` ranks (`paddle_tpu/serving/sharded_kv.py:141`).
    `devices` None puts every rank on the device of the engine that
    serves it; an explicit list must name `tp` devices, all one device.
    `ranks` (default `range(tp)`) are the logical rank ids, distinct."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"need tp >= 1, got {tp}")
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if len(devices) != tp:
            raise ValueError(f"explicit device group has {len(devices)} "
                             f"devices, need tp={tp}")
        if len(set(devices)) > 1:
            raise NotImplementedError(
                f"a TP group over several devices "
                f"({sorted({str(d) for d in devices})}) needs collectives "
                f"across cards, which are not ported ({MULTI_DEVICE_ITEM})")
    if ranks is not None:
        ranks = [int(r) for r in ranks]
        if len(ranks) != tp or len(set(ranks)) != tp:
            raise ValueError(f"ranks {ranks} must be {tp} distinct ids")
    return TPGroup(tp, devices, ranks)


def mesh_fingerprint(group: Optional[TPGroup]) -> tuple:
    """`()` without a group, else `(tp, *rank ids)`: the tail of every
    program key of an engine (`paddle_tpu/serving/sharded_kv.py:170`),
    so sibling engines on other groups never share a key."""
    if group is None:
        return ()
    return (group.tp,) + group.ranks


def require_tp_heads(num_heads: int, tp: int) -> int:
    """`tp`, or ValueError when the heads do not split evenly over it
    (`paddle_tpu/serving/sharded_kv.py:214`)."""
    if num_heads % tp:
        raise ValueError(
            f"num_heads={num_heads} not divisible by tp={tp}: the KV "
            f"layout shards heads over the group's ranks and a ragged "
            f"head split would give ranks unequal work")
    return tp


def all_reduce(parts: Sequence[torch.Tensor],
               group: Optional[TPGroup] = None) -> torch.Tensor:
    """The ranks' partials summed in rank order, ((p0 + p1) + p2) + ...,
    each add in the partials' dtype: fp32 for fp32 partials, the
    activation dtype (bf16) for bf16 ones, as a ring all-reduce in that
    dtype adds. The result lives on the group's one device, which every
    rank shares. Counted once in the group's all-reduce counter."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    if group is not None and group.all_reduces is not None:
        group.all_reduces.count += 1
    return out


def all_gather(parts: Sequence[torch.Tensor], dim: int = -1,
               group: Optional[TPGroup] = None) -> torch.Tensor:
    """The ranks' shards concatenated along `dim` in rank order, on the
    group's one device. Counted once in the group's all-gather
    counter."""
    out = torch.cat(list(parts), dim=dim)
    if group is not None and group.all_gathers is not None:
        group.all_gathers.count += 1
    return out


class ShardedParams(dict):
    """A GPT parameter dict placed over a TP group
    (`serving.sharded_kv.shard_serving_params`): the replicated entries
    are the dict's own, the sharded ones live in `ranks[r]` (rank r's
    shard under the same name). `vocab_starts[r]` is the first vocabulary
    row of rank r's embedding shard. The decode wiring
    (`models/gpt.py`) runs its TP form when handed one."""

    def __init__(self, replicated: Dict[str, torch.Tensor],
                 ranks: List[Dict[str, torch.Tensor]], group: TPGroup,
                 vocab_starts: Sequence[int] = ()):
        super().__init__(replicated)
        self.ranks = ranks
        self.group = group
        self.vocab_starts = tuple(int(v) for v in vocab_starts)
