"""Collectives over a mesh's logical ranks: the counterpart of
`paddle_tpu/parallel/collective.py`.

The JAX package's collectives are `lax` primitives over mesh axis names,
used inside `shard_map`. Here the ranks of a mesh are logical ranks of
one process on one device (`mesh.py`), and each collective comes in two
forms:

- **the list form**, from the driving code: the ranks' tensors of the
  group, in rank order, in one call. `all_reduce`, `all_gather` and
  `broadcast` return the one tensor every rank gets (one storage on the
  shared device); `reduce_scatter`, `all_to_all` and `ppermute` return
  the list of the ranks' results;
- **the rank form**, inside an SPMD run (`spmd`, `nn.ranks.spmd`; the
  Trainer's steps under a mesh): one rank's tensor; the ranks of the
  group meet, and each gets its result.

Both combine in rank order: sums add ((p0 + p1) + p2) + ... in the
parts' dtype, gathers concatenate (`nn/tp.py`'s `all_reduce` and
`all_gather`). `counts()` reads how many of each ran (each collective
once, whatever its ranks), `reset_counts()` zeroes them. `group` is
what the JAX package takes: an axis name, a tuple of names, a `Group`,
or None for "dp". `barrier`, `wait`, `host_broadcast` and
`host_all_gather` are the host control plane: one process, so they
return at once (`barrier` inside a run is a rendezvous of its ranks).

Deviation: `ReduceOp.PROD` multiplies in rank order; the JAX package
computes exp(psum(log x)), which is NaN for a negative entry.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn import ranks as _ranks
from ..nn.ranks import counts, reset_counts, spmd  # noqa: F401
from .mesh import get_mesh, mesh_shape

__all__ = ["ReduceOp", "Group", "all_reduce", "all_gather",
           "reduce_scatter", "broadcast", "all_to_all", "ppermute",
           "send_recv", "psum", "pmean", "pmax", "pmin", "axis_index",
           "axis_size", "barrier", "host_broadcast", "host_all_gather",
           "new_group", "wait", "get_group", "counts", "reset_counts",
           "spmd"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_AXIS_DEFAULT = ("dp",)


def _axes(group):
    if group is None:
        return _AXIS_DEFAULT
    if isinstance(group, str):
        return (group,)
    if isinstance(group, (list, tuple)):
        return tuple(group)
    return getattr(group, "axes", _AXIS_DEFAULT)


class Group:
    """A communication group: a set of mesh axes (the reference's
    `collective.Group`)."""

    def __init__(self, axes):
        self.axes = tuple(axes)

    @property
    def nranks(self) -> int:
        m = get_mesh()
        if m is None:
            return 1
        ms = mesh_shape(m)
        n = 1
        for a in self.axes:
            n *= ms.get(a, 1)
        return n

    def __repr__(self):
        return f"Group(axes={self.axes})"


def new_group(ranks=None, backend=None, axes=("dp",)):
    """Reference-parity constructor: a group IS a set of mesh axes."""
    return Group(axes)


def get_group(group=None):
    return Group(_axes(group))


def _is_parts(x) -> bool:
    return isinstance(x, (list, tuple))


def _run(name, x, group, **kw):
    if _is_parts(x):
        return _ranks.combine(name, x, **kw)
    return _ranks.collective(name, x, _axes(group), **kw)


def all_reduce(x, op: str = ReduceOp.SUM, group=None):
    """Sum (or max, min, avg, prod) over the group's ranks."""
    op = str(op).lower()
    if op not in _ranks.REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op}")
    return _run("all_reduce", x, group, op=op)


def psum(x, group=None):
    return all_reduce(x, ReduceOp.SUM, group)


def pmean(x, group=None):
    return all_reduce(x, ReduceOp.AVG, group)


def pmax(x, group=None):
    return all_reduce(x, ReduceOp.MAX, group)


def pmin(x, group=None):
    return all_reduce(x, ReduceOp.MIN, group)


def _one_axis(group, what):
    ax = _axes(group)
    if len(ax) != 1:
        raise ValueError(f"{what} takes a single axis name")
    return ax


def all_gather(x, group=None, axis: int = 0, tiled: bool = True):
    """The ranks' shards concatenated along `axis` (stacked on a new
    `axis` when not `tiled`)."""
    _one_axis(group, "all_gather")
    return _run("all_gather", x, group, axis=axis, tiled=tiled)


def reduce_scatter(x, op: str = ReduceOp.SUM, group=None, axis: int = 0):
    """The ranks' tensors summed, then split along `axis`: rank i keeps
    piece i."""
    _one_axis(group, "reduce_scatter")
    if op not in (ReduceOp.SUM, "sum"):
        raise NotImplementedError("reduce_scatter supports sum")
    return _run("reduce_scatter", x, group, axis=axis)


def broadcast(x, src: int = 0, group=None):
    """Every rank takes rank `src`'s tensor."""
    return _run("broadcast", x, group, src=src)


def all_to_all(x, group=None, split_axis: int = 0, concat_axis: int = 0):
    """Rank i's tensor split in n along `split_axis`; rank j gets piece
    j of every rank, concatenated in rank order along `concat_axis`."""
    _one_axis(group, "all_to_all")
    return _run("all_to_all", x, group, split_axis=split_axis,
                concat_axis=concat_axis)


def ppermute(x, perm, group=None):
    """Rank dst gets rank src's tensor for each (src, dst) of `perm`; a
    rank nobody sends to gets zeros (`lax.ppermute`)."""
    return _run("ppermute", x, group, perm=tuple(tuple(p) for p in perm))


def send_recv(x, src_dst_pairs, group=None):
    """Point to point as a permutation (the reference's send_v2 /
    recv_v2)."""
    return ppermute(x, src_dst_pairs, group)


def axis_index(group=None) -> int:
    """This rank's index along the group's axes inside an SPMD run (0
    outside one)."""
    return _ranks.axis_index(_axes(group))


def axis_size(group=None) -> int:
    m = get_mesh()
    if m is None:
        return 1
    ms = mesh_shape(m)
    n = 1
    for a in _axes(group):
        n *= ms.get(a, 1)
    return n


def barrier(group=None):
    """A rendezvous of the group's ranks inside an SPMD run; outside one,
    one process has nothing to wait for."""
    if _ranks.in_run():
        _ranks.collective("barrier", None, _axes(group))


def host_broadcast(x, src: int = 0):
    """One process: its value is everyone's."""
    return x


def host_all_gather(x):
    """One process: its value with a leading axis of 1."""
    if isinstance(x, torch.Tensor):
        return x[None]
    return np.asarray(x)[None]


def wait(x, group=None, use_calc_stream=True):
    """The collectives run on the compute stream: nothing to wait for."""
    return x
