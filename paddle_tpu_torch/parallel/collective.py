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
or None for "dp". `wire()` reads the bytes the collectives joined, by
dtype.

`barrier`, `host_broadcast` and `host_all_gather` are the host control
plane. Over several processes (`env.init_parallel_env`) they go over
the gloo group; in one process they return at once (`barrier` inside a
run is a rendezvous of its ranks). Tensors cross the transport as CPU
copies in their own dtype and come back on their device.
`exchange_ranks` carries the ranks' tensors of a mesh that spans
processes to every process (`TRANSPORT` times its parts), so each
process can combine every rank's part in global rank order.

Deviation: `ReduceOp.PROD` multiplies in rank order; the JAX package
computes exp(psum(log x)), which is NaN for a negative entry.
"""
from __future__ import annotations

import numpy as np
import torch

import time
from typing import List

from ..nn import ranks as _ranks
from ..nn.ranks import counts, reset_counts, spmd, wire  # noqa: F401
from . import env as _env
from .mesh import get_mesh, mesh_shape

__all__ = ["ReduceOp", "Group", "all_reduce", "all_gather",
           "reduce_scatter", "broadcast", "all_to_all", "ppermute",
           "send_recv", "psum", "pmean", "pmax", "pmin", "axis_index",
           "axis_size", "barrier", "host_broadcast", "host_all_gather",
           "new_group", "wait", "get_group", "counts", "reset_counts",
           "spmd", "wire", "exchange_ranks", "TRANSPORT",
           "reset_transport"]


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
    of the processes (nothing to wait for in one process)."""
    if _ranks.in_run():
        _ranks.collective("barrier", None, _axes(group))
    elif _env.is_initialized():
        import torch.distributed as dist
        dist.barrier()


def _to_host(x):
    """(CPU tensor, function mapping a CPU result back to x's kind)."""
    if isinstance(x, torch.Tensor):
        dev = x.device
        return x.detach().to("cpu", copy=True).contiguous(), \
            lambda t: t.to(dev)
    a = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(a.copy()), lambda t: t.numpy()


def host_broadcast(x, src: int = 0):
    """Process `src`'s value, in every process (one process: x)."""
    if not _env.is_initialized():
        return x
    import torch.distributed as dist
    t, back = _to_host(x)
    dist.broadcast(t, src)
    return back(t)


def host_all_gather(x):
    """Every process's value stacked on a new leading axis, process 0
    first (one process: a leading axis of 1)."""
    if not _env.is_initialized():
        if isinstance(x, torch.Tensor):
            return x[None]
        return np.asarray(x)[None]
    import torch.distributed as dist
    t, back = _to_host(x)
    out = [torch.empty_like(t) for _ in range(_env.get_world_size())]
    dist.all_gather(out, t)
    return back(torch.stack(out))


# what `exchange_ranks` cost: calls, bytes this process sent, seconds
# of the device-to-host copies, the gloo all_gathers and the copies back
TRANSPORT = {"calls": 0, "bytes": 0, "d2h_s": 0.0, "gather_s": 0.0,
             "h2d_s": 0.0}
# page-locked host buffers of the exchanges from a card, kept per dtype
# (a pinned allocation costs more than the copy it speeds up)
_PINNED = {}
# the gloo all_gather of a buffer goes as this many concurrent pieces
# (gloo runs them on its worker threads: 1.6x one piece on loopback)
_PIECES = 4


def reset_transport():
    TRANSPORT.update(calls=0, bytes=0, d2h_s=0.0, gather_s=0.0, h2d_s=0.0)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(key, shape, dtype, dev):
    """A host buffer for an exchange: page-locked and kept for the next
    exchange when the tensors are on a card, fresh otherwise."""
    if dev.type != "cuda":
        return torch.empty(shape, dtype=dtype)
    buf = _PINNED.get(key)
    if buf is None or tuple(buf.shape) != tuple(shape):
        buf = _PINNED[key] = torch.empty(shape, dtype=dtype,
                                         pin_memory=True)
    return buf


def exchange_ranks(local: List[List[torch.Tensor]]
                   ) -> List[List[List[torch.Tensor]]]:
    """Every process's ranks' tensors: `local[i][j]` is this process's
    i-th rank's j-th tensor (every process passes the same number of
    ranks and the same shapes and dtypes); returns `out[p][i][j]`,
    process p's. One process: [local]. Across processes, per dtype the
    tensors flattened into one buffer, one copy to the host, one gloo
    all_gather (in `_PIECES` concurrent pieces) and one copy back: the
    results come back on the tensors' device, bit for bit."""
    if not _env.is_initialized():
        return [list(local)]
    import torch.distributed as dist
    nproc = _env.get_world_size()
    flat = [(i, j, t) for i, ts in enumerate(local) for j, t in
            enumerate(ts)]
    if not flat:
        return [[[] for _ in local] for _ in range(nproc)]
    dev = flat[0][2].device
    out = [[[None] * len(ts) for ts in local] for _ in range(nproc)]
    for dtype in dict.fromkeys(t.dtype for _, _, t in flat):
        items = [(i, j, t) for i, j, t in flat if t.dtype == dtype]
        t0 = time.perf_counter()
        buf = torch.cat([t.detach().reshape(-1) for _, _, t in items])
        n = buf.numel()
        send = _host(("send", dtype), (n,), dtype, dev)
        send.copy_(buf)
        t1 = time.perf_counter()
        recv = _host(("recv", dtype), (nproc, n), dtype, dev)
        cuts = [n * k // _PIECES for k in range(_PIECES + 1)]
        works = [dist.all_gather([recv[p, a:b] for p in range(nproc)],
                                 send[a:b], async_op=True)
                 for a, b in zip(cuts, cuts[1:]) if b > a]
        for w in works:
            w.wait()
        t2 = time.perf_counter()
        back = recv.to(dev, non_blocking=True) if dev.type == "cuda" \
            else recv
        _sync(dev)
        t3 = time.perf_counter()
        for p in range(nproc):
            off = 0
            for i, j, t in items:
                out[p][i][j] = back[p, off:off + t.numel()].view(t.shape)
                off += t.numel()
        _ranks.record_wire([send])
        TRANSPORT["calls"] += 1
        TRANSPORT["bytes"] += n * send.element_size()
        TRANSPORT["d2h_s"] += t1 - t0
        TRANSPORT["gather_s"] += t2 - t1
        TRANSPORT["h2d_s"] += t3 - t2
    return out


def wait(x, group=None, use_calc_stream=True):
    """The collectives run on the compute stream: nothing to wait for."""
    return x
