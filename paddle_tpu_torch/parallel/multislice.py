"""Multi-slice meshes: the counterpart of
`paddle_tpu/parallel/multislice.py` (the reference's FleetExecutor
spans clusters; the JAX package turns a slice boundary into device
order in one mesh).

A slice is a group of ranks joined by a fast link, slices by a slow one
(DCN between TPU slices; between the processes of `parallel.launch`
here). The mesh is built so that the outer axes (pp, dp) vary across
slices and the inner ones within a slice: a collective over an inner
axis stays in its slice, and only the outer axes' traffic crosses. Here
a slice is a contiguous block of logical ranks (`num_slices` equal
blocks: there is no `slice_index`), so the slices of a mesh whose
ranks span P processes are the processes' ranks when `num_slices` is
P. `init_multislice_mesh` composes the rank grid block by block as the
JAX package composes its device grid (an axis in both `dcn` and `ici`
has its outer factor across slices); the mesh has the usual axes, so
the Trainer, the specs and the collectives take it as any other, and
what a step computes follows the coordinates alone.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import DeviceLike
from .mesh import _AXIS_ORDER, Mesh, set_mesh

__all__ = ["detect_slices", "init_multislice_mesh", "slice_axes",
           "dcn_parallelism"]


def detect_slices(devices: Optional[Sequence[int]] = None,
                  num_slices: Optional[int] = None,
                  world_size: Optional[int] = None) -> List[List[int]]:
    """The logical ranks `devices` (default: 0..world_size-1) cut into
    `num_slices` equal contiguous groups (one group by default)."""
    if devices is None:
        if world_size is None:
            from . import env
            world_size = env.default_world_size()
        if world_size is None:
            raise ValueError("pass the ranks (devices=) or world_size, the "
                             "number of logical ranks")
        devices = range(world_size)
    devices = [int(d) for d in devices]
    n = num_slices or 1
    if len(devices) % n:
        raise ValueError(f"{len(devices)} devices not divisible into "
                         f"{n} slices")
    per = len(devices) // n
    return [devices[i * per:(i + 1) * per] for i in range(n)]


def init_multislice_mesh(dcn: Optional[Dict[str, int]] = None,
                         ici: Optional[Dict[str, int]] = None,
                         devices: Optional[Sequence[int]] = None,
                         num_slices: Optional[int] = None,
                         world_size: Optional[int] = None,
                         device: DeviceLike = None) -> Mesh:
    """One mesh whose axes factor over slices x within a slice.

    dcn: axis -> degree across slices (the product is the number of
    slices); ici: axis -> degree within a slice (the product is the
    slice size). Without `num_slices`, the slices are dcn's product.
    The rank grid is block-composed: slice s (dcn coordinates the
    row-major index s) fills the block at those coordinates with its
    ranks in ici's row-major order. The mesh becomes the current one."""
    dcn = dict(dcn or {})
    ici = dict(ici or {})
    for d in (dcn, ici):
        for a in d:
            if a not in _AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {a!r}")
    dcn_shape = tuple(dcn.get(a, 1) for a in _AXIS_ORDER)
    ici_shape = tuple(ici.get(a, 1) for a in _AXIS_ORDER)
    if devices is None and world_size is None:
        world_size = int(np.prod(dcn_shape)) * int(np.prod(ici_shape))
    slices = detect_slices(devices, num_slices=num_slices or int(
        np.prod(dcn_shape)), world_size=world_size)
    n_slices, slice_size = len(slices), len(slices[0])
    if int(np.prod(dcn_shape)) != n_slices:
        raise ValueError(f"dcn degrees {dcn} multiply to "
                         f"{int(np.prod(dcn_shape))}, have {n_slices} "
                         f"slices")
    if int(np.prod(ici_shape)) != slice_size:
        raise ValueError(f"ici degrees {ici} multiply to "
                         f"{int(np.prod(ici_shape))}, slice size is "
                         f"{slice_size}")
    full = tuple(d * i for d, i in zip(dcn_shape, ici_shape))
    grid = np.empty(full, dtype=np.int64)
    for outer in np.ndindex(*dcn_shape):
        sid = int(np.ravel_multi_index(outer, dcn_shape))
        sel = tuple(slice(o * i, (o + 1) * i)
                    for o, i in zip(outer, ici_shape))
        grid[sel] = np.asarray(slices[sid]).reshape(ici_shape)
    mesh = Mesh(dict(zip(_AXIS_ORDER, full)), device, grid=grid)
    set_mesh(mesh)
    return mesh


def slice_axes(dcn: Dict[str, int]) -> tuple:
    """The axes whose collectives cross slices (cost models, logs)."""
    return tuple(a for a, v in dcn.items() if v > 1)


def dcn_parallelism(n_slices: int, strategy: str = "dp") -> Dict[str, int]:
    """The recommended factorization across slices: 'dp' (the gradient
    reduction crosses once per step, the default), 'pp' (one microbatch
    activation per tick crosses) or 'fsdp'. For a cost-model choice use
    `auto.Planner(cluster=ClusterSpec(n_slices=...)).plan_multislice(...)`
    and the winning plan's `mesh_factorization()`."""
    if strategy not in ("dp", "pp", "fsdp"):
        raise ValueError("DCN-friendly strategies: dp, pp, fsdp")
    return {strategy: n_slices}
