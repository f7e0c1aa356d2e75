"""The hybrid mesh of the port: the counterpart of
`paddle_tpu/parallel/mesh.py`.

The JAX package builds one `jax.sharding.Mesh` over its devices with
the axes ("pp", "dp", "fsdp", "ep", "sp", "tp"), tp innermost. Here a
mesh is the same grid of LOGICAL ranks on one device (`nn/tp.py`'s
design, ROADMAP Queue 1 item 13.4), and every rank shares the mesh's
device. The rank grid (`Mesh.devices`, JAX's grid of device ids) says
which rank sits at which coordinates: `init_mesh` puts rank i at the
row-major coordinates of i over the axes in that order;
`multislice.init_multislice_mesh` composes it block by block, as JAX
places devices. What a step computes follows the coordinates only, so
two meshes of one shape train alike whatever their grids. Where JAX
reads its device count (`dp=-1`, `allow_partial`), the port takes an
explicit `world_size`, the number of logical ranks on offer: the CPU
tests pass 8, as conftest gives JAX 8 virtual devices; under
`parallel.launch` with `--devices_per_proc k` it defaults to k times
the number of processes.

Several processes (`env.init_parallel_env` over gloo) share the ranks
of one mesh: with P processes, process p drives the ranks [p W / P,
(p + 1) W / P) of W (`Mesh.local_ranks`), each on its own copy of the
mesh's device.

`P` is the port's own PartitionSpec: a tuple of an axis name, a tuple
of names or None per dim.
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Dict, List, Optional, Tuple

from ..core import DeviceLike, resolve_device

__all__ = ["init_mesh", "get_mesh", "set_mesh", "mesh_shape", "Mesh",
           "HybridCommunicateGroup", "data_axes", "P"]

# outermost -> innermost, as the JAX package orders them
_AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


class P(tuple):
    """PartitionSpec: one entry per dim (None, an axis name, or a tuple
    of names), compared as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


class Mesh:
    """Logical ranks over the named axes, all on `device`. `shape` is
    {axis: size}; `axis_names` the fixed order; `devices` the grid of
    rank ids (JAX's `Mesh.devices` holds devices there): `grid`, an
    integer array of the axes' sizes holding each rank once (default:
    row-major). The processes that share the ranks are read from
    `env` when the mesh is made."""

    axis_names = _AXIS_ORDER

    def __init__(self, shape: Dict[str, int], device: DeviceLike = None,
                 grid=None):
        import numpy as np
        from . import env
        self.shape = {a: int(shape.get(a, 1)) for a in _AXIS_ORDER}
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axis sizes must be >= 1, got "
                             f"{self.shape}")
        self.device = resolve_device(device)
        dims = tuple(self.shape[a] for a in _AXIS_ORDER)
        if grid is None:
            grid = np.arange(self.size).reshape(dims)
        grid = np.asarray(grid, dtype=np.int64)
        if grid.shape != dims or sorted(grid.ravel().tolist()) != \
                list(range(self.size)):
            raise ValueError(f"a rank grid of shape {dims} holds each of "
                             f"the ranks 0..{self.size - 1} once, got "
                             f"{grid.tolist()}")
        self._grid = grid
        self.processes = env.get_world_size()
        self.process = env.get_rank()
        if self.size % self.processes:
            raise ValueError(f"{self.size} ranks do not split over "
                             f"{self.processes} processes")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def devices(self):
        """The rank grid: rank ids as an array of the axes' sizes."""
        return self._grid.copy()

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank `rank`'s coordinates in the grid."""
        import numpy as np
        at = np.argwhere(self._grid == rank)
        if len(at) != 1:
            raise ValueError(f"no rank {rank} in a mesh of {self.size}")
        return {a: int(i) for a, i in zip(_AXIS_ORDER, at[0])}

    def rank_at(self, coords: Dict[str, int]) -> int:
        """The rank at `coords` (axes left out are at 0)."""
        return int(self._grid[tuple(coords.get(a, 0)
                                    for a in _AXIS_ORDER)])

    @property
    def spans_processes(self) -> bool:
        return self.processes > 1

    def local_ranks(self) -> range:
        """The ranks this process drives: the p-th of P equal blocks."""
        per = self.size // self.processes
        return range(self.process * per, (self.process + 1) * per)

    def ranks_over(self, axes) -> List[Dict[str, int]]:
        """The coordinates over `axes` (the others at 0), row-major."""
        axes = [a for a in _AXIS_ORDER if a in axes]
        return [dict(zip(axes, c)) for c in itertools.product(
            *(range(self.shape[a]) for a in axes))]

    def __eq__(self, other):
        return isinstance(other, Mesh) and other.shape == self.shape \
            and other.device == self.device \
            and (other._grid == self._grid).all()

    def __hash__(self):
        return hash((tuple(self.shape.items()), str(self.device),
                     self._grid.tobytes()))

    def __repr__(self):
        sizes = ", ".join(f"{a}={v}" for a, v in self.shape.items()
                          if v > 1) or "1 rank"
        return f"Mesh({sizes}, device={self.device})"


_state = threading.local()


def set_mesh(mesh: Optional[Mesh]):
    _state.mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def init_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, pp: int = 1,
              sp: int = 1, ep: int = 1, world_size: Optional[int] = None,
              allow_partial: bool = True, device: DeviceLike = None
              ) -> Mesh:
    """The hybrid mesh (`paddle_tpu/parallel/mesh.py:40`); it becomes
    the current one (`get_mesh`). Axes of size 1 are kept. One axis may
    be -1: it takes the ranks of `world_size` the others leave. With
    `world_size` given, a smaller mesh is allowed when `allow_partial`
    (JAX then uses the first devices), a larger one never. Under
    `parallel.launch --devices_per_proc k` (PTPU_RANKS_PER_PROC),
    `world_size` defaults to k times the number of processes."""
    if world_size is None:
        from . import env
        world_size = env.default_world_size()
    sizes = {"pp": pp, "dp": dp, "fsdp": fsdp, "ep": ep, "sp": sp,
             "tp": tp}
    known, wild = 1, None
    for k, v in sizes.items():
        if v == -1:
            if wild is not None:
                raise ValueError("only one axis may be -1")
            wild = k
        elif v < 1:
            raise ValueError(f"{k}={v}: a mesh axis is >= 1 or -1")
        else:
            known *= v
    if wild is not None:
        if world_size is None:
            raise ValueError(f"{wild}=-1 takes the ranks the other axes "
                             f"leave: pass world_size (the number of "
                             f"logical ranks)")
        if world_size % known:
            raise ValueError(f"{world_size} ranks not divisible by {known}")
        sizes[wild] = world_size // known
        known *= sizes[wild]
    if world_size is not None and known != world_size:
        if not allow_partial or known > world_size:
            raise ValueError(f"mesh size {known} != world size "
                             f"{world_size}")
    mesh = Mesh(sizes, device)
    set_mesh(mesh)
    return mesh


def mesh_shape(mesh: Optional[Mesh] = None) -> Dict[str, int]:
    mesh = mesh or get_mesh()
    return dict(mesh.shape)


def data_axes(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    """Axes the global batch is split over (dp and fsdp: the ZeRO axis
    doubles as a batch axis, as in FSDP)."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return ()
    ms = mesh.shape
    return tuple(a for a in ("dp", "fsdp") if ms.get(a, 1) > 1) or ("dp",)


class HybridCommunicateGroup:
    """The reference's accessor battery over the mesh
    (`paddle_tpu/parallel/mesh.py:99`)."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh or get_mesh()
        if self.mesh is None:
            raise RuntimeError("call parallel.init_mesh(...) first")
        self._shape = mesh_shape(self.mesh)

    def _size(self, axis):
        return self._shape.get(axis, 1)

    def get_data_parallel_world_size(self):
        return self._size("dp") * self._size("fsdp")

    def get_model_parallel_world_size(self):
        return self._size("tp")

    def get_pipe_parallel_world_size(self):
        return self._size("pp")

    def get_sharding_parallel_world_size(self):
        return self._size("fsdp")

    def get_sequence_parallel_world_size(self):
        return self._size("sp")

    def get_expert_parallel_world_size(self):
        return self._size("ep")

    def topology(self):
        return dict(self._shape)

    def nranks(self):
        return math.prod(self._shape.values())
