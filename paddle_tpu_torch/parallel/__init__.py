"""paddle_tpu_torch.parallel: data-parallel and ZeRO training over a mesh
of logical ranks on one device, the counterpart of the single-process
core of `paddle_tpu/parallel/`.

A mesh (`mesh.py`) is k logical ranks that one process drives on one
device (ROADMAP Queue 1 item 13.4); collectives (`collective.py`) join
the ranks' tensors in rank order, in one call over their list or as a
rendezvous inside an SPMD run (`nn/ranks.py`). `Trainer(mesh=)` trains
over its dp and fsdp ranks at ZeRO stages 0-3 (`sharding.py`), with
batch norm synced over the data ranks; `fleet` builds mesh, model and
Trainer from a `DistributedStrategy`. Not ported yet (ROADMAP item
13.4, steps 4-6): `tp_layers`, `pipeline`, `moe`, `sequence`,
`compression`, `localsgd`, `elastic`, `launch`, `multislice`, `auto`.
It brings no speed or memory gain on one card: it gives the JAX
package's 8-virtual-device results, each rank's partition as tensors
of its own, and the structure collectives across cards (item 18) will
run under.
"""
from . import collective  # noqa: F401
from . import env  # noqa: F401
from . import fleet  # noqa: F401
from . import mesh as mesh_mod  # noqa: F401
from . import random_  # noqa: F401
from . import sharding  # noqa: F401
from .collective import (ReduceOp, all_gather, all_reduce, all_to_all,  # noqa: F401
                         barrier, broadcast, get_group, new_group, ppermute,
                         reduce_scatter, send_recv, spmd, wait)
from .data_parallel import DataParallel  # noqa: F401
from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env)
from .mesh import (HybridCommunicateGroup, Mesh, P, get_mesh,  # noqa: F401
                   init_mesh, set_mesh)
from .random_ import get_rng_state_tracker  # noqa: F401
from .sharding import apply_fsdp, shard_model  # noqa: F401
from .strategy import DistributedStrategy  # noqa: F401
