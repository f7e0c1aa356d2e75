"""paddle_tpu_torch.parallel: training over a mesh of logical ranks on
one device, the counterpart of the single-process core of
`paddle_tpu/parallel/`.

A mesh (`mesh.py`) is k logical ranks that one process drives on one
device (ROADMAP Queue 1 item 13.4); collectives (`collective.py`) join
the ranks' tensors in rank order, in one call over their list or as a
rendezvous inside an SPMD run (`nn/ranks.py`). `Trainer(mesh=)` trains
over every axis: dp and fsdp at ZeRO stages 0-3 (`sharding.py`, batch
norm synced over the data ranks), tp (`tp_layers.py`: column, row and
vocabulary-parallel layers; GPT's and BERT's specs), sp
(`sequence.py`: ring and Ulysses attention on the flash kernels),
ep (`moe.py`: expert-parallel MoE) and pp (`pipeline.py`: the tick
schedule of `PipelineStack`); `fleet` builds mesh, model and Trainer
from a `DistributedStrategy`. Not ported yet (ROADMAP item 13.4,
step 6, the multi-process part): `compression`, `localsgd`,
`elastic`, `launch`, `multislice`, `auto`. It brings no speed or
memory gain on one card: it gives the JAX package's 8-virtual-device
results, each rank's shard as tensors of its own, and the structure
collectives across cards (item 18) will run under.
"""
from . import collective  # noqa: F401
from . import env  # noqa: F401
from . import fleet  # noqa: F401
from . import mesh as mesh_mod  # noqa: F401
from . import moe  # noqa: F401
from . import pipeline  # noqa: F401
from . import random_  # noqa: F401
from . import sequence  # noqa: F401
from . import sharding  # noqa: F401
from . import tp_layers  # noqa: F401
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
from .tp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                        RowParallelLinear, VocabParallelEmbedding)
