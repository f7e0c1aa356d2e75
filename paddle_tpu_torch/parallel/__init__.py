"""paddle_tpu_torch.parallel: training over a mesh of logical ranks on
one device, the counterpart of `paddle_tpu/parallel/`: every one of its
19 files has its counterpart here.

A mesh (`mesh.py`) is k logical ranks on one device (ROADMAP Queue 1
item 13.4); collectives (`collective.py`) join the ranks' tensors in
rank order, in one call over their list or as a rendezvous inside an
SPMD run (`nn/ranks.py`). `Trainer(mesh=)` trains over every axis: dp
and fsdp at ZeRO stages 0-3 (`sharding.py`, batch norm synced over the
data ranks), tp (`tp_layers.py`: column, row and vocabulary-parallel
layers; GPT's and BERT's specs), sp (`sequence.py`: ring and Ulysses
attention on the flash kernels), ep (`moe.py`: expert-parallel MoE)
and pp (`pipeline.py`: the tick schedule of `PipelineStack`); `fleet`
builds mesh, model and Trainer from a `DistributedStrategy`.
`compression` (int8 error-feedback reduction, `strategy.dgc`) and
`localsgd` (k local steps, then one mean) are explicit exchanges over
a data axis; `multislice` composes a mesh's rank grid from slices;
`auto` plans a mesh with a cost model and trains it (`Engine`).

Several processes share the ranks of one mesh: `launch` starts them,
`env.init_parallel_env` joins them in a gloo group, the host plane
(`collective.barrier`, `host_*`, `fleet.metrics`) and the Trainer's
data-parallel exchange cross it, and `elastic` relaunches a gang that
lost a member, which resumes from `framework.AutoCheckpoint`. Across
processes only data axes at ZeRO stages 0-1 run; the rest is ROADMAP
item 18. None of it brings a speed or memory gain on one card: it
gives the JAX package's results, each rank's shard as tensors of its
own, and the structure collectives across cards (item 18) will run
under.
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
from . import auto  # noqa: F401
from . import compression  # noqa: F401
from . import elastic  # noqa: F401
from . import launch  # noqa: F401
from . import localsgd  # noqa: F401
from . import multislice  # noqa: F401
from .compression import (compressed_grad_step, compressed_grads,  # noqa: F401
                          compressed_psum_mean, zero_residuals)
from .elastic import ElasticController, Heartbeat  # noqa: F401
from .localsgd import LocalSGD, local_train_steps  # noqa: F401
from .multislice import init_multislice_mesh  # noqa: F401
