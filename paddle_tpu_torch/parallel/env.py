"""The process environment: the counterpart of
`paddle_tpu/parallel/env.py`.

One process drives every rank of a mesh, so the process world is one
process of rank 0; the ranks of a mesh are logical (`mesh.py`). There is
no counterpart of `jax.distributed` (several processes are ROADMAP
Queue 1 item 13.4's step 6): `init_parallel_env` returns the one-process
environment and refuses a world of several processes.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "get_local_device_count", "is_initialized", "ParallelEnv"]


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None) -> "ParallelEnv":
    """The one-process environment. The reference's variables
    (PTPU_NUM_PROCESSES, PADDLE_TRAINERS_NUM) naming more than one
    process raise: several processes are not ported."""
    num_processes = num_processes or int(
        os.environ.get("PTPU_NUM_PROCESSES",
                       os.environ.get("PADDLE_TRAINERS_NUM", "1")))
    if num_processes > 1:
        raise NotImplementedError(
            f"{num_processes} processes: the port drives every rank from "
            f"one process; several processes are ROADMAP Queue 1 item "
            f"13.4, step 6")
    return ParallelEnv()


def is_initialized() -> bool:
    return False


def get_rank() -> int:
    return 0


def get_world_size() -> int:
    return 1


def get_local_device_count() -> int:
    """The cards this process sees (0 on a CPU-only host)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class ParallelEnv:
    """Rank, world and device of this process."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return 0

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        return get_rank()
