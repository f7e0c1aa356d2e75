"""The process environment: the counterpart of
`paddle_tpu/parallel/env.py`.

One process drives the logical ranks of a mesh (`mesh.py`). Several
processes (`parallel.launch`, `parallel.elastic`) join a
`torch.distributed` group over **gloo**, the JAX package's
coordination service: `init_parallel_env` reads the variables the
launcher sets (PTPU_COORDINATOR or PADDLE_MASTER, PTPU_NUM_PROCESSES,
PTPU_PROCESS_ID) and, when they name more than one process, opens the
group at that address with a finite `timeout` (seconds; gloo's own
default is 30 minutes). NCCL refuses two ranks on one device, and the
processes of this port share one card (ROADMAP Queue 1 item 13.4).
`get_rank`, `get_world_size` and `is_initialized` are then the
group's; with one process they are 0, 1 and False. The group carries
the host plane (`collective.barrier`, `host_broadcast`,
`host_all_gather`) and the data-parallel exchange of a mesh whose
ranks span the processes.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "get_local_device_count", "is_initialized", "ParallelEnv",
           "DEFAULT_TIMEOUT_S"]

DEFAULT_TIMEOUT_S = 120.0


def _dist():
    import torch.distributed as dist
    return dist


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      timeout: float = DEFAULT_TIMEOUT_S
                      ) -> "ParallelEnv":
    """Join the gloo group of `num_processes` processes at
    `coordinator_address` (host:port; process 0 serves the store there)
    as process `process_id`; every argument defaults to the launcher's
    variables. One process (no variables) opens nothing. A peer that
    does not join, or a collective a peer never enters, raises after
    `timeout` seconds."""
    coordinator_address = coordinator_address or \
        os.environ.get("PTPU_COORDINATOR") or \
        os.environ.get("PADDLE_MASTER")
    num_processes = num_processes or int(
        os.environ.get("PTPU_NUM_PROCESSES",
                       os.environ.get("PADDLE_TRAINERS_NUM", "1")))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PTPU_PROCESS_ID",
                       os.environ.get("PADDLE_TRAINER_ID", "0")))
    if num_processes > 1 and not is_initialized():
        if not coordinator_address:
            raise ValueError(f"{num_processes} processes need a "
                             f"coordinator address (host:port)")
        _dist().init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout))
    return ParallelEnv()


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return _dist().get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def default_world_size() -> Optional[int]:
    """Logical ranks on offer by default: PTPU_RANKS_PER_PROC (the
    launcher's `--devices_per_proc`) times the processes, else None."""
    per = int(os.environ.get("PTPU_RANKS_PER_PROC", "0"))
    return per * get_world_size() if per > 0 else None


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
