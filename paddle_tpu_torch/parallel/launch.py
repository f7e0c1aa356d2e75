"""The process launcher: the counterpart of `paddle_tpu/parallel/launch.py`
(the reference's `python/paddle/distributed/launch`: main.py, the
collective controller, the PADDLE_TRAINER_* variables).

Every worker is a fresh interpreter (`subprocess`, never a fork of a
process that may have started CUDA) with the variables
`env.init_parallel_env` reads: PTPU_COORDINATOR (host:port of the gloo
store, served by process 0), PTPU_NUM_PROCESSES and PTPU_PROCESS_ID.
JAX's `--devices_per_proc` (virtual XLA devices per process) is here
the number of logical ranks each process drives (PTPU_RANKS_PER_PROC,
so `init_mesh` defaults `world_size` to it times the processes). The
workers share this host's card: each drives its ranks on it.

Usage:
    python -m paddle_tpu_torch.parallel.launch --nproc_per_node 2 \\
        --devices_per_proc 2 train.py --epochs 10
    python -m paddle_tpu_torch.parallel.launch --nnodes 2 --node_rank 0 \\
        --master 10.0.0.1:8476 train.py
    python -m paddle_tpu_torch.parallel.launch --elastic \\
        --nproc_per_node 2 --heartbeat_dir /tmp/hb train.py
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["main", "launch_local", "build_worker_env", "free_port"]


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port nothing listens on now (bound once to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _parse(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.parallel.launch")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PTPU_NNODES", "1")))
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PTPU_NODE_RANK", "0")))
    p.add_argument("--master", type=str,
                   default=os.environ.get("PTPU_COORDINATOR", ""))
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="N worker processes on this host")
    p.add_argument("--devices_per_proc", type=int, default=0,
                   help="logical ranks each worker drives")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before every worker is killed")
    p.add_argument("--elastic", action="store_true",
                   help="supervise the gang: detect failures (exit codes + "
                        "heartbeats) and relaunch with rewritten endpoints")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--heartbeat_dir", type=str, default=None)
    p.add_argument("--heartbeat_timeout", type=float, default=60.0)
    p.add_argument("script", type=str)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def build_worker_env(rank: int, nproc: int, master: str,
                     devices_per_proc: int = 0, extra: dict = None) -> dict:
    """The one place a worker's variables are set (the rendezvous and
    the logical ranks per process): `launch_local` and the elastic
    controller both spawn through it."""
    env = dict(os.environ)
    env["PTPU_COORDINATOR"] = master
    env["PTPU_NUM_PROCESSES"] = str(nproc)
    env["PTPU_PROCESS_ID"] = str(rank)
    if devices_per_proc:
        env["PTPU_RANKS_PER_PROC"] = str(devices_per_proc)
    if extra:
        env.update(extra)
    return env


def _spawn(cmd: List[str], env: dict, log_path):
    stdout = open(log_path, "w") if log_path else None
    try:
        return subprocess.Popen(cmd, env=env, stdout=stdout,
                                stderr=subprocess.STDOUT if stdout else None)
    finally:
        if stdout is not None:
            stdout.close()          # the child holds its own copy


def stop_all(procs: List[subprocess.Popen], grace: float = 10.0):
    """Terminate the live processes, kill those still there after
    `grace` seconds, and reap every one."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_local(script: str, script_args: List[str], nproc: int,
                 master: Optional[str] = None, devices_per_proc: int = 0,
                 log_dir=None, timeout: Optional[float] = None) -> int:
    """N local worker processes rendezvousing at `master` (default: a
    free port on 127.0.0.1). Returns the OR of their exit codes. When a
    worker fails the others are stopped (a peer left waiting in a
    collective would otherwise sit out its group's timeout); past
    `timeout` seconds every worker is killed and 124 returned."""
    master = master or f"127.0.0.1:{free_port()}"
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    procs = []
    for rank in range(nproc):
        env = build_worker_env(rank, nproc, master, devices_per_proc)
        log = os.path.join(log_dir, f"worker.{rank}.log") if log_dir \
            else None
        procs.append(_spawn([sys.executable, script] + list(script_args),
                            env, log))
    deadline = None if timeout is None else time.time() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                rc = 0
                for c in codes:
                    rc |= c
                return rc
            if any(c not in (None, 0) for c in codes):
                stop_all(procs)
                rc = 0
                for p in procs:
                    rc |= p.returncode if p.returncode > 0 else 1
                return rc
            if deadline is not None and time.time() > deadline:
                stop_all(procs, grace=2.0)
                return 124
            time.sleep(0.05)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        stop_all(procs)
        return 130


def main(argv=None):
    args = _parse(argv)
    if args.elastic:
        from .elastic import ElasticController
        ctrl = ElasticController(
            args.script, args.script_args, nproc=max(args.nproc_per_node, 1),
            master=args.master or f"127.0.0.1:{free_port()}",
            devices_per_proc=args.devices_per_proc, log_dir=args.log_dir,
            max_restarts=args.max_restarts,
            heartbeat_dir=args.heartbeat_dir,
            heartbeat_timeout=args.heartbeat_timeout, timeout=args.timeout)
        sys.exit(ctrl.run())
    if args.nproc_per_node > 1:
        sys.exit(launch_local(args.script, args.script_args,
                              args.nproc_per_node, master=args.master or None,
                              devices_per_proc=args.devices_per_proc,
                              log_dir=args.log_dir, timeout=args.timeout))
    # one process per host: exec in place with the variables set
    env = dict(os.environ)
    if args.nnodes > 1:
        if not args.master:
            sys.exit("--master host:port required for multi-node launch")
        env["PTPU_COORDINATOR"] = args.master
        env["PTPU_NUM_PROCESSES"] = str(args.nnodes)
        env["PTPU_PROCESS_ID"] = str(args.node_rank)
    if args.devices_per_proc:
        env["PTPU_RANKS_PER_PROC"] = str(args.devices_per_proc)
    os.execve(sys.executable,
              [sys.executable, args.script] + args.script_args, env)


if __name__ == "__main__":
    main()
