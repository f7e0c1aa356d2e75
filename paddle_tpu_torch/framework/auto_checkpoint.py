"""Auto-checkpoint: step-granular save and transparent resume, the
counterpart of `paddle_tpu/framework/auto_checkpoint.py` (the
reference's `incubate/checkpoint/auto_checkpoint.py` TrainEpochRange).

The unit of state is the Trainer's `TrainState` (parameters, buffers,
optimizer state, scaler state, seed, step), saved whole: the state
keeps whole tensors under any mesh (`Trainer.gathered_state`), so a
checkpoint restores onto whatever mesh the trainer has now (one saved
by 4 processes restores into 3). Files are `framework.io`'s pickle of
the state tree. Two backends:
- "pickle": `state.<step>.pkl` files in `directory` (the JAX package's
  layout);
- "orbax" (the default): one directory per step, `<step>/state.pkl`.
  The port has no orbax; this step-directory backend keeps its
  contract (atomic steps, `max_to_keep`, restore onto the current
  mesh), not its file format.

A save writes `<name>.tmp` and publishes it with `os.replace`, so a
process killed mid-save leaves only a `.tmp` that `latest_step` never
reads; `restore` sweeps them. The fault point `checkpoint_io` fires at
the JAX package's two sites: before the step-directory backend writes,
and between the pickle backend's complete `.tmp` and its publish.
Process 0 writes, then every process meets at a host `barrier`.

A pickle checkpoint the JAX package wrote (its Trainer's state tree)
restores too: its state goes through `models.from_jax_train_state`
(the model's names and shapes, the optimizer's slots); its `rng_key`
is ignored, since the port keys dropout by (seed, step) and no JAX key
maps onto that.

Resume contract: `restore()` returns the step to continue FROM (0
without a checkpoint); `step(i)` saves every `save_every` steps.
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

from ..testing import faults
from . import io as fio

__all__ = ["AutoCheckpoint"]


class AutoCheckpoint:
    def __init__(self, trainer, directory: str, save_every: int = 1,
                 max_to_keep: int = 3, backend: str = "orbax"):
        if backend not in ("orbax", "pickle"):
            raise ValueError(f"unknown backend {backend!r}")
        self.trainer = trainer
        self.directory = os.path.abspath(directory)
        self.save_every = save_every
        self.max_to_keep = max_to_keep
        self.backend = backend
        os.makedirs(self.directory, exist_ok=True)

    # --- where a step lives --------------------------------------------------
    def _path(self, step: int) -> str:
        if self.backend == "pickle":
            return os.path.join(self.directory, f"state.{step:012d}.pkl")
        return os.path.join(self.directory, str(step))

    def _file(self, step: int) -> str:
        p = self._path(step)
        return p if self.backend == "pickle" else \
            os.path.join(p, "state.pkl")

    def _steps(self) -> List[int]:
        steps = []
        for fn in os.listdir(self.directory):
            if self.backend == "pickle":
                if fn.startswith("state.") and fn.endswith(".pkl"):
                    steps.append(int(fn.split(".")[1]))
            elif fn.isdigit() and os.path.exists(
                    os.path.join(self.directory, fn, "state.pkl")):
                steps.append(int(fn))
        return sorted(steps)

    @staticmethod
    def _is_rank0() -> bool:
        from ..parallel import env
        return env.get_rank() == 0

    # --- public API -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self) -> int:
        """Load the newest checkpoint into the trainer (if any) and
        return its number of completed steps; process 0 first sweeps
        the `.tmp` a killed save left."""
        if self._is_rank0():
            for fn in os.listdir(self.directory):
                if fn.endswith(".tmp"):
                    p = os.path.join(self.directory, fn)
                    if os.path.isdir(p):
                        shutil.rmtree(p, ignore_errors=True)
                    else:
                        try:
                            os.remove(p)
                        except OSError:
                            pass
        last = self.latest_step()
        if last is None:
            if self.trainer.state is None:
                self.trainer.init_state()
            return 0
        tree = fio.load(self._file(last))
        self.trainer.load_state(self._state(tree))
        return last

    def _state(self, tree):
        from .trainer import TrainState
        if isinstance(tree.get("rng_key"), torch.Tensor):
            # the JAX package's state tree (its rng_key is a key array)
            from ..models.weights import from_jax_train_state
            return from_jax_train_state(tree, model=self.trainer.model,
                                        optimizer=self.trainer.optimizer)
        return TrainState.from_tree(tree)

    def step(self, completed_steps: int):
        """Call after each optimizer step with the number of completed
        steps; saves every `save_every`."""
        if completed_steps % self.save_every:
            return
        self.save(completed_steps)

    def save(self, completed_steps: int):
        from ..parallel.collective import barrier
        if self.backend == "orbax":
            faults.fire("checkpoint_io")
        if self._is_rank0():
            tree = self.trainer.gathered_state().tree()
            final = self._path(completed_steps)
            tmp = final + ".tmp"
            if self.backend == "pickle":
                fio.save(tree, tmp)
                # the torn-write window: a fault fired here is a kill
                # between the full tmp write and the atomic publish
                faults.fire("checkpoint_io")
                os.replace(tmp, final)
            else:
                shutil.rmtree(tmp, ignore_errors=True)
                fio.save(tree, os.path.join(tmp, "state.pkl"))
                shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)
            for s in self._steps()[:-self.max_to_keep]:
                p = self._path(s)
                if os.path.isdir(p):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
        barrier()

    def wait(self):
        """Saves are synchronous: nothing to wait for."""
