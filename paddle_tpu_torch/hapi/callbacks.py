"""Training callbacks: `Callback`, `CallbackList`, `History`,
`ProgBarLogger` and `ModelCheckpoint`, the counterparts of
`paddle_tpu/hapi/callbacks.py` (`EarlyStopping`, `LRSchedulerCallback`
and `VisualDL` are not ported yet)."""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "History", "ProgBarLogger",
           "ModelCheckpoint"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    """Calls each `on_*` hook on every callback, in order."""

    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for cb in self.callbacks:
                    getattr(cb, name)(*args, **kwargs)
            return dispatch
        raise AttributeError(name)


class History(Callback):
    """{log name: [value at the end of each epoch]}."""

    def __init__(self):
        super().__init__()
        self.history = {}

    def on_train_begin(self, logs=None):
        self.history = {}

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class ProgBarLogger(Callback):
    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    @staticmethod
    def _fmt(logs):
        return " - ".join(f"{k}: {np.asarray(v).item():.4f}"
                          if isinstance(v, (int, float, np.number))
                          else f"{k}: {v}" for k, v in (logs or {}).items())

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            ips = ""
            dt = time.time() - self._t0
            if dt > 0 and "batch_size" in self.params:
                ips = (f" - {(step + 1) * self.params['batch_size'] / dt:.1f}"
                       f" samples/sec")
            total = f"/{self.steps}" if self.steps else ""
            print(f"step {step + 1}{total} - {self._fmt(logs)}{ips}",
                  file=sys.stdout)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """`Model.save` to `save_dir/<epoch>` every `save_freq` epochs and to
    `save_dir/final` at the end (state-dict files of `framework.io`)."""

    def __init__(self, save_freq: int = 1, save_dir: str = "checkpoint"):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))
