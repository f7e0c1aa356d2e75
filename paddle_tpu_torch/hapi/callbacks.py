"""Training callbacks: `Callback`, `CallbackList`, `History`,
`ProgBarLogger`, `ModelCheckpoint`, `LRSchedulerCallback`,
`EarlyStopping` and `VisualDL`, the counterparts of
`paddle_tpu/hapi/callbacks.py`."""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRSchedulerCallback", "EarlyStopping", "History", "VisualDL"]


def _scalar_value(v):
    """A log value as a float; None when it is not scalar-like (one rule
    for EarlyStopping and VisualDL)."""
    try:
        return float(np.asarray(v).reshape(-1)[0])
    except (TypeError, ValueError, IndexError):
        return None


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


class LRSchedulerCallback(Callback):
    """Steps the optimizer's LRScheduler each epoch (`by_epoch`) and / or
    each batch (`by_step`)."""

    def __init__(self, by_step: bool = False, by_epoch: bool = True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if isinstance(lr, LRScheduler) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class EarlyStopping(Callback):
    """Sets `stop_training` once the monitored eval log has not improved
    (by more than `min_delta`, in `mode`: "auto" is "max" for a name with
    "acc" in it, else "min") for `patience` evaluations; `fit` stops
    after that epoch."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0
        self.wait = 0
        self.best = None
        self.stop_training = False
        self._warned_nonscalar = False

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        raw = logs.get(self.monitor)
        cur = _scalar_value(raw)
        if cur is None:
            if raw is not None and not self._warned_nonscalar:
                import warnings
                warnings.warn(
                    f"EarlyStopping monitor {self.monitor!r} produced a "
                    f"non-scalar value ({type(raw).__name__}); early "
                    "stopping is effectively disabled", stacklevel=2)
                self._warned_nonscalar = True
            return
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True


class VisualDL(Callback):
    """Scalar logging: each train batch's logs (every `log_freq` steps)
    as `train/<name>` and each evaluation's as `eval/<name>`, to a
    visualdl `LogWriter` when the `visualdl` package imports, else to
    `{log_dir}/scalars.jsonl`, one {"tag", "step", "value"} object per
    line (JAX's file, line for line). Non-scalar values are skipped."""

    def __init__(self, log_dir: str = "./vdl_log", log_freq: int = 1):
        super().__init__()
        self.log_dir = log_dir
        self.log_freq = max(log_freq, 1)
        os.makedirs(log_dir, exist_ok=True)
        self._step = 0
        self._eval_round = 0
        self._writer = None
        self._jsonl = None

    def _ensure_open(self):
        """Lazy (re-)open: the callback survives close (reuse across
        fit/evaluate calls) and an aborted fit leaks nothing beyond the
        currently-open handle."""
        if self._writer is not None or \
                (self._jsonl is not None and not self._jsonl.closed):
            return
        try:  # real visualdl when present
            from visualdl import LogWriter  # type: ignore
            self._writer = LogWriter(logdir=self.log_dir)
        except ImportError:
            self._jsonl = open(os.path.join(self.log_dir,
                                            "scalars.jsonl"),
                               "a", buffering=1)

    def _scalar(self, tag, value, step):
        value = _scalar_value(value)
        if value is None:
            return
        self._ensure_open()
        if self._writer is not None:
            self._writer.add_scalar(tag=tag, value=value, step=step)
        else:
            import json
            self._jsonl.write(json.dumps(
                {"tag": tag, "step": step, "value": value}) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        if self._step % self.log_freq:
            return
        for k, v in (logs or {}).items():
            self._scalar(f"train/{k}", v, self._step)

    def on_eval_end(self, logs=None):
        self._eval_round += 1
        for k, v in (logs or {}).items():
            self._scalar(f"eval/{k}", v, self._eval_round)

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        elif self._jsonl is not None:
            self._jsonl.close()  # _ensure_open reopens on reuse
