"""The high-level `Model`: the counterpart of `paddle_tpu/hapi/model.py`
over the port's `Trainer` (`prepare`, `fit`, `evaluate`, `predict`,
`train_batch`, `eval_batch`, `predict_batch`, `save`, `load`,
`summary`); `InputSpec` is `static.InputSpec`, re-exported as in JAX.

The network runs where its parameters are (a port model is built on
the card unless it is given `device="cpu"`); numpy batches go there
through the Trainer, a `DataLoader(to_device=...)`'s are there already.
`fit` times images per second with `profiler.Benchmark` (each step ends
in a host read of the loss, so the host clock sees the device's time)
and reports them as `ips` in the step logs. `save` writes the network's
state dict (parameters and buffers) and the optimizer's tensors as
`framework.io` state-dict files (`.pdparams` / `.pdopt`), which the JAX
package's `load` reads too.
"""
from __future__ import annotations

import os
import warnings
from typing import List, Optional

import numpy as np
import torch

from ..framework import io as fio
from ..framework.trainer import Trainer
from ..io import DataLoader, Dataset
from ..metric import Metric
from ..profiler import Benchmark, benchmark
from ..static import InputSpec
from .callbacks import CallbackList, History, ModelCheckpoint, ProgBarLogger

__all__ = ["Model", "InputSpec"]


class Model:
    """`paddle.Model` over the port's Trainer."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._trainer: Optional[Trainer] = None
        self.stop_training = False

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    # --- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """`amp_configs`: "O1" / "O2", or {"level", "dtype", "scaler"}."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = list(metrics) \
                if isinstance(metrics, (list, tuple)) else [metrics]
        amp_level, amp_dtype, scaler = None, "bfloat16", None
        if amp_configs:
            if isinstance(amp_configs, str):
                amp_level = amp_configs
            else:
                amp_level = amp_configs.get("level", "O1")
                amp_dtype = amp_configs.get("dtype", "bfloat16")
                scaler = amp_configs.get("scaler")

        def loss_fn(outputs, *labels):
            if self._loss is None:
                return outputs.mean()
            out = self._loss(outputs, *labels)
            return out if out.dim() == 0 else out.mean()

        n_in = len(self._inputs) if self._inputs else 1
        self._trainer = Trainer(self.network, optimizer, loss_fn,
                                num_inputs=n_in, amp_level=amp_level,
                                amp_dtype=amp_dtype, scaler=scaler)
        return self

    # --- single-step APIs ----------------------------------------------------
    @staticmethod
    def _as_list(v):
        if v is None:
            return []
        return list(v) if isinstance(v, (list, tuple)) else [v]

    def train_batch(self, inputs, labels=None):
        """[loss, metric values...] after one optimizer step."""
        inputs, labels = self._as_list(inputs), self._as_list(labels)
        loss, out = self._trainer.train_step(*inputs, *labels)
        return [float(loss)] + self._update_metrics(out, labels)

    def eval_batch(self, inputs, labels=None):
        inputs, labels = self._as_list(inputs), self._as_list(labels)
        loss, out = self._trainer.eval_step(*inputs, *labels)
        return [float(loss)] + self._update_metrics(out, labels)

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The network's outputs (numpy, fp32 for a bf16 output) in eval
        mode, from the trained state when there is one."""
        dev = self.device
        inputs = [torch.as_tensor(i).to(dev) for i in self._as_list(inputs)]
        self.network.eval()
        if self._trainer is None or self._trainer.state is None:
            out = self.network(*inputs)
        else:
            st = self._trainer.state
            if self._trainer.amp_level == "O2":
                inputs = [i.to(self._trainer.amp_dtype)
                          if i.is_floating_point() else i for i in inputs]
            out = torch.func.functional_call(
                self.network, {**st.params, **st.buffers}, tuple(inputs))
        if out.is_floating_point():
            out = out.float()
        return out.cpu().numpy()

    def _update_metrics(self, out, labels):
        if out is None:   # a grad-accum step has no whole-batch forward
            return [m.accumulate() for m in self._metrics]
        vals = []
        for m in self._metrics:
            r = m.compute(out, *labels)
            m.update(r[0] if isinstance(r, tuple) else r)
            vals.append(m.accumulate())
        return vals

    # --- loops ---------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train for `epochs` (or `num_iters` steps); a Dataset is wrapped
        in a DataLoader. Returns the History ({log name: per-epoch
        values})."""
        train_loader = DataLoader(train_data, batch_size=batch_size,
                                  shuffle=shuffle, drop_last=drop_last,
                                  num_workers=num_workers) \
            if isinstance(train_data, Dataset) else train_data
        eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                 num_workers=num_workers) \
            if isinstance(eval_data, Dataset) else eval_data
        history = History()
        cbks = CallbackList([ProgBarLogger(log_freq, verbose=verbose),
                             history] + list(callbacks or []))
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        cbks.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks.set_params({"epochs": epochs, "steps": steps,
                         "batch_size": batch_size, "verbose": verbose})
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be >= 1, got "
                             f"{accumulate_grad_batches}")
        self._trainer.grad_accum = accumulate_grad_batches
        if accumulate_grad_batches > 1 and self._metrics:
            warnings.warn(
                "metrics are not computed when accumulate_grad_batches > 1 "
                "(grad-accum steps return no whole-batch forward)",
                stacklevel=2)
        bench = benchmark()
        if bench.active:          # a nested fit keeps the shared timer
            bench = Benchmark()
        cbks.on_train_begin()
        bench.begin()
        try:
            self._fit_loop(train_loader, eval_loader, epochs, eval_freq,
                           cbks, bench, num_iters, batch_size)
        finally:
            bench.end()
        cbks.on_train_end()
        return history.history

    def _fit_loop(self, train_loader, eval_loader, epochs, eval_freq, cbks,
                  bench, num_iters, batch_size):
        it_count = 0
        for epoch in range(epochs):
            self.network.train()
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                logs = self._logs(self.train_batch(inputs, labels))
                n = np.shape(inputs[0])
                bench.step(n[0] if n else batch_size)
                rep = bench.report()
                if rep["steps"]:
                    logs["ips"] = round(rep["ips"], 2)
                cbks.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    break
            bench.pause()    # eval and saves stay out of the step times
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, verbose=0, _callbacks=cbks)
                if any(getattr(cb, "stop_training", False)
                       for cb in cbks.callbacks):
                    self.stop_training = True
            if self.stop_training or (num_iters is not None
                                      and it_count >= num_iters):
                break

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _callbacks=None):
        """{loss: mean over the batches, metric names: accumulated}."""
        loader = DataLoader(eval_data, batch_size=batch_size,
                            num_workers=num_workers) \
            if isinstance(eval_data, Dataset) else eval_data
        cbks = _callbacks or CallbackList(
            [ProgBarLogger(log_freq, verbose=verbose)]
            + list(callbacks or []))
        if _callbacks is None:
            cbks.set_model(self)
            cbks.set_params({"verbose": verbose})
        self.network.eval()
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        logs, losses = {}, []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            inputs, labels = self._split_batch(batch)
            vals = self.eval_batch(inputs, labels)
            losses.append(vals[0])
            logs = self._logs(vals)
            cbks.on_eval_batch_end(step, logs)
        logs["loss"] = float(np.mean(losses)) if losses else 0.0
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = DataLoader(test_data, batch_size=batch_size,
                            num_workers=num_workers) \
            if isinstance(test_data, Dataset) else test_data
        outs = [self.predict_batch(self._split_batch(b, predict=True)[0])
                for b in loader]
        return np.concatenate(outs, axis=0) if stack_outputs else outs

    def _split_batch(self, batch, predict=False):
        if not isinstance(batch, (list, tuple)):
            return [batch], []
        n_in = len(self._inputs) if self._inputs else 1
        return list(batch[:n_in]), [] if predict else list(batch[n_in:])

    def _logs(self, vals):
        logs = {"loss": vals[0]}
        for m, v in zip(self._metrics, vals[1:]):
            names = m.name()
            names = [names] if isinstance(names, str) else names
            for n, vv in zip(names, v if isinstance(v, (list, tuple))
                             else [v]):
                logs[n] = vv
        return logs

    # --- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        """`path.pdparams`: the network's state dict (the trained state
        written back first); with `training`, `path.pdopt`: the
        optimizer's `state_dict()` tensors."""
        if self._trainer is not None and self._trainer.state is not None:
            self._trainer.sync_model()
        fio.save({k: v.detach().cpu()
                  for k, v in self.network.state_dict().items()},
                 path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save({k: torch.as_tensor(v).detach().cpu()
                      for k, v in self._optimizer.state_dict().items()
                      if isinstance(v, (torch.Tensor, int, float))},
                     path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = fio.load(path + ".pdparams")
        self.network.load_state_dict(state, strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(fio.load(opt_path))
        if self._trainer is not None:
            self._trainer.state = None    # rebuilt from the loaded weights

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        if input_size is None and self._inputs:
            input_size = [tuple(i.shape) for i in self._inputs]
        return summary(self.network, input_size, dtypes=dtype)
