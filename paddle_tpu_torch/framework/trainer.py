"""Trainer: the training step of the PyTorch/CUDA port.

The counterpart of `paddle_tpu/framework/trainer.py`. The JAX Trainer
traces forward, backward and the optimizer update into one XLA program;
here the same step runs eagerly: `torch.func.functional_call` of the
model over the state's parameter dict, `torch.autograd.grad` for the
gradients, and the optimizer's in-place update. The state keeps the JAX
layout (`TrainState`: params, buffers, opt_state, scaler_state, rng_key,
step), so a JAX state can be resumed here (`models.weights.
from_jax_train_state` + `Trainer.load_state`).

AMP O2 is the JAX policy: every floating parameter except the norm
layers' is cast to `amp_dtype` and gets an fp32 master in the
optimizer; norm parameters stay fp32 with no master and are cast to the
activation dtype inside `nn.functional.layer_norm`.

Not ported yet (each raises `NotImplementedError`, ROADMAP Queue 1 after
item 6): `mesh`, `remat`, `scaler` (GradScaler), `amp_level="O1"` and
`check_nan_inf`. `loop_unroll` is an XLA scheduling hint with no eager
meaning: only 1 is accepted. There is no `donate`: the step always
updates the state's tensors in place.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from .. import core
from ..nn.layers import LayerNorm

__all__ = ["TrainState", "Trainer"]

_NORM_TYPES = (LayerNorm,)


def _not_ported(what: str):
    return NotImplementedError(
        f"Trainer {what} is not ported yet (ROADMAP Queue 1, after item 6)")


class TrainState:
    """Everything a step mutates: {name: tensor} params and buffers, the
    optimizer state, the (empty) scaler state, the seed and the step."""

    def __init__(self, params, buffers, opt_state, scaler_state, rng_key,
                 step):
        self.params = params
        self.buffers = buffers
        self.opt_state = opt_state
        self.scaler_state = scaler_state
        self.rng_key = rng_key
        self.step = step

    def tree(self):
        return {"params": self.params, "buffers": self.buffers,
                "opt_state": self.opt_state,
                "scaler_state": self.scaler_state, "rng_key": self.rng_key,
                "step": self.step}

    @classmethod
    def from_tree(cls, t):
        return cls(t["params"], t["buffers"], t["opt_state"],
                   t["scaler_state"], t["rng_key"], t["step"])


class Trainer:
    """Train and eval steps for (model, optimizer).

    `loss_fn(model_outputs, *labels)` gives the scalar loss. A batch is
    (inputs..., labels...) with `num_inputs` leading inputs (default 1).
    With `grad_accum = k` the batch is cut into k microbatches along
    dim 0 and the update uses the mean of their gradients.
    """

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable,
                 num_inputs: int = 1, amp_level: Optional[str] = None,
                 amp_dtype="bfloat16", scaler=None, mesh=None,
                 remat: bool = False, loop_unroll: int = 1,
                 grad_accum: int = 1, check_nan_inf: bool = False):
        if mesh is not None:
            raise _not_ported("mesh (sharded training)")
        if remat:
            raise _not_ported("remat (activation checkpointing)")
        if scaler is not None:
            raise _not_ported("scaler (GradScaler)")
        if amp_level not in (None, "O2"):
            raise _not_ported(f"amp_level={amp_level!r}")
        if check_nan_inf:
            raise _not_ported("check_nan_inf")
        if loop_unroll != 1:
            raise ValueError(f"loop_unroll={loop_unroll}: an XLA scan hint "
                             f"with no eager meaning; only 1 is accepted")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.num_inputs = num_inputs
        self.amp_level = amp_level
        self.amp_dtype = core.resolve_dtype(amp_dtype)
        self.grad_accum = grad_accum
        self.state: Optional[TrainState] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # --- state management ----------------------------------------------------
    def init_state(self, rng_seed: int = 0) -> TrainState:
        params = {k: p.detach().clone()
                  for k, p in self.model.named_parameters()
                  if p.requires_grad}
        if self.amp_level == "O2":
            self.optimizer.multi_precision = True
            keep = self._norm_param_names()
            params = {k: (v if k in keep
                          else core.cast_floating(v, self.amp_dtype))
                      for k, v in params.items()}
        for v in params.values():
            v.requires_grad_(v.is_floating_point())
        buffers = {k: b.detach().clone()
                   for k, b in self.model.named_buffers()}
        opt_state = self.optimizer.init(params)
        self.state = TrainState(params, buffers, opt_state, {},
                                int(rng_seed), 0)
        return self.state

    def load_state(self, state: TrainState) -> TrainState:
        """Adopt `state` (e.g. `from_jax_train_state` of a JAX run):
        its tensors move to the model's device; the parameters become
        the leaves the next step differentiates."""
        dev = self.device

        def to_dev(t):
            if isinstance(t, torch.Tensor):
                return t.to(dev)
            if isinstance(t, dict):
                return {k: to_dev(v) for k, v in t.items()}
            return t

        if self.amp_level == "O2":
            self.optimizer.multi_precision = True
        params = {k: v.detach().to(dev).requires_grad_(v.is_floating_point())
                  for k, v in state.params.items()}
        self.state = TrainState(params, to_dev(state.buffers),
                                to_dev(state.opt_state),
                                to_dev(state.scaler_state), state.rng_key,
                                int(state.step))
        return self.state

    def _norm_param_names(self):
        names = set()
        for path, sub in self.model.named_modules():
            if isinstance(sub, _NORM_TYPES):
                for pname, p in sub.named_parameters(recurse=False):
                    names.add(f"{path}.{pname}" if path else pname)
        return names

    # --- the step ------------------------------------------------------------
    def _forward(self, params, buffers, batch, training: bool):
        inputs = batch[: self.num_inputs]
        labels = batch[self.num_inputs:]
        if self.amp_level == "O2":
            inputs = core.cast_floating(inputs, self.amp_dtype)
        self.model.train(training)
        out = torch.func.functional_call(self.model, {**params, **buffers},
                                         tuple(inputs))
        loss = self.loss_fn(out, *labels)
        return loss, out

    def _loss_and_grads(self, st: TrainState, batch):
        """(loss, out, grads): whole batch, or the mean over
        `grad_accum` microbatches (out is None then, as in JAX)."""
        names = [k for k, v in st.params.items() if v.requires_grad]
        leaves = [st.params[k] for k in names]

        def grad_of(b):
            loss, out = self._forward(st.params, st.buffers, b,
                                      training=True)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), out, {
                k: g for k, g in zip(names, grads) if g is not None}

        if self.grad_accum == 1:
            loss, out, grads = grad_of(batch)
            return loss, out.detach(), grads

        k = self.grad_accum
        for b in batch:
            if b.shape[0] % k:
                raise ValueError(f"batch dim {b.shape[0]} not divisible by "
                                 f"grad_accum={k}")
        micro = [b.chunk(k, dim=0) for b in batch]
        gsum, lsum = None, None
        for i in range(k):
            loss, _, grads = grad_of(tuple(m[i] for m in micro))
            if gsum is None:
                gsum, lsum = grads, loss.float()
            else:
                for n, g in grads.items():
                    gsum[n].add_(g)
                lsum = lsum + loss
        inv_k = 1.0 / k
        grads = {n: g.mul_(inv_k) for n, g in gsum.items()}
        return lsum * inv_k, None, grads

    def _step_body(self, st: TrainState, batch):
        """One optimizer step: forward, backward and the update."""
        loss, out, grads = self._loss_and_grads(st, batch)
        params, opt_state = self.optimizer.update(grads, st.opt_state,
                                                  st.params)
        new_state = TrainState(params, st.buffers, opt_state,
                               st.scaler_state, st.rng_key, st.step + 1)
        return new_state, loss, out

    def _batch(self, batch):
        dev = self.device
        return tuple(torch.as_tensor(b).to(dev) for b in batch)

    # --- public API ----------------------------------------------------------
    def train_step(self, *batch) -> Tuple[torch.Tensor, Any]:
        """One step; returns (loss, model outputs) as device tensors."""
        if self.state is None:
            self.init_state()
        self.state, loss, out = self._step_body(self.state,
                                                self._batch(batch))
        return loss, out

    def train_steps(self, *batch, steps: int, stacked: bool = False):
        """`steps` optimizer steps in a Python loop. With stacked=False
        the same batch is used every step; with stacked=True each input
        has a leading `steps` axis, one slice per step. Returns
        (last_loss, losses[steps]) without a host sync."""
        if self.state is None:
            self.init_state()
        batch = self._batch(batch)
        losses = []
        for i in range(steps):
            b = tuple(x[i] for x in batch) if stacked else batch
            self.state, loss, _ = self._step_body(self.state, b)
            losses.append(loss)
        losses = torch.stack(losses)
        return losses[-1], losses

    @torch.no_grad()
    def eval_step(self, *batch):
        """(loss, outputs) in eval mode, no gradients, no update."""
        if self.state is None:
            self.init_state()
        return self._forward(self.state.params, self.state.buffers,
                             self._batch(batch), training=False)

    @torch.no_grad()
    def sync_model(self) -> nn.Module:
        """Write the trained parameters and buffers back into the model.
        As in JAX, a master weight is first cast to its parameter's
        dtype."""
        if self.state is None:
            return self.model
        params = dict(self.state.params)
        for k, s in self.state.opt_state["slots"].items():
            if "master_weight" in s:
                params[k] = s["master_weight"].to(params[k].dtype)
        for k, p in self.model.named_parameters():
            if k in params:
                p.copy_(params[k])
        for k, b in self.model.named_buffers():
            if k in self.state.buffers:
                b.copy_(self.state.buffers[k])
        return self.model
