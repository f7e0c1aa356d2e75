"""Trainer: the training step of the PyTorch/CUDA port.

The counterpart of `paddle_tpu/framework/trainer.py`. The JAX Trainer
traces forward, backward and the optimizer update into one XLA program;
here the same step runs eagerly: `torch.func.functional_call` of the
model over the state's parameter dict, `torch.autograd.grad` for the
gradients, and the optimizer's in-place update. The state keeps the JAX
layout (`TrainState`: params, buffers, opt_state, scaler_state, rng_key,
step), so a JAX state can be resumed here (`models.weights.
from_jax_train_state` + `Trainer.load_state`).

AMP is the JAX policy. O2: every floating parameter except the norm
layers' (with `keep_bn_fp32`, the default) is cast to `amp_dtype` and
gets an fp32 master in the optimizer; norm parameters (LayerNorm's and
BatchNorm's) stay fp32 with no master and are cast to the activation
dtype inside `nn.functional.layer_norm` / `batch_norm`. O1: the
parameters stay fp32 and the forward runs under `amp.auto_cast`, where
`nn.functional.linear` and the convolutions cast their operands to
`amp_dtype`.

A `scaler` (`amp.GradScaler`) scales the loss before the gradients,
unscales them, divides the reported loss by the scale and updates its
state; a step whose unscaled gradients hold a NaN or an inf is
rejected: parameters, slots, masters and the optimizer's step stay as
they were (JAX restores them with `where`; the update here is in place,
so a rejected step never runs it). Deciding that reads `found_inf` on
the host: one host sync per step with a scaler. The flag
`check_nan_inf` (`core.set_flags`) checks the loss and every gradient
after the backward and raises `FloatingPointError` naming the first 8
offenders, also one host sync per step; under a scaler it checks the
unscaled gradients and keeps quiet on a step the scaler rejects.

Buffers: what a training forward changes in them (BatchNorm's running
statistics) is written back as in JAX, where `functional_call` returns
the updates and the step merges them (`new_buffers = {**st.buffers,
**buf_updates}`): once per optimizer step, from the primal forward;
threaded through the `grad_accum` microbatches (microbatch i
normalises with the statistics microbatch i-1 left); written even on a
step the GradScaler rejects (JAX's merge is unconditional); never by
`eval_step`; each in its own dtype (fp32 under O2). The forward does
not write them itself: the Trainer hands the model's BatchNorms a
`nn.layers_norm.StatSink` around the forward and the backward (so the
forward a checkpoint recomputes writes nothing) and installs the
recorded statistics after the backward.

A parameter the loss does not reach (BertForMaskedLM's pooler) gets a
zero gradient, as `jax.grad` gives it, so the rule still updates it
(AdamW's decoupled decay moves it).

`remat=True` checkpoints the loss function
(`torch.utils.checkpoint`, `use_reentrant=False`), as
`jax.checkpoint(loss_for_grad)` does. Dropout draws from a key (`nn.rng`)
of (rng_seed, step), and the microbatch under `grad_accum`; the key is
installed inside the checkpointed function, so the recomputed forward
draws the same masks. `loop_unroll` is an XLA scan hint: any value >= 1
is accepted and changes nothing. There is no `donate`: the step always
updates the state's tensors in place. `mesh` raises (sharded training,
ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from .. import amp, core
from ..nn import rng
from ..nn.layers import LayerNorm
from ..nn.layers_norm import _BatchNormBase, collect_stats

__all__ = ["TrainState", "Trainer"]

_NORM_TYPES = (LayerNorm, _BatchNormBase)


class TrainState:
    """Everything a step mutates: {name: tensor} params and buffers, the
    optimizer state, the scaler state ({} without a scaler), the seed
    and the step."""

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
                 donate: bool = True, remat: bool = False,
                 keep_bn_fp32: bool = True, loop_unroll: int = 1,
                 grad_accum: int = 1):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer mesh (sharded training) is not ported yet (ROADMAP "
                "Queue 1, item 13)")
        if amp_level not in (None, "O1", "O2"):
            raise ValueError(f"amp_level must be None, 'O1' or 'O2', got "
                             f"{amp_level!r}")
        if int(loop_unroll) < 1:
            raise ValueError(f"loop_unroll must be >= 1, got {loop_unroll}")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.num_inputs = num_inputs
        self.amp_level = amp_level
        self.amp_dtype = core.resolve_dtype(amp_dtype)
        self.scaler = scaler
        self.remat = remat
        self.keep_bn_fp32 = keep_bn_fp32
        self.loop_unroll = int(loop_unroll)
        self.grad_accum = grad_accum
        self.state: Optional[TrainState] = None
        self._module_paths = None          # {module: dotted name}

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
            keep = self._norm_param_names() if self.keep_bn_fp32 else set()
            params = {k: (v if k in keep
                          else core.cast_floating(v, self.amp_dtype))
                      for k, v in params.items()}
        for v in params.values():
            v.requires_grad_(v.is_floating_point())
        buffers = {k: b.detach().clone()
                   for k, b in self.model.named_buffers()}
        opt_state = self.optimizer.init(params)
        scaler_state = self.scaler.init(self.device) if self.scaler else {}
        self.state = TrainState(params, buffers, opt_state, scaler_state,
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
        scaler_state = to_dev(state.scaler_state)
        if self.scaler and not scaler_state:
            scaler_state = self.scaler.init(dev)
        self.state = TrainState(params, to_dev(state.buffers),
                                to_dev(state.opt_state), scaler_state,
                                state.rng_key, int(state.step))
        return self.state

    def _norm_param_names(self):
        names = set()
        for path, sub in self.model.named_modules():
            if isinstance(sub, _NORM_TYPES):
                for pname, p in sub.named_parameters(recurse=False):
                    names.add(f"{path}.{pname}" if path else pname)
        return names

    # --- the step ------------------------------------------------------------
    def _forward(self, params, buffers, batch, training: bool, key=()):
        """(loss, out) of one forward; dropout draws from `key`."""
        inputs = batch[: self.num_inputs]
        labels = batch[self.num_inputs:]
        if self.amp_level == "O2":
            inputs = core.cast_floating(inputs, self.amp_dtype)
        self.model.train(training)
        cast = amp.auto_cast(True, dtype=self.amp_dtype) \
            if self.amp_level == "O1" else contextlib.nullcontext()
        with cast, rng.rng_context(*key):
            out = torch.func.functional_call(
                self.model, {**params, **buffers}, tuple(inputs))
        loss = self.loss_fn(out, *labels)
        return loss, out

    def _stat_names(self, sink):
        """{buffer name: new value} of a `StatSink`'s records."""
        if self._module_paths is None:
            self._module_paths = {m: p for p, m in
                                  self.model.named_modules()}
        out = {}
        for m, (mean, var) in sink.updates.items():
            path = self._module_paths[m]
            pre = f"{path}." if path else ""
            out[pre + "_mean"], out[pre + "_variance"] = mean, var
        return out

    def _loss_and_grads(self, st: TrainState, batch):
        """(loss, out, buffers, grads): whole batch, or the mean over
        `grad_accum` microbatches (out is None then, as in JAX); the
        buffers with the step's statistics merged in. With a scaler the
        loss and gradients are the scaled ones."""
        names = [k for k, v in st.params.items() if v.requires_grad]
        leaves = [st.params[k] for k in names]

        def grad_of(b, key, buffers):
            def loss_for_grad():
                loss, out = self._forward(st.params, buffers, b,
                                          training=True, key=key)
                if self.scaler:
                    loss = self.scaler.scale_loss(loss, st.scaler_state)
                return loss, out

            with collect_stats(self.model) as sink:
                if self.remat:
                    loss, out = torch.utils.checkpoint.checkpoint(
                        loss_for_grad, use_reentrant=False)
                else:
                    loss, out = loss_for_grad()
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # a parameter the loss does not reach (BertForMaskedLM's
            # pooler) gets a zero gradient, as jax.grad gives it, so the
            # rule still updates it (AdamW's decay)
            return loss.detach(), out, {
                k: g if g is not None else torch.zeros_like(p)
                for k, g, p in zip(names, grads, leaves)}, \
                {**buffers, **self._stat_names(sink)}

        key = (st.rng_key, st.step)
        if self.grad_accum == 1:
            loss, out, grads, buffers = grad_of(batch, key, st.buffers)
            return loss, out.detach(), buffers, grads

        k = self.grad_accum
        for b in batch:
            if b.shape[0] % k:
                raise ValueError(f"batch dim {b.shape[0]} not divisible by "
                                 f"grad_accum={k}")
        micro = [b.chunk(k, dim=0) for b in batch]
        gsum, lsum, buffers = None, None, st.buffers
        for i in range(k):
            # fresh dropout masks per microbatch, as JAX's fold_in(rng, i);
            # the statistics thread through the microbatches
            loss, _, grads, buffers = grad_of(
                tuple(m[i] for m in micro), key + (i,), buffers)
            if gsum is None:
                gsum, lsum = grads, loss.float()
            else:
                for n, g in grads.items():
                    gsum[n].add_(g)
                lsum = lsum + loss
        inv_k = 1.0 / k
        grads = {n: g.mul_(inv_k) for n, g in gsum.items()}
        return lsum * inv_k, None, buffers, grads

    def _step_body(self, st: TrainState, batch):
        """One optimizer step: forward, backward, (scaler,) the update,
        the buffers (also on a step the scaler rejects, as in JAX)."""
        loss, out, buffers, grads = self._loss_and_grads(st, batch)
        check = core.get_flags("check_nan_inf")["check_nan_inf"]
        scaler_state = st.scaler_state
        if self.scaler:
            grads, found_inf = self.scaler.unscale(grads, st.scaler_state)
            loss = loss / st.scaler_state["scale"]
            if check:
                # after unscale; a step the scaler rejects is its
                # routine path, not a numerics fault
                self._check_numerics(loss, grads, st.step, found_inf)
            if not bool(found_inf):         # the step's one host sync
                self.optimizer.update(grads, st.opt_state, st.params)
            scaler_state = self.scaler.update(st.scaler_state, found_inf)
        else:
            if check:
                self._check_numerics(loss, grads, st.step)
            self.optimizer.update(grads, st.opt_state, st.params)
        new_state = TrainState(st.params, buffers, st.opt_state,
                               scaler_state, st.rng_key, st.step + 1)
        return new_state, loss, out

    @staticmethod
    def _check_numerics(loss, grads, step, suppress=None):
        """Raise `FloatingPointError` naming the first 8 of the loss and
        the gradients that hold a NaN or an inf (one host read of the
        per-tensor flags); nothing when `suppress` (found_inf) is
        True."""
        names = ["loss"] + [f"grad:{k}" for k in grads]
        bad = amp.nonfinite([loss.detach().float().reshape(1)]
                            + list(grads.values()))
        if suppress is not None:
            bad = bad & ~suppress
        bad = bad.tolist()
        if any(bad):
            hit = [n for n, b in zip(names, bad) if b]
            raise FloatingPointError(
                f"FLAGS_check_nan_inf: non-finite values at step {step} in: "
                f"{', '.join(hit[:8])}" + (" …" if len(hit) > 8 else ""))

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
