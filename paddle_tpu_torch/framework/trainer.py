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
updates the state's tensors in place.

`mesh` (a `parallel.Mesh` of dp and fsdp ranks; tp, pp, sp or ep above
1 raise, naming ROADMAP Queue 1 item 13.4's steps 4-5) trains data
parallel over k = dp x fsdp logical ranks on the mesh's one device, at
the model's ZeRO stage (`parallel.apply_fsdp`; `parallel/sharding.py`
says what each stage splits). The step equals JAX's one program over
the global batch, which GSPMD partitions:
- the global batch (each microbatch under `grad_accum`: the global
  batch's chunk i) is split over the data ranks in rank order, and
  each rank runs its forward and backward on its rows
  (`nn.ranks.spmd`, one rank at a time between collectives), with its
  own alias of every parameter, so its gradients are its own;
- the ranks' gradients meet in `parallel.collective`: `all_reduce` at
  stages 0-1, `reduce_scatter` over the fsdp ranks at stages 2-3 (then
  an `all_reduce` over dp when dp > 1); the optimizer rule runs once
  per fsdp partition (a partition the dp ranks share is one storage,
  updated once), and at stages 1-2 the parameters are all-gathered;
- the loss is JAX's global mean: a count pass after the first rank's
  forward records each masked mean's count for every rank's labels
  (`nn.ranks.counting`), one `all_reduce` sums them before any
  backward, and each rank divides by the global count; a loss with no
  masked mean is weighted by the rank's share of the rows;
- dropout draws one mask over the global batch and each rank keeps its
  rows; batch norm averages its moments over the data ranks mid-forward
  (sync batch norm), so a model with batch norm runs the ranks'
  forwards together and one backward over all of them; the running
  statistics update once from the global moments;
- a GradScaler's found_inf is the MAX over the partitions; a
  `ClipGradByGlobalNorm` sums its squared norm over the partitions, as
  the norm of the unsharded gradients. Rules and clips that take one
  parameter's norm (Lamb, LarsMomentum, ClipGradByNorm) refuse
  partitions.
`gathered_state()` gives the state as whole tensors; `sync_model`,
`eval_step` and a loaded state go through it.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from .. import amp, core
from ..nn import ranks, rng
from ..nn.layers import LayerNorm
from ..nn.layers_norm import _BatchNormBase, collect_stats
from ..nn.tp import all_reduce       # the ranks' values added in rank order

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
        self.mesh = None
        if mesh is not None:
            self._init_mesh(mesh)

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
        if self.mesh is not None:
            self._partition_state()
        return self.state

    def load_state(self, state: TrainState) -> TrainState:
        """Adopt `state` (e.g. `from_jax_train_state` of a JAX run):
        its tensors move to the model's device; the parameters become
        the leaves the next step differentiates."""
        dev = self.device
        if self.mesh is not None:
            from ..parallel.sharding import gather_train_state
            state = gather_train_state(state)

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
        if self.mesh is not None:
            self._partition_state()
        return self.state

    def _norm_param_names(self):
        names = set()
        for path, sub in self.model.named_modules():
            if isinstance(sub, _NORM_TYPES):
                for pname, p in sub.named_parameters(recurse=False):
                    names.add(f"{path}.{pname}" if path else pname)
        return names

    # --- the step ------------------------------------------------------------
    def _forward(self, params, buffers, batch, training: bool, key=(),
                 module=None, before_loss=None):
        """(loss, out) of one forward of `module` (the model, or a rank's
        replica of it); dropout draws from `key`; `before_loss(out)`
        runs between the forward and the loss."""
        module = self.model if module is None else module
        inputs = batch[: self.num_inputs]
        labels = batch[self.num_inputs:]
        if self.amp_level == "O2":
            inputs = core.cast_floating(inputs, self.amp_dtype)
        module.train(training)
        cast = amp.auto_cast(True, dtype=self.amp_dtype) \
            if self.amp_level == "O1" else contextlib.nullcontext()
        with cast, rng.rng_context(*key):
            out = torch.func.functional_call(
                module, {**params, **buffers}, tuple(inputs))
        if before_loss is not None:
            before_loss(out)
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
            return loss.detach(), out, _zero_fill(names, grads, st.params), \
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
        if self.mesh is not None:
            return self._mesh_step_body(st, batch)
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
        return self._forward(self._whole_params(), self.state.buffers,
                             self._batch(batch), training=False)

    @torch.no_grad()
    def sync_model(self) -> nn.Module:
        """Write the trained parameters and buffers back into the model.
        As in JAX, a master weight is first cast to its parameter's
        dtype."""
        if self.state is None:
            return self.model
        st = self.gathered_state()
        params = dict(st.params)
        for k, s in st.opt_state["slots"].items():
            if "master_weight" in s:
                params[k] = s["master_weight"].to(params[k].dtype)
        for k, p in self.model.named_parameters():
            if k in params:
                p.copy_(params[k])
        for k, b in self.model.named_buffers():
            if k in self.state.buffers:
                b.copy_(self.state.buffers[k])
        return self.model

    def gathered_state(self) -> TrainState:
        """The state with whole tensors: itself without a mesh, else a
        copy whose split entries are joined (the JAX state's values: a
        mesh is a placement)."""
        if self.mesh is None:
            return self.state
        from ..parallel.sharding import gather_train_state
        return gather_train_state(self.state)

    def _whole_params(self):
        if self.mesh is None:
            return self.state.params
        from ..parallel.sharding import Sharded
        return {k: v.full() if isinstance(v, Sharded) else v
                for k, v in self.state.params.items()}

    # --- under a mesh ----------------------------------------------------
    def _init_mesh(self, mesh):
        from ..nn.clip import ClipGradByNorm
        from ..optimizer import Lamb, LarsMomentum
        from ..parallel.mesh import Mesh
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh "
                            f"(parallel.init_mesh), got {type(mesh)!r}")
        later = {a: n for a, n in mesh.shape.items()
                 if a in ("tp", "pp", "sp", "ep") and n > 1}
        if later:
            raise NotImplementedError(
                f"Trainer(mesh=) with {later}: tensor, pipeline, sequence "
                f"and expert parallel training are ROADMAP Queue 1 item "
                f"13.4, steps 4-5; this Trainer splits over dp and fsdp")
        dev = self.device
        if (mesh.device.type, mesh.device.index or 0) != \
                (dev.type, dev.index or 0):
            raise ValueError(f"the mesh's ranks are on {mesh.device}, the "
                             f"model on {dev}")
        if mesh.shape["fsdp"] > 1 and (
                isinstance(self.optimizer, (Lamb, LarsMomentum))
                or isinstance(self.optimizer.grad_clip, ClipGradByNorm)):
            raise NotImplementedError(
                f"{type(self.optimizer).__name__} with "
                f"{type(self.optimizer.grad_clip).__name__}: a rule or clip "
                f"that takes each parameter's own norm over fsdp "
                f"partitions is not ported")
        self.mesh = mesh
        self._data = mesh.ranks_over(("dp", "fsdp"))
        self._coupled = any(isinstance(m, _BatchNormBase)
                            for m in self.model.modules())
        self._modules: Optional[List[nn.Module]] = None
        self._pdims: Dict[str, Optional[int]] = {}

    def _partition_state(self):
        """Split the (whole) state for the model's ZeRO stage and note
        each parameter's partition dim: the parameter's own at stage 3,
        its slots' at stages 1-2, None (whole) otherwise."""
        from ..parallel import sharding as shd
        st = self.state
        for v in st.params.values():        # the ranks' aliases are the
            v.requires_grad_(False)         # leaves of their graphs
        parts = shd.state_partitions(st, self.model, self.mesh)
        shd.shard_train_state(st, self.model, self.mesh)
        self._pdims = {}
        for k in st.params:
            d = parts["params"][k]
            if d is None:
                d = next((x for x in parts["slots"].get(k, {}).values()
                          if x is not None), None)
            self._pdims[k] = d

    def _rank_modules(self) -> List[nn.Module]:
        """The model for rank 0 and a replica for each other data rank:
        the same parameters, buffers and settings, its own module
        objects, so the ranks' `functional_call`s do not meet."""
        if self._modules is None:
            self._modules = [self.model] + [
                _replica(self.model) for _ in self._data[1:]]
        return self._modules

    def _rank_leaves(self, st: TrainState) -> Dict[str, torch.Tensor]:
        """A rank's parameters: its own autograd leaf over each tensor
        (one storage for the replicated ones); at stage 3 each split
        parameter all-gathered from its slices first."""
        from ..parallel import collective as C
        from ..parallel.sharding import Sharded
        out = {}
        for k, v in st.params.items():
            if isinstance(v, Sharded):
                v = C.all_gather(v.parts, axis=v.dim, group="fsdp")
            out[k] = v.detach().requires_grad_(v.is_floating_point())
        return out

    def _count_pass(self, out, shards, ctxs):
        """Every rank's masked-mean counts from its labels (the loss
        over this rank's outputs in `ranks.counting` mode), one
        all_reduce, and the global counts into each rank's context.
        Returns whether the loss holds a masked mean."""
        from ..parallel import collective as C
        det = _tree_detach(out)
        per = []
        with torch.no_grad():
            for sh in shards:
                with ranks.counting() as got:
                    self.loss_fn(det, *sh[self.num_inputs:])
                per.append(got)
        if not per[0]:
            return False
        if any(len(c) != len(per[0]) for c in per):
            raise RuntimeError("the ranks' losses take different numbers "
                               "of masked means")
        tot = C.all_reduce([torch.stack(c) for c in per], group=("dp",
                                                                 "fsdp"))
        for ctx in ctxs:
            ctx.denominators = list(tot.unbind())
        return True

    def _mesh_micro(self, st: TrainState, mb, key, buffers):
        """One (micro)batch over the data ranks: ([rank losses], [rank
        gradient dicts], [rank outputs], buffers). A model with batch
        norm runs the ranks' forwards together (its moments meet) and
        one backward over all of them; otherwise each rank's backward
        follows its forward."""
        k = len(self._data)
        rows = mb[0].shape[0] // k
        shards = [tuple(b[r * rows:(r + 1) * rows] for b in mb)
                  for r in range(k)]
        ctxs = [ranks.RankContext(c, self.mesh.shape, ("dp", "fsdp"), rows)
                for c in self._data]
        mods = self._rank_modules()
        shared = {"masked": None}

        def rank_fn(r):
            leaves = self._rank_leaves(st)
            names = [n for n, v in leaves.items() if v.requires_grad]

            def before_loss(out):
                if shared["masked"] is None:
                    shared["masked"] = self._count_pass(out, shards, ctxs)

            def loss_for_grad():
                with ranks.use(ctxs[r]):
                    loss, out = self._forward(leaves, buffers, shards[r],
                                              training=True, key=key,
                                              module=mods[r],
                                              before_loss=before_loss)
                    if not shared["masked"]:
                        loss = loss * (1.0 / k)
                    if self.scaler:
                        loss = self.scaler.scale_loss(loss,
                                                      st.scaler_state)
                return loss, out

            if self.remat:
                loss, out = torch.utils.checkpoint.checkpoint(
                    loss_for_grad, use_reentrant=False)
            else:
                loss, out = loss_for_grad()
            out = _tree_detach(out)
            if self._coupled:
                return loss, out, leaves, names
            grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                        allow_unused=True)
            return loss.detach(), out, _zero_fill(names, grads, leaves), None

        with contextlib.ExitStack() as stack:
            sinks = [stack.enter_context(collect_stats(m)) for m in mods]
            res = ranks.spmd(self._data, rank_fn)
            losses = [r[0] for r in res]
            if self._coupled:
                total = all_reduce(losses)
                flat = [(r, n) for r, x in enumerate(res) for n in x[3]]
                gs = torch.autograd.grad(
                    total, [res[r][2][n] for r, n in flat],
                    allow_unused=True)
                grads = [{} for _ in res]
                for (r, n), g in zip(flat, gs):
                    grads[r][n] = g if g is not None else \
                        torch.zeros_like(res[r][2][n])
                losses = [l.detach() for l in losses]
            else:
                grads = [x[2] for x in res]
        # every rank's statistics are the global moments' (sync batch
        # norm): rank 0's, the model's own modules, go to the buffers
        buffers = {**buffers, **self._stat_names(sinks[0])}
        return losses, grads, [x[1] for x in res], buffers

    def _mesh_loss_and_grads(self, st: TrainState, batch):
        """(loss, out, buffers, [rank gradient dicts]) of the global
        batch, or the mean over `grad_accum` microbatches (global chunk
        i, split over the ranks; the ranks' gradients add up over the
        microbatches before they meet, as under `no_sync`)."""
        k, acc = len(self._data), self.grad_accum
        for b in batch:
            if b.shape[0] % (k * acc):
                raise ValueError(
                    f"batch dim {b.shape[0]} not divisible by {k} data "
                    f"ranks x grad_accum={acc}")
        key = (st.rng_key, st.step)
        if acc == 1:
            losses, grads, outs, buffers = self._mesh_micro(
                st, batch, key, st.buffers)
            return all_reduce(losses), _tree_cat(outs), buffers, grads
        micro = [b.chunk(acc, dim=0) for b in batch]
        gsum, lsum, buffers = None, None, st.buffers
        for i in range(acc):
            losses, grads, _, buffers = self._mesh_micro(
                st, tuple(m[i] for m in micro), key + (i,), buffers)
            loss = all_reduce(losses).float()
            if gsum is None:
                gsum, lsum = grads, loss
            else:
                for acc_g, g in zip(gsum, grads):
                    for n, t in g.items():
                        acc_g[n].add_(t)
                lsum = lsum + loss
        inv = 1.0 / acc
        for g in gsum:
            for t in g.values():
                t.mul_(inv)
        return lsum * inv, None, buffers, gsum

    def _mesh_reduce(self, grads) -> List[Dict[str, torch.Tensor]]:
        """The data ranks' gradients met: per fsdp partition j, {name:
        the summed gradient's slice j} for the split parameters, and
        (partition 0 only) {name: the whole sum} for the others.
        Stages 0-1: one all_reduce per parameter over the data ranks;
        stages 2-3: a reduce_scatter over the fsdp ranks of each dp row,
        then an all_reduce of each slice over dp."""
        from ..parallel import collective as C
        from ..parallel.sharding import zero_stage
        n = self.mesh.shape["fsdp"]
        dp = len(self._data) // n
        stage = zero_stage(self.model)
        out = [{} for _ in range(n)]
        for name in grads[0]:
            d = self._pdims.get(name)
            gl = [g[name] for g in grads]
            if stage <= 1 or d is None:
                tot = C.all_reduce(gl, group=("dp", "fsdp"))
                if d is None:
                    out[0][name] = tot
                else:
                    for j, c in enumerate(tot.chunk(n, dim=d)):
                        out[j][name] = c
                continue
            rows = [C.reduce_scatter(gl[i * n:(i + 1) * n], axis=d,
                                     group="fsdp") for i in range(dp)]
            for j in range(n):
                out[j][name] = rows[0][j] if dp == 1 else C.all_reduce(
                    [rows[i][j] for i in range(dp)], group="dp")
        return out

    def _mesh_update(self, st: TrainState, parts):
        """The optimizer rule once per fsdp partition, each in a rank of
        an SPMD run over the fsdp ranks (the clip's norm meets there);
        at stages 1-2 the updated slices are all-gathered into the
        parameters."""
        from ..parallel import collective as C
        from ..parallel.sharding import Sharded
        n = len(parts)
        views = []
        for j, grads in enumerate(parts):
            params, slots = {}, {}
            for name in grads:
                p, d = st.params[name], self._pdims.get(name)
                if isinstance(p, Sharded):
                    params[name] = p.parts[j]
                elif d is None:
                    params[name] = p
                else:
                    params[name] = p.detach().chunk(n, dim=d)[j].clone()
                slots[name] = {sk: sv.parts[j] if isinstance(sv, Sharded)
                               else sv for sk, sv in
                               st.opt_state["slots"][name].items()}
            views.append((params, {"step": st.opt_state["step"],
                                   "slots": slots}))

        def part_fn(j):
            ctx = ranks.RankContext({"fsdp": j}, self.mesh.shape)
            ctx.update_axes = ("fsdp",)
            with ranks.use(ctx):
                self.optimizer.update(parts[j], views[j][1], views[j][0])

        ranks.spmd([{"fsdp": j} for j in range(n)], part_fn)
        st.opt_state["step"] = views[0][1]["step"]
        with torch.no_grad():
            for name, p in st.params.items():
                d = self._pdims.get(name)
                if d is None or isinstance(p, Sharded) or name not in \
                        parts[0]:
                    continue
                p.copy_(C.all_gather([v[0][name] for v in views], axis=d,
                                     group="fsdp"))

    def _mesh_step_body(self, st: TrainState, batch):
        """One optimizer step over the mesh's data ranks (see the module
        docstring)."""
        from ..parallel import collective as C
        loss, out, buffers, grads = self._mesh_loss_and_grads(st, batch)
        parts = self._mesh_reduce(grads)
        del grads
        if not any(self._pdims.get(k) is not None for k in parts[0]):
            parts = parts[:1]
        check = core.get_flags("check_nan_inf")["check_nan_inf"]
        scaler_state = st.scaler_state
        found = None
        if self.scaler:
            flags = []
            for j, g in enumerate(parts):
                parts[j], f = self.scaler.unscale(g, st.scaler_state)
                flags.append(f.to(torch.int32))
            found = C.all_reduce(flags, op="max", group="fsdp").bool()
            loss = loss / st.scaler_state["scale"]
        if check:
            self._check_numerics(loss, _joined(parts, self._pdims),
                                 st.step, found)
        if found is None or not bool(found):   # the scaler's host sync
            self._mesh_update(st, parts)
        if self.scaler:
            scaler_state = self.scaler.update(st.scaler_state, found)
        new_state = TrainState(st.params, buffers, st.opt_state,
                               scaler_state, st.rng_key, st.step + 1)
        return new_state, loss, out


def _replica(module: nn.Module) -> nn.Module:
    """A copy of the module tree that shares every parameter, buffer and
    attribute value but has its own module objects and member dicts."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = {k: (_replica(c) if c is not None else None)
                    for k, c in module._modules.items()}
    return new


def _tree_detach(t):
    if isinstance(t, torch.Tensor):
        return t.detach()
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_detach(x) for x in t)
    if isinstance(t, dict):
        return {k: _tree_detach(v) for k, v in t.items()}
    return t


def _tree_cat(outs):
    """The ranks' outputs joined along the batch dim."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs, dim=0) if first.dim() else first
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_cat([o[i] for o in outs])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _tree_cat([o[k] for o in outs]) for k in first}
    return first


def _zero_fill(names, grads, leaves):
    return {n: g if g is not None else torch.zeros_like(leaves[n])
            for n, g in zip(names, grads)}


def _joined(parts, pdims):
    """{name: the whole gradient} from the partitions' pieces."""
    out = {}
    for name in parts[0]:
        d = pdims.get(name)
        out[name] = parts[0][name] if d is None or len(parts) == 1 else \
            torch.cat([p[name] for p in parts], dim=d)
    return out
