"""Optimizers of the PyTorch/CUDA port: the counterpart of
`paddle_tpu/optimizer/__init__.py`, every rule of it: `SGD`, `Momentum`,
`Adam`, `AdamW`, `Adamax`, `Adagrad`, `Adadelta`, `RMSProp`, `Lamb` and
`LarsMomentum`, with JAX's signatures and slot names (so a JAX state
carries across).

The pure surface:
    state = opt.init(params)
    params, state = opt.update(grads, state, params)
with the state a flat {"step": int, "slots": {name: {slot: tensor}}}
tree. `update` first applies `grad_clip` (before the master-weight
cast, so under O2 the clip sees bf16 or fp16 gradients), then reads the
learning rate at the step BEFORE it increments (a scheduler's first
update sees `value(0)`), while bias corrections use the 1-based step.
Multi-precision keeps an fp32 `master_weight` slot for every floating
parameter that is not fp32; the rule then runs in fp32 on the master and
the parameter becomes a cast of it.

Unlike the pure JAX functions, `update` works IN PLACE: it overwrites
the tensors of `params` and of the state and returns the same dicts (no
second copy of weights and moments on the card). Each rule is the JAX
rule written with `torch._foreach_*` over (device, dtype) groups of
parameters; Lamb and LarsMomentum scale each parameter by its own trust
ratio from fp32 norms (`torch._foreach_norm`). AdamW adds its decoupled
decay after the Adam ratio: `p -= lr * (m_hat / (sqrt(v_hat) + eps) +
wd * p)` (`torch.optim.AdamW` decays in another order and is not this
function).

The eager surface: `bind(model)`, `step(grads)` (updates the bound
model's parameters in place), `clear_grad` / `clear_gradients`,
`state_dict` / `set_state_dict` (with the scheduler's state under
"LR_Scheduler"), `get_lr` / `set_lr`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..core import foreach_groups as _groups
from ..core import fp32_norms as _fp32_norms
from ..nn.clip import ClipGradBase
from . import lr as lr_module
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "lr"]

lr = lr_module

Params = Dict[str, torch.Tensor]


def _bias_correction(beta: float, step: int) -> float:
    """1 - beta^t in fp32, as JAX computes it (1 - b2^t loses digits to
    cancellation at small t; this keeps the same loss)."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(step))


class Optimizer:
    """Base optimizer; subclasses define `init_slots` and `apply_rule`."""

    def __init__(self, learning_rate: Union[float, LRScheduler] = 0.001,
                 parameters=None, weight_decay: Optional[float] = None,
                 grad_clip: Optional[ClipGradBase] = None,
                 multi_precision: bool = False, name: Optional[str] = None):
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {learning_rate!r}")
        if grad_clip is not None and not callable(grad_clip):
            raise TypeError(f"grad_clip must be a ClipGrad* object, got "
                            f"{grad_clip!r}")
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self._eager_state: Optional[Dict[str, Any]] = None
        self._model: Optional[torch.nn.Module] = None

    # --- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def _lr_value(self, step: int) -> float:
        """The LR at `step` (fp32, as a Python float)."""
        if isinstance(self._lr, LRScheduler):
            return float(self._lr.value(step))
        return float(np.float32(self._lr))

    # --- pure surface --------------------------------------------------------
    def _acc_dtype(self, p: torch.Tensor) -> torch.dtype:
        """fp32 accumulators under multi-precision, else the param's."""
        return torch.float32 if self.multi_precision else p.dtype

    def _needs_master(self, p: torch.Tensor) -> bool:
        return (self.multi_precision and p.is_floating_point()
                and p.dtype != torch.float32)

    def _zeros(self, p, fill: float = 0.0):
        return torch.full_like(p, fill, dtype=self._acc_dtype(p))

    def init(self, params: Params) -> Dict:
        def slots_for(p):
            s = dict(self.init_slots(p))
            if self._needs_master(p):
                s["master_weight"] = p.detach().to(torch.float32, copy=True)
            return s

        return {"step": 0,
                "slots": {k: slots_for(v) for k, v in params.items()}}

    @torch.no_grad()
    def update(self, grads: Params, state: Dict, params: Params):
        """One step over every parameter with a gradient, in place;
        returns (params, state)."""
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        step = state["step"] + 1
        lr_t = self._lr_value(state["step"])
        names, targets, gs, slots = [], [], [], []
        cast_back = []
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            sl = state["slots"][k]
            master = sl.get("master_weight")
            if master is not None:
                targets.append(master)
                gs.append(g.to(torch.float32))
                cast_back.append((p, master))
            else:
                targets.append(p)
                gs.append(g.to(p.dtype))
            names.append(k)
            slots.append(sl)
        if names:
            self.apply_rule(names, targets, gs, slots, lr_t, step)
        for p, master in cast_back:
            p.copy_(master)
        state["step"] = step
        return params, state

    # --- subclass hooks ------------------------------------------------------
    def init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def apply_rule(self, names: List[str], ps: List[torch.Tensor],
                   gs: List[torch.Tensor], slots: List[Dict], lr_t: float,
                   step: int):
        """Update `ps` and `slots` in place for one (1-based) `step`."""
        raise NotImplementedError

    def _l2(self, p, g):
        """g + weight_decay * p (the coupled L2 decay), out of place."""
        if self.weight_decay:
            return torch._foreach_add(g, p, alpha=self.weight_decay)
        return g

    def _each_group(self, ps, gs, slots, keys):
        """(params, grads, {slot: tensors}) per (device, dtype) group."""
        for idx in _groups(ps):
            yield ([ps[i] for i in idx], [gs[i] for i in idx],
                   {k: [slots[i][k] for i in idx] for k in keys})

    # --- eager surface -------------------------------------------------------
    def bind(self, model: torch.nn.Module) -> "Optimizer":
        self._model = model
        return self

    def step(self, grads: Optional[Params] = None):
        """An eager step over the bound model's trainable parameters
        (updated in place)."""
        if self._model is None:
            raise RuntimeError("call opt.bind(model) (or use Trainer / "
                               "the functional update) before eager step()")
        if grads is None:
            raise ValueError("functional autograd: pass grads to step() "
                             "(torch.autograd.grad computes them)")
        params = {k: p.detach() for k, p in self._model.named_parameters()
                  if p.requires_grad}
        if self._eager_state is None:
            self._eager_state = self.init(params)
        _, self._eager_state = self.update(grads, self._eager_state, params)

    def clear_grad(self):
        """API parity: gradients are values here, nothing is stored."""

    clear_gradients = clear_grad

    def state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self._eager_state is not None:
            out["step"] = self._eager_state["step"]
            for pk, slots in self._eager_state["slots"].items():
                for sk, v in slots.items():
                    out[f"{pk}.{sk}"] = v
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state: Dict[str, Any]):
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        slots: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, v in state.items():
            if key in ("LR_Scheduler", "step"):
                continue
            pk, _, sk = key.rpartition(".")
            slots.setdefault(pk, {})[sk] = torch.as_tensor(v)
        if slots:
            self._eager_state = {"step": int(state.get("step", 0)),
                                 "slots": slots}


class SGD(Optimizer):
    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        for p, g, _ in self._each_group(ps, gs, slots, ()):
            torch._foreach_add_(p, self._l2(p, g), alpha=-lr_t)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def init_slots(self, p):
        return {"velocity": self._zeros(p)}

    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        for p, g, s in self._each_group(ps, gs, slots, ("velocity",)):
            g = self._l2(p, g)
            v = s["velocity"]
            torch._foreach_mul_(v, self.momentum)
            torch._foreach_add_(v, g)
            upd = torch._foreach_add(g, v, alpha=self.momentum) \
                if self.use_nesterov else v
            torch._foreach_add_(p, upd, alpha=-lr_t)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, p):
        return {"moment1": self._zeros(p), "moment2": self._zeros(p)}

    def _decays(self, name: str) -> bool:
        """Whether AdamW's decoupled decay applies to `name`."""
        return False

    def _adam_ratio(self, g, s, step):
        """Updates moment1 and moment2 in place; returns m_hat /
        (sqrt(v_hat) + eps)."""
        b1, b2 = self.beta1, self.beta2
        m, v = s["moment1"], s["moment2"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        den = torch._foreach_div(v, _bias_correction(b2, step))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.epsilon)
        upd = torch._foreach_div(m, _bias_correction(b1, step))
        torch._foreach_div_(upd, den)
        return upd

    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        for idx in _groups(ps):
            p = [ps[i] for i in idx]
            g = [gs[i] for i in idx]
            if self.weight_decay and not isinstance(self, AdamW):
                g = self._l2(p, g)
            upd = self._adam_ratio(
                g, {k: [slots[i][k] for i in idx]
                    for k in ("moment1", "moment2")}, step)
            dec = [j for j, i in enumerate(idx) if self._decays(names[i])]
            if dec:
                torch._foreach_add_([upd[j] for j in dec],
                                    [p[j] for j in dec],
                                    alpha=self.weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr_t)


class AdamW(Adam):
    """Decoupled weight decay; `apply_decay_param_fun(name)` False
    exempts a parameter from it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self.apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, name: str) -> bool:
        return bool(self.weight_decay) and (
            self.apply_decay_param_fun is None
            or bool(self.apply_decay_param_fun(name)))


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, p):
        return {"moment": self._zeros(p), "inf_norm": self._zeros(p)}

    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        b1, b2 = self.beta1, self.beta2
        # lr / (1 - b1^t) in fp32
        lr_c = float(np.float32(lr_t) / np.float32(_bias_correction(b1,
                                                                    step)))
        for p, g, s in self._each_group(ps, gs, slots,
                                        ("moment", "inf_norm")):
            g = self._l2(p, g)
            m, u = s["moment"], s["inf_norm"]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1 - b1)
            torch._foreach_mul_(u, b2)
            torch._foreach_maximum_(u, torch._foreach_abs(g))
            upd = torch._foreach_mul(m, lr_c)
            torch._foreach_div_(upd, torch._foreach_add(u, self.epsilon))
            torch._foreach_sub_(p, upd)


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def init_slots(self, p):
        return {"moment": self._zeros(p, self.initial_accumulator_value)}

    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        for p, g, s in self._each_group(ps, gs, slots, ("moment",)):
            g = self._l2(p, g)
            acc = s["moment"]
            torch._foreach_addcmul_(acc, g, g)
            den = torch._foreach_sqrt(acc)
            torch._foreach_add_(den, self.epsilon)
            upd = torch._foreach_mul(g, lr_t)
            torch._foreach_div_(upd, den)
            torch._foreach_sub_(p, upd)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self.epsilon, self.rho = epsilon, rho

    def init_slots(self, p):
        return {"avg_squared_grad": self._zeros(p),
                "avg_squared_update": self._zeros(p)}

    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        rho, eps = self.rho, self.epsilon
        for p, g, s in self._each_group(
                ps, gs, slots, ("avg_squared_grad", "avg_squared_update")):
            g = self._l2(p, g)
            eg, eu = s["avg_squared_grad"], s["avg_squared_update"]
            torch._foreach_mul_(eg, rho)
            torch._foreach_addcmul_(eg, g, g, value=1 - rho)
            num = torch._foreach_add(eu, eps)
            torch._foreach_sqrt_(num)
            upd = torch._foreach_mul(g, num)
            den = torch._foreach_add(eg, eps)
            torch._foreach_sqrt_(den)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(eu, rho)
            torch._foreach_addcmul_(eu, upd, upd, value=1 - rho)
            torch._foreach_add_(p, upd, alpha=-lr_t)


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def init_slots(self, p):
        s = {"mean_square": self._zeros(p), "momentum_acc": self._zeros(p)}
        if self.centered:
            s["mean_grad"] = self._zeros(p)
        return s

    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        rho = self.rho
        keys = ("mean_square", "momentum_acc") + (
            ("mean_grad",) if self.centered else ())
        for p, g, s in self._each_group(ps, gs, slots, keys):
            g = self._l2(p, g)
            ms, mom = s["mean_square"], s["momentum_acc"]
            torch._foreach_mul_(ms, rho)
            torch._foreach_addcmul_(ms, g, g, value=1 - rho)
            if self.centered:
                mg = s["mean_grad"]
                torch._foreach_mul_(mg, rho)
                torch._foreach_add_(mg, g, alpha=1 - rho)
                den = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
                torch._foreach_add_(den, self.epsilon)
            else:
                den = torch._foreach_add(ms, self.epsilon)
            torch._foreach_sqrt_(den)
            upd = torch._foreach_mul(g, lr_t)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(mom, self.momentum)
            torch._foreach_add_(mom, upd)
            torch._foreach_sub_(p, mom)


class Lamb(Optimizer):
    """Layer-wise adaptive moments: the Adam ratio plus decoupled decay,
    scaled per parameter by the trust ratio ||p|| / ||update|| (fp32
    norms; 1 where either is 0)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name=name)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn

    def init_slots(self, p):
        return {"moment1": self._zeros(p), "moment2": self._zeros(p)}

    _adam_ratio = Adam._adam_ratio

    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        for idx in _groups(ps):
            p = [ps[i] for i in idx]
            g = [gs[i] for i in idx]
            upd = self._adam_ratio(
                g, {k: [slots[i][k] for i in idx]
                    for k in ("moment1", "moment2")}, step)
            wd = self.weight_decay or 0.0
            dec = [j for j, i in enumerate(idx)
                   if wd and not (self.exclude_fn is not None
                                  and self.exclude_fn(names[i]))]
            if dec:
                torch._foreach_add_([upd[j] for j in dec],
                                    [p[j] for j in dec], alpha=wd)
            w_norm, u_norm = _fp32_norms(p), _fp32_norms(upd)
            for pj, uj, wn, un in zip(p, upd, w_norm, u_norm):
                trust = torch.where((wn > 0) & (un > 0), wn / un, 1.0)
                pj.sub_(uj * (lr_t * trust).to(pj.dtype))


class LarsMomentum(Optimizer):
    """LARS: momentum whose step is scaled per parameter by the local
    rate lars_coeff ||p|| / (||g|| + wd ||p|| + eps) (fp32 norms; 1
    where either norm is 0)."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, epsilon=1e-9,
                 exclude_from_weight_decay=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, lars_weight_decay,
                         grad_clip, multi_precision, name=name)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.epsilon = epsilon
        if isinstance(exclude_from_weight_decay, str):
            # a bare string would iterate per character and match almost
            # every parameter name
            exclude_from_weight_decay = (exclude_from_weight_decay,)
        self.exclude = tuple(exclude_from_weight_decay or ())

    def init_slots(self, p):
        return {"velocity": self._zeros(p)}

    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        w_norm, g_norm = _fp32_norms(ps), _fp32_norms(gs)
        for name, p, g, s, wn, gn in zip(names, ps, gs, slots, w_norm,
                                         g_norm):
            wd = self.weight_decay or 0.0
            if any(tok in (name or "") for tok in self.exclude):
                wd = 0.0
            local = torch.where(
                (wn > 0) & (gn > 0),
                self.lars_coeff * wn / (gn + wd * wn + self.epsilon), 1.0)
            v = s["velocity"]
            v.mul_(self.momentum).add_(
                (g + wd * p) * (lr_t * local).to(p.dtype))
            p.sub_(v.to(p.dtype))

