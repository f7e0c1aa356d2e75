"""Optimizers of the PyTorch/CUDA port: `Optimizer`, `Adam`, `AdamW`.

The counterpart of `paddle_tpu/optimizer/__init__.py`'s update rules:
    state = opt.init(params)
    params, state = opt.update(grads, state, params)
with the state a flat {"step": int, "slots": {name: {slot: tensor}}}
tree. Multi-precision keeps an fp32 `master_weight` slot for every
floating parameter that is not fp32; the rule then runs in fp32 on the
master and the parameter becomes a cast of it.

Unlike the pure JAX functions, `update` works IN PLACE: it overwrites
the tensors of `params` and of the state and returns the same dicts
(no second copy of weights and moments on the card). The arithmetic is
the JAX rule, written with `torch._foreach_*` over groups of
parameters: the first update sees the learning rate as set, the bias
correction uses the 1-based step, and AdamW adds its decoupled decay
after the Adam ratio: `p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`
(`torch.optim.AdamW` decays in another order and is not this
function). A float learning rate only: schedulers and `grad_clip` are
not ported yet (ROADMAP Queue 1, after item 6).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["Optimizer", "Adam", "AdamW"]

Params = Dict[str, torch.Tensor]


class Optimizer:
    """Base optimizer; subclasses define `init_slots` and `apply_rule`."""

    def __init__(self, learning_rate: float = 0.001,
                 weight_decay: Optional[float] = None, grad_clip=None,
                 multi_precision: bool = False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning_rate {learning_rate!r}: LR schedulers are not "
                f"ported yet (ROADMAP Queue 1, after item 6); pass a float")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP Queue 1, after item 6)")
        self._lr = float(learning_rate)
        self.weight_decay = weight_decay
        self.multi_precision = multi_precision

    def get_lr(self) -> float:
        return self._lr

    def _acc_dtype(self, p: torch.Tensor) -> torch.dtype:
        """fp32 accumulators under multi-precision, else the param's."""
        return torch.float32 if self.multi_precision else p.dtype

    def _needs_master(self, p: torch.Tensor) -> bool:
        return (self.multi_precision and p.is_floating_point()
                and p.dtype != torch.float32)

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
        step = state["step"] + 1
        lr_t = self.get_lr()
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


def _groups(ts: List[torch.Tensor]):
    """Indices of `ts` grouped by (device, dtype), so every
    `torch._foreach_*` call takes its fast path."""
    out: Dict[tuple, List[int]] = {}
    for i, t in enumerate(ts):
        out.setdefault((t.device, t.dtype), []).append(i)
    return out.values()


class Adam(Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: Optional[float] = None, grad_clip=None,
                 multi_precision: bool = False):
        super().__init__(learning_rate, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, p):
        return {"moment1": torch.zeros_like(p, dtype=self._acc_dtype(p)),
                "moment2": torch.zeros_like(p, dtype=self._acc_dtype(p))}

    def _decays(self, name: str) -> bool:
        """Whether AdamW's decoupled decay applies to `name`."""
        return False

    def apply_rule(self, names, ps, gs, slots, lr_t, step):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        # the bias corrections in fp32, as JAX computes them (1 - b2^t
        # loses digits to cancellation at small t; this keeps the loss)
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        for idx in _groups(ps):
            p = [ps[i] for i in idx]
            g = [gs[i] for i in idx]
            m = [slots[i]["moment1"] for i in idx]
            v = [slots[i]["moment2"] for i in idx]
            if self.weight_decay and not isinstance(self, AdamW):
                g = torch._foreach_add(g, p, alpha=self.weight_decay)  # L2
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, g, g, value=1 - b2)
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(m, bc1)
            torch._foreach_div_(upd, den)
            del den
            dec = [j for j, i in enumerate(idx) if self._decays(names[i])]
            if dec:
                torch._foreach_add_([upd[j] for j in dec],
                                    [p[j] for j in dec],
                                    alpha=self.weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr_t)


class AdamW(Adam):
    """Decoupled weight decay; `apply_decay_param_fun(name)` False
    exempts a parameter from it."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 grad_clip=None, multi_precision: bool = False):
        super().__init__(learning_rate, beta1, beta2, epsilon, weight_decay,
                         grad_clip, multi_precision)
        self.apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, name: str) -> bool:
        return bool(self.weight_decay) and (
            self.apply_decay_param_fun is None
            or bool(self.apply_decay_param_fun(name)))
