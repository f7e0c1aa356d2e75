"""LR schedulers of the PyTorch/CUDA port: a copy of
`paddle_tpu/optimizer/lr.py`.

Two interfaces, as there:
- the stateful one: `sched.step()` / `sched.get_lr()` / `sched()`;
- `sched.value(step)`, a pure function of the step, which the
  optimizer's `update` reads at the step before it increments (the
  first update sees `value(0)`).

`value` computes in fp32 as the jnp version does: numpy `float32`
scalars at the points where jnp holds fp32 arrays, Python doubles where
the JAX code combines Python numbers before they meet an array (so
`(base_lr - eta_min)` is a double rounded once to fp32, `pi * step` an
fp32 product). It returns an `np.float32`. ReduceOnPlateau is driven by
a metric and eager only, and MultiplicativeDecay's `value` is its
current eager value, as in the reference.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "ReduceOnPlateau", "CosineAnnealingDecay", "MultiplicativeDecay",
           "OneCycleLR", "CyclicLR", "CosineAnnealingWarmRestarts",
           "ConstantLR", "CosineWarmup"]

f32 = np.float32
_PI = f32(math.pi)


# exp, cos, log1p and pow of fp32 arguments, correctly rounded to fp32
# (evaluated in fp64): within XLA's own error of the jnp functions
def _exp(x):
    return f32(np.exp(np.float64(x)))


def _cos(x):
    return f32(np.cos(np.float64(x)))


def _log1p(x):
    return f32(np.log1p(np.float64(x)))


def _pow(a, b):
    return f32(np.float64(a) ** np.float64(b))


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.verbose = verbose
        self.step()

    # --- stateful -----------------------------------------------------------
    def step(self, epoch: Optional[int] = None):
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.last_lr = float(self.get_lr())

    def get_lr(self) -> float:
        return float(self.value(max(self.last_epoch, 0)))

    def __call__(self) -> float:
        return self.last_lr

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]

    # --- pure ---------------------------------------------------------------
    def value(self, step) -> np.float32:
        """The LR at `step` in fp32; subclasses implement this."""
        return f32(self.base_lr)


class ConstantLR(LRScheduler):
    def value(self, step):
        return f32(self.base_lr)


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        step = max(f32(step), f32(1.0))
        a = _pow(step, -0.5)
        b = step * f32(self.warmup_steps ** -1.5)
        return f32(self.base_lr * (self.d_model ** -0.5)) * min(a, b)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float],
                 last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def value(self, step):
        idx = sum(1 for b in self.boundaries if step >= b)
        return f32(self.values[idx])


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        return f32(self.base_lr) * _exp(f32(-self.gamma) * f32(step))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        return f32(self.base_lr) / (f32(1) + f32(self.gamma) * f32(step))


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        return f32(self.base_lr) * _pow(f32(self.gamma), f32(step))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        step = f32(step)
        if self.cycle:
            div = np.ceil(max(step, f32(1.0)) / f32(self.decay_steps))
            decay_steps = f32(self.decay_steps) * max(div, f32(1.0))
        else:
            decay_steps = f32(self.decay_steps)
            step = min(step, decay_steps)
        frac = _pow(f32(1) - step / decay_steps, f32(self.power))
        return f32(self.base_lr - self.end_lr) * frac + f32(self.end_lr)


class LinearWarmup(LRScheduler):
    """Linear from start_lr to end_lr over warmup_steps, then
    `learning_rate` (a float, or a scheduler run from step 0)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr, self.end_lr = start_lr, end_lr
        super().__init__(end_lr if isinstance(learning_rate, LRScheduler)
                         else learning_rate, last_epoch, verbose)

    def value(self, step):
        step = f32(step)
        warm = f32(self.start_lr) + f32(self.end_lr - self.start_lr) * \
            min(step, f32(self.warmup_steps)) / f32(self.warmup_steps)
        if step < f32(self.warmup_steps):
            return warm
        if isinstance(self.lr_after, LRScheduler):
            return f32(self.lr_after.value(
                max(step - f32(self.warmup_steps), f32(0))))
        return f32(self.lr_after)


class CosineWarmup(LRScheduler):
    """Linear warmup, then cosine decay to min_lr over total_steps."""

    def __init__(self, learning_rate, warmup_steps, total_steps,
                 min_lr=0.0, last_epoch=-1, verbose=False):
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.min_lr = min_lr
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        step = f32(step)
        if step < f32(self.warmup_steps):
            return f32(self.base_lr) * max(step, f32(1.0)) / \
                f32(max(self.warmup_steps, 1))
        prog = np.clip((step - f32(self.warmup_steps)) /
                       f32(max(self.total_steps - self.warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        return f32(self.min_lr) + f32(0.5 * (self.base_lr - self.min_lr)) * \
            (f32(1) + _cos(_PI * prog))


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        n = sum(1 for m in self.milestones if step >= m)
        return f32(self.base_lr) * _pow(f32(self.gamma), f32(n))


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        n = int(step) // self.step_size
        return f32(self.base_lr) * _pow(f32(self.gamma), f32(n))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        return f32(self.base_lr * self.lr_lambda(step))


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        # recursive in its own state: eager only, as in the reference
        if self.last_epoch > 0:
            return self.last_lr * self.lr_lambda(self.last_epoch)
        return self.base_lr

    def value(self, step):
        return f32(self.last_lr)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        step = f32(step)
        return f32(self.eta_min) + f32(self.base_lr - self.eta_min) * \
            (f32(1) + _cos(_PI * step / f32(self.T_max))) / f32(2)


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0,
                 last_epoch=-1, verbose=False):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def value(self, step):
        step = f32(step)
        if self.T_mult == 1:
            t_cur = np.mod(step, f32(self.T_0))
            t_i = f32(self.T_0)
        else:
            n = np.floor(_log1p(step / f32(self.T_0) *
                                  f32(self.T_mult - 1)) /
                         f32(math.log(self.T_mult)))
            tm_n = _pow(f32(self.T_mult), n)
            start = f32(self.T_0) * (tm_n - f32(1)) / f32(self.T_mult - 1)
            t_cur = step - start
            t_i = f32(self.T_0) * tm_n
        return f32(self.eta_min) + f32(self.base_lr - self.eta_min) * \
            (f32(1) + _cos(_PI * t_cur / t_i)) / f32(2)


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, frac, a, b):
        if self.anneal == "cos":
            return f32(b) + f32(a - b) * (f32(1) + _cos(_PI * frac)) / f32(2)
        return f32(a) + f32(b - a) * frac

    def value(self, step):
        step = f32(step)
        up_steps = self.phase_pct * self.total_steps
        down_steps = self.total_steps - up_steps
        if step < f32(up_steps):
            frac = np.clip(step / f32(max(up_steps, 1)), f32(0), f32(1))
            return self._interp(frac, self.initial_lr, self.max_lr)
        frac = np.clip((step - f32(up_steps)) / f32(max(down_steps, 1)),
                       f32(0), f32(1))
        return self._interp(frac, self.max_lr, self.end_lr)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up=2000, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.base_lr_ = base_learning_rate
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def value(self, step):
        step = f32(step)
        total = self.up + self.down
        cycle = np.floor(f32(1) + step / f32(total))
        x = step - (cycle - f32(1)) * f32(total)
        if x <= f32(self.up):
            frac = x / f32(self.up)
        else:
            frac = f32(1) - (x - f32(self.up)) / f32(self.down)
        amp = f32(self.max_lr - self.base_lr_)
        if self.mode == "triangular2":
            amp = amp / _pow(f32(2.0), cycle - f32(1))
        elif self.mode == "exp_range":
            amp = amp * _pow(f32(self.exp_gamma), step)
        return f32(self.base_lr_) + amp * frac


class ReduceOnPlateau(LRScheduler):
    """Driven by a metric through `step(metrics)`; eager only."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def _is_better(self, current, best):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < best * (1 - self.threshold)
            return current < best - self.threshold
        if self.threshold_mode == "rel":
            return current > best * (1 + self.threshold)
        return current > best + self.threshold

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        current = float(np.asarray(metrics.detach().cpu() if hasattr(
            metrics, "detach") else metrics))
        self.last_epoch += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.best is None or self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def value(self, step):
        return f32(self.last_lr)

    def get_lr(self):
        return self.last_lr
