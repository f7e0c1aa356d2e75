"""Automatic mixed precision of the PyTorch/CUDA port: the counterpart
of `paddle_tpu/amp/__init__.py`.

`auto_cast` (O1) keeps the JAX package's thread-local white- and
black-list policy. Only the entry points that consult it cast: the
port's `nn.functional.linear` (op "linear"), as the JAX `linear` and
convolutions do. That is not `torch.autocast`, whose op list and cast
points differ (it runs `layer_norm` and softmax in fp32, among
others). `decorate` (O2) casts a model and turns on the optimizers'
fp32 master weights.

`GradScaler` is dynamic loss scaling for fp16: the pure functions
`init` / `scale_loss` / `unscale` / `update` over a state of 0-d
tensors on the device (no host sync), and the eager `scale` / `step` /
`minimize` / `state_dict` / `load_state_dict`, whose `step` reads
`found_inf` on the host to decide whether the optimizer runs.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

from .. import core

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "get_autocast_dtype", "white_op_hint", "nonfinite"]

_DEFAULT_WHITE = {"matmul", "linear", "conv1d", "conv2d", "conv3d",
                  "attention", "einsum", "bmm", "mm"}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white = set(_DEFAULT_WHITE)
        self.black = set()


_amp = _AmpState()


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1", dtype="bfloat16"):
    """Under O1 the white-list entry points cast their floating inputs
    to `dtype`; black-listed ops stay as they are."""
    prev = (_amp.enabled, _amp.dtype, _amp.level, _amp.white, _amp.black)
    _amp.enabled = enable
    _amp.dtype = core.resolve_dtype(dtype)
    _amp.level = level
    _amp.white = set(_DEFAULT_WHITE) | set(custom_white_list or ())
    _amp.black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_amp.enabled, _amp.dtype, _amp.level, _amp.white,
         _amp.black) = prev


amp_guard = auto_cast


def get_autocast_dtype(op: Optional[str] = None):
    """The compute dtype if autocast is on for `op`, else None: None for
    an op in the black list or outside the white list."""
    if not _amp.enabled:
        return None
    if op is not None and (op in _amp.black or op not in _amp.white):
        return None
    return _amp.dtype


def white_op_hint(*tensors, op: Optional[str] = None):
    """`tensors` with the floating ones cast to the autocast dtype (when
    it is on for `op`); everything else passes through."""
    dt = get_autocast_dtype(op)
    if dt is None:
        return tensors
    return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() else t for t in tensors)


def decorate(models, optimizers=None, level: str = "O2", dtype="bfloat16",
             master_weight: Optional[bool] = None, save_dtype=None):
    """O2: cast the models' floating parameters to `dtype` and give the
    optimizers fp32 master weights (multi_precision). Returns what it
    was given, as `(models, optimizers)` when optimizers are given."""
    dt = core.resolve_dtype(dtype)
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    opt_list = list(optimizers) if isinstance(optimizers, (list, tuple)) \
        else ([] if optimizers is None else [optimizers])
    if level == "O2":
        for m in model_list:
            m.to(dtype=dt)
        for o in opt_list:
            o.multi_precision = True if master_weight is None \
                else master_weight
    if optimizers is None:
        return models
    return models, optimizers


def nonfinite(tensors) -> torch.Tensor:
    """(len(tensors),) bool on the tensors' device: whether each holds a
    NaN or an inf. Per dtype group one `torch._foreach_norm` of order
    inf (max |x|, which is finite exactly when every entry is)."""
    norms = core.fp32_norms(tensors, float("inf"))
    return ~torch.isfinite(torch.stack(norms)) if norms else \
        torch.zeros(0, dtype=torch.bool)


class GradScaler:
    """Dynamic loss scaling (fp16), `update_loss_scaling`'s state
    machine: after `decr_every_n_nan_or_inf` overflowing steps in a row
    the scale is multiplied by `decr_ratio` (never below 1), after
    `incr_every_n_steps` clean ones by `incr_ratio`."""

    def __init__(self, enable: bool = True, init_loss_scaling: float = 2.**15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self.enable = enable
        self.init_loss_scaling = init_loss_scaling
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self.use_dynamic = use_dynamic_loss_scaling
        self._eager_state: Optional[Dict[str, torch.Tensor]] = None

    # --- pure API -----------------------------------------------------------
    def init(self, device=None) -> Dict[str, torch.Tensor]:
        """The state: `scale` (fp32), `good_steps` and `bad_steps`
        (int32), 0-d tensors on `device` (default: the card)."""
        dev = core.resolve_device(device)
        return {"scale": torch.tensor(self.init_loss_scaling,
                                      dtype=torch.float32, device=dev),
                "good_steps": torch.zeros((), dtype=torch.int32, device=dev),
                "bad_steps": torch.zeros((), dtype=torch.int32, device=dev)}

    def scale_loss(self, loss, state):
        if not self.enable:
            return loss
        return loss * state["scale"].to(loss.dtype)

    def unscale(self, grads: Dict[str, torch.Tensor], state
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(grads / scale, found_inf): each gradient multiplied in fp32
        by 1 / scale and rounded once to its dtype; found_inf a 0-d bool
        on the device, True when any unscaled entry is NaN or inf."""
        if not self.enable:
            dev = next(iter(grads.values())).device if grads else "cpu"
            return grads, torch.zeros((), dtype=torch.bool, device=dev)
        inv = 1.0 / state["scale"]
        names = list(grads)
        out = core.mul_fp32([grads[k] for k in names], inv)
        found = nonfinite(out).any() if out else \
            torch.zeros((), dtype=torch.bool, device=inv.device)
        return dict(zip(names, out)), found

    def update(self, state, found_inf):
        """The next state after a step whose gradients overflowed or not
        (device tensors in, device tensors out)."""
        if not self.enable or not self.use_dynamic:
            return state
        zero = torch.zeros_like(state["good_steps"])
        good = torch.where(found_inf, zero, state["good_steps"] + 1)
        bad = torch.where(found_inf, state["bad_steps"] + 1, zero)
        grow = good >= self.incr_every_n_steps
        shrink = bad >= self.decr_every_n_nan_or_inf
        scale = torch.where(grow, state["scale"] * self.incr_ratio,
                            state["scale"])
        scale = torch.where(shrink, torch.clamp(
            state["scale"] * self.decr_ratio, min=1.0), scale)
        return {"scale": scale, "good_steps": torch.where(grow, zero, good),
                "bad_steps": torch.where(shrink, zero, bad)}

    # --- eager API ----------------------------------------------------------
    def _state_on(self, device):
        if self._eager_state is None:
            self._eager_state = self.init(device)
        return self._eager_state

    def scale(self, var):
        return self.scale_loss(var, self._state_on(var.device))

    def is_enable(self):
        return self.enable

    def is_use_dynamic_loss_scaling(self):
        return self.use_dynamic

    def get_loss_scaling(self):
        if self._eager_state is None:
            return float(self.init_loss_scaling)
        return float(self._eager_state["scale"])

    def state_dict(self):
        return dict(self._eager_state or {})

    def load_state_dict(self, state):
        self._eager_state = {k: torch.as_tensor(v) for k, v in state.items()}

    def step(self, optimizer, grads):
        """Unscale `grads`, step `optimizer` unless they overflowed (one
        host read of found_inf), update the scale."""
        dev = next(iter(grads.values())).device
        state = self._state_on(dev)
        grads, found_inf = self.unscale(grads, state)
        if not bool(found_inf):
            optimizer.step(grads)
        self._eager_state = self.update(state, found_inf)

    def minimize(self, optimizer, loss, grads=None):
        if grads is not None:
            self.step(optimizer, grads)

    def update_(self):
        pass
