"""Keyed random draws for dropout: the counterpart of `make_rng` and
`functional_call(rngs=...)` (`paddle_tpu/nn/layer.py`).

The JAX package installs a PRNG key for a traced forward and hands out
`fold_in(key, n)` for the n-th draw. Here `rng_context(*key)` installs
a key of integers (the Trainer's is (seed, step), or (seed, step,
microbatch) under gradient accumulation) and a call counter, and each
draw seeds a fresh `torch.Generator` with a hash of the key and the
counter. The port keeps no global random state: a draw outside a
context raises.

Why a fresh generator per draw: `torch.utils.checkpoint` restores only
the default generators when it recomputes a forward. A draw from a
long-lived explicit generator would give the recomputed forward
another mask and the gradients would be silently wrong. The Trainer
enters the context inside the checkpointed function, so the recompute
restarts the counter and draws the same masks. Masks equal JAX's in
law only (another generator), as the sampler's draws do.

Under a mesh (`nn.ranks`), a data rank's draw whose leading dim is its
batch rows is its rows of one draw over the global batch, as JAX draws
one mask for the global batch of a sharded step: every rank draws the
whole mask from the same seed and keeps its slice.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .. import core
from . import ranks

__all__ = ["rng_context", "next_seed", "keep_mask", "keep_mask_block",
           "normal", "uniform"]

class _RngState(threading.local):
    def __init__(self):
        self.key = None
        self.count = 0


_state = _RngState()


@contextlib.contextmanager
def rng_context(*key: int):
    """Install `key` (integers) for the draws inside, counter at 0; the
    previous key and counter come back on exit."""
    prev = (_state.key, _state.count)
    _state.key, _state.count = tuple(int(x) for x in key), 0
    try:
        yield
    finally:
        _state.key, _state.count = prev


def next_seed() -> int:
    """The seed of the next draw: a hash of the installed key and the
    call counter (then incremented). Raises outside `rng_context`."""
    if _state.key is None:
        raise RuntimeError(
            "a random draw (dropout in training) needs a key: run the "
            "forward under paddle_tpu_torch.nn.rng.rng_context(seed, step) "
            "(Trainer does this for every step)")
    h = core.hash_seed(*_state.key, _state.count)
    _state.count += 1
    return h


def keep_mask(prob: float, shape, device) -> torch.Tensor:
    """A bool tensor of `shape` on `device`, each entry True with
    probability `prob` (`jax.random.bernoulli`'s law: uniform < prob),
    from a generator seeded by `next_seed()`."""
    return _draw(shape, device) < prob


def keep_mask_block(prob: float, shape, device, block) -> torch.Tensor:
    """`keep_mask` for a tensor that is block r of n along dim of a
    larger one, `block` = (dim, r, n) (a tensor-parallel rank's heads
    of one attention): that block of the draw over the whole."""
    return _draw(shape, device, block) < prob


def normal(shape, device) -> torch.Tensor:
    """fp32 standard normals of `shape` from a generator seeded by
    `next_seed()` (an MoE gate's noise)."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(next_seed())
    return torch.randn(tuple(shape), generator=g, device=device)


def _draw(shape, device, block=None) -> torch.Tensor:
    """fp32 uniforms in [0, 1) of `shape` from a generator seeded by
    `next_seed()`; under a mesh a data rank's rows of the global
    batch's draw (`ranks.global_rows`), and with `block` (dim, r, n)
    block r of n along dim of the draw over the whole dim."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(next_seed())
    full, index = list(shape), [slice(None)] * len(shape)
    whole = ranks.global_rows(shape)
    if whole is not None:
        full[0] = whole[0][0]
        index[0] = slice(whole[1], whole[1] + whole[2])
    if block is not None and block[2] > 1:
        dim, r, n = block
        d = shape[dim]
        full[dim] = d * n
        index[dim] = slice(r * d, (r + 1) * d)
    out = torch.rand(tuple(full), generator=g, device=device)
    return out if list(full) == list(shape) else out[tuple(index)]


def uniform(shape, device, low: float = 0.0, high: float = 1.0
            ) -> torch.Tensor:
    """An fp32 tensor of `shape` on `device`, uniform in [low, high),
    from a generator seeded by `next_seed()` (`rrelu`'s slopes,
    `gumbel_softmax`'s noise)."""
    return low + (high - low) * _draw(shape, device)
