"""Named random streams for parallel code: the counterpart of
`paddle_tpu/parallel/random_.py` (the reference's RNGStatesTracker,
fleet/meta_parallel/parallel_layers/random.py:32).

The port keeps no global random state: a draw reads the key installed
by `nn.rng.rng_context`. A tracker's stream is a seed and a counter;
`rng_state(name)` installs (seed, counter) for the draws inside and
moves the counter on, as JAX splits the stream's key.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

from ..nn.rng import rng_context

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]


class RNGStatesTracker:
    def __init__(self):
        self.states: Dict[str, Tuple[int, int]] = {}

    def reset(self):
        self.states = {}

    def add(self, name: str, seed: int):
        if name in self.states:
            raise ValueError(f"state {name!r} already exists")
        self.states[name] = (int(seed), 0)

    def get_states_tracker(self):
        return dict(self.states)

    def set_states_tracker(self, states):
        self.states = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name: str = "model_parallel_rng"):
        """Within the context, dropout draws from the named stream."""
        if name not in self.states:
            raise ValueError(f"unknown rng state {name!r}")
        seed, n = self.states[name]
        self.states[name] = (seed, n + 1)
        with rng_context(seed, n):
            yield


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed: int = 0):
    """The reference's seeds: a shared "global_seed" stream (100003 +
    seed) and a local "model_parallel_rng" one (seed + 1024 + the
    process rank, 0 in one process). JAX also reseeds its global
    generator with the shared seed; the port has none."""
    _tracker.reset()
    global_seed = 100003 + seed
    local_seed = seed + 1024
    _tracker.add("model_parallel_rng", local_seed)
    _tracker.add("global_seed", global_seed)
