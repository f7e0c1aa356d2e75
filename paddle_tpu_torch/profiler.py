"""The profiler's stats-provider registry and the ips timer.

The counterpart of the registry part and of `TimeAverager` /
`Benchmark` of `paddle_tpu/profiler/__init__.py` (its `Profiler` window
and `record_span` are not ported yet; ROADMAP.md, Queue 1 item 13).
`Benchmark` times the steps of a training loop on the host's clock
(`hapi.Model.fit` reads images per second from it); a step's time is
honest only when the step ends in a host sync, as `fit`'s does (it
reads the loss). Long-running subsystems (`serving.LLMEngine` first)
register a zero-argument callable returning a flat numeric dict under a
name; `custom_stats()` snapshots every provider, so one surface carries
the serving counters without the caller holding an engine, and
`obs.prometheus.registry_exposition` renders them.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

__all__ = ["register_stats_provider", "unregister_stats_provider",
           "custom_stats", "TimeAverager", "Benchmark", "benchmark"]

_STATS_PROVIDERS: Dict[str, Callable[[], Dict[str, float]]] = {}


def register_stats_provider(name: str, fn: Callable[[], Dict[str, float]]):
    """Register `fn` (-> flat numeric dict) under `name`; registering a
    name again replaces the previous provider."""
    if not callable(fn):
        raise TypeError(f"stats provider {name!r} must be callable")
    _STATS_PROVIDERS[name] = fn


def unregister_stats_provider(name: str):
    _STATS_PROVIDERS.pop(name, None)


def custom_stats() -> Dict[str, Dict[str, float]]:
    """{provider name: snapshot} over every registered provider. A
    provider that raises reports {"error": repr(e)} instead of taking
    the others (or a serving loop) down."""
    out: Dict[str, Dict[str, float]] = {}
    for name, fn in list(_STATS_PROVIDERS.items()):
        try:
            out[name] = dict(fn())
        except Exception as e:  # noqa: BLE001 — a broken provider must
            # never take the stats surface down
            out[name] = {"error": repr(e)}  # type: ignore[dict-item]
    return out


class TimeAverager:
    """A running average of step times and samples."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._count = 0
        self._total_samples = 0

    def record(self, elapsed: float, num_samples: Optional[int] = None):
        self._total += elapsed
        self._count += 1
        if num_samples:
            self._total_samples += num_samples

    def get_average(self) -> float:
        return self._total / self._count if self._count else 0.0

    def get_ips_average(self) -> float:
        return self._total_samples / self._total if self._total else 0.0

    @property
    def count(self):
        return self._count


class Benchmark:
    """Steps per second and samples per second: `begin()` once,
    `step(batch_size)` after each step, `end()` to finish; `report()`
    gives {steps, avg_step_s, ips}. The first `skip_steps` steps after a
    begin are left out (warm-up: the first calls build cuDNN plans and
    fill the allocator's cache); `pause()` keeps work between steps
    (eval, checkpoints) out of the next step's time."""

    def __init__(self, skip_steps: int = 2):
        self.skip_steps = skip_steps
        self._avg = TimeAverager()
        self._seen = 0
        self._t_last: Optional[float] = None
        self.active = False

    def begin(self):
        self._seen = 0
        self._avg.reset()
        self.active = True
        self._t_last = time.perf_counter()

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._t_last is None:
            self._t_last = now
            return
        elapsed = now - self._t_last
        self._t_last = now
        self._seen += 1
        if self._seen > self.skip_steps:
            self._avg.record(elapsed, num_samples)

    def pause(self):
        self._t_last = None

    def end(self):
        self._t_last = None
        self.active = False

    def report(self) -> Dict[str, float]:
        return {"steps": self._avg.count,
                "avg_step_s": self._avg.get_average(),
                "ips": self._avg.get_ips_average()}


_BENCHMARK = Benchmark()


def benchmark() -> Benchmark:
    """The process's shared Benchmark (what a bare `fit` reports to)."""
    return _BENCHMARK
