"""The profiler's stats-provider registry.

The counterpart of the registry part of `paddle_tpu/profiler/__init__.py`
(its `Profiler` window and `record_span` are not ported yet; ROADMAP.md,
Queue 1 item 13). Long-running subsystems (`serving.LLMEngine` first)
register a zero-argument callable returning a flat numeric dict under a
name; `custom_stats()` snapshots every provider, so one surface carries
the serving counters without the caller holding an engine, and
`obs.prometheus.registry_exposition` renders them.
"""
from __future__ import annotations

from typing import Callable, Dict

__all__ = ["register_stats_provider", "unregister_stats_provider",
           "custom_stats"]

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
