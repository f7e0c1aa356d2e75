"""fleet.metrics: metrics summed over workers, the counterpart of
`paddle_tpu/parallel/fleet_metrics.py` (the reference's
fleet/metrics/metric.py: sum / max / min / acc / mae / rmse / auc over
the trainers' local statistics).

The transport is the host collective (`collective.host_all_gather`);
the port runs one process, where it is the identity, so the same code
gives the global metric once several processes exist (ROADMAP Queue 1
item 13.4, step 6). `DistributedMetric` wraps a `metric.Metric`: its
`accumulate` sums the metric's additive statistics over the workers
first; `merged_accumulate` is the same merge over metric objects of
one process (per-rank eval loops).
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np

from ..metric import Accuracy, Auc, Metric, Precision, Recall
from .collective import host_all_gather

__all__ = ["sum", "max", "min", "acc", "mae", "rmse", "auc",
           "DistributedMetric", "merged_accumulate"]

# additive sufficient statistics of each built-in metric
_STATE_ATTRS = {
    Accuracy: ("total", "count"),
    Precision: ("tp", "fp"),
    Recall: ("tp", "fn"),
    Auc: ("_stat_pos", "_stat_neg"),
}


def _allreduce(x, op: str = "sum"):
    """A host statistic reduced over the processes (one here)."""
    parts = np.asarray(host_all_gather(np.asarray(x, np.float64)))
    if op == "sum":
        return parts.sum(axis=0)
    if op == "max":
        return parts.max(axis=0)
    if op == "min":
        return parts.min(axis=0)
    raise ValueError(f"unknown op {op}")


# --- reference module functions (fleet/metrics/metric.py names) ---------- #

def sum(x):  # noqa: A001 - reference API name
    return _allreduce(x, "sum")


def max(x):  # noqa: A001
    return _allreduce(x, "max")


def min(x):  # noqa: A001
    return _allreduce(x, "min")


def acc(correct, total) -> float:
    """Global accuracy from per-worker (correct, total) counts."""
    c = float(np.asarray(_allreduce(correct)).sum())
    t = float(np.asarray(_allreduce(total)).sum())
    return c / t if t else 0.0


def mae(abserr, total) -> float:
    e = float(np.asarray(_allreduce(abserr)).sum())
    t = float(np.asarray(_allreduce(total)).sum())
    return e / t if t else 0.0


def rmse(sqrerr, total) -> float:
    e = float(np.asarray(_allreduce(sqrerr)).sum())
    t = float(np.asarray(_allreduce(total)).sum())
    return float(np.sqrt(e / t)) if t else 0.0


def auc(stat_pos, stat_neg) -> float:
    """Global ROC AUC from the workers' positive / negative bucket
    histograms (the statistics `metric.Auc` keeps)."""
    pos = np.asarray(_allreduce(stat_pos))
    neg = np.asarray(_allreduce(stat_neg))
    m = Auc(num_thresholds=pos.shape[-1] - 1)
    m._stat_pos = pos
    m._stat_neg = neg
    return m.accumulate()


# --- metric-object surface ----------------------------------------------- #

def _state_attrs(metric: Metric) -> Sequence[str]:
    for cls, attrs in _STATE_ATTRS.items():
        if isinstance(metric, cls):
            return attrs
    attrs = getattr(metric, "_dist_state_attrs", None)
    if attrs is None:
        raise TypeError(
            f"{type(metric).__name__} has no known additive state; set "
            f"`_dist_state_attrs` on the class to the attribute names "
            f"accumulate() sums over")
    return attrs


def merged_accumulate(metrics: Sequence[Metric]):
    """accumulate() over the union of several metric objects' data: the
    merge DistributedMetric applies over workers, for one process
    (per-rank eval loops)."""
    base = copy.deepcopy(metrics[0])
    for attr in _state_attrs(base):
        total = np.asarray(getattr(metrics[0], attr), np.float64)
        for m in metrics[1:]:
            total = total + np.asarray(getattr(m, attr), np.float64)
        v = getattr(metrics[0], attr)
        setattr(base, attr, type(v)(total) if isinstance(v, (int, float))
                else total)
    return base.accumulate()


class DistributedMetric(Metric):
    """A metric over the workers' local updates (for hapi
    `Model.prepare(metrics=...)`): compute / update run on the worker's
    results; accumulate() sums the statistics over the workers first."""

    def __init__(self, inner: Metric):
        super().__init__(getattr(inner, "_name", None))
        _state_attrs(inner)  # fail fast on unsupported metrics
        self.inner = inner

    def reset(self):
        self.inner.reset()

    def compute(self, pred, label, *args):
        return self.inner.compute(pred, label, *args)

    def update(self, *args):
        return self.inner.update(*args)

    def accumulate(self):
        merged = copy.deepcopy(self.inner)
        for attr in _state_attrs(self.inner):
            v = getattr(self.inner, attr)
            red = _allreduce(v)
            setattr(merged, attr,
                    type(v)(red) if isinstance(v, (int, float)) else red)
        return merged.accumulate()

    def name(self):
        return self.inner.name()
