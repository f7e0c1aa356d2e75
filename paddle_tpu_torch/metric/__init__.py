"""Metrics: `Metric` and `Accuracy`, the counterparts of
`paddle_tpu/metric/__init__.py`. Host-side numpy accumulation: a step's
predictions (a tensor on any device, bf16 included, or an array) come
to the host once in `compute`."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype != torch.float64:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        """Pre-processing of a step's outputs; default pass-through."""
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy for each k of `topk`; labels as class ids, a
    trailing 1 column or one-hot rows."""

    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred, label = _np(pred), _np(label)
        order = np.argsort(-pred, axis=-1)[..., :max(self.topk)]
        if label.ndim == pred.ndim:
            label = label[..., 0] if label.shape[-1] == 1 \
                else label.argmax(-1)
        return order == label[..., None]

    def update(self, correct):
        correct = _np(correct)
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(-1)
            self.total[i] += c.sum()
            self.count[i] += c.size
        num = self.total / np.maximum(self.count, 1)
        return num[0] if len(self.topk) == 1 else num

    def accumulate(self):
        acc = self.total / np.maximum(self.count, 1)
        return float(acc[0]) if len(self.topk) == 1 else acc.tolist()

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]
