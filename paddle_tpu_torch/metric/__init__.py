"""Metrics: `Metric`, `Accuracy`, `Precision`, `Recall`, `Auc` and the
functional `accuracy`, the counterparts of
`paddle_tpu/metric/__init__.py`. Host-side numpy accumulation: a step's
predictions (a tensor on any device, bf16 included, or an array) come
to the host once in `compute` / `update`. Each metric keeps additive
sufficient statistics (Accuracy: total, count; Precision: tp, fp;
Recall: tp, fn; Auc: the positive and negative bucket histograms),
which `parallel.fleet_metrics` sums over workers."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc",
           "accuracy"]


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


class Precision(Metric):
    """Binary precision of scores thresholded at 0.5."""

    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp / denom) if denom else 0.0


class Recall(Metric):
    """Binary recall of scores thresholded at 0.5."""

    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        labels = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp / denom) if denom else 0.0


class Auc(Metric):
    """ROC AUC over `num_thresholds` + 1 score buckets: each score adds
    one to its bucket's positive or negative count; `accumulate` sums
    the trapezoids from the highest bucket down."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2:                      # [neg_prob, pos_prob]
            preds = preds[:, -1]
        labels = _np(labels).reshape(-1)
        buckets = np.clip((preds * self.num_thresholds).astype(np.int64),
                          0, self.num_thresholds).reshape(-1)
        pos = labels.astype(bool)
        self._stat_pos += np.bincount(buckets[pos],
                                      minlength=self.num_thresholds + 1)
        self._stat_neg += np.bincount(buckets[~pos],
                                      minlength=self.num_thresholds + 1)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def accumulate(self):
        # from the highest bucket down, as the reference's loop
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = pos[-1], neg[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        prev_pos = np.concatenate([[0.0], pos[:-1]])
        prev_neg = np.concatenate([[0.0], neg[:-1]])
        auc = np.sum(np.abs(neg - prev_neg) * (pos + prev_pos) / 2.0)
        return float(auc / (tot_pos * tot_neg))


def accuracy(input, label, k=1):
    """Top-k accuracy of one batch as a 0-d fp32 tensor
    (paddle.metric.accuracy); labels as ids or a trailing 1 column."""
    input = torch.as_tensor(input)
    label = torch.as_tensor(label, device=input.device)
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    topk = torch.argsort(-input, dim=-1, stable=True)[..., :k]
    correct = (topk == label[..., None]).any(dim=-1)
    return correct.to(torch.float32).mean()
