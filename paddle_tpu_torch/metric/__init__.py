"""``paddle.metric`` of the port (counterpart of
``paddle_tpu/metric/__init__.py``): the streaming metrics ``Metric``,
``Accuracy``, ``Precision``, ``Recall`` and ``Auc``, accumulated on the
host in numpy as the JAX package accumulates them (``Accuracy.compute``
ranks with ``np.argsort(-pred)``, so ties rank the same in both
packages), and the functional ``accuracy`` (top-k through the port's
``topk`` rule: among equal scores the lower index first, as
``lax.top_k``). ``chunk_eval`` and ``DetectionMAP`` are still to port
(ROADMAP).
"""
from __future__ import annotations

import abc

import numpy as np

from ..core.tensor import Tensor


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, Tensor) else x)


class Metric(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        """Device-side pre-computation; default passthrough."""
        return args if len(args) > 1 else args[0]


class Accuracy(Metric):
    """Top-k accuracy (reference metrics.py Accuracy:181)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        if label_np.ndim == pred_np.ndim:
            if label_np.shape[-1] == pred_np.shape[-1]:
                # one-hot / soft label
                label_np = np.argmax(label_np, axis=-1)
            else:
                # conventional [B, 1] class-index column (reference
                # Accuracy treats this as indices, not one-hot)
                label_np = label_np[..., 0]
        correct = (idx == label_np[..., None]).astype(np.float32)
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        for k in self.topk:
            num = correct[..., :k].sum()
            accs.append(num / max(correct.shape[0], 1))
            self.total[self.topk.index(k)] += num
            self.count[self.topk.index(k)] += correct.shape[0]
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    """Binary precision (reference metrics.py Precision:310)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        pred_pos = (preds.reshape(-1) > 0.5)
        lab = labels.reshape(-1).astype(bool)
        self.tp += int(np.sum(pred_pos & lab))
        self.fp += int(np.sum(pred_pos & ~lab))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall (reference metrics.py Recall:408)."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        pred_pos = (preds.reshape(-1) > 0.5)
        lab = labels.reshape(-1).astype(bool)
        self.tp += int(np.sum(pred_pos & lab))
        self.fn += int(np.sum(~pred_pos & lab))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via thresholded confusion bins (reference metrics.py
    Auc:481, the '_stat' histogram approach)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = labels.reshape(-1)
        bins = np.clip((preds * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        pos = labels.astype(bool)
        self._stat_pos += np.bincount(bins[pos],
                                      minlength=self.num_thresholds + 1)
        self._stat_neg += np.bincount(bins[~pos],
                                      minlength=self.num_thresholds + 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # integrate TPR over FPR from the highest threshold down,
        # anchored at the (0, 0) origin so saturated/degenerate score
        # distributions still integrate the full curve
        pos = np.concatenate([[0], self._stat_pos[::-1].cumsum()])
        neg = np.concatenate([[0], self._stat_neg[::-1].cumsum()])
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy as a float32 scalar Tensor: a row is correct when its
    label is among its k highest scores."""
    import torch

    from ..core import dispatch
    from ..core.tensor import as_tensor

    it = input if isinstance(input, Tensor) else as_tensor(input)
    lt = label if isinstance(label, Tensor) else as_tensor(label)

    def f(a, y):
        top = torch.sort(a, dim=-1, descending=True, stable=True).indices
        top = top[..., :k]
        hit = (top == y.reshape(-1, 1).to(top.dtype)).any(dim=1)
        return hit.float().mean()
    return dispatch.call("metric_accuracy", f, [it, lt],
                         differentiable_mask=[False, False])
