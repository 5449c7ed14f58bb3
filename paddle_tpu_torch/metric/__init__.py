"""``paddle.metric`` of the port (counterpart of
``paddle_tpu/metric/__init__.py``): the streaming metrics ``Metric``,
``Accuracy``, ``Precision``, ``Recall`` and ``Auc``, accumulated on the
host in numpy as the JAX package accumulates them (``Accuracy.compute``
ranks with ``np.argsort(-pred)``, so ties rank the same in both
packages), and the functional ``accuracy`` (top-k through the port's
``topk`` rule: among equal scores the lower index first, as
``lax.top_k``), and the host-side ``chunk_eval`` (chunk precision,
recall and F1 of IOB/IOE/IOBES/plain tags) and ``DetectionMAP`` (VOC
mAP, integral or 11-point, with difficult flags), the JAX package's
numpy.
"""
from __future__ import annotations

import abc
import collections

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


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk-level precision/recall/F1 for sequence labeling (NER).

    The tag of chunk type t is ``t * tag_num + pos``: for IOB pos is B=0,
    I=1; for IOE I=0, E=1; for IOBES B, I, E, S; "plain" has one tag a
    type. Tags outside ``num_chunk_types * tag_num`` are O. Returns
    (precision, recall, f1, num_infer, num_label, num_correct) as
    one-element Tensors, fp32 and int32 (as in the JAX package, whose
    int64 is int32).
    """
    from ..core.tensor import as_tensor

    schemes = {"IOB": ["B", "I"], "IOE": ["I", "E"],
               "IOBES": ["B", "I", "E", "S"], "plain": ["U"]}
    if chunk_scheme not in schemes:
        raise ValueError(f"unknown chunk_scheme {chunk_scheme}")
    tags = schemes[chunk_scheme]
    tag_num = len(tags)
    excluded = set(excluded_chunk_types or ())

    def decode(seq):
        """token tags -> set of (start, end, type) chunks"""
        chunks = []
        start = None
        cur_type = None
        for i, t in enumerate(list(seq) + [-1]):
            if t < 0 or t >= num_chunk_types * tag_num:
                pos, typ = None, None
            else:
                typ, pos = divmod(int(t), tag_num)
                pos = tags[pos]
            if chunk_scheme == "plain":
                if typ is not None:
                    if cur_type == typ:
                        pass  # continues
                    else:
                        if start is not None:
                            chunks.append((start, i - 1, cur_type))
                        start, cur_type = i, typ
                else:
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start = cur_type = None
                continue
            begin = pos in ("B", "S") or (chunk_scheme == "IOE" and pos == "I"
                                          and cur_type != typ)
            inside = pos in ("I",) and cur_type == typ and start is not None
            if chunk_scheme == "IOB":
                if pos == "B" or (pos == "I" and not inside):
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start, cur_type = i, typ
                elif pos == "I":
                    pass
                else:
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start = cur_type = None
            elif chunk_scheme == "IOE":
                if start is None or cur_type != typ:
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start, cur_type = (i, typ) if typ is not None else (None, None)
                if pos == "E" and start is not None:
                    chunks.append((start, i, cur_type))
                    start = cur_type = None
            else:  # IOBES
                if pos == "S":
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    chunks.append((i, i, typ))
                    start = cur_type = None
                elif pos == "B":
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start, cur_type = i, typ
                elif pos == "I" and cur_type == typ and start is not None:
                    pass
                elif pos == "E" and cur_type == typ and start is not None:
                    chunks.append((start, i, cur_type))
                    start = cur_type = None
                else:
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start = cur_type = None
        return {c for c in chunks if c[2] not in excluded}

    inp = _np(input)
    lab = _np(label)
    if inp.ndim == 1:
        inp, lab = inp[None], lab[None]
    sl = (_np(seq_length).ravel() if seq_length is not None
          else np.full(inp.shape[0], inp.shape[1], np.int64))
    n_inf = n_lab = n_cor = 0
    for b in range(inp.shape[0]):
        ic = decode(inp[b, :sl[b]])
        lc = decode(lab[b, :sl[b]])
        n_inf += len(ic)
        n_lab += len(lc)
        n_cor += len(ic & lc)
    prec = n_cor / n_inf if n_inf else 0.0
    rec = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    def mk(v, dt):
        return as_tensor(np.asarray([v], dtype=dt))
    return (mk(prec, np.float32), mk(rec, np.float32), mk(f1, np.float32),
            mk(n_inf, np.int64), mk(n_lab, np.int64), mk(n_cor, np.int64))


class DetectionMAP:
    """VOC mean average precision over detection results.

    update() takes per-image detections (M, 6) [label, score, x1, y1, x2,
    y2] and ground truths (G, 5) [label, x1, y1, x2, y2] (+ optional
    difficult flags); accumulate() returns mAP under 'integral' or
    '11point' AP.
    """

    def __init__(self, class_num, overlap_threshold=0.5,
                 evaluate_difficult=False, ap_version="integral"):
        if ap_version not in ("integral", "11point"):
            raise ValueError(f"unknown ap_version {ap_version}")
        self.class_num = class_num
        self.thr = overlap_threshold
        self.eval_difficult = evaluate_difficult
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._scores = collections.defaultdict(list)  # cls -> [(score, tp)]
        self._npos = collections.defaultdict(int)

    @staticmethod
    def _iou(a, b):
        ix1 = np.maximum(a[0], b[0]); iy1 = np.maximum(a[1], b[1])
        ix2 = np.minimum(a[2], b[2]); iy2 = np.minimum(a[3], b[3])
        inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, gt, difficult=None):
        det = _np(detections)
        gtn = _np(gt)
        diff = (_np(difficult).ravel().astype(bool)
                if difficult is not None
                else np.zeros(gtn.shape[0], bool))
        for c in range(self.class_num):
            gidx = np.nonzero(gtn[:, 0].astype(int) == c)[0]
            if not self.eval_difficult:
                self._npos[c] += int((~diff[gidx]).sum())
            else:
                self._npos[c] += len(gidx)
            dets_c = det[det[:, 0].astype(int) == c]
            order = np.argsort(-dets_c[:, 1])
            matched = set()
            for di in order:
                drow = dets_c[di]
                best, best_g = 0.0, -1
                for g in gidx:
                    ov = self._iou(drow[2:6], gtn[g, 1:5])
                    if ov > best:
                        best, best_g = ov, g
                if best >= self.thr and best_g not in matched:
                    if diff[best_g] and not self.eval_difficult:
                        continue  # difficult gt: ignore the detection
                    matched.add(best_g)
                    self._scores[c].append((float(drow[1]), 1))
                else:
                    self._scores[c].append((float(drow[1]), 0))

    def accumulate(self):
        aps = []
        for c in range(self.class_num):
            npos = self._npos[c]
            if npos == 0 and not self._scores[c]:
                continue
            if not self._scores[c]:
                aps.append(0.0)
                continue
            rows = sorted(self._scores[c], key=lambda r: -r[0])
            tp = np.cumsum([r[1] for r in rows])
            fp = np.cumsum([1 - r[1] for r in rows])
            rec = tp / max(npos, 1)
            prec = tp / np.maximum(tp + fp, 1e-12)
            if self.ap_version == "11point":
                ap = 0.0
                for t in np.linspace(0, 1, 11):
                    p = prec[rec >= t].max() if (rec >= t).any() else 0.0
                    ap += p / 11
            else:
                mrec = np.concatenate([[0], rec, [1]])
                mpre = np.concatenate([[0], prec, [0]])
                for i in range(mpre.size - 2, -1, -1):
                    mpre[i] = max(mpre[i], mpre[i + 1])
                idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
                ap = float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "chunk_eval", "DetectionMAP"]


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
