"""Metrics (counterpart of ``paddle_tpu/metric``; parity:
python/paddle/metric/ — Metric ABC, Accuracy, Precision, Recall, Auc).

They take tensors on any device (or arrays) and accumulate on the host
in numpy, as the JAX metrics do."""

from __future__ import annotations

import numpy as np
import torch

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _host(x):
    """``x`` as a numpy array: a tensor is detached and copied to the host
    (bf16 and other dtypes numpy lacks as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.is_floating_point() and x.dtype not in (torch.float32,
                                                     torch.float64):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return type(self).__name__.lower()


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.correct = np.zeros(len(self.topk))
        self.total = 0

    def compute(self, pred, label):
        pred = _host(pred)
        label = _host(label)
        k = max(self.topk)
        top = np.argsort(-pred, axis=-1)[..., :k]
        if label.ndim == pred.ndim:  # one-hot
            label = label.argmax(-1)
        return top == label[..., None]

    def update(self, correct_or_pred, label=None):
        if label is not None:
            corrects = self.compute(correct_or_pred, label)
        else:
            corrects = _host(correct_or_pred)
        n = int(np.prod(corrects.shape[:-1]))
        for i, k in enumerate(self.topk):
            self.correct[i] += corrects[..., :k].any(-1).sum()
        self.total += n
        return self.accumulate()

    def accumulate(self):
        accs = [
            float(c / self.total) if self.total else 0.0 for c in self.correct
        ]
        return accs[0] if len(accs) == 1 else accs

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_host(preds) > 0.5).astype(int).ravel()
        labels = _host(labels).astype(int).ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp / denom) if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_host(preds) > 0.5).astype(int).ravel()
        labels = _host(labels).astype(int).ravel()
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp / denom) if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC-AUC via threshold bucketing (parity: paddle.metric.Auc)."""

    def __init__(self, num_thresholds=4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1)
        self._neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _host(preds)
        if preds.ndim == 2:  # [n, 2] probs
            preds = preds[:, 1]
        labels = _host(labels).ravel()
        idx = np.clip(
            (preds.ravel() * self.num_thresholds).astype(int), 0,
            self.num_thresholds,
        )
        np.add.at(self._pos, idx[labels == 1], 1)
        np.add.at(self._neg, idx[labels == 0], 1)

    def accumulate(self):
        tot_pos = self._pos.sum()
        tot_neg = self._neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate TPR over FPR from the highest threshold down
        pos = self._pos[::-1].cumsum()
        neg = self._neg[::-1].cumsum()
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name
