"""Eval metrics on host arrays (copy of ``roc_curve`` and
``optimal_threshold_youden`` in ``mpmc_tpu/train/metrics.py`` and of
``accuracy_score`` / ``macro_f1`` in ``mpmc_tpu/io/scorer.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def roc_curve(y_true: np.ndarray, y_score: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC points at each distinct score (descending), sklearn semantics:
    thresholds start at +inf; collinear points are kept (a superset of
    sklearn's thinned curve with the same Youden argmax)."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(-y_score, kind="stable")
    y_true = y_true[order]
    y_score = y_score[order]
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    P = max(y_true.sum(), 1)
    N = max((~y_true).sum(), 1)
    tpr = np.r_[0.0, tps / P]
    fpr = np.r_[0.0, fps / N]
    thresholds = np.r_[np.inf, y_score[idx]]
    return fpr, tpr, thresholds


def optimal_threshold_youden(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """argmax(tpr - fpr) over the ROC thresholds."""
    fpr, tpr, thr = roc_curve(y_true, y_score)
    return float(thr[int(np.argmax(tpr - fpr))])


def accuracy_score(gold: np.ndarray, pred: np.ndarray) -> float:
    return float(np.mean(gold == pred))


def macro_f1(gold: np.ndarray, pred: np.ndarray,
             classes: Sequence[int] = (0, 1)) -> float:
    """Mean per-class F1 with sklearn's zero-division-to-0 convention."""
    gold, pred = np.asarray(gold), np.asarray(pred)
    fs = []
    for c in classes:
        tp = int(np.sum((pred == c) & (gold == c)))
        fp = int(np.sum((pred == c) & (gold != c)))
        fn = int(np.sum((pred != c) & (gold == c)))
        p = tp / (tp + fp) if (tp + fp) else 0.0
        r = tp / (tp + fn) if (tp + fn) else 0.0
        fs.append(2 * p * r / (p + r) if (p + r) else 0.0)
    return float(np.mean(fs))
