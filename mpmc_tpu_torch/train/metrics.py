"""Eval metrics on host arrays (copy of ``mpmc_tpu/train/metrics.py``):
the ROC curve and its Youden threshold, the in-loop threshold rule, and the
100-point threshold scans of the fold ensemble (binary F1 and macro-F1,
strict ``prob > t``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mpmc_tpu_torch.io.scorer import binary_f1, macro_f1


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


def threshold_scan(y_true: np.ndarray, y_prob: np.ndarray,
                   num: int = 100) -> Tuple[float, float]:
    """(best threshold, best binary F1) over ``np.linspace(0, 1, num)``."""
    thresholds = np.linspace(0, 1, num)
    y_true, y_prob = np.asarray(y_true), np.asarray(y_prob)
    scores = [binary_f1(y_true, (y_prob > t).astype(int))
              for t in thresholds]
    best = int(np.argmax(scores))
    return float(thresholds[best]), float(scores[best])


def macro_f1_threshold_scan(y_true: np.ndarray, y_prob: np.ndarray,
                            num: int = 100) -> Tuple[float, float]:
    """(best threshold, best macro-F1) over the same thresholds."""
    thresholds = np.linspace(0, 1, num)
    y_true, y_prob = np.asarray(y_true), np.asarray(y_prob)
    scores = [macro_f1(y_true, (y_prob > t).astype(int))
              for t in thresholds]
    best = int(np.argmax(scores))
    return float(thresholds[best]), float(scores[best])
