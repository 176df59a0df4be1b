"""Fold ensembling (copy of ``mpmc_tpu/cv/ensemble.py``, the reference's
``combine_preds.py``) over per-fold probability TSVs read as dicts:

* ``majority_voting``: each fold binarized at 0.5, then the per-id mode;
* ``average_probability``: the per-id mean probability, or of log-odds;
* ``group_average`` and ``family_weight_scan``: averages per run-id family
  and the blend weight of two families;
* ``threshold_optimization``: the 100-point threshold scan on the gold
  labels (binary F1, macro-F1) or the Youden threshold.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Sequence, Tuple

import numpy as np

from mpmc_tpu_torch.io.scorer import macro_f1
from mpmc_tpu_torch.train.metrics import (macro_f1_threshold_scan,
                                          optimal_threshold_youden,
                                          threshold_scan)

FoldPreds = Dict[str, float]  # id -> propaganda probability


def _logit(p: float) -> float:
    p = min(max(p, 1e-6), 1 - 1e-6)
    return float(np.log(p / (1 - p)))


def _sigmoid(x: float) -> float:
    return float(1 / (1 + np.exp(-x)))


def majority_voting(folds: Sequence[FoldPreds]) -> Dict[str, str]:
    """Each fold's label at prob > 0.5, then the per-id modal label; a tie
    goes to the lexicographically first label (pandas ``mode``)."""
    out = {}
    for i in folds[0]:
        votes = ["propaganda" if f[i] > 0.5 else "not_propaganda"
                 for f in folds]
        counts = Counter(votes)
        top = max(counts.values())
        out[i] = sorted(label for label, c in counts.items() if c == top)[0]
    return out


def average_probability(folds: Sequence[FoldPreds],
                        space: str = "prob") -> FoldPreds:
    """Per-id mean probability; ``space='logit'`` averages the log-odds
    (the geometric mean of the odds) instead."""
    ids = list(folds[0].keys())
    if space == "logit":
        return {i: _sigmoid(float(np.mean([_logit(f[i]) for f in folds])))
                for i in ids}
    return {i: float(np.mean([f[i] for f in folds])) for i in ids}


def group_average(folds: Sequence[FoldPreds], groups: Sequence[str],
                  space: str = "prob") -> Dict[str, FoldPreds]:
    """The average of each group (model family, typically the TSV run id)
    of members, keyed by group in order of first appearance."""
    out: Dict[str, list] = {}
    for f, g in zip(folds, groups):
        out.setdefault(g, []).append(f)
    return {g: average_probability(fs, space=space) for g, fs in out.items()}


def family_weight_scan(a: FoldPreds, b: FoldPreds, gold: Dict[str, str],
                       num: int = 101, metric: str = "macro",
                       space: str = "prob"
                       ) -> Tuple[FoldPreds, float, float]:
    """(blended probs, weight, best F1): the weight ``w`` of ``w * a + (1 -
    w) * b`` over ``num`` points in [0, 1], the threshold re-fit at each;
    ``space='logit'`` blends log-odds."""
    if set(a) != set(b):
        only_a, only_b = set(a) - set(b), set(b) - set(a)
        raise ValueError(
            "family id sets differ — the members were predicted on "
            f"different manifests ({len(only_a)} ids only in the first "
            f"family, {len(only_b)} only in the second)")
    ids = list(a.keys())
    if space == "logit":
        la = {i: _logit(a[i]) for i in ids}
        lb = {i: _logit(b[i]) for i in ids}

        def blend_at(w):
            return {i: _sigmoid(w * la[i] + (1 - w) * lb[i]) for i in ids}
    else:
        def blend_at(w):
            return {i: float(w * a[i] + (1 - w) * b[i]) for i in ids}

    best: Tuple[float, float] = (-1.0, 0.5)
    for w in np.linspace(0.0, 1.0, num):
        _, _, f1 = threshold_optimization(blend_at(w), gold, metric=metric)
        if f1 > best[0]:
            best = (f1, float(w))
    f1, w = best
    return blend_at(w), w, f1


def threshold_optimization(preds: FoldPreds, gold: Dict[str, str],
                           num: int = 100, metric: str = "binary"
                           ) -> Tuple[Dict[str, str], float, float]:
    """(labels, threshold, F1).  ``binary``: the reference's scan for the
    best positive-class F1; ``macro``: the same scan for macro-F1;
    ``youden``: no scan, the ROC Youden threshold of the in-loop eval,
    scored by macro-F1."""
    ids = list(preds.keys())
    y_true = np.array([1 if gold[i] == "propaganda" else 0 for i in ids])
    y_prob = np.array([preds[i] for i in ids])
    if metric == "binary":
        thr, f1 = threshold_scan(y_true, y_prob, num)
    elif metric == "youden":
        thr = optimal_threshold_youden(y_true, y_prob)
        f1 = float(macro_f1(y_true, (y_prob > thr).astype(int)))
    else:
        thr, f1 = macro_f1_threshold_scan(y_true, y_prob, num)
    labels = {i: ("propaganda" if preds[i] > thr else "not_propaganda")
              for i in ids}
    return labels, thr, f1
