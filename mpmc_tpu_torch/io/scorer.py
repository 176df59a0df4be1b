"""Official-scorer-compatible evaluation (copy of ``mpmc_tpu/io/scorer.py``),
without sklearn: read the gold JSON manifest and a prediction TSV, require
the same id set on both sides, align them by sorting on id, and return
``(accuracy, precision_weighted, recall_weighted, f1_macro)``; macro-F1 is
the official ArAIEval Task-2 metric.  The metric functions are pure numpy
and serve the training loop too.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mpmc_tpu_torch.io.tsv import check_format, read_predictions

log = logging.getLogger(__name__)


def _binary_counts(gold: np.ndarray, pred: np.ndarray, cls: int
                   ) -> Tuple[int, int, int]:
    tp = int(np.sum((pred == cls) & (gold == cls)))
    fp = int(np.sum((pred == cls) & (gold != cls)))
    fn = int(np.sum((pred != cls) & (gold == cls)))
    return tp, fp, fn


def precision_recall_f1(gold: np.ndarray, pred: np.ndarray,
                        classes: Sequence[int]
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class precision, recall and F1 with sklearn's zero-division-to-0
    convention."""
    ps, rs, fs = [], [], []
    for c in classes:
        tp, fp, fn = _binary_counts(gold, pred, c)
        p = tp / (tp + fp) if (tp + fp) else 0.0
        r = tp / (tp + fn) if (tp + fn) else 0.0
        f = 2 * p * r / (p + r) if (p + r) else 0.0
        ps.append(p)
        rs.append(r)
        fs.append(f)
    return np.asarray(ps), np.asarray(rs), np.asarray(fs)


def accuracy_score(gold: np.ndarray, pred: np.ndarray) -> float:
    return float(np.mean(gold == pred))


def macro_f1(gold: np.ndarray, pred: np.ndarray,
             classes: Sequence[int] = (0, 1)) -> float:
    _, _, fs = precision_recall_f1(np.asarray(gold), np.asarray(pred),
                                   classes)
    return float(np.mean(fs))


def binary_f1(gold: np.ndarray, pred: np.ndarray, positive: int = 1) -> float:
    """F1 of the positive class only (sklearn ``f1_score``'s default
    ``average='binary'``), the ensemble threshold scan's score."""
    _, _, fs = precision_recall_f1(np.asarray(gold), np.asarray(pred),
                                   [positive])
    return float(fs[0])


def weighted_precision_recall(gold: np.ndarray, pred: np.ndarray,
                              classes: Sequence[int] = (0, 1)
                              ) -> Tuple[float, float]:
    gold = np.asarray(gold)
    ps, rs, _ = precision_recall_f1(gold, np.asarray(pred), classes)
    support = np.asarray([np.sum(gold == c) for c in classes],
                         dtype=np.float64)
    w = support / max(support.sum(), 1.0)
    return float(np.sum(ps * w)), float(np.sum(rs * w))


def read_gold(gold_fpath: str) -> Dict[str, str]:
    """Gold labels keyed by id."""
    with open(gold_fpath, encoding="utf-8") as f:
        return {str(e["id"]): e["class_label"] for e in json.load(f)}


def _read_gold_and_pred(gold_fpath: str, pred_fpath: str
                        ) -> Tuple[Dict[str, str], List[Tuple[str, str]]]:
    gold_labels = read_gold(gold_fpath)
    ids, labels = read_predictions(pred_fpath)
    line_score = []
    for i, label in zip(ids, labels):
        if i not in gold_labels:
            raise ValueError(f"No such id: {i} in gold file!")
        line_score.append((i, label))
    pred_ids = [t[0] for t in line_score]
    if set(gold_labels) != set(pred_ids) or len(pred_ids) != len(gold_labels):
        raise ValueError(
            "The predictions do not match the lines from the gold file - "
            "missing or extra line_no")
    return gold_labels, line_score


def evaluate(gold_fpath: str, pred_fpath: str
             ) -> Tuple[float, float, float, float]:
    """(acc, P_weighted, R_weighted, F1_macro) of a label TSV."""
    gold_labels, line_score = _read_gold_and_pred(gold_fpath, pred_fpath)
    gold = [label for _, label in sorted(gold_labels.items())]
    pred = [label for _, label in sorted(line_score)]
    # sklearn averages over the union of gold and predicted label names,
    # which differs from the gold names alone on a single-class gold split.
    names = sorted(set(gold) | set(pred))
    to_id = {n: k for k, n in enumerate(names)}
    g = np.asarray([to_id[x] for x in gold])
    p = np.asarray([to_id[x] for x in pred])
    classes = list(range(len(names)))
    acc = accuracy_score(g, p)
    pw, rw = weighted_precision_recall(g, p, classes)
    return acc, pw, rw, macro_f1(g, p, classes)


def validate_files(pred_file: str) -> bool:
    if not check_format(pred_file):
        log.error("Bad format for pred file %s. Cannot score.", pred_file)
        return False
    return True
