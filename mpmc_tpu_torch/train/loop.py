"""Batched evaluation over host arrays (port of ``batch_iter`` and
``run_eval`` in ``mpmc_tpu/train/loop.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.train.metrics import (accuracy_score, macro_f1,
                                          optimal_threshold_youden)
from mpmc_tpu_torch.train.step import EvalStep


def batch_iter(data: Dict[str, np.ndarray], batch_size: int
               ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Yield ``(batch, n_valid)`` with every batch of ``batch_size`` rows.

    The short final batch is padded by replicating real rows (wrap-around
    over the index order), not with zero rows, so every row the model sees
    is a real sample; ``n_valid`` says how many rows are new."""
    n = len(next(iter(data.values())))
    idx = np.arange(n)
    for start in range(0, n, batch_size):
        take = idx[start:start + batch_size]
        full = (np.concatenate([take, np.resize(idx, batch_size - len(take))])
                if len(take) < batch_size else take)
        yield {k: v[full] for k, v in data.items()}, len(take)


@dataclasses.dataclass
class EvalResult:
    loss: float
    accuracy: float
    macro_f1: float
    threshold: float
    probs: np.ndarray  # [N] propaganda probability, dataset order


def run_eval(eval_step: EvalStep, data: Dict[str, np.ndarray],
             batch_size: int, device: torch.device) -> EvalResult:
    """Full pass, sigmoid probs, ROC/Youden threshold, accuracy and
    macro-F1 (the metrics are NaN and the threshold 0.5 without labels).
    Results stay on the device until the pass ends, so the host never
    waits on the device between batches."""
    parts = []
    for batch, n_valid in batch_iter(data, batch_size):
        dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        probs, loss = eval_step(dev)
        parts.append((probs[:n_valid], loss[:n_valid]))
    probs = torch.cat([p for p, _ in parts]).cpu().numpy()
    losses = torch.cat([l for _, l in parts]).cpu().numpy()
    labels = data.get("label")
    if labels is None:
        return EvalResult(float("nan"), float("nan"), float("nan"), 0.5, probs)
    labels = np.asarray(labels)
    thr = optimal_threshold_youden(labels, probs)
    pred = (probs > thr).astype(int)
    return EvalResult(float(losses.mean()), accuracy_score(labels, pred),
                      macro_f1(labels, pred), thr, probs)
