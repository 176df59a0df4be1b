"""Stratified k-fold splitting (copy of ``mpmc_tpu/cv/kfold.py``).

With sklearn importable the folds are ``StratifiedKFold(n_splits,
shuffle=True, random_state=seed)``'s, as the reference's; without it a
stratified round-robin over each class's shuffled members keeps every
fold's class proportions within one sample, with other assignments.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _native_stratified_kfold(labels: np.ndarray, n_splits: int, seed: int
                             ) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    fold_of = np.empty(len(labels), dtype=np.int64)
    for cls in np.unique(labels):
        idx = np.where(labels == cls)[0]
        rng.shuffle(idx)
        for j, sample in enumerate(idx):
            fold_of[sample] = j % n_splits
    return [(np.where(fold_of != k)[0], np.where(fold_of == k)[0])
            for k in range(n_splits)]


def stratified_kfold(labels: np.ndarray, n_splits: int = 5, seed: int = 42,
                     use_sklearn: bool = True
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``[(train_idx, val_idx)] * n_splits``, shuffled and stratified."""
    if use_sklearn:
        try:
            from sklearn.model_selection import StratifiedKFold
        except ImportError:
            pass
        else:
            skf = StratifiedKFold(n_splits=n_splits, shuffle=True,
                                  random_state=seed)
            return [(tr, te) for tr, te in
                    skf.split(np.zeros(len(labels)), labels)]
    return _native_stratified_kfold(labels, n_splits, seed)
