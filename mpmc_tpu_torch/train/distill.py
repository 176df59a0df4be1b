"""Classic-to-neural distillation: cross-fitted char-n-gram SVM soft
targets (port of ``mpmc_tpu/train/distill.py``).

The teacher is the calibrated char-n-gram SVM of
``baselines/classic.run_ngram_cv`` (analyzer ``char_wb``, 2- to 5-grams,
30000 features).  For each outer fold k it sees only the fold's train
rows: an inner stratified K-fold over ``tr_idx`` fits the SVM on the
inner-train rows and predicts the held-out inner-val rows, so no training
row's soft target comes from a model that saw it, and no fold-k
validation row is ever fitted.  The student mixes the soft target into its
loss, ``(1-λ)·loss(hard) + λ·CE(soft)`` (``train/step.loss_from_outputs``,
``TrainConfig.distill_lambda``); eval and the TSVs stay purely neural.

The soft targets are cached as ``distill_<sha16>.npz`` under the cache
dir with the JAX package's key, so either package reads the other's file.
A cache hit imports no sklearn: that is how a host without sklearn (such
as a GPU machine) trains with distillation, from a cache written where
sklearn is installed.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)


def _teacher_pipeline(analyzer: str, ngram_range: Tuple[int, int],
                      max_features: int):
    from mpmc_tpu_torch.baselines.classic import (_ngram_vectorizer,
                                                  require_sklearn)
    require_sklearn()
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.pipeline import Pipeline
    from sklearn.svm import SVC

    return Pipeline([
        ("vect", _ngram_vectorizer(analyzer=analyzer,
                                   ngram_range=ngram_range,
                                   max_features=max_features)),
        ("svc", CalibratedClassifierCV(
            SVC(C=1, kernel="linear", random_state=0), ensemble=False)),
    ])


def cache_path(cache_dir: str, texts: Sequence[str], labels: np.ndarray,
               splits: List[Tuple[np.ndarray, np.ndarray]],
               analyzer: str = "char_wb",
               ngram_range: Tuple[int, int] = (2, 5),
               max_features: int = 30000, inner_folds: int = 5,
               seed: int = 42) -> str:
    """The soft targets' cache file, ``<cache_dir>/distill_<sha16>.npz``,
    keyed as the JAX package keys it: the texts, the labels, the number of
    splits and the teacher's settings, and each split's train rows."""
    h = hashlib.sha256()
    h.update("\x00".join(texts).encode("utf-8"))
    h.update(np.asarray(labels).astype(np.int64).tobytes())
    h.update(f"{len(splits)}|{analyzer}|{ngram_range}|{max_features}|"
             f"{inner_folds}|{seed}".encode())
    for tr, _va in splits:
        h.update(np.asarray(tr, np.int64).tobytes())
    return os.path.join(cache_dir, f"distill_{h.hexdigest()[:16]}.npz")


def ngram_soft_targets(texts: Sequence[str], labels: np.ndarray,
                       splits: List[Tuple[np.ndarray, np.ndarray]],
                       analyzer: str = "char_wb",
                       ngram_range: Tuple[int, int] = (2, 5),
                       max_features: int = 30000,
                       inner_folds: int = 5, seed: int = 42,
                       cache_dir: Optional[str] = None) -> np.ndarray:
    """Per-outer-fold leak-free soft targets, shape ``[F, N]`` float32.

    ``soft[k, i]`` is the teacher's P(propaganda) for row ``i`` when row
    ``i`` is a TRAIN row of outer fold ``k`` (produced by an inner model
    that never saw row ``i``); validation rows of fold ``k`` hold the
    sentinel 0.5 and are never consumed (the student trains only on
    ``tr_idx`` rows).

    Teacher text is the RAW manifest text (the 0.712 recipe feeds
    TfidfVectorizer unnormalized — ``classic.run_ngram_cv``), independent
    of the neural tokenizer's Arabic normalization.

    Deterministic for fixed inputs; cached under ``cache_dir`` keyed by the
    corpus, split seed/shape and teacher hyperparameters (300 SVC fits cost
    minutes on a one-core host).
    """
    from mpmc_tpu_torch.baselines.classic import require_sklearn
    from mpmc_tpu_torch.cv.kfold import stratified_kfold

    labels = np.asarray(labels)
    n = len(labels)
    key = None
    if cache_dir:
        key = cache_path(cache_dir, texts, labels, splits, analyzer,
                         ngram_range, max_features, inner_folds, seed)
        if os.path.exists(key):
            log.info("distillation soft targets: cache hit %s", key)
            return np.load(key)["soft"]
    require_sklearn()

    soft = np.full((len(splits), n), 0.5, np.float32)
    for k, (tr_idx, _va_idx) in enumerate(splits):
        tr_idx = np.asarray(tr_idx)
        tr_labels = labels[tr_idx]
        for j, (itr, iva) in enumerate(
                stratified_kfold(tr_labels, inner_folds, seed=seed)):
            pipe = _teacher_pipeline(analyzer, ngram_range, max_features)
            fit_rows = tr_idx[itr]
            pred_rows = tr_idx[iva]
            pipe.fit([texts[i] for i in fit_rows], labels[fit_rows])
            soft[k, pred_rows] = pipe.predict_proba(
                [texts[i] for i in pred_rows])[:, 1].astype(np.float32)
        log.info("distillation teacher fold %d/%d: %d soft targets "
                 "(inner %d-fold char-n-gram SVM)", k, len(splits),
                 len(tr_idx), inner_folds)
    if key:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(key, soft=soft)
        log.info("distillation soft targets cached to %s", key)
    return soft
