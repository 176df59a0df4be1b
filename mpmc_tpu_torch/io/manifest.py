"""JSON manifest loading (copy of ``mpmc_tpu/io/manifest.py``).

Records carry ``id``, ``img_path``, ``text`` and, for labelled splits,
``class_label`` in {propaganda, not_propaganda}.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

L2ID = {"not_propaganda": 0, "propaganda": 1}


@dataclasses.dataclass
class Manifest:
    """Columnar view of one split of the dataset."""

    ids: List[str]
    texts: List[str]
    img_paths: List[str]
    labels: Optional[np.ndarray]  # int32 [N] or None for unlabelled sets

    def __len__(self) -> int:
        return len(self.ids)

    def select(self, indices: Sequence[int]) -> "Manifest":
        idx = [int(i) for i in indices]
        return Manifest(
            ids=[self.ids[i] for i in idx],
            texts=[self.texts[i] for i in idx],
            img_paths=[self.img_paths[i] for i in idx],
            labels=None if self.labels is None else self.labels[idx],
        )

    def concat(self, other: "Manifest") -> "Manifest":
        labels = None
        if self.labels is not None and other.labels is not None:
            labels = np.concatenate([self.labels, other.labels])
        return Manifest(
            ids=self.ids + other.ids,
            texts=self.texts + other.texts,
            img_paths=self.img_paths + other.img_paths,
            labels=labels,
        )


def read_manifest(path: str, is_test: bool = False) -> Manifest:
    """Load a JSON-array manifest; ``is_test=True`` ignores labels."""
    with open(path, encoding="utf-8") as f:
        records = json.load(f)

    ids, texts, img_paths, labels = [], [], [], []
    labelled = True
    for rec in records:
        ids.append(str(rec["id"]))
        texts.append(rec.get("text", ""))
        img_paths.append(rec.get("img_path", ""))
        if not is_test and "class_label" in rec:
            labels.append(L2ID[rec["class_label"]])
        else:
            labelled = False

    return Manifest(
        ids=ids,
        texts=texts,
        img_paths=img_paths,
        labels=np.asarray(labels, dtype=np.int32) if labelled else None,
    )


def class_weights(labels: np.ndarray) -> np.ndarray:
    """'balanced' class weights, ``n / (n_classes * bincount)`` over the
    two classes (an empty class counts as one), f32: what
    ``TrainConfig.use_class_weights`` weighs the cross-entropy's rows by.
    The reference computes these and never uses them."""
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=2).astype(np.float64)
    counts = np.maximum(counts, 1.0)
    return (labels.shape[0] / (len(counts) * counts)).astype(np.float32)
