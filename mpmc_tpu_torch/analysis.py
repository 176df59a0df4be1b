"""Error analysis (copy of ``mpmc_tpu/analysis.py``, the reference's
``analysis/analyze.ipynb``):

* ``merge_predictions``: a prediction TSV joined with the gold manifest;
* ``misclassified``: its wrong predictions;
* ``word_frequencies``: token counts over the texts of some rows;
* ``per_class_report``: per-class precision, recall and F1, macro-F1 and
  the confusion counts.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from mpmc_tpu_torch.io.manifest import read_manifest
from mpmc_tpu_torch.io.scorer import precision_recall_f1
from mpmc_tpu_torch.io.tsv import read_predictions
from mpmc_tpu_torch.text.normalize import preprocess_arabic_tweet


def merge_predictions(pred_tsv: str, gold_json: str) -> List[Dict]:
    manifest = read_manifest(gold_json)
    by_id = {i: (t, int(label)) for i, t, label in
             zip(manifest.ids, manifest.texts, manifest.labels)}
    ids, labels = read_predictions(pred_tsv)
    rows = []
    for i, pred in zip(ids, labels):
        text, gold = by_id[i]
        rows.append({"id": i, "text": text,
                     "gold": "propaganda" if gold else "not_propaganda",
                     "pred": pred,
                     "correct": (pred == "propaganda") == bool(gold)})
    return rows


def misclassified(pred_tsv: str, gold_json: str) -> List[Dict]:
    return [r for r in merge_predictions(pred_tsv, gold_json)
            if not r["correct"]]


def word_frequencies(rows: List[Dict], normalize: bool = True,
                     top_k: int = 50) -> List[Tuple[str, int]]:
    counter: Counter = Counter()
    for r in rows:
        text = preprocess_arabic_tweet(r["text"]) if normalize else r["text"]
        counter.update(text.split())
    return counter.most_common(top_k)


def per_class_report(pred_tsv: str, gold_json: str) -> Dict:
    rows = merge_predictions(pred_tsv, gold_json)
    g = np.array([1 if r["gold"] == "propaganda" else 0 for r in rows])
    p = np.array([1 if r["pred"] == "propaganda" else 0 for r in rows])
    ps, rs, fs = precision_recall_f1(g, p, [0, 1])
    confusion = {
        "tn": int(((p == 0) & (g == 0)).sum()),
        "fp": int(((p == 1) & (g == 0)).sum()),
        "fn": int(((p == 0) & (g == 1)).sum()),
        "tp": int(((p == 1) & (g == 1)).sum()),
    }
    return {
        "not_propaganda": {"precision": ps[0], "recall": rs[0], "f1": fs[0]},
        "propaganda": {"precision": ps[1], "recall": rs[1], "f1": fs[1]},
        "macro_f1": float(np.mean(fs)),
        "confusion": confusion,
        "n": len(rows),
    }
