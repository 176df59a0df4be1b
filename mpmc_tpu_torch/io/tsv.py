"""Prediction TSV emission and format checking (copy of
``mpmc_tpu/io/tsv.py``).

* label TSV: header ``id\tlabel\trun_id``, one 3-column row per sample;
* prob TSV: header ``id\tlabel\tprob\trun_id``;

and their readers.

``check_format`` applies the official checker's acceptance rule: skip the
header; every line splits on tabs into exactly 3 fields and matches
``^([\\w:]+\\/.*?\\.[\\w:]+)\t(propaganda|not_propaganda)\t[\\w-]+``.
"""

from __future__ import annotations

import logging
import re
from typing import List, Sequence, Tuple

import numpy as np

ID2L = {0: "not_propaganda", 1: "propaganda"}

_LINE_PATTERN = re.compile(
    r"^([\w:]+\/.*?\.[\w:]+)\t(propaganda|not_propaganda)\t[\w-]+")

log = logging.getLogger(__name__)


def write_label_tsv(path: str, ids: Sequence[str], labels: Sequence[int],
                    run_id: str) -> None:
    """Emit the submission TSV: ``id\tlabel\trun_id``."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("id\tlabel\trun_id\n")
        for i, y in zip(ids, labels):
            f.write(f"{i}\t{ID2L[int(y)]}\t{run_id}\n")


def write_prob_tsv(path: str, ids: Sequence[str], labels: Sequence[int],
                   probs: Sequence[float], run_id: str,
                   prob_header: str = "prob") -> None:
    """Emit the probability TSV: ``id\tlabel\t<prob>\trun_id``."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"id\tlabel\t{prob_header}\trun_id\n")
        for i, y, p in zip(ids, labels, probs):
            f.write(f"{i}\t{ID2L[int(y)]}\t{float(p)}\t{run_id}\n")


def check_format(path: str) -> bool:
    """Validate a label TSV against the official format contract; returns
    False on the first bad line."""
    with open(path, encoding="utf-8") as f:
        next(f)
        content = f.read().strip()
        for line in content.split("\n"):
            parts = line.strip().split("\t")
            if len(parts) != 3:
                log.error("Wrong number of columns: %s", line)
                return False
            if not _LINE_PATTERN.match("\t".join(parts)):
                log.error("Wrong line format: %s", line)
                return False
    return True


def read_predictions(path: str) -> Tuple[List[str], List[str]]:
    """A label TSV read back as (ids, labels), as the official scorer
    parses it: split on tabs, strip id and label."""
    ids, labels = [], []
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            if not line.strip():
                continue
            i, label, _run = line.split("\t")
            ids.append(i.strip())
            labels.append(label.strip())
    return ids, labels


def read_run_id(path: str) -> str:
    """The run id of a prediction TSV (last column of the first data row),
    the family key of ``combine --group-by-run-id``."""
    with open(path, encoding="utf-8") as f:
        if next(f, None) is not None:
            for line in f:
                if line.strip():
                    return line.rstrip("\n").split("\t")[-1].strip()
    raise ValueError(f"no data rows in {path}")


def read_prob_predictions(path: str
                          ) -> Tuple[List[str], List[str], np.ndarray]:
    """A 4-column probability TSV read back as (ids, labels, probs)."""
    ids, labels, probs = [], [], []
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            if not line.strip():
                continue
            i, label, prob, _run = line.split("\t")
            ids.append(i.strip())
            labels.append(label.strip())
            probs.append(float(prob))
    return ids, labels, np.asarray(probs, dtype=np.float64)
