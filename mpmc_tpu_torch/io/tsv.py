"""Prediction TSV emission and format checking (copy of
``mpmc_tpu/io/tsv.py``).

* label TSV: header ``id\tlabel\trun_id``, one 3-column row per sample;
* prob TSV: header ``id\tlabel\tprob\trun_id``.

``check_format`` applies the official checker's acceptance rule: skip the
header; every line splits on tabs into exactly 3 fields and matches
``^([\\w:]+\\/.*?\\.[\\w:]+)\t(propaganda|not_propaganda)\t[\\w-]+``.
"""

from __future__ import annotations

import logging
import re
from typing import Sequence

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
