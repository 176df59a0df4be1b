"""The numbers that decide ``correct``: each a gap between what the system
produced and what the plain reference works out from the same inputs,
held against the limit its workload file states.

Training (the fold's first checked steps, as the set-up ran them through
the grouped dispatch: an eager group, then graph replays):

* ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
* ``logit_gap``: over the steps, the largest root mean square of the
  per-meme log-odds' gap over the valid memes, over the reference
  log-odds' standard deviation there;
* ``logit_gap_pooled``: the same over all the steps' valid memes at once,
  each log-odds taken from its batch's mean on both sides: steady where a
  batch's log-odds barely spread (a two-logit head at random weights);
* ``norm_gap``: the largest ``|norm - ref| / ref`` of a step's pre-clip
  global gradient norm;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  first clipped gradient as the system's optimizer got it and the
  reference's, over the larger of the reference leaf's norm and the median
  leaf's;
* ``change_gap``: the largest such gap of each leaf's change after the
  last checked step.

The two by leaf leave out the leaves whose reference gradient is under a
thousandth of the median leaf's: nought but rounding (a bias ahead of a
training-mode BatchNorm, a key's bias under softmax), which Adam turns into
a full-sized step of random sign.

Scoring, over every request of the window (each the same split, against
one reference pass over it): ``prob_gap``, the largest ``|p - ref|`` of a
propaganda probability; ``logit_gap_rms``, over the requests, the largest
root mean square of the log-odds' gap over the reference log-odds'
standard deviation, steady where the largest gap swings.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

NEGLIGIBLE_GRAD = 1e-3


def _leaf_gaps(port: Dict[str, float], ref: Dict[str, float], names
               ) -> np.ndarray:
    med = float(np.median([ref[n] for n in names]))
    if not med > 0:
        return np.array([np.inf])
    return np.array([abs(port[n] - ref[n]) / max(ref[n], med)
                     for n in names])


def moving_leaves(ref: dict) -> list:
    g = ref["grad_norms"]
    med = float(np.median(list(g.values())))
    return sorted(n for n in g if g[n] >= NEGLIGIBLE_GRAD * med)


def log_odds_of(logits: np.ndarray) -> np.ndarray:
    """One logit as it is; two as the second's margin over the first."""
    z = np.asarray(logits, np.float64)
    return z if z.ndim == 1 else z[:, 1] - z[:, 0]


def _rms_gap(z: np.ndarray, zr: np.ndarray) -> float:
    return float(np.sqrt(np.mean((z - zr) ** 2)) / max(np.std(zr), 1e-12))


def train_gaps(port: dict, ref: dict, valid: list) -> Dict[str, float]:
    """``valid``: each checked step's row weights."""
    losses = [abs(a - b) / abs(b) for a, b in zip(port["losses"],
                                                  ref["losses"])]
    logits = [_rms_gap(log_odds_of(a)[v > 0], log_odds_of(b)[v > 0])
              for a, b, v in zip(port["logits"], ref["logits"], valid)]
    norms = [abs(a - b) / b for a, b in zip(port["grad_norm"],
                                            ref["grad_norm"])]
    dev, ref_dev = [], []
    for a, b, v in zip(port["logits"], ref["logits"], valid):
        z, zr = log_odds_of(a)[v > 0], log_odds_of(b)[v > 0]
        dev.append(z - z.mean())
        ref_dev.append(zr - zr.mean())
    dev, ref_dev = np.concatenate(dev), np.concatenate(ref_dev)
    pooled = float(np.sqrt(np.mean((dev - ref_dev) ** 2))
                   / max(np.sqrt(np.mean(ref_dev ** 2)), 1e-12))
    names = moving_leaves(ref)
    grads = _leaf_gaps(port["grad_norms"], ref["grad_norms"], names)
    return {"loss_gap": max(losses), "logit_gap": max(logits),
            "logit_gap_pooled": pooled,
            "norm_gap": max(norms), "grad_gap": float(grads.max()),
            "change_gap": float(_leaf_gaps(port["change_norms"],
                                           ref["change_norms"], names).max())}


def train_detail(port: dict, ref: dict, valid: list, top: int = 4) -> dict:
    """What sets the training numbers, for a look: each step's loss on both
    sides, each step's logit and norm gap, and the leaves behind
    ``grad_gap`` and ``change_gap`` (name, the system's norm, the
    reference's, and the reference's over the median leaf's)."""
    out = {"losses": [port["losses"], ref["losses"]],
           "logit_gaps": [_rms_gap(log_odds_of(a)[v > 0],
                                   log_odds_of(b)[v > 0])
                          for a, b, v in zip(port["logits"], ref["logits"],
                                             valid)],
           "norms": [port["grad_norm"], ref["grad_norm"]]}
    names = moving_leaves(ref)
    for key in ("grad_norms", "change_norms"):
        r, p = ref[key], port[key]
        med = float(np.median([r[n] for n in names]))
        worst = sorted(names, key=lambda n: -abs(p[n] - r[n]) / max(r[n], med))
        out[key] = [[n, p[n], r[n], r[n] / med] for n in worst[:top]]
    return out


def _log_odds(p: np.ndarray) -> np.ndarray:
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1 - 1e-7)
    return np.log(p / (1 - p))


def prob_gaps(port: list, ref: np.ndarray) -> Dict[str, float]:
    """``port``: the probabilities of each request, ``ref`` the
    reference's of the split they all score."""
    ref = np.asarray(ref, np.float64)
    zr = _log_odds(ref)
    gaps, rms = [], []
    for p in port:
        p = np.asarray(p, np.float64)
        gaps.append(float(np.max(np.abs(p - ref))))
        rms.append(_rms_gap(_log_odds(p), zr))
    return {"prob_gap": max(gaps), "logit_gap_rms": max(rms)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """Each number that the cell compares (its workload file gives it a
    limit) beside its limit."""
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
            if k in limits}


def passed(judged: Dict[str, dict]) -> bool:
    """Some number compared, and every one finite and within its
    limit."""
    return bool(judged) and all(
        np.isfinite(j["value"]) and j["value"] <= j["limit"]
        for j in judged.values())
