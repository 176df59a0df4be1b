"""Fold-parallel cross-validation driver: all k folds train at once (port
of ``mpmc_tpu/cv/fold_driver.py`` on one device).

The k replicas are stacked on a leading fold axis and every step advances
all folds (``parallel/fold_parallel.py``); each fold samples batches from
its own train rows, so a batch is ``[F, B]`` row indices into the
device-resident data (``DataConfig.device_resident``) or, host-fed, those
rows of every array, ``[F, B, ...]``, copied from the host (the JAX
driver's ``host_batch``); the rows are the same in both modes.  The
semantics are the JAX driver's:

* mid-epoch evals at the ``check_interval`` cadence, with groups of
  ``cfg.scan_steps`` steps planned so that none straddles an eval
  (``train.loop._scan_group_plan`` with ``eval_on=True``);
* per-fold best-F1 TSVs written the moment a fold's test macro-F1
  improves (labels at the fold's Youden threshold, or
  ``cfg.emit_threshold``);
* ceil steps per epoch: the remainder step wraps around, so every row is
  real and ``valid`` is all ones;
* per-fold ``np.random.default_rng(seed + k)`` permutations, one per
  epoch;
* per-fold checkpoints under ``<checkpoint_dir>/fold_k``: ``model.pt``,
  which ``predict --checkpoint`` reads, and the fold's training state;
* per-fold held-out eval in 2A mode (``test_data=None``): each fold scores
  only its own validation rows.

Under ``--fold-shards N`` each fold group trains its ``folds`` (F/N of
them) with the steps and seeds they have among all F, writes their
checkpoints, and defers its TSVs: :func:`write_fold_tsvs` writes them on
rank 0 from every group's results, in the order the one-device run would.
Within a fold group each rank of ``data`` feeds its rows of every fold's
batch (``train_step.sync``), and the eval step gathers them.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from mpmc_tpu_torch.config import TrainConfig
from mpmc_tpu_torch.cv.kfold import stratified_kfold
from mpmc_tpu_torch.io.scorer import macro_f1
from mpmc_tpu_torch.io.tsv import write_label_tsv, write_prob_tsv
from mpmc_tpu_torch.train import loop
from mpmc_tpu_torch.train.loop import _scan_group_plan
from mpmc_tpu_torch.train.metrics import optimal_threshold_youden

log = logging.getLogger(__name__)


def fit_folds_parallel(cfg: TrainConfig, train_step, eval_step,
                       full_data: Dict[str, np.ndarray],
                       test_data: Optional[Dict[str, np.ndarray]],
                       test_ids: Optional[List[str]], device: torch.device,
                       tsv_prefix: Optional[str] = None,
                       run_id: str = "fold-parallel",
                       ids: Optional[List[str]] = None,
                       checkpoint_dir: Optional[str] = None,
                       scan_train_step=None,
                       folds: Optional[List[int]] = None) -> List[Dict]:
    """Train all folds simultaneously with ``train_step`` (a
    ``FoldParallelTrainStep`` over the resident ``full_data``) and
    ``eval_step`` (a ``FoldParallelEvalStep`` over the resident test
    split, or ``full_data`` when ``test_data`` is None), with K steps a
    dispatch through ``scan_train_step`` when given.  Without
    ``cfg.data.device_resident`` the steps' stores are empty and every
    batch carries its rows of ``full_data`` (train) or of the eval split,
    copied from the host (page-locked on a CUDA ``device``).

    ``test_data=None`` selects per-fold held-out eval (the 2A pattern;
    needs ``ids``): fold k is scored on rows ``val_idx[k]`` of
    ``full_data``.  Otherwise every fold scores the shared ``test_data``
    split (the 2C dev-set pattern).  ``folds`` (default all) are the
    folds the steps hold, in order; without them each fold writes its TSVs
    as it improves.  Returns per fold ``{"fold", "macro_f1", "threshold",
    "probs", "history", "steps", "best_step"}``."""
    bs = cfg.data.batch_size
    labels = full_data["label"]
    splits = stratified_kfold(labels, cfg.data.num_folds, cfg.data.fold_seed)
    # Every fold's size sets the steps, so that each group steps alike.
    steps_per_epoch = max((max(len(tr) for tr, _ in splits) + bs - 1)
                          // bs, 1)
    emit = folds is None
    folds = list(range(cfg.data.num_folds)) if folds is None else folds
    F = len(folds)
    train_idx = [splits[k][0] for k in folds]
    val_idx = [splits[k][1] for k in folds]

    per_fold_eval = test_data is None
    if per_fold_eval and ids is None:
        raise ValueError("per-fold eval (test_data=None) requires `ids`")
    if per_fold_eval:
        eval_rows = [np.asarray(v, np.int64) for v in val_idx]
        eval_ids = [[ids[i] for i in v] for v in val_idx]
        eval_labels = [labels[v] for v in val_idx]
    else:
        rows = np.arange(len(test_ids), dtype=np.int64)
        eval_rows = [rows] * F
        eval_ids = [list(test_ids)] * F
        eval_labels = [test_data.get("label")] * F
    eval_host = full_data if per_fold_eval else test_data
    scan_k = scan_train_step.k if scan_train_step is not None else 1
    sync = getattr(train_step, "sync", None)
    resident = cfg.data.device_resident
    pin = torch.device(device).type == "cuda"

    def rows_of(arrays, idx) -> Dict[str, np.ndarray]:
        """The batch of rows ``idx``: resident, the indices; host-fed,
        those rows of every array."""
        return ({"idx": idx} if resident
                else {name: arr[idx] for name, arr in arrays.items()})

    check_interval = max(steps_per_epoch // max(cfg.eval_per_epoch, 1), 1)
    rngs = [np.random.default_rng(cfg.seed + k) for k in folds]

    def fold_rows(perms, step):
        """``[F, B]`` absolute row indices: each fold samples its own train
        rows, wrapping around at the fold's epoch end."""
        out = []
        for k in range(F):
            take = perms[k][(step * bs) % len(perms[k]):][:bs]
            if len(take) < bs:
                take = np.concatenate([take, perms[k][:bs - len(take)]])
            out.append(take)
        return np.stack(out).astype(np.int64)

    def eval_all_folds():
        """Probs of every fold over its eval rows; rows past a fold's
        extent are clamped to its last row and sliced off."""
        V = [len(r) for r in eval_rows]
        nb = (max(V) + bs - 1) // bs
        parts: List[List[torch.Tensor]] = [[] for _ in range(F)]
        for b in range(nb):
            pos = np.arange(b * bs, b * bs + bs)
            idx = np.stack([r[np.minimum(pos, len(r) - 1)]
                            for r in eval_rows])
            p, _ = eval_step({k: torch.from_numpy(v).to(device)
                              for k, v in rows_of(eval_host, idx).items()})
            for k in range(F):
                parts[k].append(p[k])
        return [torch.cat(ps).cpu().numpy()[:V[k]]
                for k, ps in enumerate(parts)]

    best_f1 = [-1.0] * F
    best_thr = [0.5] * F
    best_probs: List[Optional[np.ndarray]] = [None] * F
    best_step = [-1] * F
    history: List[List[Dict]] = [[] for _ in range(F)]
    steps: List[List[Dict[str, float]]] = [[] for _ in range(F)]
    checkpointers: List = [None] * F
    if checkpoint_dir:
        from mpmc_tpu_torch.train.checkpoint import Checkpointer, to_host
        checkpointers = [Checkpointer(os.path.join(checkpoint_dir,
                                                   f"fold_{k}"))
                         for k in folds]
    step_count = 0
    pending: List[Dict[str, torch.Tensor]] = []

    def flush():
        """Per-fold losses and grad norms of the dispatches since the last
        flush, read in one copy."""
        if not pending:
            return
        vals = torch.cat([torch.stack([m["loss"].reshape(-1, F),
                                       m["grad_norm"].reshape(-1, F)], 2)
                          for m in pending]).cpu().numpy()
        for row in vals:
            for k in range(F):
                steps[k].append({"loss": float(row[k, 0]),
                                 "grad_norm": float(row[k, 1])})
        pending.clear()

    def emit_fold(k, probs):
        y = eval_labels[k]
        if y is None:
            return 0.5, float("nan")
        thr = optimal_threshold_youden(y, probs)
        return thr, macro_f1(y, (probs > thr).astype(int))

    def run_eval_pass(epoch, bi):
        """Eval every fold; a fold whose best macro-F1 improved writes its
        TSVs and checkpoint."""
        probs_list = eval_all_folds()
        for k in range(F):
            thr, f1 = emit_fold(k, probs_list[k])
            history[k].append({"epoch": epoch, "batch": bi,
                               "step": step_count, "test_f1": f1})
            improved = eval_labels[k] is not None and f1 > best_f1[k]
            if not (improved or (eval_labels[k] is None
                                 and best_probs[k] is None)):
                continue
            best_f1[k] = f1
            best_thr[k] = (cfg.emit_threshold
                           if cfg.emit_threshold is not None else thr)
            best_probs[k] = probs_list[k]
            best_step[k] = step_count
            if tsv_prefix and emit:
                write_fold_tsvs(cfg, tsv_prefix, run_id, folds[k],
                                eval_ids[k], probs_list[k], best_thr[k],
                                per_fold_eval)
            if checkpointers[k] is not None:
                # One copy of the fold's state in host memory, out of the
                # stacked tensors; model.pt is its weights.
                state = to_host(train_step.fold_state(k))
                torch.save(state["model"], os.path.join(
                    checkpointers[k].directory, "model.pt"))
                checkpointers[k].save(state, step_count,
                                      {"test_f1": f1,
                                       "threshold": best_thr[k]})
        log.info("eval | epoch %d batch %d/%d | per-fold F1 %s", epoch, bi,
                 steps_per_epoch,
                 [round(float(emit_fold(k, p)[1]), 4)
                  for k, p in enumerate(probs_list)])

    for epoch in range(cfg.epochs):
        perms = [rng.permutation(idx) for rng, idx in zip(rngs, train_idx)]
        plan = _scan_group_plan(steps_per_epoch, check_interval, scan_k,
                                eval_on=True)
        step = 0
        for g in plan:
            idx = np.stack([fold_rows(perms, step + j) for j in range(g)])
            if sync is not None:        # this rank's rows of every fold's
                idx = np.ascontiguousarray(idx[..., sync.rows(bs)])
            batch = loop._host_tensors(
                dict(rows_of(full_data, idx),
                     valid=np.ones(idx.shape, np.float32)),
                pin and not resident)
            if g == scan_k > 1:
                pending.append(scan_train_step(batch))
            else:                       # a remainder runs step by step
                pending += [train_step({
                    k: v[j].to(device, non_blocking=True)
                    for k, v in batch.items()}) for j in range(g)]
            step += g
            step_count += g
            if step % check_interval == 0 or step == steps_per_epoch:
                flush()
                run_eval_pass(epoch, step)
        flush()
        log.info("epoch %d: per-fold losses %s", epoch,
                 [round(s[-1]["loss"], 4) for s in steps])

    for k in range(F):
        if checkpointers[k] is not None:
            checkpointers[k].wait()
    results = []
    for k in range(F):
        results.append({"fold": folds[k], "macro_f1": best_f1[k],
                        "threshold": best_thr[k], "probs": best_probs[k],
                        "history": history[k], "steps": steps[k],
                        "best_step": best_step[k], "ids": eval_ids[k]})
        log.info("fold %d: best macro-F1 %.4f", folds[k], best_f1[k])
    return results


def write_fold_tsvs(cfg: TrainConfig, tsv_prefix: str, run_id: str,
                    fold: int, ids: List[str], probs: np.ndarray,
                    threshold: float, per_fold_eval: bool) -> None:
    """Fold ``fold``'s best TSVs: its probabilities, the label TSV (the
    last fold to write it wins, as each improves) and, where the val split
    is the test split, its val TSV, the same rows."""
    pred = (probs > threshold).astype(int)
    write_prob_tsv(f"{tsv_prefix}_probs_fold_{fold}.tsv", ids, pred, probs,
                   run_id, prob_header=cfg.prob_header)
    write_label_tsv(f"{tsv_prefix}.tsv", ids, pred, run_id)
    if cfg.emit_val_tsv and per_fold_eval:
        write_prob_tsv(f"{tsv_prefix}_val_fold_{fold}.tsv", ids, pred,
                       probs, run_id, prob_header=cfg.prob_header)
