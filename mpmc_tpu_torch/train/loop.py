"""Training and batched evaluation over host arrays (port of
``batch_iter``, ``run_eval`` and ``fit`` in ``mpmc_tpu/train/loop.py``),
with exact-state resume from a :class:`~mpmc_tpu_torch.train.checkpoint.
Checkpointer`."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.config import TrainConfig
from mpmc_tpu_torch.io.tsv import write_label_tsv, write_prob_tsv
from mpmc_tpu_torch.io.scorer import accuracy_score, macro_f1
from mpmc_tpu_torch.train.metrics import optimal_threshold_youden
from mpmc_tpu_torch.train.step import EvalStep, TrainStep

log = logging.getLogger(__name__)

LOG_EVERY = 10          # steps between loss logs (and reads of the losses)


def batch_iter(data: Dict[str, np.ndarray], batch_size: int,
               shuffle: bool = False,
               rng: Optional[np.random.Generator] = None,
               with_valid: bool = False,
               ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Yield ``(batch, n_valid)`` with every batch of ``batch_size`` rows.

    The short final batch is padded by replicating real rows (wrap-around
    over the index order), not with zero rows, so every row the model sees
    is a real sample; ``n_valid`` says how many rows are new.  ``shuffle``
    draws the order from ``rng``; ``with_valid`` adds a float32 ``valid``
    [B] that is 0 on the replicated rows."""
    n = len(next(iter(data.values())))
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    for start in range(0, n, batch_size):
        take = idx[start:start + batch_size]
        full = (np.concatenate([take, np.resize(idx, batch_size - len(take))])
                if len(take) < batch_size else take)
        batch = {k: v[full] for k, v in data.items()}
        if with_valid:
            batch["valid"] = (np.arange(batch_size)
                              < len(take)).astype(np.float32)
        yield batch, len(take)


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


@dataclasses.dataclass
class FitResult:
    best_macro_f1: float
    best_threshold: float          # the TSV labels' threshold at the best
    history: List[Dict]            # one entry per eval
    steps: List[Dict[str, float]]  # per step: loss, grad_norm


def _emit_threshold(cfg: TrainConfig, res: EvalResult) -> float:
    return (cfg.emit_threshold if cfg.emit_threshold is not None
            else res.threshold)


def _to_device(batch: Dict[str, np.ndarray], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def fit(train_step: TrainStep, eval_step: EvalStep, cfg: TrainConfig,
        train_data: Dict[str, np.ndarray], device: torch.device,
        test_data: Optional[Dict[str, np.ndarray]] = None,
        val_data: Optional[Dict[str, np.ndarray]] = None,
        test_ids: Optional[List[str]] = None,
        val_ids: Optional[List[str]] = None,
        fold: int = 0,
        tsv_prefix: Optional[str] = None,
        packed_plan=None,
        train_rows: Optional[np.ndarray] = None,
        on_best: Optional[Callable[[int], None]] = None,
        checkpointer=None) -> FitResult:
    """The epoch loop with the reference's cadence, on one device: eval of
    the test (and val) split ``cfg.eval_per_epoch`` times per epoch and at
    its end, and on a new best test macro-F1 the label and probability
    TSVs, ``on_best(step)`` and, with ``checkpointer``, a checkpoint of
    ``train_step``'s whole state with the best F1 and threshold.  Labels
    are at ``cfg.emit_threshold`` when set, else at that eval's Youden
    threshold;
    the probability column is headed ``cfg.prob_header``; with
    ``cfg.emit_val_tsv`` the val split's probability TSV
    (``<prefix>_val_fold_<k>.tsv``, ids ``val_ids``) follows the same
    rule.

    Batches are the packed plan's (``packed_plan``) or, unpacked, the
    shuffled ``train_rows`` of the device-resident store as ``idx``; the
    order comes from ``np.random.default_rng(cfg.seed + fold)`` as in the
    JAX package.  Losses and grad norms are read back at each log or eval
    point; a non-finite loss raises ``FloatingPointError``.

    A ``train_step`` restored from a checkpoint carries its optimizer's
    step count, and the run resumes there as the JAX loop does: the
    skipped epochs' shuffles are drawn, a mid-epoch prefix of batches is
    replayed without training, and the best F1 and threshold come back
    from the checkpointer's sidecar, so the TSVs are rewritten only on an
    improvement.  The dropout and augmentation draws continue from the
    restored generator."""
    bs = cfg.data.batch_size
    n_train = len(train_data["label"])
    if packed_plan is not None:
        steps_per_epoch = packed_plan.steps_per_epoch
    else:
        steps_per_epoch = (n_train + bs - 1) // bs
        if train_rows is None:
            train_rows = np.arange(n_train)
    check_interval = max(steps_per_epoch // max(cfg.eval_per_epoch, 1), 1)
    data_rng = np.random.default_rng(cfg.seed + fold)
    # Tag the run id when distillation really applies, that is when the
    # training rows carry the teacher's soft targets (the step reads them
    # only then): 2B and the simple 2C, which take none, stay untagged.
    distilled = cfg.distill_lambda > 0 and "soft" in train_data
    run_id = (f"{cfg.team_name}_{cfg.run_id}"
              + ("_distill" if distilled else ""))
    best_f1, best_thr = -1.0, 0.5
    history: List[Dict] = []
    steps: List[Dict[str, float]] = []
    pending: List[Tuple[int, int, Dict]] = []
    step_count = train_step.optimizer.count
    start_epoch = min(step_count // steps_per_epoch, cfg.epochs)
    resume_bi = step_count - start_epoch * steps_per_epoch
    if step_count:
        if start_epoch >= cfg.epochs:
            log.warning("restored step %d already covers all %d epochs "
                        "(steps_per_epoch=%d): nothing to train", step_count,
                        cfg.epochs, steps_per_epoch)
        else:
            log.info("resuming at epoch %d batch %d/%d (restored step %d)",
                     start_epoch, resume_bi, steps_per_epoch, step_count)
        for _ in range(start_epoch):
            # What each skipped epoch's iterator draws.
            if packed_plan is not None:
                data_rng.permutation(n_train)
            else:
                data_rng.shuffle(np.arange(n_train))
        restored = checkpointer.latest_metrics() if checkpointer else None
        if restored:
            best_f1 = restored.get("test_f1", best_f1)
            best_thr = restored.get("threshold", best_thr)
            log.info("restored best test F1 %.4f (threshold %.4f): TSVs "
                     "rewrite only on improvement", best_f1, best_thr)

    def flush():
        if not pending:
            return
        vals = torch.stack([torch.stack([m["loss"], m["grad_norm"]])
                            for _, _, m in pending]).cpu().numpy()
        for (ep, bi_, _), (loss, gnorm) in zip(pending, vals):
            if not np.isfinite(loss):
                pending.clear()
                raise FloatingPointError(
                    f"non-finite loss at epoch {ep} batch {bi_} "
                    f"(grad_norm={gnorm:.3e})")
            steps.append({"loss": float(loss), "grad_norm": float(gnorm)})
        pending.clear()

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        first = len(steps)
        if packed_plan is not None:
            it = packed_plan.epoch_iter(data_rng)
        else:
            it = batch_iter({"idx": train_rows.astype(np.int64)}, bs,
                            shuffle=True, rng=data_rng, with_valid=True)
        bi = 0
        for batch, _ in it:
            if epoch == start_epoch and bi < resume_bi:
                bi += 1                 # trained before the checkpoint
                continue
            metrics = train_step(_to_device(batch, device))
            bi += 1
            step_count += 1
            pending.append((epoch, bi, metrics))
            if bi % LOG_EVERY == 0:
                flush()
                log.info("TRAIN | Epoch [%d] | Batch [%d/%d] | Loss: %.4f | "
                         "Grad Norm: %.4f", epoch, bi, steps_per_epoch,
                         np.mean([m["loss"] for m in steps[-LOG_EVERY:]]),
                         steps[-1]["grad_norm"])
            if test_data is None or not (bi % check_interval == 0
                                         or bi == steps_per_epoch):
                continue
            flush()
            t_res = run_eval(eval_step, test_data, bs, device)
            history.append({"epoch": epoch, "batch": bi, "step": step_count,
                            "test_f1": t_res.macro_f1,
                            "test_loss": t_res.loss})
            log.info(" TEST | Epoch [%d] | Batch [%d/%d] | Loss: %.4f | "
                     "Acc: %.4f | F1: %.4f | thresh: %.4f", epoch, bi,
                     steps_per_epoch, t_res.loss, t_res.accuracy,
                     t_res.macro_f1, t_res.threshold)
            v_res = None
            if val_data is not None:
                v_res = run_eval(eval_step, val_data, bs, device)
                log.info("  VAL | Epoch [%d] | F1: %.4f", epoch,
                         v_res.macro_f1)
            if t_res.macro_f1 > best_f1:
                best_f1 = t_res.macro_f1
                best_thr = _emit_threshold(cfg, t_res)
                if tsv_prefix and test_ids is not None:
                    pred = (t_res.probs > best_thr).astype(int)
                    write_label_tsv(f"{tsv_prefix}.tsv", test_ids, pred,
                                    run_id)
                    write_prob_tsv(f"{tsv_prefix}_probs_fold_{fold}.tsv",
                                   test_ids, pred, t_res.probs, run_id,
                                   prob_header=cfg.prob_header)
                    if (cfg.emit_val_tsv and v_res is not None
                            and val_ids is not None):
                        vpred = (v_res.probs > _emit_threshold(cfg, v_res)
                                 ).astype(int)
                        write_prob_tsv(f"{tsv_prefix}_val_fold_{fold}.tsv",
                                       val_ids, vpred, v_res.probs, run_id,
                                       prob_header=cfg.prob_header)
                if on_best is not None:
                    on_best(step_count)
                if checkpointer is not None:
                    checkpointer.save(train_step.state_dict(), step_count,
                                      {"test_f1": best_f1,
                                       "threshold": best_thr})
        flush()
        losses = [m["loss"] for m in steps[first:]]
        log.info("TRAIN | Epoch [%d] done in %.1fs | loss %.4f", epoch,
                 time.time() - t0, float(np.mean(losses)) if losses
                 else float("nan"))
    return FitResult(best_f1, best_thr, history, steps)
