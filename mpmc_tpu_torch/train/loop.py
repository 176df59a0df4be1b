"""Training and batched evaluation (port of ``batch_iter``,
``prefetch_batches``, ``_scan_group_plan``, ``_scan_groups``,
``DeviceData``, ``run_eval`` and ``fit`` in ``mpmc_tpu/train/loop.py``),
with exact-state resume from a
:class:`~mpmc_tpu_torch.train.checkpoint.Checkpointer` and, with
``scan_steps`` K > 1, full groups of K steps (or eval batches) as one
dispatch (``train/graphs.py``).  Batches are row indices into arrays
already on the device (``DataConfig.device_resident``, the default) or
the rows themselves, copied from the host; both give the same batches."""

from __future__ import annotations

import contextlib
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
from mpmc_tpu_torch.train.step import EvalStep, TrainStep, gather_batch
from mpmc_tpu_torch.utils.profiling import h2d, span

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


def prefetch_batches(it: Iterator[Tuple[Dict[str, np.ndarray], int]],
                     put: Callable = lambda b: b, depth: int = 2,
                     stats: Optional[Dict[str, float]] = None,
                     ) -> Iterator[Tuple[object, Dict[str, np.ndarray], int]]:
    """Run the batch iterator ``it`` and ``put`` on a background thread
    ``depth`` batches ahead of the consumer.  Yields ``(put(batch), batch,
    n_valid)``: the host batch is kept for the failure dump.  An exception
    on the thread is raised here after the batches before it.

    ``stats`` (updated in place) counts ``gets`` (batches consumed),
    ``empty_gets`` (the queue was empty when the consumer asked: the
    producer fell behind) and ``wait_s`` (consumer time blocked on the
    queue)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    STOP = object()
    errs: List[BaseException] = []

    def producer():
        try:
            for batch, n_valid in it:
                q.put((put(batch), batch, n_valid))
        except BaseException as e:  # surface on the consumer thread
            errs.append(e)
        q.put(STOP)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        if stats is not None:
            empty = q.empty()
            t0 = time.perf_counter()
            item = q.get()
            stats["wait_s"] = (stats.get("wait_s", 0.0)
                               + time.perf_counter() - t0)
            if item is not STOP:
                stats["gets"] = stats.get("gets", 0) + 1
                stats["empty_gets"] = stats.get("empty_gets", 0) + int(empty)
        else:
            item = q.get()
        if item is STOP:
            break
        yield item
    if errs:
        raise errs[0]


def _scan_group_plan(steps_per_epoch: int, check_interval: int, k: int,
                     eval_on: bool) -> List[int]:
    """Group sizes for one epoch of grouped dispatch: full-K groups plus
    remainders, with no group straddling an eval boundary, so the eval
    cadence (``bi % check_interval == 0`` or the epoch's end) is the
    per-step one.  Groups smaller than K run as single steps."""
    if eval_on:
        ends = [i for i in range(1, steps_per_epoch + 1)
                if i % check_interval == 0 or i == steps_per_epoch]
    else:
        ends = [steps_per_epoch]
    plan, prev = [], 0
    for e in ends:
        seg = e - prev
        plan += [k] * (seg // k)
        if seg % k:
            plan.append(seg % k)
        prev = e
    return plan


def _scan_groups(it: Iterator[Tuple[Dict[str, np.ndarray], int]],
                 plan: List[int], k: int,
                 ) -> Iterator[Tuple[Dict[str, np.ndarray], object]]:
    """Chunk the per-step batch iterator by ``plan``: a full group of K
    is stacked on a leading axis and yielded with the list of its steps'
    ``n_valid``; a smaller group falls through as single steps."""
    for size in plan:
        try:
            items = [next(it) for _ in range(size)]
        except StopIteration as e:
            raise RuntimeError(
                "the group plan is longer than the batch iterator: build it "
                "from the same steps_per_epoch") from e
        if size == k:
            yield ({key: np.stack([b[key] for b, _ in items])
                    for key in items[0][0]}, [n for _, n in items])
        else:
            yield from items


@dataclasses.dataclass
class DeviceData:
    """A split of a device-resident store: ``data``, the arrays on the
    device (the whole train manifest's, or the test split's), and
    ``abs_idx``, the split's rows of them.  Its eval batches ship only
    ``idx`` and are gathered on the device."""
    data: Dict[str, torch.Tensor]
    abs_idx: np.ndarray


@dataclasses.dataclass
class EvalResult:
    loss: float
    accuracy: float
    macro_f1: float
    threshold: float
    probs: np.ndarray  # [N] propaganda probability, dataset order


def run_eval(eval_step: EvalStep, data: Dict[str, np.ndarray],
             batch_size: int, device: torch.device,
             scan_eval_step=None, dev: Optional[DeviceData] = None
             ) -> EvalResult:
    """Full pass, sigmoid probs, ROC/Youden threshold, accuracy and
    macro-F1 (the metrics are NaN and the threshold 0.5 without labels).
    Results stay on the device until the pass ends, so the host never
    waits on the device between batches.  With ``scan_eval_step`` (a
    ``train.graphs.make_scan_eval_step`` of K eval batches) each full
    group of K batches is one dispatch and every other batch goes through
    its :meth:`~mpmc_tpu_torch.train.graphs.GroupedSteps.single` (a graph
    of one batch on a CUDA device); without it the batches run one by
    one.

    With ``dev`` the split is device-resident: a batch ships its rows
    ``idx`` of ``dev.data`` and is gathered there
    (``train.step.gather_batch``); ``data`` gives the labels.  Otherwise
    the batches are ``data``'s rows, copied from the host.

    The pass is the ``utils.profiling`` span ``mpmc.eval.run``
    (``rows``); each batch run on its own without ``scan_eval_step``
    ``mpmc.eval.eager``, each copy ``mpmc.h2d``, and the read of the
    results ``mpmc.sync``."""
    n = len(next(iter(data.values())))
    with span("mpmc.eval.run", rows=n):
        n_batches = (n + batch_size - 1) // batch_size
        if dev is not None:
            if len(dev.abs_idx) != n:
                raise ValueError(f"the resident split has "
                                 f"{len(dev.abs_idx)} rows, the host "
                                 f"split {n}")
            it = batch_iter({"idx": np.asarray(dev.abs_idx, np.int64)},
                            batch_size)
        else:
            it = batch_iter(data, batch_size)
        scan = None
        if scan_eval_step is not None:
            k = scan_eval_step.k
            scan = (scan_eval_step if dev is None
                    else scan_eval_step.with_store(dev.data))
            plan = [k] * (n_batches // k) + ([n_batches % k]
                                             if n_batches % k else [])
            it = _scan_groups(it, plan, k)
        parts = []
        for batch, n_valid in it:
            host = {key: torch.from_numpy(np.ascontiguousarray(v))
                    for key, v in batch.items()}
            if isinstance(n_valid, list):
                out = scan(host)
                parts += [(out["probs"][j, :nv], out["loss"][j, :nv])
                          for j, nv in enumerate(n_valid)]
                continue
            if scan is not None:
                out = scan.single(host)
                parts.append((out["probs"][:n_valid], out["loss"][:n_valid]))
                continue
            with span("mpmc.eval.eager"):
                with h2d(host.values()):
                    batch = {key: v.to(device) for key, v in host.items()}
                probs, loss = eval_step(batch if dev is None
                                        else gather_batch(batch, dev.data))
            parts.append((probs[:n_valid], loss[:n_valid]))
        with span("mpmc.sync", where="eval"):
            probs = torch.cat([p for p, _ in parts]).cpu().numpy()
            losses = torch.cat([l for _, l in parts]).cpu().numpy()
        labels = data.get("label")
        if labels is None:
            return EvalResult(float("nan"), float("nan"), float("nan"), 0.5,
                              probs)
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
    # prefetch_batches' stall counters over the run: gets, empty_gets,
    # wait_s.
    input_pipeline: Dict[str, float] = dataclasses.field(
        default_factory=dict)


def _emit_threshold(cfg: TrainConfig, res: EvalResult) -> float:
    return (cfg.emit_threshold if cfg.emit_threshold is not None
            else res.threshold)


def _host_tensors(batch: Dict[str, np.ndarray], pin: bool
                  ) -> Dict[str, torch.Tensor]:
    """The batch as CPU tensors, in page-locked memory under ``pin``, so
    that the consumer's copy to the card is asynchronous.  Runs on the
    prefetch thread; the copy itself is issued by the consumer on the
    current stream, ordered with the steps.  The page-locked blocks come
    from PyTorch's caching host allocator: a block goes back to its cache
    once the copies that read it have run, and the next batch of the same
    size reuses it, so steady-state batches allocate no new pinned
    memory."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if pin else t
    return out


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
        checkpointer=None, scan_train_step=None,
        scan_eval_step=None, dev_test: Optional[DeviceData] = None,
        dev_val: Optional[DeviceData] = None) -> FitResult:
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

    Batches are the packed plan's (``packed_plan``) or, unpacked, under
    ``cfg.data.device_resident`` the shuffled ``train_rows`` of the
    train step's resident store as ``idx``, else the same rows of
    ``train_data`` copied from the host; the order comes from
    ``np.random.default_rng(cfg.seed + fold)`` as in the JAX package, the
    same in both modes.  The evals gather their batches on the device
    from ``dev_test`` and ``dev_val`` (:class:`DeviceData`) when given,
    else copy them from the host.  A background thread
    (:func:`prefetch_batches`) builds each batch and pins it ahead of the
    step.  Losses and grad norms are
    read back at each log or eval point; a non-finite loss writes the
    offending batch (row indices resolved to the fold's rows) and its grad
    norm to ``nonfinite_fold<k>_epoch<e>_batch<b>.npz`` in the working
    directory, then raises ``FloatingPointError``.  With
    ``cfg.profile_dir`` dispatches 3 to 5 of epoch 0 run under the
    profiler, whose trace goes there.  Each epoch ends with a log of its
    items/s (the rows it trained over its seconds, evals included) and
    the input wait.  The loop's layer boundaries are ``utils.profiling``
    spans: the eager steps (``mpmc.train.eager``), their copies
    (``mpmc.h2d``) and the reads of the losses (``mpmc.sync``).

    With ``scan_train_step`` (``train.graphs.make_scan_train_step`` over
    ``train_step``, K = ``cfg.scan_steps`` > 1) the epoch runs by the
    group plan (``_scan_group_plan``): each full group of K steps is one
    dispatch of the stacked ``[K, ...]`` batch, the rest single steps
    through its ``single`` (a graph of one step on a CUDA device); a
    non-finite loss inside a group dumps and names its own step.  With
    ``scan_eval_step`` the evals group K batches a dispatch likewise.

    A ``train_step`` restored from a checkpoint carries its optimizer's
    step count, and the run resumes there as the JAX loop does: the
    skipped epochs' shuffles are drawn, a mid-epoch prefix of batches is
    replayed without training, and the best F1 and threshold come back
    from the checkpointer's sidecar, so the TSVs are rewritten only on an
    improvement.  The dropout and augmentation draws continue from the
    restored generator.

    Under a multi-process layout (``train_step.sync``) every rank runs this
    loop alike: an unpacked batch is cut to the rank's rows (a packed plan
    yields them itself), the evals gather every rank's rows
    (``GradSync.eval_step``), and rank 0 alone writes the TSVs, the dump
    and the checkpoints; ``on_best`` runs on every rank (it may gather)."""
    from mpmc_tpu_torch.parallel.distributed import is_writer
    bs = cfg.data.batch_size
    scan_k = scan_train_step.k if scan_train_step is not None else 1
    sync = getattr(train_step, "sync", None)
    writer = is_writer()
    n_train = len(train_data["label"])
    resident = packed_plan is None and cfg.data.device_resident
    if packed_plan is not None:
        steps_per_epoch = packed_plan.steps_per_epoch
    else:
        steps_per_epoch = (n_train + bs - 1) // bs
    if resident and train_rows is None:
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
    pending: List[Tuple[int, int, Dict, Dict[str, np.ndarray]]] = []
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

    # Row index -> row of ``train_data``, for the failure dump of a
    # resident batch, which carries only the store's row indices.
    local_of = None
    if resident and len(train_rows):
        local_of = np.zeros(int(np.max(train_rows)) + 1, np.int64)
        local_of[train_rows] = np.arange(len(train_rows))

    def dump_payload(host_batch: Dict[str, np.ndarray],
                     j: Optional[int]) -> Dict:
        """The offending step's batch (step ``j`` of a stacked group)."""
        payload = {k: np.asarray(v if j is None else v[j])
                   for k, v in host_batch.items()}
        if local_of is not None and "idx" in payload:
            idx = payload["idx"]
            payload.update({k: np.asarray(v)[local_of[idx]]
                            for k, v in train_data.items()})
            payload["idx"] = idx
        return payload

    def flush():
        if not pending:
            return
        with span("mpmc.sync", where="flush"):
            vals = torch.cat([torch.stack([m["loss"].reshape(-1),
                                           m["grad_norm"].reshape(-1)], 1)
                              for _, _, m, _ in pending]).cpu().numpy()
        row = 0
        for ep, bi_, m, host_batch in pending:
            size = m["loss"].numel()
            for j, (loss, gnorm) in enumerate(vals[row:row + size]):
                if not np.isfinite(loss):
                    step_bi = bi_ - (size - 1 - j)    # bi_: the group's last
                    dump = f"nonfinite_fold{fold}_epoch{ep}_batch{step_bi}.npz"
                    if writer:
                        np.savez(dump, **dump_payload(
                            host_batch, j if m["loss"].dim() else None),
                                 grad_norm=np.float64(gnorm))
                    pending.clear()
                    raise FloatingPointError(
                        f"non-finite loss at epoch {ep} batch {step_bi} "
                        f"(grad_norm={gnorm:.3e}); batch dumped to {dump}")
                steps.append({"loss": float(loss), "grad_norm": float(gnorm)})
            row += size
        pending.clear()

    from mpmc_tpu_torch.utils.profiling import trace
    pf_stats: Dict[str, float] = {}
    pin = device.type == "cuda"
    dispatch_no = 0
    profiler = contextlib.ExitStack()   # holds the trace while it runs
    with profiler:                      # closed on any exit
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            first = len(steps)
            rows = 0
            pf_at_start = dict(pf_stats)
            if packed_plan is not None:
                it = packed_plan.epoch_iter(data_rng)
            else:
                # The same shuffle either way: resident batches carry the
                # rows' indices, host-fed ones the rows.
                it = batch_iter({"idx": train_rows.astype(np.int64)}
                                if resident else train_data, bs,
                                shuffle=True, rng=data_rng, with_valid=True)
                if sync is not None:
                    it = (({k: v[sync.rows(bs)] for k, v in b.items()}, n)
                          for b, n in it)
            if scan_k > 1:
                it = _scan_groups(it, _scan_group_plan(
                    steps_per_epoch, check_interval, scan_k,
                    eval_on=test_data is not None), scan_k)
            bi = 0
            for host, host_batch, n_valid in prefetch_batches(
                    it, lambda b: _host_tensors(b, pin), stats=pf_stats):
                group = len(n_valid) if isinstance(n_valid, list) else 1
                if epoch == start_epoch and bi + group <= resume_bi:
                    bi += group             # trained before the checkpoint
                    continue
                if cfg.profile_dir and epoch == 0 and dispatch_no < 6:
                    # Dispatches 3 to 5: the first carries the one-time set-up,
                    # the second the warm-up; from the third on, steady state.
                    dispatch_no += 1
                    if dispatch_no == 3:
                        profiler.enter_context(trace(cfg.profile_dir))
                    elif dispatch_no == 6:
                        flush()
                        profiler.close()
                        log.info("profiler trace written to %s",
                                 cfg.profile_dir)
                if group > 1:
                    metrics = scan_train_step(host)
                elif scan_train_step is not None:
                    metrics = scan_train_step.single(host)
                else:
                    with span("mpmc.train.eager"):
                        with h2d(host.values()):
                            batch = {k: v.to(device, non_blocking=True)
                                     for k, v in host.items()}
                        metrics = train_step(batch)
                prev_bi, bi = bi, bi + group
                step_count += group
                rows += sum(n_valid) if group > 1 else n_valid
                pending.append((epoch, bi, metrics, host_batch))
                if bi // LOG_EVERY > prev_bi // LOG_EVERY:
                    flush()
                    log.info("TRAIN | Epoch [%d] | Batch [%d/%d] | "
                             "Loss: %.4f | Grad Norm: %.4f", epoch, bi,
                             steps_per_epoch,
                             np.mean([m["loss"] for m in steps[-LOG_EVERY:]]),
                             steps[-1]["grad_norm"])
                if test_data is None or not (bi % check_interval == 0
                                             or bi == steps_per_epoch):
                    continue
                flush()
                t_res = run_eval(eval_step, test_data, bs, device,
                                 scan_eval_step, dev_test)
                history.append({"epoch": epoch, "batch": bi,
                                "step": step_count,
                                "test_f1": t_res.macro_f1,
                                "test_loss": t_res.loss})
                log.info(" TEST | Epoch [%d] | Batch [%d/%d] | Loss: %.4f | "
                         "Acc: %.4f | F1: %.4f | thresh: %.4f", epoch, bi,
                         steps_per_epoch, t_res.loss, t_res.accuracy,
                         t_res.macro_f1, t_res.threshold)
                v_res = None
                if val_data is not None:
                    v_res = run_eval(eval_step, val_data, bs, device,
                                     scan_eval_step, dev_val)
                    log.info("  VAL | Epoch [%d] | F1: %.4f", epoch,
                             v_res.macro_f1)
                if t_res.macro_f1 > best_f1:
                    best_f1 = t_res.macro_f1
                    best_thr = _emit_threshold(cfg, t_res)
                    if tsv_prefix and test_ids is not None and writer:
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
                        state = train_step.state_dict()   # may gather
                        if writer:
                            checkpointer.save(state, step_count,
                                              {"test_f1": best_f1,
                                               "threshold": best_thr})
            flush()
            if epoch == 0 and 3 <= dispatch_no < 6:   # ended before dispatch 6
                profiler.close()
                log.info("profiler trace written to %s", cfg.profile_dir)
            losses = [m["loss"] for m in steps[first:]]
            seconds = time.time() - t0
            gets = int(pf_stats.get("gets", 0) - pf_at_start.get("gets", 0))
            wait_s = (pf_stats.get("wait_s", 0.0)
                      - pf_at_start.get("wait_s", 0.0))
            empty = int(pf_stats.get("empty_gets", 0)
                        - pf_at_start.get("empty_gets", 0))
            log.info("TRAIN | Epoch [%d] done in %.1fs | loss %.4f | "
                     "%.1f items/s | input-wait %.2f ms/dispatch (%d/%d "
                     "empty gets)", epoch, seconds,
                     float(np.mean(losses)) if losses else float("nan"),
                     rows / seconds if seconds > 0 else 0.0,
                     1e3 * wait_s / max(gets, 1), empty, gets)
    return FitResult(best_f1, best_thr, history, steps,
                     input_pipeline=dict(pf_stats))
