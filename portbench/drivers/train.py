"""Fold training, as the system's fold driver runs it: ``build_fold`` then
``fit`` for each stratified fold over the train memes, the dev memes as the
test split (without them, as 2A folds over train and dev, the val split is
the test split too), evals of the test and val splits at the recipe's
cadence, the arrays device-resident or host-fed as the traffic says
(``device_resident``), no checkpoints (TSVs go under ``TMPDIR``).

Set-up builds the first fold (``seed % num_folds``), starts it from the
benchmark's weights and runs its first ``checked_steps`` steps through the
window's own call, the fold's grouped dispatch (``scan_train_step``) on
the batches ``fit`` draws first: the first group of K steps runs eagerly
and is captured as a CUDA graph, the next ones are replays of that graph.
``fit`` then resumes that same fold after them.  Those steps are what the
check holds against the reference: each step's loss, per-meme logits and
pre-clip gradient norm, the first gradient of each leaf as the optimizer's
state after one step holds it, and each leaf's change after the last
checked step.  The augmentation draws, the dropout masks and the logits of
those steps are recorded on the device (:class:`Recorder`), so that a
replay records as an eager step does.  The reference takes each checked
meme from the memes made: by the row indices a resident batch carries,
else found by its own tokens (out of its packed row) or pixels.  The
window trains the first fold's rest and then the next folds in turn; the
fold running when the window closes completes and counts.  A traced run
traces the second fold whole.

A traffic mix with a ``work_seed`` fixes the amount of work whatever the
seed: the memes' order of lengths and labels (``portbench/data.py``), the
system's own seed (its shuffles, so its packed row budgets and the graph
captures they cause) and the first fold come from it; the weights, token
ids, pixels and so the numbers checked still come from the seed."""

from __future__ import annotations

import gc
import hashlib
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check as checks
from portbench import spec
from portbench.counts import attention, flops
from portbench.data import make_memes
from portbench.drivers.common import (bucket, load_train_weights,
                                      model_weights, token_counts,
                                      train_config)
from portbench.reference.augment import augment as ref_augment
from portbench.reference.nets import CONTROL, F32, Precision
from portbench.reference.train import train_steps


PACKED_IDS = {"t_": "text_ids", "c_": "caption_ids"}


def _contents(batch: Dict[str, np.ndarray]) -> List[bytes]:
    """What tells each meme of ``batch`` from the others: its text tokens
    (out of its packed row when the batch is packed), or without text its
    pixels' digest."""
    if "t_ids" in batch:
        out = []
        for row, slot in zip(batch["t_row_of"], batch["t_slot_of"]):
            own = batch["t_segments"][row] == slot
            out.append(batch["t_ids"][row][own].astype(np.int64).tobytes())
        return out
    if "text_ids" in batch:
        return [ids[m > 0].astype(np.int64).tobytes()
                for ids, m in zip(batch["text_ids"], batch["text_mask"])]
    return [hashlib.sha256(np.ascontiguousarray(im).tobytes()).digest()
            for im in batch["image"]]


class Recorder:
    """Each of the first ``n`` train steps' augmentation draws, dropout
    keep masks and logits, kept on the device at the slot of a step
    counter that the steps advance on the device (written by the draws'
    wrapper and by forward hooks on the model and on its ``Dropout``
    modules), so a step replayed in a CUDA graph records as an eager one
    does; steps past ``n`` write a spare slot.  While ``on`` is false (and
    in eval mode) the hooks add nothing to what they run in."""

    def __init__(self, n: int):
        self.n, self.on = n, True
        self.rings: Dict[str, torch.Tensor] = {}
        self.count = self.slot = None
        self.hooks: list = []

    def attach(self, model: torch.nn.Module) -> None:
        from mpmc_tpu_torch.models.norm import Dropout
        for name, mod in model.named_modules():
            if isinstance(mod, Dropout) and mod.rate > 0:
                self.hooks.append(mod.register_forward_hook(
                    self._keep_hook(name)))
        self.hooks.append(model.register_forward_hook(self._logits_hook))

    def _put(self, name: str, value: torch.Tensor) -> None:
        ring = self.rings.get(name)
        if ring is None:
            if (value.is_cuda
                    and torch.cuda.is_current_stream_capturing()):
                return
            if self.count is None:
                self.count = torch.zeros((), dtype=torch.long,
                                         device=value.device)
                self.slot = torch.zeros(1, dtype=torch.long,
                                        device=value.device)
            ring = self.rings[name] = torch.zeros(
                (self.n + 1,) + tuple(value.shape), dtype=value.dtype,
                device=value.device)
        if ring.shape[1:] == value.shape:
            ring.index_copy_(0, self.slot, value.unsqueeze(0))

    def _keep_hook(self, name: str):
        def hook(mod, inputs, output):
            if self.on and mod.training:
                self._put("drop:" + name, output != 0)
        return hook

    def _logits_hook(self, mod, inputs, output):
        if not (self.on and mod.training):
            return
        self._put("logits", output.detach().float())
        if self.count is None:
            return
        self.count.add_(1)
        self.slot.copy_(torch.clamp(self.count, max=self.n).view(1))

    def draws(self, draws) -> None:
        if self.on:
            for i, d in enumerate(draws):
                self._put(f"draw:{i}", d)

    def steps(self) -> List[Dict[str, torch.Tensor]]:
        """What was recorded, a dict a step: ``logits``, ``draws`` (the
        augmentation's, in order) and ``drop`` (keep masks by module)."""
        out = []
        for j in range(self.n):
            rec = {k: v[j] for k, v in self.rings.items()}
            out.append({
                "logits": rec.pop("logits"),
                "draws": [rec.pop(f"draw:{i}") for i in range(3)
                          if f"draw:{i}" in rec],
                "drop": {k[len("drop:"):]: v for k, v in rec.items()}})
        return out

    def detach(self) -> None:
        for h in self.hooks:
            h.remove()
        self.hooks, self.rings = [], {}


class RecordingAugment:
    """The system's training augmentation (``train_augment``: its draws from
    the step's generator, then the fused image kernel and the rotation),
    handing each step's draws to ``recorder`` while there is one."""

    def __init__(self):
        self.recorder: Optional[Recorder] = None

    def __call__(self, images_u8: torch.Tensor, generator: torch.Generator):
        from mpmc_tpu_torch.image.augment import (augment_draws,
                                                  augment_with_draws)
        draws = augment_draws(images_u8.shape[0], generator)
        if self.recorder is not None:
            self.recorder.draws(draws)
        return augment_with_draws(images_u8, *draws)


def first_grad_norms(opt) -> Dict[str, float]:
    """Each leaf's norm of the first (clipped) gradient, from the
    optimizer's state after one step: Adam's second moment is ``(1 - b2)
    g^2``; factored RMS keeps ``g^2`` (its decay is 0 at the first step),
    as a whole or as means over the largest dimension."""
    from mpmc_tpu_torch.train.step import ADAM_B2
    sums = []
    for name, st in opt.state.items():
        if "nu" in st:
            sums.append(st["nu"].double().sum() / (1 - ADAM_B2))
        elif "v" in st:
            sums.append(st["v"].double().sum())
        else:
            _, d0 = opt._fold_factored_dims(opt.params[name].shape, name)
            sums.append(st["v_row"].double().sum()
                        * opt.params[name].shape[d0])
    norms = torch.sqrt(torch.stack(sums)).cpu().tolist()
    return dict(zip(opt.state, norms))


def change_norms(opt, W: Dict[str, torch.Tensor]) -> Dict[str, float]:
    norms = torch.stack([torch.linalg.vector_norm((p - W[n]).double())
                         for n, p in opt.params.items()]).cpu().tolist()
    return dict(zip(opt.params, norms))


class Session:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.seed, self.device = seed, device
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.kind = spec.kind(self.cfg["kind"])

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from mpmc_tpu_torch.cli.experiments import resident_store
        from mpmc_tpu_torch.cv.kfold import stratified_kfold
        cfg, t, dev = self.cfg, self.traffic, self.device
        kind = self.kind.PORT_KIND
        work_seed = t.get("work_seed", self.seed)
        self.tc = tc = train_config(cfg, work_seed, dev,
                                    device_resident=t["device_resident"])
        self.data = make_memes(cfg, t, t["train_memes"], self.seed, 0, dev)
        self.test = (make_memes(cfg, t, t["test_memes"], self.seed, 1, dev)
                     if t.get("test_memes") else None)
        bucket(tc, [d for d in (self.data, self.test) if d is not None])
        self.W = model_weights(cfg, t, self.seed, tc, dev)
        self.splits = stratified_kfold(self.data["label"], tc.data.num_folds,
                                       tc.data.fold_seed)
        self.store = resident_store(tc, self.data, dev, kind)
        self.test_store = (resident_store(tc, self.test, dev, kind)
                           if self.test is not None else {})
        self.ids = [f"train_{i:05d}" for i in range(t["train_memes"])]
        self.test_ids = [f"dev_{i:05d}" for i in range(t.get("test_memes",
                                                              0))]
        self.by_content = None
        self.tmp = tempfile.mkdtemp(prefix="portbench_")
        self.augment = RecordingAugment()
        self.first_fold = work_seed % tc.data.num_folds
        self.run0 = self._build(self.first_fold)
        self._first_steps()

    def _build(self, k: int):
        from mpmc_tpu_torch.cli.experiments import _select, build_fold
        tr_idx, _ = self.splits[k]
        run = build_fold(self.tc, _select(self.data, tr_idx), tr_idx,
                         self.store, self.device, k, augment=self.augment,
                         kind=self.kind.PORT_KIND)
        load_train_weights(run.train_step, self.W)
        return run

    def _first_steps(self) -> None:
        """The first fold's first ``checked_steps`` steps, grouped as
        ``fit`` groups them, through the fold's grouped dispatch, keeping
        what the check needs; the first step's gradients are read from the
        optimizer's state right after that step."""
        from mpmc_tpu_torch.cli.experiments import _select
        from mpmc_tpu_torch.train.loop import (_host_tensors,
                                               _scan_group_plan, _scan_groups,
                                               batch_iter)
        run, tc, k = self.run0, self.tc, self.first_fold
        grouped, K = run.scan_train_step, run.scan_train_step.k
        n = self.traffic["checked_steps"]
        if n % K or n < 2 * K:
            raise ValueError(f"checked_steps {n}: whole groups of {K}, a "
                             "replay among them")
        tr_idx, _ = self.splits[k]
        rng = np.random.default_rng(tc.seed + k)
        # As ``fit`` draws them: resident batches carry the rows' indices,
        # host-fed ones the rows.
        it = (run.plan.epoch_iter(rng) if run.plan is not None else
              batch_iter({"idx": tr_idx.astype(np.int64)}
                         if tc.data.device_resident
                         else _select(self.data, tr_idx),
                         tc.data.batch_size, shuffle=True, rng=rng,
                         with_valid=True))
        spe = run.steps_per_epoch
        it = _scan_groups(it, _scan_group_plan(
            spe, max(spe // max(tc.eval_per_epoch, 1), 1), K, eval_on=True), K)
        opt = run.train_step.optimizer
        rec = self.recorder = Recorder(n)
        rec.attach(run.train_step.model)
        self.augment.recorder = rec
        inner, calls = grouped.step, []

        def step(batch):
            out = inner(batch)
            if not calls:
                calls.append(first_grad_norms(opt))
            return out

        grouped.step = step
        self.batches, outs, self.setup_rows = [], [], 0
        try:
            for _ in range(n // K):
                group, n_valid = next(it)
                if not isinstance(n_valid, list) or len(n_valid) != K:
                    raise ValueError("the checked steps are not whole groups")
                outs.append(grouped(_host_tensors(
                    group, self.device.type == "cuda")))
                self.setup_rows += int(sum(n_valid))
                self.batches += [{key: np.asarray(v[j]) for key, v in
                                  group.items()} for j in range(K)]
        finally:
            grouped.step = inner
            rec.on = False
            self.augment.recorder = None
        self.recorded = [{"logits": r["logits"].cpu().numpy(),
                          "draws": r["draws"], "drop": r["drop"]}
                         for r in rec.steps()]
        self.port = {
            "losses": torch.cat([o["loss"] for o in outs]).tolist(),
            "grad_norm": torch.cat([o["grad_norm"] for o in outs]).tolist(),
            "logits": [r["logits"] for r in self.recorded],
            "grad_norms": calls[0], "change_norms": change_norms(opt, self.W)}
        self.total_steps = spe * tc.epochs

    # ------------------------------------------------------------ window
    def _fit(self, k: int, run):
        from mpmc_tpu_torch.cli.experiments import _select
        from mpmc_tpu_torch.train.loop import DeviceData, fit
        tr_idx, va_idx = self.splits[k]
        val = _select(self.data, va_idx)
        val_ids = [self.ids[i] for i in va_idx]
        dev_val = DeviceData(self.store, va_idx) if self.store else None
        dev_test = (DeviceData(self.test_store, np.arange(len(self.test_ids)))
                    if self.test_store else dev_val)
        return fit(run.train_step, run.eval_step, self.tc,
                   _select(self.data, tr_idx), self.device,
                   test_data=self.test if self.test is not None else val,
                   val_data=val,
                   test_ids=self.test_ids if self.test is not None
                   else val_ids, val_ids=val_ids, fold=k,
                   tsv_prefix=os.path.join(self.tmp, "portbench"),
                   packed_plan=run.plan, train_rows=tr_idx,
                   scan_train_step=run.scan_train_step,
                   scan_eval_step=run.scan_eval_step,
                   dev_test=dev_test, dev_val=dev_val)

    def _need(self, k: int, n_evals: int) -> Dict[str, float]:
        """FLOPs and attention need of fold ``k`` trained whole with
        ``n_evals`` evals of its val and the test split."""
        cfg, epochs, kind = self.cfg, self.tc.epochs, self.kind
        tr_idx, va_idx = self.splits[k]
        tokens = token_counts(self.data, tr_idx)
        train_f = epochs * flops.TRAIN_FACTOR * kind.forward_flops(
            cfg, len(tr_idx), tokens)
        ops, nbytes = attention.model_need(
            kind.attention_parts(cfg, len(tr_idx), tokens), True)
        ev_f, ev_o, ev_b = 0.0, 0.0, 0.0
        test = ((self.test, None) if self.test is not None
                else (self.data, va_idx))
        for d, rows in ((self.data, va_idx), test):
            n = len(rows) if rows is not None else len(d["label"])
            tokens = token_counts(d, rows)
            ev_f += kind.forward_flops(cfg, n, tokens)
            o, b = attention.model_need(kind.attention_parts(cfg, n, tokens),
                                        False)
            ev_o, ev_b = ev_o + o, ev_b + b
        return {"flops": train_f + n_evals * ev_f,
                "attn_ops": epochs * ops + n_evals * ev_o,
                "attn_bytes": epochs * nbytes + n_evals * ev_b}

    def window(self, seconds: float, tracer=None) -> dict:
        """Folds back to back for ``seconds`` (with ``tracer``: the first
        fold's rest untraced, then one whole fold traced)."""
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k, run, self.run0 = self.first_fold, self.run0, None
        memes, steps, folds, ctx, detail = 0, 0, 0, {}, []
        while True:
            traced = tracer is not None and folds == 1
            f0 = time.perf_counter()
            if run is None:
                if traced:
                    tracer.start()
                run = self._build(k)
            res = self._fit(k, run)
            if traced:
                tracer.stop()
            ev = run.scan_eval_step
            detail.append({"fold": k, "seconds": time.perf_counter() - f0,
                           "steps": len(res.steps),
                           "train_captures": run.scan_train_step.captures,
                           "eval_captures": ev.captures + sum(
                               b.captures for b in ev._stores.values())})
            n = len(self.splits[k][0]) * self.tc.epochs
            memes += n - (self.setup_rows if folds == 0 else 0)
            steps += len(res.steps)
            if traced:
                pipe = res.input_pipeline
                ctx = {"train_steps": len(res.steps),
                       "graphed_steps": run.scan_train_step.replays
                       * run.scan_train_step.k,
                       "input_wait_s": pipe.get("wait_s", 0.0),
                       "input_gets": pipe.get("gets", 0),
                       **self._need(k, len(res.history))}
            run = None
            gc.collect()
            folds += 1
            if tracer is not None and folds == 2:
                break
            if tracer is None and time.perf_counter() >= deadline:
                break
            k = (k + 1) % self.tc.data.num_folds
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        return {"end_to_end": {"train_memes_per_s": memes / elapsed},
                "attempted": steps, "failed": 0, "layer_ctx": ctx,
                "window_s": elapsed, "detail": detail}

    def release(self) -> None:
        self.run0 = None
        self.recorder.detach()
        self.store = self.test_store = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.tmp, ignore_errors=True)

    # ------------------------------------------------------------- check
    def ref_batches(self) -> List[dict]:
        """The checked steps' inputs as the reference takes them: the
        memes' raw arrays by row, the images augmented with the recorded
        draws, the recorded dropout masks in the memes' own layout."""
        out = []
        for batch, rec in zip(self.batches, self.recorded):
            rows = self._rows(batch)
            b = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
                     self.device) for k, v in self.data.items()}
            if "image" in b:
                b["image"] = ref_augment(b["image"], *rec["draws"])
            b["valid"] = torch.from_numpy(batch["valid"]).to(self.device)
            b["drop"] = {name: self._unpacked(name, keep, batch, b)
                         for name, keep in rec["drop"].items()}
            out.append(b)
        return out

    def _rows(self, batch: dict) -> np.ndarray:
        """The memes (rows of the train memes) of a checked step's batch,
        slot by slot: the row indices a resident batch carries, else each
        slot found by its content among the memes made.  A slot that holds
        none (a packed plan's empty slot, ``valid`` 0) takes the first
        meme; a valid one that holds none fails the run."""
        for key in ("idx", "img_idx"):
            if key in batch:
                return np.asarray(batch[key])
        if self.by_content is None:
            self.by_content = {c: i for i, c in
                               enumerate(_contents(self.data))}
        rows = np.array([self.by_content.get(c, -1)
                         for c in _contents(batch)])
        lost = (rows < 0) & (np.asarray(batch["valid"]) > 0)
        if lost.any():
            raise ValueError(f"{int(lost.sum())} valid memes of a checked "
                             "step are none of the memes made")
        return np.maximum(rows, 0)

    def _unpacked(self, name: str, keep: torch.Tensor, batch: dict,
                  b: dict) -> torch.Tensor:
        """An encoder's keep mask ``[R, P, H]`` over the packed rows as
        ``[B, S, H]`` over each meme's own tokens (a meme's tokens start at
        its row's ``start_of``; the kind's ``PACKED`` says which encoder's
        rows are which); any other mask as it is."""
        key = next((v for p, v in self.kind.PACKED.items()
                    if name.startswith(p)), None)
        if keep.dim() != 3 or key is None or key + "row_of" not in batch:
            return keep
        S = b[PACKED_IDS[key]].shape[1]
        dev = keep.device
        row = torch.from_numpy(batch[key + "row_of"]).long().to(dev)
        start = torch.from_numpy(batch[key + "start_of"]).long().to(dev)
        pos = (start[:, None] + torch.arange(S, device=dev)[None, :]).clamp(
            max=keep.shape[1] - 1)
        return keep[row[:, None], pos]

    def reference(self, P: Precision = F32) -> dict:
        return train_steps(self.W, self.cfg, self.ref_batches(),
                           self.total_steps, P)

    def check(self, ref: dict) -> Dict[str, float]:
        return checks.train_gaps(self.port, ref, self._valid())

    def control(self, ref: dict) -> Dict[str, float]:
        """The check's numbers with the control (``nets.CONTROL``: float8
        products) in the system's place."""
        return checks.train_gaps(self.reference(CONTROL), ref, self._valid())

    def _valid(self) -> List[np.ndarray]:
        return [np.asarray(b["valid"]) for b in self.batches]
