"""Manifest scoring, as the system's ``predict`` runs it: the model in its
serving precision (``make_eval_step``), full groups of K batches as one
dispatch (``make_scan_eval_step``), host-fed batches through ``run_eval``.

One client in a closed loop, each request the task's dev split of
``split_memes`` memes scored whole (decoded pixels and tokens bucketed as
the system does, made in set-up, unlabelled as a user's manifest is), the
next request sent when the probabilities of the last are on the host: what
a user does who scores the dev manifest with a model, once per fold
model.  Set-up scores one request, so that every batch shape of the
traffic is warm.  A traced run traces the first ``trace_seconds`` of
requests."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check as checks
from portbench import spec
from portbench.counts import attention
from portbench.data import make_memes
from portbench.drivers.common import (bucket, model_weights, token_counts,
                                      train_config)
from portbench.reference.nets import CONTROL, F32, Precision, normalize
from portbench.reference.train import probabilities

DEV_SPLIT = 1
REF_BLOCK = 32


class Session:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.seed, self.device = seed, device
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.kind = spec.kind(self.cfg["kind"])

    def setup(self) -> None:
        from mpmc_tpu_torch.models.classifier import build_model
        from mpmc_tpu_torch.train.graphs import graph_pool, make_scan_eval_step
        from mpmc_tpu_torch.train.step import make_eval_step
        cfg, t, dev = self.cfg, self.traffic, self.device
        self.tc = tc = train_config(cfg, self.seed, dev)
        split = make_memes(cfg, t, t["split_memes"], self.seed, DEV_SPLIT,
                           dev)
        split.pop("label")
        bucket(tc, [split])
        self.split = split
        self.W = model_weights(cfg, t, self.seed, tc, dev)
        model = build_model(tc.model, dev, kind=self.kind.PORT_KIND)
        model.load_state_dict(self.W)
        self.step = make_eval_step(model, tc)
        self.scan = make_scan_eval_step(self.step, t["scan_steps"], dev,
                                        graph_pool(dev))
        self._score()

    def _score(self) -> np.ndarray:
        from mpmc_tpu_torch.train.loop import run_eval
        return run_eval(self.step, self.split, self.traffic["batch_size"],
                        self.device, scan_eval_step=self.scan).probs

    def window(self, seconds: float, tracer=None) -> dict:
        if tracer is not None:
            seconds = self.traffic["trace_seconds"]
            replays0 = self.scan.replays
            tracer.start()
        lat: List[float] = []
        self.done: List[np.ndarray] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            r0 = time.perf_counter()
            probs = self._score()
            lat.append(time.perf_counter() - r0)
            self.done.append(probs)
        elapsed = time.perf_counter() - t0
        n = self.traffic["split_memes"]
        ctx = {}
        if tracer is not None:
            tracer.stop()
            bs, k = self.traffic["batch_size"], self.scan.k
            ctx = {"batches": len(self.done) * -(-n // bs),
                   "graphed_batches": (self.scan.replays - replays0) * k,
                   **{key: len(self.done) * v
                      for key, v in self._need().items()}}
        return {"end_to_end": {
                    "predict_memes_per_s": len(self.done) * n / elapsed,
                    "predict_request_ms_p95": 1e3 * float(
                        np.percentile(lat, 95, method="linear"))},
                "attempted": len(self.done), "failed": 0, "layer_ctx": ctx,
                "window_s": elapsed}

    def _need(self) -> Dict[str, float]:
        """FLOPs and attention need of one request."""
        n = self.traffic["split_memes"]
        tokens = token_counts(self.split)
        ops, nbytes = attention.model_need(
            self.kind.attention_parts(self.cfg, n, tokens), False)
        return {"flops": self.kind.forward_flops(self.cfg, n, tokens),
                "attn_ops": ops, "attn_bytes": nbytes}

    def release(self) -> None:
        self.step = self.scan = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference(self, P: Precision = F32) -> np.ndarray:
        """Probabilities of the split's memes, in order."""
        logits_fn = self.kind.logits
        out, n = [], self.traffic["split_memes"]
        with torch.no_grad():
            for s in range(0, n, REF_BLOCK):
                b = {k: torch.from_numpy(np.ascontiguousarray(
                         v[s:s + REF_BLOCK])).to(self.device)
                     for k, v in self.split.items()}
                if "image" in b:
                    b["image"] = normalize(b["image"])
                out.append(probabilities(logits_fn(
                    self.W, self.cfg, b, False, P)).cpu().numpy())
        return np.concatenate(out)

    def check(self, ref: np.ndarray) -> Dict[str, float]:
        """Every request of the window against the reference."""
        return checks.prob_gaps(self.done, ref)

    def control(self, ref: np.ndarray) -> Dict[str, float]:
        return checks.prob_gaps([self.reference(CONTROL)], ref)
