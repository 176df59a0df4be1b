"""HF-Trainer-style wrapper (port of ``mpmc_tpu/train/trainer.py``).

A thin object API over the port's train and eval steps for users coming
from ``transformers.Trainer``: ``train()`` -> ``evaluate()`` ->
``predict()`` -> ``save_model()``.  ``save_model`` persists the whole
training state through a :class:`~mpmc_tpu_torch.train.checkpoint.
Checkpointer`, and ``cfg.resume`` restores it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mpmc_tpu_torch.config import TrainConfig
from mpmc_tpu_torch.train.checkpoint import Checkpointer
from mpmc_tpu_torch.train.loop import EvalResult, FitResult, fit, run_eval
from mpmc_tpu_torch.train.step import build_train_step, make_eval_step


class Trainer:
    """Trains ``model`` (one of the port's classifiers, f32 weights) on the
    numpy ``train_data`` (its input keys and ``label``) on ``device`` (CUDA
    unless given), evaluating on ``eval_data``.  The train arrays stay on
    the device and batches carry row indices (under
    ``cfg.data.device_resident=False`` the batches come from the host);
    dropout and augmentation
    draw from a generator seeded with ``cfg.seed``.  With
    ``cfg.checkpoint_dir`` every new best is checkpointed, and with
    ``cfg.resume`` the newest checkpoint there is restored first."""

    def __init__(self, model: nn.Module, cfg: TrainConfig,
                 train_data: Dict[str, np.ndarray],
                 eval_data: Optional[Dict[str, np.ndarray]] = None,
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but torch.cuda."
                               "is_available() is False; pass device='cpu'")
        self.model = model.to(self.device)
        self.train_data = train_data
        self.eval_data = eval_data
        n = len(train_data["label"])
        bs = cfg.data.batch_size
        total_steps = ((n + bs - 1) // bs) * cfg.epochs
        store = ({k: torch.from_numpy(np.ascontiguousarray(v)).to(
                      self.device) for k, v in train_data.items()}
                 if cfg.data.device_resident else {})
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._train_step = build_train_step(self.model, cfg, total_steps,
                                            store, generator)
        self._eval_step = make_eval_step(self.model, cfg,
                                         cast_in_place=False)
        self._ckpt = None
        if cfg.checkpoint_dir:
            self._ckpt = Checkpointer(cfg.checkpoint_dir)
            if cfg.resume:
                self._ckpt.restore_latest(self._train_step)

    def train(self) -> FitResult:
        result = fit(self._train_step, self._eval_step, self.cfg,
                     self.train_data, self.device, test_data=self.eval_data,
                     checkpointer=self._ckpt)
        if self._ckpt is not None:
            self._ckpt.wait()
        return result

    def evaluate(self) -> EvalResult:
        if self.eval_data is None:
            raise ValueError("the Trainer has no eval_data")
        return run_eval(self._eval_step, self.eval_data,
                        self.cfg.data.eval_batch_size, self.device)

    def predict(self, data: Dict[str, np.ndarray]) -> np.ndarray:
        """Per-sample propaganda probabilities for an (optionally
        unlabelled) split."""
        return run_eval(self._eval_step, data, self.cfg.data.eval_batch_size,
                        self.device).probs

    def save_model(self, step: int = 0,
                   metrics: Optional[Dict] = None) -> None:
        if self._ckpt is None:
            raise ValueError("TrainConfig.checkpoint_dir not set")
        self._ckpt.save(self._train_step.state_dict(), step=step,
                        metrics=metrics or {})
        self._ckpt.wait()
