"""The eval step (port of ``_build_eval_fn`` in ``mpmc_tpu/train/step.py``
for the single-logit 2C model).

Precision policy under ``bf16``: every floating parameter runs in bf16
while BatchNorm running statistics stay f32, and the image is cast to bf16
after normalization, as the JAX package's eval does.  The port casts the
model's parameters once, in place (the JAX package casts a copy on every
call); this halves the weights' device memory for serving.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from mpmc_tpu_torch.config import TrainConfig
from mpmc_tpu_torch.image.augment import eval_preprocess
from mpmc_tpu_torch.ops.losses import sigmoid_focal_loss

EvalStep = Callable[[Dict[str, torch.Tensor]],
                    Tuple[torch.Tensor, torch.Tensor]]


def make_eval_step(model: nn.Module, cfg: TrainConfig,
                   grayscale: bool = False) -> EvalStep:
    """``step(batch) -> (probs [B], per-sample focal loss [B])``.  The batch
    holds ``text_ids``, ``text_mask``, uint8 ``image [B,H,W,C]``,
    ``caption_ids``, ``caption_mask`` and optionally ``label``; the loss is
    zero without labels."""
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    for p in model.parameters():
        p.data = p.data.to(dtype)
    model.eval()

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]):
        image = eval_preprocess(batch["image"], grayscale=grayscale).to(dtype)
        logits = model(batch.get("text_ids"), batch.get("text_mask"), image,
                       batch.get("caption_ids"), batch.get("caption_mask"))
        logits = logits.to(torch.float32)
        probs = torch.sigmoid(logits)
        if "label" in batch:
            loss = sigmoid_focal_loss(logits, batch["label"],
                                      alpha=cfg.focal_alpha,
                                      gamma=cfg.focal_gamma, reduction="none")
        else:
            loss = torch.zeros_like(probs)
        return probs, loss

    return step
