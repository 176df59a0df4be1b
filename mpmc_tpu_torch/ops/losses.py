"""Losses (port of ``mpmc_tpu/ops/losses.py``): the sigmoid focal loss, the
formula of torchvision's ``sigmoid_focal_loss`` (alpha on the positive
class, 1-alpha on the negative, ``FL = alpha_t * (1 - p_t)^gamma * BCE``),
and softmax cross-entropy over integer labels for the 2-logit heads, with
optional per-class weights."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0,
                       reduction: str = "mean") -> torch.Tensor:
    targets = targets.to(logits.dtype)
    p = torch.sigmoid(logits)
    # Numerically stable BCE-with-logits, written as the JAX package does.
    ce = F.relu(logits) - logits * targets + torch.log1p(
        torch.exp(-torch.abs(logits)))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          class_weights: Optional[torch.Tensor] = None,
                          reduction: str = "mean") -> torch.Tensor:
    """CE over integer labels with optional per-class weights (torch's
    ``CrossEntropyLoss`` semantics: the weighted mean divides by the
    summed weights of the rows, floored at 1e-9)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if class_weights is not None:
        w = class_weights[labels.long()]
        if reduction == "mean":
            return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-9)
        nll = nll * w
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll
