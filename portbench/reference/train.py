"""Plain float32 training steps of the benchmark's models, from the recipe's
description (the 2C reference script's, as the configuration file states
it):

* loss: the sigmoid focal loss (alpha on the positive class, gamma 2) of
  the one-logit head, or the softmax cross-entropy of the two-logit head,
  weighted by each row's ``valid`` and divided by their sum;
* the gradient clipped to a global norm of ``grad_clip_norm``;
* Adam (0.9, 0.999, 1e-8, bias-corrected) whose first moment is stored in
  ``adam_mu_dtype``; parameters under ``text_model``, ``caption_text_model``
  or ``image_model`` at ``encoder_lr_scale`` times the rate, the rest at
  the rate; with ``embedding_optimizer`` "factored" every
  ``word_embeddings`` table takes optax's factored RMS (decay 0.8, epsilon
  1e-30, factored over its two largest dimensions when the smaller is at
  least 128) at the encoder rate instead;
* the learning rate linear from 0 over ``int(warmup_fraction * total)``
  steps, then linear down to 0 at ``total``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.nets import F32, LOGITS, Precision

B1, B2, EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.8, 1e-30


def row_losses(logits: torch.Tensor, labels: torch.Tensor, cfg: dict
               ) -> torch.Tensor:
    head = cfg["head"]
    if head["loss"] == "focal":
        y = labels.float()
        p = torch.sigmoid(logits)
        ce = F.binary_cross_entropy_with_logits(logits, y, reduction="none")
        p_t = p * y + (1 - p) * (1 - y)
        alpha = head["focal_alpha"]
        return ((alpha * y + (1 - alpha) * (1 - y)) * ce
                * (1 - p_t) ** head["focal_gamma"])
    return F.cross_entropy(logits, labels.long(), reduction="none")


def probabilities(logits: torch.Tensor) -> torch.Tensor:
    """P(propaganda): the sigmoid of one logit, the softmax's second class
    of two."""
    if logits.dim() == 1:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)[:, 1]


def learning_rate(base: float, step: int, total: int, warmup_fraction: float
                  ) -> float:
    warmup = int(warmup_fraction * total)
    if step < warmup:
        return base * step / max(warmup, 1)
    return base * max(0.0, (total - step) / max(total - warmup, 1))


def factored_dims(shape):
    """(second largest, largest) dimension, or None below 128."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


class Optimizer:
    """The recipe's grouped optimizer over f32 ``params`` (updated in
    place)."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 total_steps: int):
        r = cfg["recipe"]
        self.r, self.total, self.params = r, total_steps, params
        self.mu_dtype = getattr(torch, r["adam_mu_dtype"] or "float32")
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.t = 0
        for n, p in params.items():
            if self.factored(n):
                dims = factored_dims(tuple(p.shape))
                if dims is None:
                    self.state[n] = {"v": torch.zeros_like(p)}
                else:
                    d1, d0 = dims
                    self.state[n] = {
                        "v_row": p.new_zeros(np.delete(p.shape, d0).tolist()),
                        "v_col": p.new_zeros(np.delete(p.shape, d1).tolist())}
            else:
                self.state[n] = {"mu": torch.zeros_like(p, dtype=self.mu_dtype),
                                 "nu": torch.zeros_like(p)}

    def factored(self, name: str) -> bool:
        return (self.r["embedding_optimizer"] == "factored"
                and "word_embeddings" in name)

    def lr(self, name: str) -> float:
        encoder = ("text_model" in name or "image_model" in name
                   or self.factored(name))
        base = self.r["learning_rate"] * (self.r["encoder_lr_scale"]
                                          if encoder else 1.0)
        return learning_rate(base, self.t, self.total,
                             self.r["warmup_fraction"])

    @staticmethod
    def norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.sqrt(sum(torch.sum(g.double() ** 2)
                              for g in grads.values())).float()

    @staticmethod
    def clip(grads: Dict[str, torch.Tensor], max_norm: float
             ) -> Dict[str, torch.Tensor]:
        norm = Optimizer.norm(grads)
        if norm < max_norm:
            return grads
        return {n: g / norm * max_norm for n, g in grads.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        t = self.t
        bc1, bc2 = 1 - B1 ** (t + 1), 1 - B2 ** (t + 1)
        keep = 1 - (t + 1) ** -RMS_DECAY
        for n, p in self.params.items():
            g, st = grads[n], self.state[n]
            if "mu" in st:
                mu = B1 * st["mu"].float() + (1 - B1) * g
                st["mu"] = mu.to(self.mu_dtype)
                st["nu"] = B2 * st["nu"] + (1 - B2) * g * g
                mu_hat = st["mu"].float() / bc1
                update = mu_hat / (torch.sqrt(st["nu"] / bc2) + EPS)
            elif "v" in st:
                st["v"] = keep * st["v"] + (1 - keep) * (g * g + RMS_EPS)
                update = g * st["v"] ** -0.5
            else:
                d1, d0 = factored_dims(tuple(p.shape))
                sq = g * g + RMS_EPS
                st["v_row"] = keep * st["v_row"] + (1 - keep) * sq.mean(d0)
                st["v_col"] = keep * st["v_col"] + (1 - keep) * sq.mean(d1)
                red = d1 - 1 if d1 > d0 else d1
                row = (st["v_row"] / st["v_row"].mean(red, keepdim=True)
                       ) ** -0.5
                update = (g * row.unsqueeze(d0)
                          * st["v_col"].unsqueeze(d1) ** -0.5)
            p.sub_(self.lr(n) * update)
        self.t += 1


def train_steps(W0: Dict[str, torch.Tensor], cfg: dict,
                batches: List[Dict[str, torch.Tensor]], total_steps: int,
                P: Precision = F32) -> dict:
    """Run the recipe's steps over ``batches`` (each: the model's inputs
    with the augmented ``image``, ``label``, ``valid`` and the dropout
    masks ``drop``) from the weights ``W0`` (left as they are).  Returns
    each step's loss, logits and pre-clip global gradient norm, every
    leaf's first clipped gradient norm and every leaf's change after the
    last step, by name."""
    params = {n: v.detach().clone().float() for n, v in W0.items()
              if not n.endswith(("running_mean", "running_var"))}
    buffers = {n: v for n, v in W0.items() if n not in params}
    opt = Optimizer(cfg, params, total_steps)
    logits_fn = LOGITS[cfg["kind"]]
    losses, logits_all, norms, first_grad = [], [], [], None
    for batch in batches:
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        logits = logits_fn({**leaves, **buffers}, cfg, batch, True, P)
        w = batch["valid"].float()
        loss = torch.sum(row_losses(logits, batch["label"], cfg) * w) / \
            torch.clamp(w.sum(), min=1e-9)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(leaves.items(), grads)}
        norms.append(float(Optimizer.norm(grads)))
        grads = Optimizer.clip(grads, cfg["recipe"]["grad_clip_norm"])
        if first_grad is None:
            first_grad = {n: float(torch.linalg.vector_norm(g.double()))
                          for n, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
        logits_all.append(logits.detach().float().cpu().numpy())
    change = {n: float(torch.linalg.vector_norm((params[n] - W0[n]).double()))
              for n in params}
    return {"losses": losses, "logits": logits_all, "grad_norm": norms,
            "grad_norms": first_grad, "change_norms": change}
