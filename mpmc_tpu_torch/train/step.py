"""Train and eval steps (port of ``mpmc_tpu/train/step.py``): the eval step
of every model kind; the train step of the 2A text model and the 2C model,
packed or not, with the bf16 policy, the valid-weighted focal (one logit)
or cross-entropy (two) loss, the global-norm clip, grouped Adam with the
fast recipe's bf16 first moment and factored-RMS word embeddings, and the
linear-warmup or constant schedule.

Precision policy under ``bf16``: the master parameters stay f32; every step
runs the model on bf16 copies (``torch.func.functional_call``), so the
gradients arrive in f32, while BatchNorm statistics stay f32.  The image is
cast to bf16 after preprocessing, as the JAX package's steps do.

The optimizer is written out by hand on tensors, following optax 0.2.6
(``scale_by_adam``, ``scale_by_factored_rms``, ``clip_by_global_norm``,
``multi_transform``) rounding for rounding, including the bf16 first moment
whose decay product is taken in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from mpmc_tpu_torch.config import LossType, TrainConfig
from mpmc_tpu_torch.image.augment import eval_preprocess, train_augment
from mpmc_tpu_torch.models.classifier import (PackedMultimodalClassifier,
                                              PackedTextClassifier,
                                              build_model)
from mpmc_tpu_torch.models.norm import set_dropout_generator
from mpmc_tpu_torch.ops.losses import sigmoid_focal_loss, softmax_cross_entropy
from mpmc_tpu_torch.train.packed import packed_model_inputs

EvalStep = Callable[[Dict[str, torch.Tensor]],
                    Tuple[torch.Tensor, torch.Tensor]]
Augment = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def _compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.bf16 else torch.float32


def make_eval_step(model: nn.Module, cfg: TrainConfig,
                   grayscale: bool = False,
                   cast_in_place: bool = True) -> EvalStep:
    """``step(batch) -> (probs [B], per-sample loss [B])``.  The batch holds
    the keys of ``model.inputs`` (a uint8 ``image [B,H,W,C]`` goes through
    ``eval_preprocess``) and optionally ``label``; the loss is zero without
    labels.  One logit gives sigmoid probabilities and the focal loss, two
    give ``softmax(out)[:, 1]`` and the cross-entropy.  Eval always runs the
    unpacked forward.

    ``cast_in_place`` (serving) casts the model's parameters to the compute
    dtype once, which halves their device memory.  Otherwise (a model that
    is still training) every call runs on copies in the compute dtype and
    leaves the model as it was."""
    dtype = _compute_dtype(cfg)
    inputs = model.inputs
    if cast_in_place:
        for p in model.parameters():
            p.data = p.data.to(dtype)
        run = model
    else:
        # The unpacked model of the same kind and config, without storage.
        skeleton = build_model(
            model.cfg, torch.device("meta"), kind=model.kind,
            binary_head=getattr(model, "binary_head", None) is not None)

        def run(*args):
            weights = {n: p.detach().to(dtype)
                       for n, p in model.named_parameters()}
            weights.update(model.named_buffers())
            return functional_call(skeleton, weights, args)

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]):
        model.eval()
        args = [eval_preprocess(batch["image"], grayscale=grayscale).to(dtype)
                if key == "image" else batch.get(key) for key in inputs]
        out = run(*args).to(torch.float32)
        labels = batch.get("label")
        if out.ndim == 1:
            probs = torch.sigmoid(out)
            if labels is not None:
                loss = sigmoid_focal_loss(out, labels, alpha=cfg.focal_alpha,
                                          gamma=cfg.focal_gamma,
                                          reduction="none")
        else:
            probs = torch.softmax(out, dim=-1)[:, 1]
            if labels is not None:
                loss = softmax_cross_entropy(out, labels, reduction="none")
        if labels is None:
            loss = torch.zeros_like(probs)
        return probs, loss

    return step


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def linear_warmup_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """HF ``get_linear_schedule_with_warmup`` in f32: 0 -> lr over
    ``warmup_steps``, then linear decay to 0 at ``total_steps``."""
    warmup_steps = max(warmup_steps, 0)
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        warm = s / f32(max(warmup_steps, 1))
        decay = max(f32(0.0), (f32(total_steps) - s)
                    / f32(max(total_steps - warmup_steps, 1)))
        return float(f32(base_lr) * (warm if step < warmup_steps else decay))

    return schedule


def constant_schedule(base_lr: float) -> Callable[[int], float]:
    """The 2A schedule (``optax.constant_schedule``): the base LR at every
    step."""
    return lambda step: float(base_lr)


def param_group(name: str) -> str:
    """The reference's grouping: any parameter under ``text_model``,
    ``caption_text_model`` or ``image_model`` is ``encoder`` (0.8x lr); the
    fusion and the heads are ``head``."""
    if "text_model" in name or "image_model" in name:
        return "encoder"
    return "head"


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's rule: factor over the two largest dims when the second
    largest has at least 128 entries; ``(second largest, largest)``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def clip_by_global_norm(grads: List[torch.Tensor], grad_norm: torch.Tensor,
                        clip: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: the gradients as they are when their
    global norm is below ``clip``, else scaled by ``clip / norm`` (divided,
    then multiplied, as optax rounds)."""
    if float(grad_norm) < clip:
        return grads
    grads = torch._foreach_div(grads, grad_norm)
    torch._foreach_mul_(grads, clip)
    return grads


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_updates(g: List[torch.Tensor], states: List[Dict[str, torch.Tensor]],
                 c: int) -> List[torch.Tensor]:
    """optax ``scale_by_adam`` at step ``c`` (0-based) for the gradients
    ``g``: updates each state's ``mu`` (f32 or bf16) and f32 ``nu`` and
    returns the bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)``."""
    mu = [st["mu"] for st in states]
    nu = [st["nu"] for st in states]
    # The decay product is taken in the moment's dtype (bf16 under the
    # fast recipe), as JAX multiplies a bf16 array by a Python float; it is
    # widened into f32 scratch so that every list op below has one dtype
    # (mixed-dtype lists leave the multi-tensor kernels).
    decayed = torch._foreach_mul(mu, torch.tensor(ADAM_B1,
                                                  dtype=mu[0].dtype))
    if mu[0].dtype != torch.float32:
        wide = [st.setdefault("mu_f32", torch.empty_like(g_))
                for st, g_ in zip(states, g)]
        torch._foreach_copy_(wide, decayed)
        decayed = wide
    mu_new = torch._foreach_mul(g, 1 - ADAM_B1)
    torch._foreach_add_(mu_new, decayed)
    nu_new = torch._foreach_mul(g, g)
    torch._foreach_mul_(nu_new, 1 - ADAM_B2)
    torch._foreach_add_(nu_new, torch._foreach_mul(nu, ADAM_B2))
    t = np.float32(c + 1)
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** t)
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** t)
    denom = torch._foreach_sqrt(torch._foreach_div(nu_new, bc2))
    torch._foreach_add_(denom, ADAM_EPS)
    updates = torch._foreach_div(torch._foreach_div(mu_new, bc1), denom)
    torch._foreach_copy_(mu, mu_new)               # rounds to mu's dtype
    for st, v in zip(states, nu_new):
        st["nu"] = v
    return updates


class Optimizer:
    """``clip_by_global_norm(grad_clip_norm)`` then, per group, Adam at the
    head or encoder schedule (``cfg.lr_schedule``: linear warmup over
    ``total_steps``, or constant), or (``embed``: ``word_embeddings`` under
    ``embedding_optimizer="factored"``) factored RMS with decay 0.8 and
    epsilon 1e-30 at the encoder schedule.  Updates the parameters in
    place; parameters without a gradient take a zero one."""

    RMS_DECAY, RMS_EPS = 0.8, 1e-30

    def __init__(self, cfg: TrainConfig, total_steps: int,
                 params: Dict[str, torch.Tensor]):
        if cfg.embedding_optimizer not in ("adam", "factored"):
            raise ValueError(f"embedding_optimizer "
                             f"{cfg.embedding_optimizer!r} is not ported")
        lrs = {"head": cfg.learning_rate,
               "encoder": cfg.learning_rate * cfg.encoder_lr_scale}
        if cfg.lr_schedule == "constant":
            self.schedules = {g: constant_schedule(lr)
                              for g, lr in lrs.items()}
        elif cfg.lr_schedule == "linear_warmup":
            warmup = int(cfg.warmup_fraction * total_steps)
            self.schedules = {g: linear_warmup_schedule(lr, warmup,
                                                        total_steps)
                              for g, lr in lrs.items()}
        else:
            raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule!r} "
                             "(expected 'linear_warmup' or 'constant')")
        self.schedules["embed"] = self.schedules["encoder"]
        self.clip = cfg.grad_clip_norm
        mu_dtype = (getattr(torch, cfg.adam_mu_dtype) if cfg.adam_mu_dtype
                    else None)
        self.params = params
        self.count = 0
        self.label: Dict[str, str] = {}
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, p in params.items():
            if (cfg.embedding_optimizer == "factored"
                    and "word_embeddings" in name):
                self.label[name] = "embed"
                dims = _factored_dims(p.shape)
                if dims is None:
                    self.state[name] = {"v": torch.zeros_like(p)}
                else:
                    d1, d0 = dims
                    self.state[name] = {
                        "v_row": p.new_zeros(np.delete(p.shape, d0).tolist()),
                        "v_col": p.new_zeros(np.delete(p.shape, d1).tolist())}
            else:
                self.label[name] = param_group(name)
                self.state[name] = {
                    "mu": torch.zeros_like(p, dtype=mu_dtype or p.dtype),
                    "nu": torch.zeros_like(p)}

    def state_dict(self) -> Dict:
        """The step count and each parameter's state at its own dtype (the
        Adam moments, bf16 or f32; the factored RMS rows and columns); the
        multi-tensor scratch is left out."""
        return {"count": self.count,
                "state": {n: {k: v for k, v in st.items() if k != "mu_f32"}
                          for n, st in self.state.items()}}

    def load_state_dict(self, sd: Dict) -> None:
        """Restore a :meth:`state_dict` in place: the same parameters and
        slots, each at the shape and dtype this optimizer holds, or it
        raises."""
        if set(sd["state"]) != set(self.state):
            raise ValueError("optimizer state for other parameters: "
                             f"{sorted(set(sd['state']) ^ set(self.state))}")
        for name, slots in sd["state"].items():
            own = self.state[name]
            if set(slots) != set(own) - {"mu_f32"}:
                raise ValueError(f"{name}: optimizer slots {sorted(slots)}, "
                                 f"expected {sorted(own)}")
            for k, v in slots.items():
                if v.shape != own[k].shape or v.dtype != own[k].dtype:
                    raise ValueError(
                        f"{name}.{k}: {v.dtype} {tuple(v.shape)}, expected "
                        f"{own[k].dtype} {tuple(own[k].shape)}")
                own[k].copy_(v)
        self.count = int(sd["count"])

    @staticmethod
    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        """``sqrt(sum over tensors of sum(g * g))``, as optax."""
        sums = torch._foreach_norm(torch._foreach_mul(grads, grads), 1)
        return torch.sqrt(torch.stack(sums).sum())

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], grad_norm: torch.Tensor
             ) -> None:
        """One update from f32 ``grads`` and their pre-clip global norm.
        The tensors of each group go through multi-tensor (``_foreach``)
        ops, a few launches per group; reading the norm to decide the clip
        is the step's one wait on the device."""
        c = self.count
        names = list(self.params)
        g = dict(zip(names, clip_by_global_norm(
            [grads[n] for n in names], grad_norm, self.clip)))
        for label, schedule in self.schedules.items():
            group = [n for n in names if self.label[n] == label]
            if not group:
                continue
            lr = -schedule(c)
            params = [self.params[n] for n in group]
            if label == "embed":
                updates = [self._factored_rms(g[n], self.state[n], c)
                           for n in group]
            else:
                updates = adam_updates([g[n] for n in group],
                                       [self.state[n] for n in group], c)
            torch._foreach_mul_(updates, lr)
            torch._foreach_add_(params, updates)
        self.count = c + 1

    def _factored_rms(self, g, st, c):
        decay = np.float32(1) - np.float32(c + 1) ** np.float32(
            -self.RMS_DECAY)
        keep, new = float(decay), float(np.float32(1) - decay)
        grad_sqr = g * g + self.RMS_EPS
        dims = _factored_dims(g.shape)
        if dims is None:
            st["v"] = keep * st["v"] + new * grad_sqr
            return g * st["v"] ** -0.5
        d1, d0 = dims
        st["v_row"] = keep * st["v_row"] + new * grad_sqr.mean(dim=d0)
        st["v_col"] = keep * st["v_col"] + new * grad_sqr.mean(dim=d1)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = st["v_row"].mean(dim=reduced_d1, keepdim=True)
        row_factor = (st["v_row"] / row_col_mean) ** -0.5
        col_factor = st["v_col"] ** -0.5
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def loss_from_outputs(outputs: torch.Tensor, labels: torch.Tensor,
                      valid: torch.Tensor, cfg: TrainConfig,
                      soft: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cfg.loss`` (focal, or softmax cross-entropy over integer labels)
    over the valid rows: ``sum(vec * w) / max(sum(w), 1e-9)`` (replicated
    rows of a short last batch and empty packed slots carry zero weight).

    With ``soft`` (the teacher's per-row P(propaganda),
    ``train/distill.py``) and ``cfg.distill_lambda`` > 0 the per-row loss
    is ``(1-λ)·loss(hard) + λ·CE(soft)``, the soft cross-entropy over the
    one-logit sigmoid head or the two-logit softmax head; any other head
    raises."""
    outputs = outputs.to(torch.float32)
    if cfg.loss == LossType.FOCAL:
        vec = sigmoid_focal_loss(outputs, labels.to(torch.float32),
                                 alpha=cfg.focal_alpha, gamma=cfg.focal_gamma,
                                 reduction="none")
    else:
        vec = softmax_cross_entropy(outputs, labels, reduction="none")
    if soft is not None and cfg.distill_lambda > 0:
        q = soft.to(torch.float32)
        if outputs.ndim == 1:
            logp1 = F.logsigmoid(outputs)
            logp0 = F.logsigmoid(-outputs)
        elif outputs.shape[-1] == 2:
            logp = torch.log_softmax(outputs, dim=-1)
            logp1, logp0 = logp[:, 1], logp[:, 0]
        else:
            raise ValueError("distill_lambda requires a binary head "
                             f"(got outputs {tuple(outputs.shape)})")
        vec_soft = -(q * logp1 + (1.0 - q) * logp0)
        lam = cfg.distill_lambda
        vec = (1.0 - lam) * vec + lam * vec_soft
    w = valid.to(torch.float32)
    return torch.sum(vec * w) / torch.clamp(torch.sum(w), min=1e-9)


def gather_batch(batch: Dict[str, torch.Tensor],
                 store: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Assemble a batch on the device: ``img_idx`` selects image rows of the
    resident store (packed batches), ``idx`` selects rows of every array of
    the store (unpacked batches)."""
    b = dict(batch)
    if "img_idx" in b:
        b["image"] = store["image"].index_select(0, b.pop("img_idx").long())
    if "idx" in b:
        idx = b.pop("idx").long()
        b.update({k: v.index_select(0, idx) for k, v in store.items()})
    return b


@dataclasses.dataclass
class TrainStep:
    """One optimizer step on ``model`` per call: ``step(batch) -> {"loss",
    "grad_norm"}`` (0-dim device tensors; the norm is the pre-clip one).

    The model gets its own batch keys: a packed model the plan's packed
    rows (``packed_model_inputs``), any other its ``inputs``; an image goes
    through ``augment`` first, and a model without one needs no image, no
    augmentation and no image store.

    Under ``bf16`` the model runs on bf16 copies of the f32 masters, kept
    as leaves of their own and refreshed from the masters after every
    update; their bf16 gradients widen to f32 exactly, so the optimizer
    sees what the JAX package's cast-inside-the-loss gives."""

    model: nn.Module
    cfg: TrainConfig
    optimizer: Optimizer
    store: Dict[str, torch.Tensor]
    generator: torch.Generator
    augment: Augment = train_augment

    def __post_init__(self):
        set_dropout_generator(self.model, self.generator)
        self.dtype = _compute_dtype(self.cfg)
        masters = list(self.optimizer.params.values())
        self.compute = None
        if self.dtype != torch.float32:
            self.compute = {n: p.detach().to(self.dtype).requires_grad_()
                            for n, p in self.optimizer.params.items()}
            self.grads = [torch.empty_like(p) for p in masters]

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        b = gather_batch(batch, self.store)
        if "image" in self.model.inputs:
            b["image"] = self.augment(b["image"],
                                      self.generator).to(self.dtype)
        if isinstance(self.model, PackedMultimodalClassifier):
            text, caption = packed_model_inputs(b)
            args = (text, b["image"], caption)
        elif isinstance(self.model, PackedTextClassifier):
            args = (packed_model_inputs(b)[0],)
        else:
            args = tuple(b.get(key) for key in self.model.inputs)
        self.model.train()
        params = self.optimizer.params
        if self.compute is None:
            leaves = list(params.values())
            outputs = self.model(*args)
        else:
            leaves = list(self.compute.values())
            outputs = functional_call(self.model, self.compute, args)
        loss = loss_from_outputs(outputs, b["label"], b["valid"], self.cfg,
                                 b.get("soft"))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))]
        if self.compute is not None:
            torch._foreach_copy_(self.grads, grads)   # bf16 -> f32, exact
            grads = self.grads
        grad_norm = Optimizer.global_norm(grads)
        self.optimizer.step(dict(zip(params, grads)), grad_norm)
        if self.compute is not None:
            with torch.no_grad():
                torch._foreach_copy_(leaves, list(params.values()))
        return {"loss": loss.detach(), "grad_norm": grad_norm}


    def state_dict(self) -> Dict:
        """The exact training state: the model's ``state_dict`` (the f32
        masters and the BatchNorm statistics), the optimizer's state and
        step count, and the state of the generator that draws the dropout
        masks and augmentations."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: Dict) -> None:
        """Restore a :meth:`state_dict` in place; the bf16 compute copies
        are refreshed from the restored masters, as after a step."""
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.generator.set_state(sd["generator"])
        if self.compute is not None:
            with torch.no_grad():
                torch._foreach_copy_(list(self.compute.values()),
                                     list(self.optimizer.params.values()))


def build_train_step(model: nn.Module, cfg: TrainConfig,
                     total_steps: int, store: Dict[str, torch.Tensor],
                     generator: torch.Generator,
                     augment: Optional[Augment] = None) -> TrainStep:
    """The train step over ``model``'s parameters (kept f32 as masters),
    with the optimizer for ``total_steps`` steps.  ``store`` holds the
    device-resident arrays that batches index; ``augment(images_u8,
    generator)`` turns uint8 pixels into the model's f32 input
    (default: :func:`train_augment`)."""
    for p in model.parameters():
        if p.dtype != torch.float32:
            raise ValueError("training needs f32 master parameters")
    optimizer = Optimizer(cfg, total_steps, dict(model.named_parameters()))
    return TrainStep(model, cfg, optimizer, store, generator,
                     augment or train_augment)

