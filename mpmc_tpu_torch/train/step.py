"""Train and eval steps (port of ``mpmc_tpu/train/step.py``): the eval step
of every model kind; the train step of the 2A text model and the 2C model,
packed or not, with the bf16 policy, the valid-weighted focal (one logit)
or cross-entropy (two; class-weighted under ``use_class_weights``) loss,
the global-norm clip, grouped Adam with the fast recipe's bf16 first
moment and factored-RMS word embeddings (or lazy row-Adam ones,
``train/sparse_opt.py``), and the linear-warmup or constant schedule.

Precision policy under ``bf16``: the master parameters stay f32; every step
runs the model on bf16 copies (``torch.func.functional_call``), so the
gradients arrive in f32, while BatchNorm statistics stay f32.  The image is
cast to bf16 after preprocessing, as the JAX package's steps do.

The optimizer is written out by hand on tensors, following optax 0.2.6
(``scale_by_adam``, ``scale_by_factored_rms``, ``clip_by_global_norm``,
``multi_transform``) rounding for rounding, including the bf16 first moment
whose decay product is taken in bf16.

A train step reads nothing back from the device and updates every piece of
its state in place (weights, compute copies, BatchNorm statistics,
optimizer slots, the optimizer's device step count), so that a CUDA graph
of K steps (``train/graphs.py``) replays them exactly.
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
from mpmc_tpu_torch.image.augment import (augment_draws, augment_with_draws,
                                          eval_preprocess, train_augment)
from mpmc_tpu_torch.models.classifier import (PackedMultimodalClassifier,
                                              PackedTextClassifier,
                                              build_model)
from mpmc_tpu_torch.models.norm import set_dropout_generator
from mpmc_tpu_torch.ops.losses import sigmoid_focal_loss, softmax_cross_entropy
from mpmc_tpu_torch.train.packed import packed_model_inputs
from mpmc_tpu_torch.train.sparse_opt import sparse_adam_rows

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
        # The unpacked model of the same kind and config, without storage
        # (a sharded model makes its own).
        make = getattr(model, "meta_skeleton", None)
        skeleton = make() if make is not None else build_model(
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
    """optax's ``clip_by_global_norm`` on the device: each gradient as it
    is where the global norm is below ``clip``, else ``g / norm * clip``
    (divided, then multiplied, as optax rounds), chosen by a select, so
    the host never waits for the norm.  ``grad_norm`` is 0-dim, or ``[F]``
    per-fold norms of gradients stacked on a leading fold axis."""
    if grad_norm.dim() == 0:
        trigger = grad_norm < clip
        scaled = torch._foreach_div(grads, grad_norm)
        torch._foreach_mul_(scaled, clip)
        return [torch.where(trigger, g, s) for g, s in zip(grads, scaled)]
    out = []
    for g in grads:
        norm = grad_norm.view(-1, *[1] * (g.dim() - 1))
        out.append(torch.where(norm < clip, g, g / norm * clip))
    return out


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_bias_corrections(c: int) -> Tuple[float, float]:
    """Adam's ``1 - b1^t`` and ``1 - b2^t`` at 0-based step ``c``, in f32
    as optax computes them."""
    t = np.float32(c + 1)
    return (float(np.float32(1) - np.float32(ADAM_B1) ** t),
            float(np.float32(1) - np.float32(ADAM_B2) ** t))


def adam_updates(g: List[torch.Tensor], states: List[Dict[str, torch.Tensor]],
                 bc1, bc2) -> List[torch.Tensor]:
    """optax ``scale_by_adam`` for the gradients ``g`` with the bias
    corrections ``bc1``, ``bc2`` (floats, or 0-dim f32 tensors on the
    device): updates each state's ``mu`` (f32 or bf16) and f32 ``nu`` in
    place and returns the bias-corrected ``mu_hat / (sqrt(nu_hat) +
    eps)``."""
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
    denom = torch._foreach_sqrt(torch._foreach_div(nu_new, bc2))
    torch._foreach_add_(denom, ADAM_EPS)
    updates = torch._foreach_div(torch._foreach_div(mu_new, bc1), denom)
    torch._foreach_copy_(mu, mu_new)               # rounds to mu's dtype
    torch._foreach_copy_(nu, nu_new)
    return updates


def sparse_support_rows(cfg: TrainConfig,
                        embed_support: Optional[int] = None) -> int:
    """The per-step row bound of ``embedding_optimizer="sparse"``, as the
    JAX ``make_optimizer`` sets it: the driver's exact bound
    ``embed_support`` (batch size times the bucketed sequence length, for
    unpacked runs), else the config's bound, rows times the longer of
    ``max_text_len`` and ``max_caption_len`` (rows: the larger of
    ``batch_size`` and ``pack_rows``); never below
    ``cfg.embedding_support_rows``."""
    if embed_support is not None:
        return max(cfg.embedding_support_rows, int(embed_support))
    rows = max(cfg.data.batch_size, cfg.data.pack_rows)
    per_step = rows * max(cfg.model.max_text_len or 1,
                          cfg.model.max_caption_len or 1)
    return max(cfg.embedding_support_rows, per_step)


class Optimizer:
    """``clip_by_global_norm(grad_clip_norm)`` then, per group, Adam at the
    head or encoder schedule (``cfg.lr_schedule``: linear warmup over
    ``total_steps``, or constant), or for ``embed`` (the ``word_embeddings``
    tables) under ``embedding_optimizer="factored"`` factored RMS with
    decay 0.8 and epsilon 1e-30, and under ``"sparse"`` lazy row-Adam
    (``train/sparse_opt.py``) on at most :func:`sparse_support_rows` rows
    a step, both at the encoder schedule.  Updates the parameters and
    every state tensor in place; parameters without a gradient take a zero
    one.

    The step count lives on the device (``count_t``, advanced by the step
    itself) beside a host mirror (``count``, for checkpoints and logs).
    Each per-step scalar (the learning rates, Adam's bias corrections, the
    factored-RMS decay) is read from an f32 table over the steps, made on
    the host with the same numpy rounding as before and uploaded once, at
    the device count: a step reads nothing from the host, so a CUDA graph
    of K steps replays with the right scalars at every step.

    ``folds`` F: every parameter carries a leading fold axis, and the
    optimizer runs per fold, as optax does under ``vmap``: each fold's own
    global norm and clip, ``_factored_dims`` on the per-fold shape, the
    sparse rows per fold.

    ``shards`` (tensor parallelism, ``parallel/tp.py``): ``{name: (dim,
    group)}`` for parameters this rank holds a slice of along ``dim``.
    Factored RMS then factors the whole table's shape and takes its means
    over a split dimension across ``group``, as JAX's global arrays do;
    everything else is elementwise, hence local."""

    RMS_DECAY, RMS_EPS = 0.8, 1e-30

    def __init__(self, cfg: TrainConfig, total_steps: int,
                 params: Dict[str, torch.Tensor],
                 embed_support: Optional[int] = None,
                 folds: Optional[int] = None,
                 shards: Optional[Dict[str, Tuple[int, object]]] = None):
        if cfg.embedding_optimizer not in ("adam", "factored", "sparse"):
            raise ValueError(f"unknown embedding_optimizer "
                             f"{cfg.embedding_optimizer!r} (expected "
                             f"'adam', 'factored' or 'sparse')")
        self.support_rows = (sparse_support_rows(cfg, embed_support)
                             if cfg.embedding_optimizer == "sparse" else 0)
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
        self.folds = folds
        self.shards = shards or {}
        lead = 1 if folds else 0
        self.device = next((p.device for p in params.values()),
                           torch.device("cpu"))
        self.count = 0
        self.count_t = torch.zeros((), dtype=torch.long, device=self.device)
        self.tables: Dict[str, torch.Tensor] = {}
        self.ensure_steps(max(total_steps, 1))
        self.label: Dict[str, str] = {}
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, p in params.items():
            if (cfg.embedding_optimizer == "sparse"
                    and "word_embeddings" in name and p.ndim == 2 + lead):
                self.label[name] = "embed"
                self.state[name] = {
                    "mu": torch.zeros_like(p, dtype=torch.float32),
                    "nu": torch.zeros_like(p, dtype=torch.float32)}
            elif (cfg.embedding_optimizer == "factored"
                    and "word_embeddings" in name):
                self.label[name] = "embed"
                dims = self._fold_factored_dims(p.shape, name)
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

    def _fold_factored_dims(self, shape, name: Optional[str] = None
                            ) -> Optional[Tuple[int, int]]:
        """:func:`_factored_dims` of the per-fold shape (of the whole table
        for a tensor-parallel slice), as dims of the (stacked) tensor."""
        lead = 1 if self.folds else 0
        shape = list(shape)
        if name in self.shards:
            from mpmc_tpu_torch.parallel.collectives import group_size
            dim, group = self.shards[name]
            shape[dim] *= group_size(group)
        dims = _factored_dims(tuple(shape)[lead:])
        return None if dims is None else (dims[0] + lead, dims[1] + lead)

    def ensure_steps(self, n: int) -> None:
        """Make the per-step tables cover steps ``0 .. n - 1`` (at least
        twice what they covered, when they grow)."""
        have = len(next(iter(self.tables.values()))) if self.tables else 0
        if n <= have:
            return
        steps = range(max(n, 2 * have))
        cols = {f"lr_{g}": [sched(c) for c in steps]
                for g, sched in self.schedules.items()}
        cols["bc1"], cols["bc2"] = zip(*(adam_bias_corrections(c)
                                         for c in steps))
        decay = [np.float32(1) - np.float32(c + 1) ** np.float32(
            -self.RMS_DECAY) for c in steps]
        cols["rms_keep"] = decay
        cols["rms_new"] = [np.float32(1) - d for d in decay]
        self.tables = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
                           self.device) for k, v in cols.items()}

    def _at(self, name: str) -> torch.Tensor:
        """Table ``name`` at the device count, 0-dim (``index_select``: a
        tensor index would read the count on the host)."""
        return self.tables[name].index_select(0, self.count_t.view(1)
                                              ).view(())

    def state_dict(self) -> Dict:
        """The step count and each parameter's state at its own dtype (the
        Adam moments, bf16 or f32; the factored RMS rows and columns; the
        sparse tables' f32 moments); the multi-tensor scratch is left
        out."""
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
        self.ensure_steps(self.count + 1)
        self.count_t.fill_(self.count)

    @staticmethod
    def global_norm(grads: List[torch.Tensor],
                    folds: Optional[int] = None) -> torch.Tensor:
        """``sqrt(sum over tensors of sum(g * g))``, as optax; ``[F]``, one
        per fold, for gradients stacked over ``folds``."""
        if not folds:
            return global_norm(grads)
        return torch.stack([global_norm([g[f] for g in grads])
                            for f in range(folds)])

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], grad_norm: torch.Tensor
             ) -> None:
        """One update from f32 ``grads`` and their pre-clip global norm
        (``[F]`` over folds).  The tensors of each group go through
        multi-tensor (``_foreach``) ops, a few launches per group; nothing
        is read back from the device."""
        self.ensure_steps(self.count + 1)
        names = list(self.params)
        g = dict(zip(names, clip_by_global_norm(
            [grads[n] for n in names], grad_norm, self.clip)))
        bc1, bc2 = self._at("bc1"), self._at("bc2")
        for label in self.schedules:
            group = [n for n in names if self.label[n] == label]
            if not group:
                continue
            neg_lr = -self._at(f"lr_{label}")
            if label == "embed" and self.support_rows:
                for n in group:
                    p, st = self.params[n], self.state[n]
                    for f in (range(self.folds) if self.folds else [None]):
                        pick = (lambda t: t) if f is None else (
                            lambda t, f=f: t[f])
                        sparse_adam_rows(pick(p), pick(g[n]),
                                         {k: pick(v) for k, v in st.items()},
                                         neg_lr, bc1, bc2, self.support_rows)
                continue
            params = [self.params[n] for n in group]
            if label == "embed":
                keep, new = self._at("rms_keep"), self._at("rms_new")
                updates = [self._factored_rms(g[n], self.state[n], keep, new,
                                              n) for n in group]
            else:
                updates = adam_updates([g[n] for n in group],
                                       [self.state[n] for n in group],
                                       bc1, bc2)
            torch._foreach_mul_(updates, neg_lr)
            torch._foreach_add_(params, updates)
        self.count_t.add_(1)
        self.count += 1

    def _factored_rms(self, g, st, keep, new, name=None):
        """optax ``scale_by_factored_rms`` with the step's decay ``keep``
        and ``1 - keep`` (0-dim tensors); the state updated in place."""
        grad_sqr = g * g + self.RMS_EPS
        dims = self._fold_factored_dims(g.shape, name)
        if dims is None:
            st["v"].copy_(keep * st["v"] + new * grad_sqr)
            return g * st["v"] ** -0.5
        d1, d0 = dims
        split, group = self.shards.get(name, (None, None))

        def mean(x, dim, split_dim, keepdim=False):
            """The mean over ``dim``, across ``group`` where ``dim`` is the
            split one (the slices are equal)."""
            m = x.mean(dim=dim, keepdim=keepdim)
            if split_dim != dim:
                return m
            from mpmc_tpu_torch.parallel.collectives import (all_reduce_,
                                                             group_size)
            return all_reduce_(m / group_size(group), group)

        st["v_row"].copy_(keep * st["v_row"]
                          + new * mean(grad_sqr, d0, split))
        st["v_col"].copy_(keep * st["v_col"]
                          + new * mean(grad_sqr, d1, split))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_split = (None if split in (None, d0)
                     else split - (1 if split > d0 else 0))
        row_col_mean = mean(st["v_row"], reduced_d1, row_split, keepdim=True)
        row_factor = (st["v_row"] / row_col_mean) ** -0.5
        col_factor = st["v_col"] ** -0.5
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum over tensors of sum(g * g))``, as optax."""
    return torch.sqrt(sum_of_squares(grads))


def sum_of_squares(grads: List[torch.Tensor]) -> torch.Tensor:
    sums = torch._foreach_norm(torch._foreach_mul(grads, grads), 1)
    return torch.stack(sums).sum()


class GradSync:
    """How the ranks of a multi-process ``layout`` (``parallel/mesh.py``)
    combine a train step, each rank feeding its rows of the global batch
    (JAX computes the same global step over sharded arrays):

    * the loss is divided by the global batch's valid weight (summed over
      ``data``);
    * with a sequence-sharded or pipelined encoder every rank of a ``seq``
      or ``stage`` group computes the same loss, so each takes
      ``loss_scale`` (1/extent) of it and the gradients of the replicated
      weights sum over the whole world; otherwise over ``data`` (under
      tensor parallelism Megatron's collectives already give every rank
      of a ``model`` group the whole gradient);
    * the weights in ``sharded`` live on this rank alone (its pipeline
      stage's layers, its tensor-parallel slices): their gradients sum
      over ``data`` only, and their squares over the inner axis enter the
      global norm once each.

    Each group's gradients (and the loss, with the replicated ones) are
    summed in one flat buffer."""

    def __init__(self, layout, names: List[str], sharded=()):
        cfg = layout.cfg
        self.data_rank, self.data_size = layout.data_rank, layout.data_size
        self.data_group = layout.data_group
        inner = layout.inner
        shared = inner in (cfg.seq_axis, cfg.stage_axis)
        self.loss_scale = 1.0 / layout.size(inner) if shared else 1.0
        rep_group = torch.distributed.group.WORLD if shared else \
            self.data_group
        rep = [n for n in names if n not in set(sharded)]
        self.sharded = [n for n in names if n in set(sharded)]
        self.buckets = [(rep, rep_group)]
        if self.sharded:
            self.buckets.append((self.sharded, self.data_group))
        self.norm_group = layout.group(inner) if self.sharded else None

    def rows(self, n: int) -> slice:
        per = n // self.data_size
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def valid_weight(self, valid: torch.Tensor) -> torch.Tensor:
        """The global batch's valid weight: 0-dim, or ``[F]`` for
        ``valid [F, B]`` (one per fold)."""
        from mpmc_tpu_torch.parallel.collectives import all_reduce_
        w = valid.to(torch.float32).sum(dim=-1)
        return all_reduce_(w.reshape(-1), self.data_group).view(w.shape)

    def reduce(self, grads: Dict[str, torch.Tensor], loss: torch.Tensor
               ) -> torch.Tensor:
        """Sum ``grads`` (in place) and ``loss`` over their groups; returns
        the summed loss."""
        from mpmc_tpu_torch.parallel.collectives import all_reduce_
        for i, (names, group) in enumerate(self.buckets):
            parts = [grads[n].reshape(-1) for n in names]
            if i == 0:
                parts.append(loss.reshape(-1))
            flat = all_reduce_(torch.cat(parts), group)
            views = flat.split([p.numel() for p in parts])
            torch._foreach_copy_([grads[n] for n in names],
                                 [v.view_as(grads[n])
                                  for n, v in zip(names, views)])
            if i == 0:
                loss = views[-1].view(loss.shape)
        return loss

    def global_norm(self, grads: Dict[str, torch.Tensor],
                    folds: Optional[int] = None) -> torch.Tensor:
        """The global norm of the summed gradients: 0-dim, or ``[F]`` for
        gradients stacked over ``folds`` (each fold's own, the split
        weights' squares summed over the inner group per fold)."""
        if not self.sharded:
            return Optimizer.global_norm(list(grads.values()), folds)
        from mpmc_tpu_torch.parallel.collectives import all_reduce_
        rep = [grads[n] for n in self.buckets[0][0]]
        own = [grads[n] for n in self.sharded]
        if not folds:
            squares = (sum_of_squares(rep),
                       sum_of_squares(own).reshape(1))
        else:
            squares = tuple(torch.stack([sum_of_squares([g[f] for g in gs])
                                         for f in range(folds)])
                            for gs in (rep, own))
        own_sum = all_reduce_(squares[1], self.norm_group)
        return torch.sqrt(squares[0] + own_sum.view(squares[0].shape))

    def eval_step(self, step: EvalStep, dim: int = 0) -> EvalStep:
        """``step`` on this rank's rows (along ``dim``: 1 for the
        fold-parallel ``[F, B]`` batches) of a global eval batch; the
        probabilities and losses of every rank of ``data``, in order."""
        from mpmc_tpu_torch.parallel.collectives import gather_rows

        def gather(x):
            return gather_rows(x.movedim(dim, 0).contiguous(),
                               self.data_group).movedim(0, dim)

        def run(batch: Dict[str, torch.Tensor]):
            sl = (slice(None),) * dim + (self.rows(
                next(iter(batch.values())).shape[dim]),)
            probs, loss = step({k: v[sl] for k, v in batch.items()})
            return gather(probs), gather(loss)

        return run


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def row_weights(labels: torch.Tensor, valid: torch.Tensor, cfg: TrainConfig,
                class_weights: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Each row's weight in the loss: ``valid``, times its class's weight
    under ``cfg.use_class_weights`` with the cross-entropy (``cw[label] *
    valid``, as the JAX step weighs them; the focal loss ignores class
    weights, as there)."""
    w = valid.to(torch.float32)
    if (class_weights is None or not cfg.use_class_weights
            or cfg.loss == LossType.FOCAL):
        return w
    return class_weights[labels.long()] * w


def loss_from_outputs(outputs: torch.Tensor, labels: torch.Tensor,
                      valid: torch.Tensor, cfg: TrainConfig,
                      soft: Optional[torch.Tensor] = None,
                      weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cfg.loss`` (focal, or softmax cross-entropy over integer labels)
    over the valid rows: ``sum(vec * w) / max(sum(w), 1e-9)`` (replicated
    rows of a short last batch and empty packed slots carry zero weight;
    ``valid`` may be :func:`row_weights`' class-weighted rows).
    ``weight`` replaces ``sum(w)``: under data parallelism the global
    batch's, so that the ranks' losses sum to the global mean.

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
    if weight is None:
        weight = torch.sum(w)
    return torch.sum(vec * w) / torch.clamp(weight, min=1e-9)


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
    sees what the JAX package's cast-inside-the-loss gives.

    With ``sync`` (:class:`GradSync`: a multi-process layout) the
    batch is this rank's rows of the global batch; the loss is divided by
    the global batch's valid weight, the gradients and the loss are summed
    over the ranks in one flat buffer before the clip, and the random
    augmentation draws the global batch's numbers and keeps this rank's,
    so every rank steps alike and as one process would on the global
    batch."""

    model: nn.Module
    cfg: TrainConfig
    optimizer: Optimizer
    store: Dict[str, torch.Tensor]
    generator: torch.Generator
    augment: Augment = train_augment
    sync: Optional[object] = None
    class_weights: Optional[torch.Tensor] = None

    def __post_init__(self):
        set_dropout_generator(self.model, self.generator)
        self.dtype = _compute_dtype(self.cfg)
        if self.class_weights is not None:
            self.class_weights = torch.as_tensor(
                self.class_weights, dtype=torch.float32,
                device=self.optimizer.device)
        masters = list(self.optimizer.params.values())
        self.compute = None
        if self.dtype != torch.float32:
            self.compute = {n: p.detach().to(self.dtype).requires_grad_()
                            for n, p in self.optimizer.params.items()}
            self.grads = [torch.empty_like(p) for p in masters]

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        b = gather_batch(batch, self.store)
        sync = self.sync
        if "image" in self.model.inputs:
            if sync is not None and self.augment is train_augment:
                n = b["image"].shape[0]
                lo = sync.data_rank * n
                draws = [d[lo:lo + n] for d in augment_draws(
                    n * sync.data_size, self.generator)]
                image = augment_with_draws(b["image"], *draws)
            else:
                image = self.augment(b["image"], self.generator)
            b["image"] = image.to(self.dtype)
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
        valid = row_weights(b["label"], b["valid"], self.cfg,
                            self.class_weights)
        weight = None if sync is None else sync.valid_weight(valid)
        loss = loss_from_outputs(outputs, b["label"], valid, self.cfg,
                                 b.get("soft"), weight)
        if sync is not None:
            loss = loss * sync.loss_scale
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))]
        if self.compute is not None:
            torch._foreach_copy_(self.grads, grads)   # bf16 -> f32, exact
            grads = self.grads
        if sync is None:
            grad_norm = Optimizer.global_norm(grads)
        else:
            loss = sync.reduce(dict(zip(params, grads)), loss.detach())
            grad_norm = sync.global_norm(dict(zip(params, grads)))
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
                     augment: Optional[Augment] = None,
                     embed_support: Optional[int] = None,
                     sync=None, step_cls=TrainStep,
                     class_weights=None) -> TrainStep:
    """The train step over ``model``'s parameters (kept f32 as masters),
    with the optimizer for ``total_steps`` steps.  ``store`` holds the
    device-resident arrays that batches index; ``augment(images_u8,
    generator)`` turns uint8 pixels into the model's f32 input
    (default: :func:`train_augment`); ``embed_support`` is the sparse
    embedding optimizer's exact per-step row bound, when the driver knows
    it (:func:`sparse_support_rows`); ``sync`` the multi-process
    layout's gradient sync (:class:`GradSync`); ``step_cls`` a subclass of
    :class:`TrainStep` to build; ``class_weights`` ``[C]`` (numpy or a
    tensor, e.g. ``io.manifest.class_weights`` of the train labels) the
    cross-entropy's per-class weights under ``cfg.use_class_weights``."""
    for p in model.parameters():
        if p.dtype != torch.float32:
            raise ValueError("training needs f32 master parameters")
    optimizer = Optimizer(cfg, total_steps, dict(model.named_parameters()),
                          embed_support,
                          shards=getattr(model, "tp_shards", None))
    return step_cls(model, cfg, optimizer, store, generator,
                    augment or train_augment, sync, class_weights)

