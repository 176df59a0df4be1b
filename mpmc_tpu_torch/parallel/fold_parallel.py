"""Fold-parallel training on one device (port of
``mpmc_tpu/parallel/fold_parallel.py`` at ``--fold-shards 1``).

The k cross-validation folds' replicas are stacked on a leading fold axis:
every parameter, BatchNorm statistic and optimizer slot is ``[F, ...]``,
and one step advances all folds.  The forward and the loss run under
``torch.func.vmap`` over the fold axis (``functional_call`` on a
storage-free skeleton of the model), so the attention kernels see one
``[F*B, S, H, D]`` batch (``ops.attention.AttentionFunction.vmap``) and
launch once for all folds; the image kernel augments the flattened
``[F*B, H, W, 3]`` batch before the model.  Dropout draws a different
mask per fold from the one generator (``randomness="different"``).  The
gradients of ``sum over folds of loss_f`` are each fold's own, and the
optimizer runs per fold (``train.step.Optimizer(folds=F)``: each fold's
own global norm and clip, factored dims of the per-fold shape, sparse rows
per fold), as optax does under JAX's ``vmap``.

Under a ``(fold, data)`` mesh with a data extent above 1 (``sync``, a
``train.step.GradSync``) each rank feeds its rows of every fold's batch:
the augmentation draws the global batch's numbers and keeps the rank's,
BatchNorm and dropout work on the global batch
(``models.norm.set_data_shard`` on the skeleton; the all-reduce has a
``vmap`` rule), each fold's loss divides by its global valid weight, and
the stacked gradients and losses sum over ``data`` before the per-fold
clip.  Under ``--fold-shards N`` a fold group holds folds ``lo .. lo + F
- 1`` of all ``total`` (``fold_slice``): its augmentation and dropout
draw the numbers of every fold and keep its own
(``models.norm.set_fold_slice``), so each fold trains on what it would
with all folds on one device, and every group's generator advances
alike.

Under tensor parallelism inside the step (JAX's 3-D ``(fold, data,
model)`` composition, ``parallel/mesh.fold_data_model_layout``; the
command line refuses it, as JAX's does) each replica comes split over the
``model`` group (``model_group``, ``parallel/tp.tensor_parallel``) and is
stacked, so every split leaf is ``[F, ...]`` with the fold dim in front
of the split one, and the skeleton is split alike: the Megatron
collectives run once for all folds under ``vmap`` (their vmap rules), the
vocabulary-parallel lookup masks and all-reduces every fold at once, and
the attention kernels see the local heads.  The ``GradSync`` names the
split leaves: each fold's norm sums their squares over ``model`` per fold,
factored RMS takes its means across the split per fold, and the state is
gathered whole (``state_dict``, ``fold_state``: the plain model's, which
``predict`` reads).

Batches are device-resident, as the JAX package's gather steps (a train
batch carries ``idx [F, B]`` rows of the resident store and ``valid [F,
B]``; an eval batch ``idx [F, B]`` rows of the eval store, each fold its
own), or host-fed, as its ``make_fold_parallel_train_step`` and
``make_fold_parallel_eval_step`` take them (``DataConfig.device_resident``
False: the steps' stores are empty, and a batch carries the rows
themselves, ``[F, B, ...]``).  With ``scan_steps`` K > 1 the
fold-parallel step is captured K at a time
(``train.graphs.make_scan_train_step``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call, vmap

from mpmc_tpu_torch.config import TrainConfig
from mpmc_tpu_torch.image.augment import (augment_draws, augment_with_draws,
                                          eval_preprocess, train_augment)
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.norm import (set_data_shard, set_dropout_generator,
                                       set_fold_slice)
from mpmc_tpu_torch.ops.losses import sigmoid_focal_loss, softmax_cross_entropy
from mpmc_tpu_torch.parallel.tp import gather_state, shard_model
from mpmc_tpu_torch.train.step import (Augment, Optimizer, _compute_dtype,
                                       loss_from_outputs, row_weights)


def stack_states(states: Sequence[Dict]) -> Dict:
    """Stack per-fold train states (``TrainStep.state_dict()``: the model,
    the optimizer's slots and count, the generator) on a new leading fold
    axis.  Every tensor is stacked; the step counts must agree; the
    generator is fold 0's (one generator drives every fold)."""

    def stack(xs):
        first = xs[0]
        if isinstance(first, dict):
            return {k: stack([x[k] for x in xs]) for k in first}
        if isinstance(first, torch.Tensor):
            return torch.stack(xs)
        if any(x != first for x in xs[1:]):
            raise ValueError(f"fold states disagree: {xs}")
        return first

    return {k: (v if k == "generator" else stack([s[k] for s in states]))
            for k, v in states[0].items()}


def unstack_state(stacked: Dict, fold: int) -> Dict:
    """Fold ``fold``'s train state out of a :func:`stack_states` one: what
    a single-fold ``TrainStep.load_state_dict`` takes."""

    def pick(x):
        if isinstance(x, dict):
            return {k: pick(v) for k, v in x.items()}
        return x[fold] if isinstance(x, torch.Tensor) else x

    return {k: (v if k == "generator" else pick(v))
            for k, v in stacked.items()}


def _gather(store: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """The batch with its rows ``idx [F, B]`` replaced by those rows of
    every array of the store, ``[F, B, ...]``; a host-fed batch (no
    ``idx``) as it is."""
    b = dict(batch)
    if "idx" not in b:
        return b
    idx = b.pop("idx")
    flat = idx.reshape(-1).long()
    b.update({k: v.index_select(0, flat).view(*idx.shape, *v.shape[1:])
              for k, v in store.items()})
    return b


def _image_flat(fn: Callable, images: torch.Tensor) -> torch.Tensor:
    """``fn`` on the folds' images flattened to ``[F*B, H, W, C]``: one
    launch of the image kernel for every fold."""
    F, B = images.shape[:2]
    out = fn(images.reshape(F * B, *images.shape[2:]))
    return out.view(F, B, *out.shape[1:])


class _Stacked:
    """The stacked weights of F replicas of one model and a storage-free
    skeleton to run them through."""

    def __init__(self, models: Sequence[nn.Module], group=None):
        model = models[0]
        self.inputs = model.inputs
        self.skeleton = build_model(
            model.cfg, torch.device("meta"), kind=model.kind,
            binary_head=getattr(model, "binary_head", None) is not None)
        if group is not None:
            shard_model(self.skeleton, group)
        self.state_keys = list(model.state_dict())
        params = [dict(m.named_parameters()) for m in models]
        buffers = [dict(m.named_buffers()) for m in models]
        with torch.no_grad():
            self.params = {n: torch.stack([p[n].detach() for p in params])
                           for n in params[0]}
            self.buffers = {n: torch.stack([b[n] for b in buffers])
                            for n in buffers[0]}
        self.folds = len(models)

    def run(self, weights: Dict[str, torch.Tensor], batch: Dict,
            body: Callable, randomness: str = "error"):
        """``vmap`` over folds of ``body(outputs, batch_f)`` where
        ``outputs`` is the model on fold f's weights and inputs."""
        args = [batch.get(key) for key in self.inputs]
        extra = {k: v for k, v in batch.items() if k not in self.inputs}

        def one(w, bufs, a, e):
            return body(functional_call(self.skeleton, {**w, **bufs},
                                        tuple(a)), e)

        arg_dims = [None if a is None else 0 for a in args]
        return vmap(one, in_dims=(0, 0, arg_dims, 0),
                    randomness=randomness)(weights, self.buffers, args, extra)

    def fold_state(self, fold: int) -> Dict[str, torch.Tensor]:
        """Fold ``fold``'s model ``state_dict`` (what ``model.pt`` holds),
        copied out of the stacked tensors: ``torch.save`` of a view would
        write the whole stacked storage, every fold's weights."""
        both = {**self.params, **self.buffers}
        return {k: both[k][fold].detach().clone() for k in self.state_keys}


class FoldParallelTrainStep:
    """One optimizer step of every fold per call: ``step({"idx": [F, B],
    "valid": [F, B]}) -> {"loss": [F], "grad_norm": [F]}`` over the
    resident ``store`` (the pre-clip norms), or host-fed, with an empty
    store, ``step({<array>: [F, B, ...], ..., "valid": [F, B]})``.  The
    bf16 policy is the single-fold step's: f32 masters, bf16 compute
    copies refreshed after each update, gradients widened to f32
    exactly."""

    def __init__(self, models: Sequence[nn.Module], cfg: TrainConfig,
                 total_steps: int, store: Dict[str, torch.Tensor],
                 generator: torch.Generator,
                 augment: Optional[Augment] = None,
                 embed_support: Optional[int] = None, sync=None,
                 fold_slice: Optional[Tuple[int, int]] = None,
                 model_group=None,
                 class_weights: Optional[torch.Tensor] = None):
        for m in models:
            for p in m.parameters():
                if p.dtype != torch.float32:
                    raise ValueError("training needs f32 master parameters")
        self.cfg, self.store, self.generator = cfg, store, generator
        self.augment = augment or train_augment
        self.class_weights = (None if class_weights is None else
                              torch.as_tensor(
                                  class_weights, dtype=torch.float32,
                                  device=next(models[0].parameters()).device))
        self.model_group = model_group
        shards = {}
        if model_group is not None:
            # The fold dim goes in front of each split dim.
            shards = {n: (d + 1, g) for n, (d, g) in
                      getattr(models[0], "tp_shards", {}).items()}
            if sync is None or set(sync.sharded) != set(shards):
                raise ValueError(
                    "tensor parallelism inside the fold-parallel step takes "
                    "replicas split over the model group "
                    "(parallel/tp.tensor_parallel) and a GradSync that "
                    f"names their split parameters: {sorted(shards)}")
        self.model = _Stacked(models, model_group)
        self.folds = self.model.folds
        self.sync = sync
        self.fold_slice = fold_slice or (0, self.folds)
        set_dropout_generator(self.model.skeleton, generator)
        set_fold_slice(self.model.skeleton, fold_slice)
        if sync is not None:
            set_data_shard(self.model.skeleton, sync.data_group)
        self.dtype = _compute_dtype(cfg)
        for p in self.model.params.values():
            p.requires_grad_()
        self.optimizer = Optimizer(cfg, total_steps, self.model.params,
                                   embed_support, folds=self.folds,
                                   shards=shards)
        self.compute = None
        if self.dtype != torch.float32:
            self.compute = {n: p.detach().to(self.dtype).requires_grad_()
                            for n, p in self.model.params.items()}
            self.grads = [torch.empty_like(p)
                          for p in self.model.params.values()]

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        b = _gather(self.store, batch)
        sync = self.sync
        if "image" in self.model.inputs:
            augment = lambda x: self.augment(x, self.generator)  # noqa: E731
            if self.augment is train_augment:
                # The draws of every fold's global batch; this process
                # keeps its folds' rows of them.
                F_, n = b["image"].shape[:2]
                lo, total = self.fold_slice
                dp, r = ((sync.data_size, sync.data_rank) if sync is not None
                         else (1, 0))
                draws = [d.view(total, dp * n)[lo:lo + F_, r * n:(r + 1) * n]
                         .reshape(-1)
                         for d in augment_draws(total * dp * n,
                                                self.generator)]
                augment = lambda x: augment_with_draws(  # noqa: E731
                    x, *draws)
            b["image"] = _image_flat(augment, b["image"]).to(self.dtype)
        cw = self.class_weights
        b["valid"] = row_weights(b["label"], b["valid"], self.cfg, cw)
        if sync is not None:
            b["weight"] = sync.valid_weight(b["valid"])
        cfg = self.cfg

        def loss(outputs, e):
            return loss_from_outputs(outputs, e["label"], e["valid"], cfg,
                                     e.get("soft"), e.get("weight"))

        self.model.skeleton.train()
        params = self.model.params
        leaves = list((self.compute or params).values())
        weights = dict(zip(params, leaves))
        losses = self.model.run(weights, b, loss, randomness="different")
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     losses.sum(), leaves, allow_unused=True))]
        if self.compute is not None:
            torch._foreach_copy_(self.grads, grads)   # bf16 -> f32, exact
            grads = self.grads
        losses = losses.detach()
        if sync is None:
            grad_norm = Optimizer.global_norm(grads, self.folds)
        else:
            losses = sync.reduce(dict(zip(params, grads)), losses)
            grad_norm = sync.global_norm(dict(zip(params, grads)),
                                         self.folds)
        self.optimizer.step(dict(zip(params, grads)), grad_norm)
        if self.compute is not None:
            with torch.no_grad():
                torch._foreach_copy_(leaves, list(params.values()))
        return {"loss": losses, "grad_norm": grad_norm}

    def _local_state(self) -> Dict:
        return {"model": {k: v.detach() for k, v in
                          {**self.model.params,
                           **self.model.buffers}.items()
                          if k in self.model.state_keys},
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def state_dict(self) -> Dict:
        """The stacked training state: weights and BatchNorm statistics,
        the optimizer's slots and count, the generator
        (:func:`unstack_state` gives one fold's); under tensor
        parallelism gathered whole (a collective of the model group)."""
        sd = self._local_state()
        if self.model_group is None:
            return sd
        return gather_state(sd, self.optimizer, self.model_group)

    def fold_state(self, fold: int) -> Dict:
        """Fold ``fold``'s training state, as a single-fold ``TrainStep``
        would save it; under tensor parallelism the plain model's, whose
        ``model`` is what ``predict`` reads (each split leaf gathered for
        this fold alone)."""
        sd = unstack_state(self._local_state(), fold)
        if self.model_group is None:
            return sd
        return gather_state(sd, self.optimizer, self.model_group, lead=1)


class FoldParallelEvalStep:
    """``step({"idx": [F, B], ...}) -> (probs [F, B], loss [F, B])``: each
    fold's model on its own rows of the resident eval ``store`` (the
    JAX package's ``per_fold_idx``), or host-fed with an empty store on
    the rows themselves (``[F, B, ...]``), on compute-dtype copies of the
    train step's weights."""

    def __init__(self, train: FoldParallelTrainStep,
                 store: Dict[str, torch.Tensor], grayscale: bool = False):
        self.train, self.store, self.grayscale = train, store, grayscale

    @torch.inference_mode()
    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        model, cfg = self.train.model, self.train.cfg
        dtype = self.train.dtype
        b = _gather(self.store, batch)
        if "image" in model.inputs:
            b["image"] = _image_flat(lambda x: eval_preprocess(
                x, grayscale=self.grayscale), b["image"]).to(dtype)
        weights = {n: p.detach().to(dtype) for n, p in model.params.items()}

        def head(outputs, e):
            out = outputs.to(torch.float32)
            labels = e.get("label")
            if out.ndim == 1:
                probs = torch.sigmoid(out)
                loss = (sigmoid_focal_loss(out, labels, alpha=cfg.focal_alpha,
                                           gamma=cfg.focal_gamma,
                                           reduction="none")
                        if labels is not None else torch.zeros_like(probs))
            else:
                probs = torch.softmax(out, dim=-1)[:, 1]
                loss = (softmax_cross_entropy(out, labels, reduction="none")
                        if labels is not None else torch.zeros_like(probs))
            return probs, loss

        model.skeleton.eval()
        return model.run(weights, b, head)


def build_fold_parallel_steps(models: List[nn.Module], cfg: TrainConfig,
                              total_steps: int,
                              store: Dict[str, torch.Tensor],
                              eval_store: Dict[str, torch.Tensor],
                              generator: torch.Generator,
                              augment: Optional[Augment] = None,
                              grayscale: bool = False,
                              embed_support: Optional[int] = None,
                              sync=None,
                              fold_slice: Optional[Tuple[int, int]] = None,
                              model_group=None,
                              class_weights: Optional[torch.Tensor] = None):
    """The fold-parallel train and eval steps over the replicas
    ``models`` (one per fold, f32), for ``total_steps`` optimizer steps;
    with ``sync`` the eval step takes the global ``[F, B]`` batch and
    gathers every rank's rows; ``fold_slice`` ``(lo, total)``: the
    replicas are folds ``lo ..`` of ``total``; ``model_group``: the
    replicas are split over it (tensor parallelism,
    ``parallel/tp.tensor_parallel``);
    ``class_weights``: the cross-entropy's per-class weights
    (``cfg.use_class_weights``)."""
    train = FoldParallelTrainStep(models, cfg, total_steps, store, generator,
                                  augment, embed_support, sync, fold_slice,
                                  model_group, class_weights)
    evaluate = FoldParallelEvalStep(train, eval_store, grayscale)
    if sync is not None:
        evaluate = sync.eval_step(evaluate, dim=1)
    return train, evaluate
