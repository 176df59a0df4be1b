"""Tensor parallelism: Megatron-style weight sharding over a ``model``
process group (port of ``mpmc_tpu/parallel/tp.py``).

JAX places the parameters with ``NamedSharding``s chosen by path rules
and lets XLA's partitioner insert the collectives.  Here the rules map to
the port's parameter names (a torch ``Linear`` weight is ``[out, in]``),
and the model holds its slices and runs Megatron's two collectives per
block (``parallel/collectives.py``: "f", identity forward and all-reduce
backward, where a replicated activation enters a column-split layer;
"g", the all-reduce of a row-split layer's partial products):

=====================================  =============  =====================
port name suffix                       JAX leaf       split dim (JAX spec)
=====================================  =============  =====================
attention.{query,key,value}.weight     [D,H,dh]       0 (None, model, None)
attention.{query,key,value}.bias       [H,dh]         0 (model, None)
attention.out.weight                   [H,dh,D]       1 (model, None, None)
intermediate.weight / .bias            [D,F] / [F]    0 (None, model) / 0
layer_N.output.weight                  [F,D]          1 (model, None)
word_embeddings.weight                 [V,D]          0 (model, None)
layer_N.{q,k,v}.weight / .bias (ViT)   as attention   0
layer_N.out.weight (ViT)               [H,dh,D]       1
layer_N.mlp1.weight / .bias (ViT)      [D,F] / [F]    0
layer_N.mlp2.weight (ViT)              [F,D]          1
everything else                        any            replicated
=====================================  =============  =====================

Each rank of the group holds H/P heads, F/P hidden units and V/P
vocabulary rows (a masked local lookup, then the all-reduce).  A block
whose heads, hidden units or vocabulary do not divide the group stays
replicated, with a warning naming its leaves (JAX replicates such a leaf
alone).  The loss is the same on every rank of the group: the replicated
weights' gradients are too, and only the data group sums them; the global
norm counts each split weight's squares once, summed over the group
(``train.step.GradSync``); factored RMS takes its means across the split
(``train.step.Optimizer``).  The attention kernels run unchanged on the
local heads (JAX forces its XLA attention under TP only because its
partitioner cannot split a custom call).  Checkpoints gather the slices:
``model.pt`` and the training state are the plain model's
(:func:`gather_state`).

Inside the fold-parallel step (``parallel/fold_parallel.py``,
``model_group``) each fold's replica is split by these rules and the
slices are stacked behind a fold dim; the collectives' vmap rules carry
the fold dim, so :class:`VocabParallelEmbedding` and the row-parallel
layers run every fold at once.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.models.bert import (EncoderLayer, MultiHeadSelfAttention,
                                        TextEncoder)
from mpmc_tpu_torch.models.vit import ViTEncoderLayer
from mpmc_tpu_torch.parallel.collectives import reduce_from_group
from mpmc_tpu_torch.train.step import TrainStep

log = logging.getLogger(__name__)

_TP_RULES = (
    (re.compile(r"attention\.(query|key|value)\.(weight|bias)$"), 0),
    (re.compile(r"attention\.out\.weight$"), 1),
    (re.compile(r"intermediate\.(weight|bias)$"), 0),
    # Anchored to encoder layers: the heads' Linears named "output" are
    # tiny and stay replicated.
    (re.compile(r"layer_\d+\.output\.weight$"), 1),
    (re.compile(r"word_embeddings\.weight$"), 0),
    (re.compile(r"layer_\d+\.(q|k|v)\.(weight|bias)$"), 0),
    (re.compile(r"layer_\d+\.out\.weight$"), 1),
    (re.compile(r"layer_\d+\.mlp1\.(weight|bias)$"), 0),
    (re.compile(r"layer_\d+\.mlp2\.weight$"), 1),
)


def spec_for_name(name: str) -> Optional[int]:
    """The dimension of parameter ``name`` split over the model group
    (JAX's ``spec_for_path``), or None for a replicated one."""
    for pat, dim in _TP_RULES:
        if pat.search(name):
            return dim
    return None


class VocabParallelEmbedding(nn.Module):
    """Rows ``[start, start + n)`` of a word-embedding table: ids outside
    look up zeros, and the all-reduce over ``group`` gives every rank the
    whole lookup.  Under the fold-parallel step's ``vmap`` the weight is
    one fold's rows of the stacked table; the masked lookup runs per fold
    and one all-reduce carries every fold."""

    def __init__(self, weight: torch.Tensor, start: int, group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.start, self.group = start, group

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        n = self.weight.shape[0]
        local = ids - self.start
        inside = (local >= 0) & (local < n)
        out = F.embedding(local.clamp(0, n - 1), self.weight)
        return reduce_from_group(out * inside[..., None].to(out.dtype),
                                 self.group)


def _slice(linear: nn.Linear, dim: int, rank: int, size: int,
           bias: bool) -> None:
    per = linear.weight.shape[dim] // size
    sl = slice(rank * per, (rank + 1) * per)
    w = linear.weight.data
    linear.weight = nn.Parameter((w[sl] if dim == 0 else w[:, sl]).clone())
    if bias:
        linear.bias = nn.Parameter(linear.bias.data[sl].clone())


def shard_model(model: nn.Module, group) -> Dict[str, int]:
    """Split ``model``'s encoder blocks (the BERT-family text encoders and
    the ViTs) and word embeddings over ``group`` in place; returns ``{name:
    split dim}`` of the parameters split (also ``model.tp_shards``, with
    the group, for the optimizer and the gradient sync)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    split: Dict[str, int] = {}

    def refuse(prefix, names, what, n):
        log.warning("tp: %s not divisible by model=%d — replicating %s",
                    f"{what} {n}", size,
                    ", ".join(f"{prefix}.{m}" for m in names))

    for prefix, mod in list(model.named_modules()):
        if isinstance(mod, MultiHeadSelfAttention):
            blocks = [(("query", "key", "value"), "out", mod.num_heads)]
        elif isinstance(mod, EncoderLayer):
            blocks = [(("intermediate",), "output",
                       mod.intermediate.weight.shape[0])]
        elif isinstance(mod, ViTEncoderLayer):
            # One flag for the whole block: both halves split, or neither.
            blocks = [(("q", "k", "v"), "out", mod.num_heads),
                      (("mlp1",), "mlp2", mod.mlp1.weight.shape[0])]
        else:
            blocks = []
        bad = [(ups, down, n) for ups, down, n in blocks if n % size]
        if bad:
            for ups, down, n in blocks:
                refuse(prefix, [f"{m}.weight" for m in ups + (down,)],
                       "heads" if len(ups) == 3 else "hidden units", n)
        elif blocks:
            for ups, down, _ in blocks:
                for m in ups:
                    _slice(getattr(mod, m), 0, rank, size, bias=True)
                    split[f"{prefix}.{m}.weight"] = 0
                    split[f"{prefix}.{m}.bias"] = 0
                _slice(getattr(mod, down), 1, rank, size, bias=False)
                split[f"{prefix}.{down}.weight"] = 1
            if hasattr(mod, "num_heads"):
                mod.num_heads //= size
            mod.tp = group
        if isinstance(mod, TextEncoder):
            table = mod.word_embeddings.weight
            if table.shape[0] % size:
                refuse(prefix, ["word_embeddings.weight"], "vocabulary",
                       table.shape[0])
            else:
                per = table.shape[0] // size
                mod.word_embeddings = VocabParallelEmbedding(
                    table.data[rank * per:(rank + 1) * per].clone(),
                    rank * per, group)
                split[f"{prefix}.word_embeddings.weight"] = 0
    split = {n.lstrip("."): d for n, d in split.items()}
    model.tp_shards = {n: (d, group) for n, d in split.items()}
    return split


def count_sharded(model: nn.Module) -> int:
    """Parameters split over the model group (diagnostic and test hook)."""
    return len(getattr(model, "tp_shards", {}))


def gather_full(tensors: Dict[str, torch.Tensor], dims: Dict[str, int],
                group) -> Dict[str, torch.Tensor]:
    """Host copies of ``tensors`` with each one named in ``dims`` gathered
    from every rank of ``group`` along its dim (a collective)."""
    from mpmc_tpu_torch.train.checkpoint import to_host
    own = to_host({n: v for n, v in tensors.items() if n in dims})
    parts: List = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, own, group=group)
    out = dict(tensors)
    for n, d in dims.items():
        if n in out:
            out[n] = torch.cat([p[n] for p in parts], dim=d)
    return out


def local_slice(tensors: Dict[str, torch.Tensor], dims: Dict[str, int],
                group) -> Dict[str, torch.Tensor]:
    """This rank's slices of whole tensors (the inverse of
    :func:`gather_full`)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    out = dict(tensors)
    for n, d in dims.items():
        if n in out:
            out[n] = out[n].chunk(size, dim=d)[rank]
    return out


def full_state_dict(model: nn.Module, group) -> Dict[str, torch.Tensor]:
    """The plain model's state dict (a collective of the model group)."""
    dims = {n: d for n, (d, _) in model.tp_shards.items()}
    return gather_full(model.state_dict(), dims, group)


def _state_dims(optimizer, lead: int = 0
                ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """The split dim of each split parameter (``{name: dim}``) and of each
    of its optimizer slots (``{"name/slot": dim}``: split where the
    parameter is, the factored statistics where they keep the split dim),
    counted in tensors with ``lead`` fewer leading dims than the
    optimizer's (1: one fold of a fold-stacked state)."""
    params, slots = {}, {}
    for name, (dim, _) in optimizer.shards.items():
        params[name] = dim - lead
        st = optimizer.state[name]
        if "v_row" in st:
            d1, d0 = optimizer._fold_factored_dims(
                optimizer.params[name].shape, name)
            for k, d in (("v_row", d0), ("v_col", d1)):
                if dim != d:
                    slots[f"{name}/{k}"] = dim - (dim > d) - lead
        else:
            slots.update({f"{name}/{k}": dim - lead for k in st
                          if k != "mu_f32"})
    return params, slots


def _map_state(sd: Dict, optimizer, group, lead: int, fn) -> Dict:
    """``sd`` (a train step's ``state_dict``: the model, the optimizer's
    slots and count, the generator) with ``fn(tensors, dims, group)``
    applied to the model's tensors and to the optimizer's slots."""
    dims, slot_dims = _state_dims(optimizer, lead)
    flat = {f"{n}/{k}": v for n, st in sd["optimizer"]["state"].items()
            for k, v in st.items()}
    slots: Dict[str, Dict] = {}
    for key, v in fn(flat, slot_dims, group).items():
        n, k = key.rsplit("/", 1)
        slots.setdefault(n, {})[k] = v
    return {"model": fn(sd["model"], dims, group),
            "optimizer": {"count": sd["optimizer"]["count"],
                          "state": slots},
            "generator": sd["generator"]}


def gather_state(sd: Dict, optimizer, group, lead: int = 0) -> Dict:
    """The plain model's whole training state from this rank's ``sd`` of
    ``optimizer``'s split parameters (a collective of ``group``).
    ``lead``: as :func:`_state_dims`."""
    return _map_state(sd, optimizer, group, lead, gather_full)


def slice_state(sd: Dict, optimizer, group) -> Dict:
    """This rank's slices of a whole training state (the inverse of
    :func:`gather_state`)."""
    return _map_state(sd, optimizer, group, 0, local_slice)


class TensorParallelTrainStep(TrainStep):
    """The train step of a tensor-parallel model; its state is the plain
    model's whole training state, gathered from the slices
    (:func:`gather_state`), and a restore takes this rank's slices of
    it."""

    def _group(self):
        return next(iter(self.optimizer.shards.values()))[1]

    def state_dict(self) -> Dict:
        return gather_state(super().state_dict(), self.optimizer,
                            self._group())

    def load_state_dict(self, sd: Dict) -> None:
        super().load_state_dict(slice_state(sd, self.optimizer,
                                            self._group()))


def tensor_parallel(model: nn.Module, group, rebuild) -> nn.Module:
    """``model`` split over ``group`` (:func:`shard_model`), with the hooks
    the drivers read: ``full_state_dict`` (the plain model's weights,
    gathered) and ``meta_skeleton`` (the split model without storage, from
    ``rebuild()``, a storage-free plain model, for the eval step).  Warns
    when no weight matched a rule, as the JAX driver does."""
    shard_model(model, group)
    if count_sharded(model) == 0:
        log.warning("--model-shards %d matched no weights for this model "
                    "family (rules target the BERT and ViT encoders, "
                    "parallel/tp.py) — training proceeds fully replicated "
                    "over the model axis", dist.get_world_size(group))
    model.full_state_dict = lambda: full_state_dict(model, group)

    def meta_skeleton():
        skeleton = rebuild()
        shard_model(skeleton, group)
        return skeleton.eval()

    model.meta_skeleton = meta_skeleton
    model.sharded_params = list(model.tp_shards)
    return model
