"""Pipeline parallelism for the 2A text encoder (port of
``mpmc_tpu/parallel/pp.py``): the GPipe schedule over a ``stage`` process
group.

* The encoder's L layers split into S contiguous stages; the rank of
  stage ``s`` holds layers ``s*L/S .. (s+1)*L/S - 1`` alone, with their
  optimizer state, so the encoder's memory per GPU is 1/S of it.
  Embeddings, pooler and head are on every rank.
* :meth:`PipelineText.pipeline` runs JAX's ``make_pipeline_fn`` schedule
  tick for tick: M + S - 1 ticks; at tick t stage s works on microbatch
  t - s (clamped in the bubble); the last stage commits its output; one
  neighbour :func:`~mpmc_tpu_torch.parallel.collectives.shift` a tick
  passes the activations on; at the end an all-reduce over the stage group
  gives every rank the last stage's output.
* The backward is autograd through the shifts (the reverse shift) and the
  all-reduce; a select, as JAX's ``where``, keeps every shift in the
  graph of every rank, so the ranks' collectives pair in both directions.
* Every rank of a stage group computes the same loss; the train step
  takes 1/S of it on each, sums the shared weights' gradients over the
  world and the stage's over ``data`` (``train.step.GradSync``).

Checkpoints are the plain ``TextClassifier``'s: rank 0 gathers the stages
(:func:`merge_stage_params`), so ``predict --checkpoint`` reads ``model.pt``
as it is, and ``--resume`` under the same ``--pipeline-stages`` gives each
stage its part of the whole state back.  Encoder-layer dropout is off
inside the pipeline (the JAX package's trade); embedding dropout stays
live.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from mpmc_tpu_torch.config import MeshConfig, ModelConfig
from mpmc_tpu_torch.models.classifier import TextClassifier
from mpmc_tpu_torch.models.norm import Dropout
from mpmc_tpu_torch.parallel.collectives import all_reduce, shift
from mpmc_tpu_torch.train.step import TrainStep

_LAYER = re.compile(r"^encoder\.layer_(\d+)\.")


def microbatches(mesh: MeshConfig, batch_size: int) -> int:
    """``--pp-microbatches`` (0: 4 x stages), which must divide the
    batch."""
    m = mesh.pp_microbatches or 4 * mesh.num_stage_shards
    if batch_size % m:
        raise ValueError(f"batch_size={batch_size} not divisible by "
                         f"pipeline microbatches={m} (set --pp-microbatches)")
    return m


def layer_of(name: str):
    """The encoder layer a parameter name belongs to, or None."""
    hit = _LAYER.match(name)
    return int(hit.group(1)) if hit else None


def split_stage_params(params: Dict[str, torch.Tensor], num_stages: int
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  List[Dict[str, torch.Tensor]]]:
    """A ``TextClassifier`` state dict as ``(rest, stages)``: ``rest``
    without the encoder layers (embeddings, the encoder's pooler, the
    classifier's pooler and head), ``stages[s]`` the layers of stage s
    (``s*L/S .. (s+1)*L/S - 1``) under their own names."""
    layers = {layer_of(n) for n in params} - {None}
    if not layers or len(layers) % num_stages:
        raise ValueError(f"{len(layers)} encoder layers not divisible into "
                         f"{num_stages} stages")
    per = len(layers) // num_stages
    rest = {n: v for n, v in params.items() if layer_of(n) is None}
    stages = [{n: v for n, v in params.items()
               if layer_of(n) is not None and layer_of(n) // per == s}
              for s in range(num_stages)]
    return rest, stages


def merge_stage_params(rest: Dict[str, torch.Tensor],
                       stages: List[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_stage_params`: the plain state dict, in the
    ``TextClassifier``'s order."""
    order = _plain_order(rest, stages)
    merged = dict(rest)
    for stage in stages:
        merged.update(stage)
    return {n: merged[n] for n in order if n in merged}


def _plain_order(rest, stages) -> List[str]:
    """Every name in a plain state dict's order: rest's names before the
    first layer, the layers in order, then rest's names after them."""
    layer_names = [n for s in stages for n in s]
    layer_names.sort(key=lambda n: layer_of(n))
    before = [n for n in rest if n.startswith("encoder.")
              and not n.startswith("encoder.pooler.")]
    after = [n for n in rest if n not in before]
    return before + layer_names + after


class PipelineText(TextClassifier):
    """The 2A ``TextClassifier`` holding only stage ``rank`` of ``group``'s
    encoder layers, its encoder run as a GPipe pipeline of
    ``num_microbatches`` microbatches."""

    def __init__(self, cfg: ModelConfig, group, num_microbatches: int):
        super().__init__(cfg)
        self.group, self.num_microbatches = group, num_microbatches
        S, s = dist.get_world_size(group), dist.get_rank(group)
        L = cfg.text.num_layers
        if L % S:
            raise ValueError(f"{L} encoder layers not divisible into {S} "
                             "stages")
        self.num_stages, self.stage = S, s
        self.layer_ids = list(range(s * L // S, (s + 1) * L // S))
        for i in range(L):
            if i not in self.layer_ids:
                delattr(self.encoder, f"layer_{i}")
        self.layers = [getattr(self.encoder, f"layer_{i}")
                       for i in self.layer_ids]
        # Weights that live on this rank alone (train.step.GradSync).
        self.sharded_params = [n for n, _ in self.named_parameters()
                               if layer_of(n) is not None]

    @classmethod
    def wrap(cls, model: TextClassifier, group, num_microbatches: int
             ) -> "PipelineText":
        """This rank's part of ``model`` (the same tensors)."""
        with torch.device("meta"):
            pp = cls(model.cfg, group, num_microbatches)
        own = pp.state_dict()
        pp.load_state_dict({n: v for n, v in model.state_dict().items()
                            if n in own}, assign=True)
        return pp.train(model.training)

    def meta_skeleton(self) -> "PipelineText":
        with torch.device("meta"):
            return type(self)(self.cfg, self.group,
                              self.num_microbatches).eval()

    def train(self, mode: bool = True):
        super().train(mode)
        for layer in self.layers:
            for mod in layer.modules():
                if isinstance(mod, Dropout):
                    mod.training = False
        return self

    def run_stage(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x

    def pipeline(self, xs: torch.Tensor, masks: torch.Tensor
                 ) -> torch.Tensor:
        """``xs [M, b, S, D]``, ``masks [M, b, S]`` -> the stack's output
        ``[M, b, S, D]`` on every rank (JAX's ``make_pipeline_fn``)."""
        S, s, M = self.num_stages, self.stage, self.num_microbatches
        # Made on the device (a copy from the host is illegal while a CUDA
        # graph is being captured).
        first = torch.full((), s == 0, dtype=torch.bool, device=xs.device)
        last = torch.full((), s == S - 1, dtype=torch.bool, device=xs.device)
        state = torch.zeros_like(xs[0])
        outs = []
        ticks = M + S - 1
        for t in range(ticks):
            mu = min(max(t - s, 0), M - 1)
            y = self.run_stage(torch.where(first, xs[mu], state), masks[mu])
            if t >= S - 1:
                outs.append(y)          # slot t - (S - 1); kept where last
            if S > 1 and t < ticks - 1:
                state = shift(y, self.group)
        out = torch.where(last, torch.stack(outs), torch.zeros_like(xs))
        return all_reduce(out, self.group)

    def forward(self, text_ids: torch.Tensor,
                text_mask: torch.Tensor) -> torch.Tensor:
        M = self.num_microbatches
        B, S = text_ids.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible by "
                             f"num_microbatches={M}")
        x = self.encoder.embed(text_ids, text_mask)
        xs = x.view(M, B // M, S, x.shape[-1])
        masks = text_mask.to(torch.float32).view(M, B // M, S)
        h = self.pipeline(xs, masks).reshape(B, S, x.shape[-1])
        return self.output(self.pooler(h, text_mask))

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The plain model's state dict on every rank: the stages gathered
        (a collective of the stage group)."""
        own = {n: v for n, v in self.state_dict().items()
               if layer_of(n) is not None}
        rest = {n: v for n, v in self.state_dict().items()
                if layer_of(n) is None}
        return merge_stage_params(rest, gather_stages(own, self.group))


def gather_stages(own: Dict, group) -> List[Dict]:
    """Every stage's ``own`` (host copies), in stage order, on every rank."""
    from mpmc_tpu_torch.train.checkpoint import to_host
    parts: List = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, to_host(own), group=group)
    return parts


class PipelineTrainStep(TrainStep):
    """The train step of a :class:`PipelineText`; its state is the plain
    model's whole training state, gathered from the stages, and a restore
    takes this stage's part of it."""

    def state_dict(self) -> Dict:
        sd = super().state_dict()
        model: PipelineText = self.model
        stage = set(model.sharded_params)
        opt = sd["optimizer"]
        parts = gather_stages(
            {"model": {n: v for n, v in sd["model"].items()
                       if layer_of(n) is not None},
             "optimizer": {n: v for n, v in opt["state"].items()
                           if n in stage}}, model.group)
        rest = {n: v for n, v in sd["model"].items() if layer_of(n) is None}
        slots = {n: v for n, v in opt["state"].items() if n not in stage}
        for p in parts:
            slots.update(p["optimizer"])
        return {"model": merge_stage_params(rest,
                                            [p["model"] for p in parts]),
                "optimizer": {"count": opt["count"], "state": slots},
                "generator": sd["generator"]}

    def load_state_dict(self, sd: Dict) -> None:
        own_model = set(self.model.state_dict())
        own_opt = set(self.optimizer.state)
        super().load_state_dict({
            "model": {n: v for n, v in sd["model"].items()
                      if n in own_model},
            "optimizer": {"count": sd["optimizer"]["count"],
                          "state": {n: v for n, v in
                                    sd["optimizer"]["state"].items()
                                    if n in own_opt}},
            "generator": sd["generator"]})
