"""Sequence parallelism for the 2A text encoder (port of
``mpmc_tpu/parallel/sp.py``).

The ranks of a ``seq`` process group each hold one block of the sequence
inside the encoder's layer stack, so activation memory and attention work
per GPU scale as 1/P in the sequence:

* every per-token op (the dense layers, LayerNorm, residuals) runs on the
  rank's own tokens with the replicated weights;
* attention mixes the blocks through the ring (K/V blocks rotate between
  neighbours) or Ulysses (all-to-all to head sharding, the exact local
  attention, all-to-all back) impl of ``ops/attention.py``;
* the embeddings (global position ids) run on the whole sequence before
  the region, and the pooler and head after it, on every rank; the region
  ends with an all-gather of the sequence, whose gradient is a
  reduce-scatter (``parallel/collectives.py``);
* the backward is autograd through those collectives.

Each rank of a ``seq`` group computes the same loss; the train step takes
1/P of it on each and sums the gradients over the world
(``train.step.GradSync``).  Encoder-layer dropout is off inside the region
(the JAX package's trade); embedding dropout stays live.  The parameters
are the plain ``TextClassifier``'s, under the same names, so checkpoints
and ``predict`` need no conversion.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.func import functional_call

from mpmc_tpu_torch.config import ModelConfig
from mpmc_tpu_torch.models.classifier import TextClassifier
from mpmc_tpu_torch.models.norm import Dropout
from mpmc_tpu_torch.parallel.collectives import all_gather

IMPLS = ("ring", "ulysses")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown SP impl: {impl!r} "
                         "(expected 'ring' or 'ulysses')")


def make_sp_stack(group, impl: str = "ring") -> Callable:
    """``stack(layers, x [B, S/P, D], mask [B, S/P]) -> [B, S/P, D]``: the
    encoder ``layers`` (a list of ``EncoderLayer``) over this rank's block
    of the sequence, attention through ``impl`` over ``group``."""
    _check_impl(impl)

    def stack(layers, x, mask):
        for layer in layers:
            layer.attention.impl, layer.attention.group = impl, group
            x = layer(x, mask)
        return x

    return stack


class SequenceParallelText(TextClassifier):
    """``TextClassifier`` whose encoder layers run sequence-sharded over
    ``group`` (the mesh's ``seq`` axis) with ``impl`` attention."""

    def __init__(self, cfg: ModelConfig, group, impl: str = "ring"):
        _check_impl(impl)
        super().__init__(cfg)
        self.group, self.impl = group, impl
        self.stack = make_sp_stack(group, impl)
        self.layers = [getattr(self.encoder, f"layer_{i}")
                       for i in range(cfg.text.num_layers)]
        for layer in self.layers:
            layer.attention.impl, layer.attention.group = impl, group

    @classmethod
    def wrap(cls, model: TextClassifier, group, impl: str = "ring"
             ) -> "SequenceParallelText":
        """``model``'s parameters (the same tensors) in the SP model."""
        with torch.device("meta"):
            sp = cls(model.cfg, group, impl)
        sp.load_state_dict(model.state_dict(), assign=True)
        return sp.train(model.training)

    def meta_skeleton(self) -> "SequenceParallelText":
        """The same model without storage, in eval mode
        (``train.step.make_eval_step``)."""
        with torch.device("meta"):
            return type(self)(self.cfg, self.group, self.impl).eval()

    def train(self, mode: bool = True):
        super().train(mode)
        for layer in self.layers:
            for mod in layer.modules():
                if isinstance(mod, Dropout):
                    mod.training = False
        return self

    def forward(self, text_ids: torch.Tensor,
                text_mask: torch.Tensor) -> torch.Tensor:
        P = torch.distributed.get_world_size(self.group)
        r = torch.distributed.get_rank(self.group)
        S = text_ids.shape[1]
        if S % P:
            raise ValueError(f"sequence length {S} not divisible by "
                             f"seq-axis size {P}")
        x = self.encoder.embed(text_ids, text_mask)
        block = slice(r * (S // P), (r + 1) * (S // P))
        h = self.stack(self.layers, x[:, block],
                       text_mask.to(torch.float32)[:, block])
        h = all_gather(h, self.group, dim=1)
        return self.output(self.pooler(h, text_mask))


def make_sp_forward(mcfg: ModelConfig, group, impl: str = "ring"
                    ) -> Callable:
    """``forward(params, input_ids, attention_mask) -> logits`` over the
    plain ``TextClassifier``'s parameters (a name -> tensor dict), its
    layer stack sequence-sharded over ``group``; the plain forward's
    numbers in eval mode."""
    with torch.device("meta"):
        skeleton = SequenceParallelText(mcfg, group, impl).eval()

    def forward(params: Dict[str, torch.Tensor], input_ids, attention_mask):
        return functional_call(skeleton, params, (input_ids, attention_mask))

    return forward
