"""The 2A text model: one BERT encoder over each meme's text, attention
pooling over its own tokens, one Linear to two logits, cross-entropy (as
the system's ``run_subtask_2a`` builds it).  Trained packed, several memes
a row (``pack_rows``), the encoder's dropout masks drawn over the rows."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.counts import flops
from portbench.data import token_rows, word_counts
from portbench.reference.nets import (F32, Precision, Weights, linear,
                                      text_encoder)
from portbench.reference.pooling import attention_pool
from portbench.weights import linear_specs, text_encoder_specs

PORT_KIND = "text"
PACKED = {"encoder.": "t_"}


def model_config(cfg: dict):
    from mpmc_tpu_torch.config import ModelConfig, PoolingType, Subtask

    from portbench.drivers.common import text_encoder_config
    head = cfg["head"]
    return ModelConfig(
        subtask=Subtask.A, text=text_encoder_config(cfg["text_encoder"]),
        caption=None, image=None, pooling=PoolingType(head["pooling"]),
        num_classes=head["num_classes"], max_text_len=head["max_text_len"])


def param_specs(cfg: dict):
    H = cfg["text_encoder"]["hidden_size"]
    A = cfg["head"]["attention_hidden"]
    return (text_encoder_specs("encoder.", cfg["text_encoder"])
            + linear_specs("pooler.attn_fc1", H, A)
            + linear_specs("pooler.attn_fc2", A, 1)
            + linear_specs("output", H, cfg["head"]["num_classes"]))


def memes(cfg: dict, traffic: dict, n: int, rng: np.random.Generator,
          g: torch.Generator, device: torch.device) -> Dict[str, np.ndarray]:
    """``text_ids``/``text_mask`` ``[n, max_text_len]``."""
    words = rng.permutation(word_counts(n, traffic))
    ids, mask = token_rows(words + 2, cfg["head"]["max_text_len"],
                           cfg["text_encoder"], g, device)
    return {"text_ids": ids, "text_mask": mask}


def logits(W: Weights, cfg: dict, batch: Dict[str, torch.Tensor],
           training: bool, P: Precision = F32) -> torch.Tensor:
    """The two logits ``[B, 2]`` of a batch of right-padded ``text_ids``
    and ``text_mask`` (and the dropout masks ``drop``, when training)."""
    drop = batch.get("drop") if training else None
    mask = batch["text_mask"]
    hidden = text_encoder(W, "encoder.", cfg["text_encoder"],
                          batch["text_ids"], mask, P, drop)
    return linear(W, "output", attention_pool(W, "pooler.", hidden, mask, P),
                  P)


def forward_flops(cfg: dict, n: int, tokens: Dict[str, np.ndarray]) -> float:
    """The encoder; the pooling's score MLP over every token and its
    weighted sum; the output Linear."""
    t, head = cfg["text_encoder"], cfg["head"]
    H, L = t["hidden_size"], np.asarray(tokens["text"], np.float64)
    per_token = flops.linears([(H, head["attention_hidden"]),
                               (head["attention_hidden"], 1)]) + 2.0 * H
    return float(np.sum(flops.encoder(L, H, t["intermediate_size"],
                                      t["num_hidden_layers"]))
                 + np.sum(L) * per_token
                 + n * flops.linears([(H, head["num_classes"])]))


def attention_parts(cfg: dict, n: int, tokens: Dict[str, np.ndarray]):
    return [(tokens["text"], cfg["text_encoder"])]
