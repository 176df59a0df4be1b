"""The 2B image model: ViT (pre-LN at the configuration's epsilon, a class
token, learned positions) and one Linear to two logits."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.counts import flops
from portbench.data import images
from portbench.reference.nets import F32, Precision, Weights, linear, vit
from portbench.weights import linear_specs, vit_specs

PORT_KIND = "image"
PACKED: Dict[str, str] = {}


def model_config(cfg: dict):
    from mpmc_tpu_torch.config import ImageEncoderConfig, ModelConfig, Subtask
    img = cfg["image_encoder"]
    return ModelConfig(
        subtask=Subtask.B, text=None, caption=None,
        image=ImageEncoderConfig(arch=img["arch"],
                                 image_size=img["image_size"],
                                 feature_dim=img["feature_dim"],
                                 patch_size=img["patch_size"]),
        num_classes=cfg["head"]["num_classes"])


def param_specs(cfg: dict):
    c = cfg["image_encoder"]
    return vit_specs("backbone.", c) + linear_specs(
        "output", c["hidden_size"], cfg["head"]["num_classes"])


def memes(cfg: dict, traffic: dict, n: int, rng: np.random.Generator,
          g: torch.Generator, device: torch.device) -> Dict[str, np.ndarray]:
    return {"image": images(cfg, n, g, device)}


def logits(W: Weights, cfg: dict, batch: Dict[str, torch.Tensor],
           training: bool, P: Precision = F32) -> torch.Tensor:
    """The two logits ``[B, 2]``: ViT features, one Linear."""
    feats = vit(W, "backbone.", cfg["image_encoder"], batch["image"], P)
    return linear(W, "output", feats, P)


def forward_flops(cfg: dict, n: int, tokens: Dict[str, np.ndarray]) -> float:
    img = cfg["image_encoder"]
    return n * (flops.vit(img) + flops.linears([(img["hidden_size"],
                                                 cfg["head"]["num_classes"])]))


def attention_parts(cfg: dict, n: int, tokens: Dict[str, np.ndarray]):
    """The patches and the class token of each image."""
    c = cfg["image_encoder"]
    return [(np.full(n, (c["image_size"] // c["patch_size"]) ** 2 + 1), c)]
