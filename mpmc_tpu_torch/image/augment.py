"""Eval-time image preprocessing (port of ``normalize`` and
``eval_preprocess`` in ``mpmc_tpu/image/augment.py``).  Images keep the
JAX package's uint8 ``[B, H, W, C]`` layout."""

from __future__ import annotations

from typing import Optional

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY_MEAN, GRAY_STD = (0.45,), (0.22,)


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """uint8 ``[B,H,W,C]`` to normalized f32."""
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


def eval_preprocess(images_u8: torch.Tensor, crop: Optional[int] = None,
                    grayscale: bool = False) -> torch.Tensor:
    """Deterministic eval path: optional center crop, then normalize."""
    x = images_u8
    if crop is not None:
        H, W = x.shape[1], x.shape[2]
        top, left = (H - crop) // 2, (W - crop) // 2
        x = x[:, top:top + crop, left:left + crop]
    if grayscale:
        return normalize(x, GRAY_MEAN, GRAY_STD)
    return normalize(x)
