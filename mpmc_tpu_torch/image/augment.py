"""Image preprocessing on the device (port of ``normalize``,
``eval_preprocess``, ``_shear_rolls``, ``_rotate_shear`` and
``train_augment`` in ``mpmc_tpu/image/augment.py``).  Images keep the JAX
package's uint8 ``[B, H, W, C]`` layout.

Training augmentation: a random horizontal flip (p = 0.5), a brightness
gain ~U[0.9, 1.1] and a rotation ~U[-15, 15] degrees.  Flip, gain and
ImageNet normalization run in one pass (``ops/image_ops.py``: the CUDA
kernel on the card); the rotation is the JAX package's gather-free Paeth
three-shear in bf16, plain PyTorch as it is plain XLA there.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from mpmc_tpu_torch.ops.image_ops import (IMAGENET_MEAN, IMAGENET_STD,
                                          fused_normalize_flip_brightness)

GRAY_MEAN, GRAY_STD = (0.45,), (0.22,)
MAX_ROTATE_DEG = 15.0


@functools.lru_cache(maxsize=None)
def _constants(values: Tuple[float, ...], device: torch.device
               ) -> torch.Tensor:
    """``values`` as an f32 tensor on ``device``, made once: a copy from
    the host on every call would cost a transfer a batch, and is illegal
    while a CUDA graph is being captured."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN,
              std=IMAGENET_STD) -> torch.Tensor:
    """uint8 ``[B,H,W,C]`` to normalized f32."""
    mean = _constants(tuple(mean), x.device)
    std = _constants(tuple(std), x.device)
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


def _shear_rolls(x: torch.Tensor, t: torch.Tensor, axis: int,
                 dmax: int) -> torch.Tensor:
    """1-D bilinear resample along ``axis`` with a per-line shift ``t``
    (out = in[pos - t], zeros outside), as the JAX package's weighted sum
    over the 2*dmax+1 integer rolls, in the dtype of ``x``.  axis=2 shears
    rows (t is [B, H]), axis=1 shears columns (t is [B, W]).

    Each term ``roll(x, d) * w_d * valid_d`` is added only where ``valid_d``
    is 1, reading the shifted slice of ``x`` in place of the roll: the same
    products and sums (an invalid position adds 0 there), without the
    roll's copy.  The weights of all shifts are computed at once."""
    L = x.shape[axis]
    ds = torch.arange(-dmax, dmax + 1, device=x.device)
    w_all = torch.clamp(1.0 - torch.abs(t[None] - ds[:, None, None]),
                        0.0, 1.0).to(x.dtype)       # [2*dmax+1, B, lines]
    out = torch.zeros_like(x)
    for i, d in enumerate(range(-dmax, dmax + 1)):
        if abs(d) >= L:
            continue
        dst = slice(max(d, 0), L + min(d, 0))       # positions pos - d valid
        src = slice(max(-d, 0), L - max(d, 0))
        if axis == 2:
            w_b = w_all[i][:, :, None, None]
            out[:, :, dst].add_(x[:, :, src] * w_b)
        else:
            w_b = w_all[i][:, None, :, None]
            out[:, dst].add_(x[:, src] * w_b)
    return out


def _rotate_shear(x: torch.Tensor, angle: torch.Tensor,
                  max_deg: float) -> torch.Tensor:
    """Rotation of each image by ``angle`` (radians) through the Paeth
    decomposition ShearX(-tan(a/2)) ShearY(sin a) ShearX(-tan(a/2)), each
    shear a weighted-roll resample in bf16; returns the input dtype."""
    H, W = x.shape[1], x.shape[2]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    out_dtype = x.dtype
    x = x.to(torch.bfloat16)
    a = angle.to(torch.float32)
    alpha = -torch.tan(a / 2.0)
    beta = torch.sin(a)
    rows = torch.arange(H, dtype=torch.float32, device=x.device) - cy
    cols = torch.arange(W, dtype=torch.float32, device=x.device) - cx
    tx = alpha[:, None] * rows[None, :]
    ty = beta[:, None] * cols[None, :]
    rad = math.radians(max_deg)
    dmax_x = int(math.ceil(math.tan(rad / 2.0) * max(H, W) / 2.0)) + 1
    dmax_y = int(math.ceil(math.sin(rad) * max(H, W) / 2.0)) + 1
    x = _shear_rolls(x, tx, axis=2, dmax=dmax_x)
    x = _shear_rolls(x, ty, axis=1, dmax=dmax_y)
    x = _shear_rolls(x, tx, axis=2, dmax=dmax_x)
    return x.to(out_dtype)


def augment_draws(batch: int, generator: torch.Generator,
                  max_rotate_deg: float = MAX_ROTATE_DEG
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(flip, bright, angle)`` for ``batch`` images from ``generator``, on
    its device: flip with p = 0.5, brightness ~U[0.9, 1.1], angle
    ~U[-max, max] degrees, returned in radians."""
    dev = generator.device
    u = torch.rand((3, batch), generator=generator, device=dev)
    flip = u[0] < 0.5
    bright = 0.9 + 0.2 * u[1]
    angle = (u[2] * 2.0 - 1.0) * max_rotate_deg * (math.pi / 180.0)
    return flip, bright, angle


def augment_with_draws(images_u8: torch.Tensor, flip: torch.Tensor,
                       bright: torch.Tensor, angle: torch.Tensor,
                       max_rotate_deg: float = MAX_ROTATE_DEG
                       ) -> torch.Tensor:
    """The deterministic half of :func:`train_augment`: the fused flip,
    brightness and normalize pass, then the rotation; f32 out."""
    x = fused_normalize_flip_brightness(images_u8, flip, bright)
    return _rotate_shear(x, angle, max_rotate_deg)


def train_augment(images_u8: torch.Tensor, generator: torch.Generator,
                  max_rotate_deg: float = MAX_ROTATE_DEG) -> torch.Tensor:
    """Random flip, brightness, rotation and normalize of a uint8 batch,
    with the draws taken from ``generator``."""
    draws = augment_draws(images_u8.shape[0], generator, max_rotate_deg)
    return augment_with_draws(images_u8, *draws, max_rotate_deg)
