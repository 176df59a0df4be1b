"""SimCLR contrastive pretraining of the image backbone (port of
``mpmc_tpu/train/pretrain_image.py``).

With no image weights on the disk the backbones start cold; this stage
pretrains one on the task images themselves, before 2B or the 2C flagship:
two independent draws of the supervised loop's augmentation
(``image/augment.train_augment``: flip, brightness, rotation and
normalization, the fused image kernel on the card) of every image, both
views through the backbone in one ``[2B, ...]`` batch in training mode, a
projection MLP (``proj_fc1``, ReLU, ``proj_fc2``) and the NT-Xent loss over
the in-batch negatives, all in f32 as the JAX stage runs it.  AdamW (weight
decay on every parameter) after a global-norm clip at 1.0, under a warmup-
cosine schedule over ``steps_per_epoch * epochs`` steps.  BatchNorm runs on
the batch statistics of both views and carries its running statistics
with flax's momentum.  The backbone and its running statistics are written
as the flax-tree npz that either package's ``--image-params`` splice reads
(``models/pretrained.py``).

The JAX loop runs whole groups of ``SimCLRConfig.scan_steps`` steps per
dispatch and drops the epoch's remainder; this port runs the same steps on
the same rows (``pretrain.mlm_epoch_rows``), each group one CUDA graph
replay on the card (``pretrain.run_grouped``): a step gathers its rows
(``[K, bs]`` indices) from the images already on the device, draws both
views' augmentation from the registered device generator and runs the
fused image kernel twice; BatchNorm updates its running statistics in
place.  The steps run under PyTorch's deterministic algorithms
(``pretrain.deterministic_algorithms``: cuDNN's default weight-gradient
algorithms sum in an order that changes from run to run).  The
augmentation draws cannot equal the JAX draws; :meth:`SimCLRTrainer.step`
takes both views' draws as arguments for the tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.config import ImageEncoderConfig
from mpmc_tpu_torch.image.augment import augment_draws, augment_with_draws
from mpmc_tpu_torch.models.classifier import create_image_backbone, init_weights
from mpmc_tpu_torch.models.convert import to_jax_variables
from mpmc_tpu_torch.models.pretrained import FLAX_IMAGE_MARKER, flatten_params
from mpmc_tpu_torch.train.pretrain import (
    AdamW, deterministic_algorithms, epoch_mean, mlm_epoch_rows, run_grouped,
    warmup_cosine_decay_schedule)

log = logging.getLogger(__name__)

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SimCLRConfig:
    epochs: int = 30
    batch_size: int = 64
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup_fraction: float = 0.05
    temperature: float = 0.5
    proj_dim: int = 128
    max_rotate_deg: float = 15.0
    seed: int = 42
    scan_steps: int = 4              # optimizer steps per device dispatch


class SimCLRModel(nn.Module):
    """The backbone (``backbone``, the subtree the classifiers splice) and
    the projection MLP, discarded after pretraining."""

    def __init__(self, cfg: ImageEncoderConfig, proj_dim: int):
        super().__init__()
        self.backbone = create_image_backbone(cfg)
        width = self.backbone.feature_dim
        self.proj_fc1 = nn.Linear(width, width)
        self.proj_fc2 = nn.Linear(width, proj_dim)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.proj_fc2(F.relu(self.proj_fc1(self.backbone(image))))


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    """NT-Xent over the ``[2B, D]`` projections in f32: each row divided by
    ``max(|z|, 1e-8)``, similarities over ``temperature``, -1e9 on the
    diagonal, each view's target its sibling view; the mean cross-entropy."""
    z = torch.cat([z1, z2], dim=0).to(torch.float32)
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                        min=1e-8)
    sim = z @ z.T / temperature
    n = sim.shape[0]
    sim = sim.masked_fill(torch.eye(n, dtype=torch.bool, device=z.device),
                          -1e9)
    b = n // 2
    # Made on the device: a host-to-device copy cannot be captured.
    targets = torch.arange(n, device=z.device).roll(b)
    return F.cross_entropy(sim, targets)


class SimCLRTrainer:
    """The SimCLR model and its AdamW; :meth:`step` runs one optimizer
    step in f32."""

    def __init__(self, model: SimCLRModel, total_steps: int,
                 cfg: SimCLRConfig):
        self.model = model
        self.cfg = cfg
        warmup = max(int(cfg.warmup_fraction * total_steps), 1)
        self.optimizer = AdamW(
            dict(model.named_parameters()),
            warmup_cosine_decay_schedule(cfg.learning_rate, warmup,
                                         total_steps),
            cfg.weight_decay, total_steps=total_steps)

    def views(self, images_u8: torch.Tensor, draws1: Draws,
              draws2: Draws) -> torch.Tensor:
        """Both augmented views of a uint8 batch, ``[2B, H, W, 3]`` f32."""
        deg = self.cfg.max_rotate_deg
        return torch.cat([augment_with_draws(images_u8, *draws1, deg),
                          augment_with_draws(images_u8, *draws2, deg)])

    def step(self, images_u8: torch.Tensor, draws1: Draws,
             draws2: Draws) -> torch.Tensor:
        """One step on a uint8 ``[B, H, W, 3]`` device batch with the two
        views' ``(flip, bright, angle)`` draws, in IEEE f32 (:func:`ieee_f32`);
        returns the loss (0-dim device tensor)."""
        self.model.train()
        params = list(self.optimizer.params.values())
        with ieee_f32():
            out = self.model(self.views(images_u8, draws1, draws2))
            b = images_u8.shape[0]
            loss = nt_xent_loss(out[:b], out[b:], self.cfg.temperature)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, torch.autograd.grad(
                         loss, params, allow_unused=True))]
        self.optimizer.step(grads)
        return loss.detach()


@contextlib.contextmanager
def ieee_f32():
    """cuDNN convolutions (TF32 by PyTorch's default) and cuBLAS matmuls in
    full f32 while active, as the JAX stage computes; the caller's settings
    come back after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@dataclasses.dataclass
class SimCLRRun:
    """What :func:`simclr_pretrain` trained: the backbone (with its running
    statistics), the per-epoch mean
    losses and every step's loss."""

    backbone: nn.Module
    epoch_losses: List[float]
    step_losses: List[float]

    @property
    def steps(self) -> int:
        return len(self.step_losses)


def simclr_pretrain(img_cfg: ImageEncoderConfig, images_u8: np.ndarray,
                    cfg: SimCLRConfig = SimCLRConfig(),
                    device: torch.device = torch.device("cuda")
                    ) -> SimCLRRun:
    """Pretrain the backbone of ``img_cfg`` contrastively over uint8 images
    ``[N, H, W, 3]`` on ``device``, each group of ``min(scan_steps,
    steps_per_epoch)`` steps one dispatch.  The images go to the device
    once and each step gathers its rows there; weights and augmentation
    draws come from a generator seeded with ``cfg.seed``, the epoch
    permutations from ``np.random.default_rng(cfg.seed)``."""
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(
            f"SimCLR takes color images [N, H, W, 3] (the augmentation's "
            f"fused pass normalizes with the 3-channel ImageNet statistics), "
            f"got {images_u8.shape}")
    n = images_u8.shape[0]
    bs = min(cfg.batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    total_steps = steps_per_epoch * cfg.epochs
    k = max(min(cfg.scan_steps, steps_per_epoch), 1)
    with torch.device(device):
        model = SimCLRModel(img_cfg, cfg.proj_dim)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    init_weights(model, generator)
    trainer = SimCLRTrainer(model, total_steps, cfg)
    images = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)

    def step(b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = images.index_select(0, b["rows"])
        draws = [augment_draws(bs, generator, cfg.max_rotate_deg)
                 for _ in range(2)]
        return {"loss": trainer.step(batch, *draws)}

    run = run_grouped(step, k, cfg.epochs * (steps_per_epoch // k), device,
                      generator, trainer.optimizer)
    rng = np.random.default_rng(cfg.seed)
    epoch_losses, step_losses = [], []
    for epoch in range(cfg.epochs):
        rows = mlm_epoch_rows(rng.permutation(n), bs, steps_per_epoch, k)
        with deterministic_algorithms():
            losses = [run({"rows": torch.from_numpy(np.stack(rows[g:g + k]))})
                      for g in range(0, len(rows), k)]
        epoch_losses.append(epoch_mean(losses, step_losses))
        if epoch % 5 == 0 or epoch == cfg.epochs - 1:
            log.info("SimCLR | epoch %d/%d | loss %.4f", epoch, cfg.epochs,
                     epoch_losses[-1])
    return SimCLRRun(model.backbone, epoch_losses, step_losses)


def save_image_encoder_params(backbone: nn.Module, path: str) -> None:
    """Write a backbone's parameters and BatchNorm running statistics as the
    marked flax-tree npz (``params/...``, ``batch_stats/...``)."""
    params, stats = to_jax_variables(backbone)
    flat = {f"params/{k}": v for k, v in flatten_params(params).items()}
    flat.update({f"batch_stats/{k}": v
                 for k, v in flatten_params(stats).items()})
    flat[FLAX_IMAGE_MARKER] = np.asarray(1)
    np.savez(path, **flat)


def pretrain_and_save_image(img_cfg: ImageEncoderConfig,
                            images_u8: np.ndarray, out_path: str,
                            cfg: SimCLRConfig = SimCLRConfig(),
                            device: torch.device = torch.device("cuda")
                            ) -> SimCLRRun:
    """Images, SimCLR on ``device``, and the backbone written to
    ``out_path`` (``--image-params``)."""
    run = simclr_pretrain(img_cfg, images_u8, cfg, device)
    save_image_encoder_params(run.backbone, out_path)
    log.info("SimCLR backbone saved to %s (loss %.3f -> %.3f)", out_path,
             run.epoch_losses[0], run.epoch_losses[-1])
    return run
