"""Corpus MLM pretraining of the text encoder (port of
``mpmc_tpu/train/pretrain.py``).

BERT-style masked-language-model pretraining over the task corpus (train
and dev texts, with OCR-style character-noise copies), run before the
supervised fine-tune when no pretrained text weights exist: dynamic masking
(15 % of real non-special tokens each step; of those 80 % ``[MASK]``, 10 %
a random id, 10 % kept), cross-entropy on the selected positions, AdamW
with global-norm clipping under a warmup-cosine schedule, all in f32 as the
JAX package runs it.  The encoder is written as the flax-tree npz that
either package's ``--text-params`` splice reads
(``models/pretrained.py``).

The JAX loop runs whole groups of ``SCAN_GROUP`` steps per dispatch and
drops the epoch's remainder, so an epoch runs ``floor(steps_per_epoch / k)
* k`` steps (``k = min(SCAN_GROUP, steps_per_epoch)``) over consecutive
``batch_size`` slices of one permutation; this port runs the same steps on
the same rows, one launch sequence per step.  Masking and dropout draw from
a ``torch.Generator`` on the device, so they cannot equal the JAX draws;
:meth:`MLMTrainer.step` takes the selection and the corrupted ids as
arguments for the tests.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.config import TextEncoderConfig
from mpmc_tpu_torch.models.bert import TextEncoder
from mpmc_tpu_torch.models.classifier import init_weights
from mpmc_tpu_torch.models.convert import to_jax_params
from mpmc_tpu_torch.models.norm import set_dropout_generator
from mpmc_tpu_torch.models.pretrained import save_encoder_params
from mpmc_tpu_torch.ops.packing import pack_sequences
from mpmc_tpu_torch.train.step import (adam_bias_corrections, adam_updates,
                                       clip_by_global_norm, global_norm)

log = logging.getLogger(__name__)

# The JAX MLM loop's steps per scan dispatch (its default ``scan_steps``):
# each epoch is truncated to whole groups of this many steps.
SCAN_GROUP = 8


def char_noise(texts: Sequence[str], rng: np.random.Generator,
               copies: int = 3, word_prob: float = 0.15) -> List[str]:
    """The texts followed by ``copies`` noisy copies: per word, with
    ``word_prob``, one character deleted, duplicated or swapped with the
    next (the JAX package's draws from ``rng``, in the same order)."""
    def noisy_word(w: str) -> str:
        if len(w) < 2:
            return w
        op = rng.integers(3)
        i = int(rng.integers(len(w)))
        if op == 0:                       # delete
            return w[:i] + w[i + 1:]
        if op == 1:                       # duplicate
            return w[:i] + w[i] + w[i:]
        j = min(i + 1, len(w) - 1)        # swap adjacent
        return w[:i] + w[j] + w[i] + w[j + 1:]

    out = list(texts)
    for _ in range(copies):
        for t in texts:
            words = [noisy_word(w) if rng.random() < word_prob else w
                     for w in t.split()]
            out.append(" ".join(words))
    return out


class MLMModel(nn.Module):
    """The text encoder (``encoder``, the subtree the classifiers splice)
    and BERT's MLM head: Linear ``mlm_transform``, GELU, LayerNorm
    ``mlm_ln``, Linear ``mlm_decoder`` over the vocab.  ``segments`` and
    ``positions`` run packed rows."""

    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.mlm_ln = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlm_decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                segments: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.encoder(ids, mask, segments=segments, positions=positions)
        h = F.gelu(self.mlm_transform(x),
                   approximate="tanh" if self.cfg.gelu_approx else "none")
        return self.mlm_decoder(self.mlm_ln(h))


@dataclasses.dataclass(frozen=True)
class MLMConfig:
    epochs: int = 30
    batch_size: int = 64
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_fraction: float = 0.05
    mask_prob: float = 0.15
    seed: int = 42
    char_noise_copies: int = 3
    char_noise_word_prob: float = 0.15
    # Pack the tokenized corpus once into full rows (segment-masked
    # attention, per-segment positions): the same objective on fewer rows;
    # batch_size then counts packed rows.
    pack: bool = False


def warmup_cosine_decay_schedule(peak: float, warmup_steps: int,
                                 total_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    total_steps)`` in f32: linear from 0 to ``peak`` over ``warmup_steps``,
    then ``peak * 0.5 * (1 + cos(pi * t / (total - warmup)))``."""
    decay_steps = total_steps - warmup_steps
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs total_steps > warmup_steps "
                         f"(got {total_steps} and {warmup_steps})")
    f32 = np.float32

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = f32(1) - f32(max(step, 0)) / f32(warmup_steps)
            return float(f32(-peak) * frac + f32(peak))
        t = min(f32(step - warmup_steps), f32(decay_steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t
                                          / f32(decay_steps)))
        return float(f32(peak) * cos)

    return schedule


class AdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule,
    weight_decay))``: Adam, plus ``weight_decay * p`` on every parameter
    (no mask), times ``-schedule(step)``.  Updates the parameters in
    place."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 schedule: Callable[[int], float], weight_decay: float,
                 clip: float = 1.0):
        self.params = params
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip = clip
        self.states = [{"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
                       for p in params.values()]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """One update from f32 ``grads`` (in ``params`` order); returns
        their pre-clip global norm."""
        norm = global_norm(grads)
        params = list(self.params.values())
        updates = adam_updates(clip_by_global_norm(grads, norm, self.clip),
                               self.states,
                               *adam_bias_corrections(self.count))
        torch._foreach_add_(updates, torch._foreach_mul(params,
                                                        self.weight_decay))
        torch._foreach_mul_(updates, -self.schedule(self.count))
        torch._foreach_add_(params, updates)
        self.count += 1
        return norm


def mlm_epoch_rows(perm: np.ndarray, batch_size: int, steps_per_epoch: int,
                   group: int = SCAN_GROUP) -> List[np.ndarray]:
    """The rows of each step of one epoch, as the JAX loop takes them:
    whole groups of ``k = min(group, steps_per_epoch)`` steps, each step
    the next ``batch_size`` slice of ``perm``."""
    k = max(min(group, steps_per_epoch), 1)
    steps = (steps_per_epoch // k) * k
    return [perm[i * batch_size:(i + 1) * batch_size] for i in range(steps)]


def draw_masking(ids: torch.Tensor, mask: torch.Tensor,
                 special: torch.Tensor, mask_id: int, vocab_size: int,
                 mask_prob: float, generator: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT dynamic masking: ``(sel, inp)``, the selected positions (each
    real non-special token with ``mask_prob``) and the input ids with the
    selected ones corrupted (80 % ``[MASK]``, 10 % a random id in ``[0,
    vocab_size)``, 10 % kept)."""
    real = (mask == 1) & ~torch.isin(ids, special.to(ids.dtype))
    sel = (torch.rand(ids.shape, device=ids.device, generator=generator)
           < mask_prob) & real
    kind = torch.rand(ids.shape, device=ids.device, generator=generator)
    rand_tok = torch.randint(0, vocab_size, ids.shape, device=ids.device,
                             generator=generator, dtype=ids.dtype)
    corrupted = torch.where(kind < 0.8, torch.full_like(ids, mask_id),
                            torch.where(kind < 0.9, rand_tok, ids))
    return sel, torch.where(sel, corrupted, ids)


class MLMTrainer:
    """The MLM model and its AdamW on ``device``; :meth:`step` runs one
    optimizer step in f32."""

    def __init__(self, model: MLMModel, total_steps: int,
                 mlm_cfg: MLMConfig):
        self.model = model
        warmup = max(int(mlm_cfg.warmup_fraction * total_steps), 1)
        self.optimizer = AdamW(
            dict(model.named_parameters()),
            warmup_cosine_decay_schedule(mlm_cfg.learning_rate, warmup,
                                         total_steps),
            mlm_cfg.weight_decay)

    def loss(self, ids, mask, sel, inp, segments=None, positions=None):
        """CE of the original ids at the selected positions, divided by
        ``max(count, 1)``."""
        logits = self.model(inp, mask, segments=segments,
                            positions=positions)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, ids.long()[..., None])[..., 0]
        w = sel.to(torch.float32)
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)

    def step(self, ids, mask, sel, inp, segments=None, positions=None
             ) -> torch.Tensor:
        """One step on ``[B, L]`` device tensors; returns the loss (0-dim
        device tensor)."""
        self.model.train()
        params = list(self.optimizer.params.values())
        loss = self.loss(ids, mask, sel, inp, segments, positions)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, torch.autograd.grad(
                     loss, params, allow_unused=True))]
        self.optimizer.step(grads)
        return loss.detach()


@dataclasses.dataclass
class MLMRun:
    """What :func:`mlm_pretrain` trained: the encoder, the per-epoch mean
    losses and the steps run."""

    encoder: TextEncoder
    epoch_losses: List[float]
    steps: int


def mlm_pretrain(text_cfg: TextEncoderConfig, ids: np.ndarray,
                 mask: np.ndarray, tok, mlm_cfg: MLMConfig,
                 device: torch.device) -> MLMRun:
    """Pretrain a text encoder on ``device`` over the tokenized corpus
    ``ids`` / ``mask`` ``[N, L]`` (packed into full rows first under
    ``mlm_cfg.pack``).  Weights come from a generator seeded with
    ``mlm_cfg.seed``; the epoch permutations from
    ``np.random.default_rng(mlm_cfg.seed)``."""
    segments = positions = None
    if mlm_cfg.pack:
        packed = pack_sequences(ids, mask, ids.shape[1])
        log.info("MLM packing: %d texts -> %d rows of %d", ids.shape[0],
                 packed.num_rows, ids.shape[1])
        ids, segments, positions = (packed.ids, packed.segments,
                                    packed.positions)
        mask = (segments > 0).astype(np.int32)
    n = ids.shape[0]
    bs = min(mlm_cfg.batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    total_steps = steps_per_epoch * mlm_cfg.epochs
    mask_id = tok.vocab.get("[MASK]")
    if mask_id is None:
        raise ValueError("MLM pretraining needs a [MASK] token in the vocab")
    special = torch.tensor([tok.vocab["[CLS]"], tok.vocab["[SEP]"],
                            tok.vocab["[PAD]"], mask_id], device=device)
    with torch.device(device):
        model = MLMModel(text_cfg)
    generator = torch.Generator(device=device).manual_seed(mlm_cfg.seed)
    init_weights(model, generator)
    set_dropout_generator(model, generator)
    trainer = MLMTrainer(model, total_steps, mlm_cfg)
    arrays = {"ids": ids, "mask": mask, "segments": segments,
              "positions": positions}
    rng = np.random.default_rng(mlm_cfg.seed)
    epoch_losses, steps = [], 0
    for epoch in range(mlm_cfg.epochs):
        losses = []
        for rows in mlm_epoch_rows(rng.permutation(n), bs, steps_per_epoch):
            b = {k: None if v is None else
                 torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
                 for k, v in arrays.items()}
            sel, inp = draw_masking(b["ids"], b["mask"], special, mask_id,
                                    text_cfg.vocab_size, mlm_cfg.mask_prob,
                                    generator)
            losses.append(trainer.step(b["ids"], b["mask"], sel, inp,
                                       b["segments"], b["positions"]))
        steps += len(losses)
        epoch_losses.append(float(torch.stack(losses).mean())
                            if losses else float("nan"))
        if epoch % 5 == 0 or epoch == mlm_cfg.epochs - 1:
            log.info("MLM | epoch %d/%d | loss %.4f", epoch, mlm_cfg.epochs,
                     epoch_losses[-1])
    return MLMRun(model.encoder, epoch_losses, steps)


def pretrain_and_save(text_cfg: TextEncoderConfig, texts: Sequence[str],
                      tok, out_path: str, mlm_cfg: MLMConfig = MLMConfig(),
                      max_len: int = 64,
                      device: torch.device = torch.device("cuda")) -> MLMRun:
    """Corpus, character-noise copies, tokenization to ``max_len``, MLM on
    ``device``, and the encoder written to ``out_path`` as the flax-tree
    npz (``--text-params``)."""
    rng = np.random.default_rng(mlm_cfg.seed)
    corpus = char_noise(texts, rng, copies=mlm_cfg.char_noise_copies,
                        word_prob=mlm_cfg.char_noise_word_prob)
    ids, mask = tok.encode_batch(corpus, max_len)
    log.info("MLM corpus: %d texts (%d original + %dx noise), seq %d",
             len(corpus), len(texts), mlm_cfg.char_noise_copies, max_len)
    run = mlm_pretrain(text_cfg, ids, mask, tok, mlm_cfg, device)
    save_encoder_params(to_jax_params(run.encoder), out_path)
    log.info("MLM encoder saved to %s (loss %.3f -> %.3f)", out_path,
             run.epoch_losses[0], run.epoch_losses[-1])
    return run
