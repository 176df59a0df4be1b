"""What both drivers share: a configuration file as the system's
``TrainConfig``, the data of a cell through the system's sequence-length
bucketing, each meme's token counts, and the model weights loaded into the
system."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import spec


def text_encoder_config(c: dict):
    """A configuration file's BERT or RoBERTa encoder as the system's
    ``TextEncoderConfig``."""
    from mpmc_tpu_torch.config import TextEncoderConfig
    return TextEncoderConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position_embeddings=c["max_position_embeddings"],
        type_vocab_size=c["type_vocab_size"],
        layer_norm_eps=c["layer_norm_eps"],
        hidden_dropout=c["hidden_dropout_prob"],
        attention_dropout=c["attention_probs_dropout_prob"],
        pad_token_id=c["pad_token_id"],
        roberta_style_positions=c["position_offset"] == "roberta")


def train_config(cfg: dict, seed: int, device: torch.device,
                 device_resident: bool = True):
    """The configuration file as the system's ``TrainConfig``, its model
    as the configuration's kind builds it (``portbench/kinds/``); bf16
    only on the card, as the system's command line sets it.  The data
    mode, ``device_resident``, is the traffic's."""
    from mpmc_tpu_torch.config import DataConfig, LossType, TrainConfig
    r, head = cfg["recipe"], cfg["head"]
    data = DataConfig(batch_size=r["batch_size"],
                      eval_batch_size=r["batch_size"],
                      num_folds=r["num_folds"], fold_seed=r["fold_seed"],
                      seq_bucket_multiple=r["seq_bucket_multiple"],
                      pack_rows=r["pack_rows"],
                      device_resident=device_resident)
    return TrainConfig(
        model=spec.kind(cfg["kind"]).model_config(cfg), data=data,
        loss=LossType.FOCAL if head["loss"] == "focal"
        else LossType.CROSS_ENTROPY,
        focal_alpha=head.get("focal_alpha", 0.25),
        focal_gamma=head.get("focal_gamma", 2.0),
        learning_rate=r["learning_rate"],
        encoder_lr_scale=r["encoder_lr_scale"],
        warmup_fraction=r["warmup_fraction"], lr_schedule=r["lr_schedule"],
        grad_clip_norm=r["grad_clip_norm"], epochs=r["epochs"], seed=seed,
        eval_per_epoch=r["eval_per_epoch"],
        bf16=r["bf16"] and device.type == "cuda",
        run_id="portbench", adam_mu_dtype=r["adam_mu_dtype"],
        embedding_optimizer=r["embedding_optimizer"],
        scan_steps=r["scan_steps"],
        emit_threshold=r.get("emit_threshold"),
        emit_val_tsv=r.get("emit_val_tsv", False))


def bucket(tc, splits) -> None:
    """Trim the token arrays of every split in ``splits`` to one length,
    the system's bucketing over all of them (as its 2C preparation does)."""
    from mpmc_tpu_torch.cli.experiments import bucket_seq_len, bucket_trim
    mult = tc.data.seq_bucket_multiple
    for ids, mask, cap in (("text_ids", "text_mask", tc.model.max_text_len),
                           ("caption_ids", "caption_mask",
                            tc.model.max_caption_len)):
        if ids not in splits[0]:
            continue
        length = bucket_seq_len([d[mask] for d in splits], mult, cap)
        for d in splits:
            bucket_trim(d, ids, mask, length)


def token_counts(data: Dict[str, np.ndarray], rows=None
                 ) -> Dict[str, np.ndarray]:
    """Each meme's real tokens by branch (``text``, ``caption``), of the
    branches the memes have."""
    sel = (lambda a: a) if rows is None else (lambda a: a[rows])
    return {key[:-len("_mask")]: sel(v).sum(1) for key, v in data.items()
            if key.endswith("_mask")}


CALIBRATION_MEMES = 64


def model_weights(cfg: dict, traffic: dict, seed: int, tc,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """The weights from the seed, every BatchNorm's running statistics set
    as a trained model has them: the batch statistics of a calibration
    split of ``CALIBRATION_MEMES`` memes through the reference in training
    mode (with the running statistics at (0, 1) the eval-mode head would
    see almost none of its inputs' variation)."""
    from portbench.data import make_memes
    from portbench.reference.nets import Precision, normalize
    from portbench.weights import make_weights

    W = make_weights(cfg, seed, device)
    if not any(n.endswith("running_var") for n in W):
        return W
    cal = make_memes(cfg, traffic, CALIBRATION_MEMES, seed, 9, device)
    bucket(tc, [cal])
    batch = {k: torch.from_numpy(v).to(device) for k, v in cal.items()}
    if "image" in batch:
        batch["image"] = normalize(batch["image"])
    stats: dict = {}
    with torch.no_grad():
        spec.kind(cfg["kind"]).logits(W, cfg, batch, True,
                                      Precision(record=stats))
    for name, (mean, var) in stats.items():
        W[name + ".running_mean"].copy_(mean)
        W[name + ".running_var"].copy_(var)
    return W


def load_train_weights(train_step, W: Dict[str, torch.Tensor]) -> None:
    """Start a fold's training state from ``W``: the model's weights and
    statistics, the optimizer's fresh state and the step's generator as
    built (the system refreshes its compute copies)."""
    train_step.load_state_dict({"model": W,
                                "optimizer": train_step.optimizer.state_dict(),
                                "generator": train_step.generator.get_state()})

