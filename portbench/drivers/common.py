"""What both drivers share: a configuration file as the system's
``TrainConfig``, the data of a cell through the system's sequence-length
bucketing, and the model weights loaded into the system."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def train_config(cfg: dict, seed: int, device: torch.device):
    """The configuration file as the system's ``TrainConfig``; bf16 only on
    the card, as the system's command line sets it."""
    from mpmc_tpu_torch.config import (DataConfig, FusionMethod,
                                       ImageEncoderConfig, LossType,
                                       ModelConfig, PoolingType, Subtask,
                                       TextEncoderConfig, TrainConfig)

    r, head = cfg["recipe"], cfg["head"]
    img = cfg["image_encoder"]

    def text(c: dict) -> TextEncoderConfig:
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

    if cfg["kind"] == "multimodal":
        model = ModelConfig(
            subtask=Subtask.C, text=text(cfg["text_encoder"]),
            caption=text(cfg["caption_encoder"]),
            image=ImageEncoderConfig(
                arch=img["arch"], image_size=img["image_size"],
                feature_dim=img["feature_dim"],
                finetune_dim=img["finetune_dim"],
                finetune_dropout=img["finetune_dropout"]),
            pooling=PoolingType(head["pooling"]),
            fusion=FusionMethod(head["fusion"]), proj_dim=head["proj_dim"],
            dropout=head["dropout"], num_classes=head["num_classes"],
            max_text_len=head["max_text_len"],
            max_caption_len=head["max_caption_len"])
    else:
        model = ModelConfig(
            subtask=Subtask.B, text=None, caption=None,
            image=ImageEncoderConfig(arch=img["arch"],
                                     image_size=img["image_size"],
                                     feature_dim=img["feature_dim"],
                                     patch_size=img["patch_size"]),
            num_classes=head["num_classes"])
    data = DataConfig(batch_size=r["batch_size"],
                      eval_batch_size=r["batch_size"],
                      num_folds=r["num_folds"], fold_seed=r["fold_seed"],
                      seq_bucket_multiple=r["seq_bucket_multiple"],
                      pack_rows=r["pack_rows"],
                      device_resident=r["device_resident"])
    return TrainConfig(
        model=model, data=data,
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
        scan_steps=r["scan_steps"])


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


def token_counts(data: Dict[str, np.ndarray], rows=None):
    """Each meme's real text and caption tokens (None for an image model)."""
    if "text_mask" not in data:
        return None, None
    sel = (lambda a: a) if rows is None else (lambda a: a[rows])
    return (sel(data["text_mask"]).sum(1), sel(data["caption_mask"]).sum(1))


CALIBRATION_MEMES = 64


def model_weights(cfg: dict, traffic: dict, seed: int, tc,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """The weights from the seed, every BatchNorm's running statistics set
    as a trained model has them: the batch statistics of a calibration
    split of ``CALIBRATION_MEMES`` memes through the reference in training
    mode (with the running statistics at (0, 1) the eval-mode head would
    see almost none of its inputs' variation)."""
    from portbench.data import make_memes
    from portbench.reference.nets import LOGITS, Precision, normalize
    from portbench.weights import make_weights

    W = make_weights(cfg, seed, device)
    if not any(n.endswith("running_var") for n in W):
        return W
    cal = make_memes(cfg, traffic, CALIBRATION_MEMES, seed, 9, device)
    bucket(tc, [cal])
    batch = {k: torch.from_numpy(v).to(device) for k, v in cal.items()}
    batch["image"] = normalize(batch["image"])
    stats: dict = {}
    with torch.no_grad():
        LOGITS[cfg["kind"]](W, cfg, batch, True, Precision(record=stats))
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

