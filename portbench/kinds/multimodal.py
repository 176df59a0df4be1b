"""The 2C flagship: AraBERT and RoBERTa text encoders (each meme's text and
caption), ResNet-18 over the image, ConcatAttention3 fusion, a Linear+BN
head with one logit.

The reference head: each text branch's CLS through Linear, BatchNorm,
ReLU; the image features through Linear, ReLU, Linear; ConcatAttention3
(a Linear+BN+ReLU softmax gate over the concatenated features, then a
reducing Linear+BN+ReLU); a Linear+BN head with one logit.  Dropout on the
image fine-tune MLP's hidden layer and on each text branch's CLS ahead of
its Linear."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.counts import flops
from portbench.data import caption_lengths, images, token_rows, word_counts
from portbench.reference.nets import (F32, Precision, Weights, batch_norm,
                                      dropout, linear, resnet18,
                                      text_encoder)
from portbench.weights import (linear_specs, norm_specs, resnet18_specs,
                               text_encoder_specs)

PORT_KIND = "multimodal"
PACKED = {"text_model.": "t_", "caption_text_model.": "c_"}


def model_config(cfg: dict):
    from mpmc_tpu_torch.config import (FusionMethod, ImageEncoderConfig,
                                       ModelConfig, PoolingType, Subtask)

    from portbench.drivers.common import text_encoder_config
    head, img = cfg["head"], cfg["image_encoder"]
    return ModelConfig(
        subtask=Subtask.C, text=text_encoder_config(cfg["text_encoder"]),
        caption=text_encoder_config(cfg["caption_encoder"]),
        image=ImageEncoderConfig(
            arch=img["arch"], image_size=img["image_size"],
            feature_dim=img["feature_dim"], finetune_dim=img["finetune_dim"],
            finetune_dropout=img["finetune_dropout"]),
        pooling=PoolingType(head["pooling"]),
        fusion=FusionMethod(head["fusion"]), proj_dim=head["proj_dim"],
        dropout=head["dropout"], num_classes=head["num_classes"],
        max_text_len=head["max_text_len"],
        max_caption_len=head["max_caption_len"])


def param_specs(cfg: dict):
    head, img = cfg["head"], cfg["image_encoder"]
    proj, fdim = head["proj_dim"], img["finetune_dim"]
    out = text_encoder_specs("text_model.", cfg["text_encoder"])
    out += linear_specs("text_fc.fc", cfg["text_encoder"]["hidden_size"],
                        proj)
    out += norm_specs("text_fc.bn", proj, True)
    out += resnet18_specs("image_model.backbone.")
    out += linear_specs("image_model.finetune_fc1", img["feature_dim"], fdim)
    out += linear_specs("image_model.finetune_fc2", fdim, fdim)
    out += text_encoder_specs("caption_text_model.", cfg["caption_encoder"])
    out += linear_specs("caption_text_fc.fc",
                        cfg["caption_encoder"]["hidden_size"], proj)
    out += norm_specs("caption_text_fc.bn", proj, True)
    width = proj + fdim + proj
    out += linear_specs("fusion.gated.gate_fc", width, width)
    out += norm_specs("fusion.gated.gate_bn", width, True)
    out += linear_specs("fusion.gated.reduce_fc", width, proj)
    out += norm_specs("fusion.gated.reduce_bn", proj, True)
    out += linear_specs("output_fc", proj, head["num_classes"])
    return out + norm_specs("output_bn", head["num_classes"], True)


def memes(cfg: dict, traffic: dict, n: int, rng: np.random.Generator,
          g: torch.Generator, device: torch.device) -> Dict[str, np.ndarray]:
    """``text_ids``/``text_mask`` ``[n, max_text_len]``,
    ``caption_ids``/``caption_mask`` ``[n, max_caption_len]`` and
    ``image``."""
    head, out = cfg["head"], {}
    words = rng.permutation(word_counts(n, traffic))
    out["text_ids"], out["text_mask"] = token_rows(
        words + 2, head["max_text_len"], cfg["text_encoder"], g, device)
    caps = rng.permutation(caption_lengths(n, traffic))
    out["caption_ids"], out["caption_mask"] = token_rows(
        caps, head["max_caption_len"], cfg["caption_encoder"], g, device)
    out["image"] = images(cfg, n, g, device)
    return out


def _modality_fc(W, name, x, training, P, drop, rate):
    x = dropout(x, drop, name + ".dropout", rate)
    return F.relu(batch_norm(W, name + ".bn", linear(W, name + ".fc", x, P),
                             training, P))


def logits(W: Weights, cfg: dict, batch: Dict[str, torch.Tensor],
           training: bool, P: Precision = F32) -> torch.Tensor:
    """The one logit ``[B]`` for a batch of ``text_ids``, ``text_mask``,
    ``caption_ids``, ``caption_mask`` and the normalized NHWC ``image``
    (and the dropout masks ``drop``, when training)."""
    drop = batch.get("drop") if training else None
    rate = cfg["head"]["dropout"]
    text = text_encoder(W, "text_model.", cfg["text_encoder"],
                        batch["text_ids"], batch["text_mask"], P, drop)[:, 0]
    cap = text_encoder(W, "caption_text_model.", cfg["caption_encoder"],
                       batch["caption_ids"], batch["caption_mask"], P,
                       drop)[:, 0]
    feats = resnet18(W, "image_model.backbone.", batch["image"], training, P)
    h = dropout(F.relu(linear(W, "image_model.finetune_fc1", feats, P)), drop,
                "image_model.dropout",
                cfg["image_encoder"]["finetune_dropout"])
    img = linear(W, "image_model.finetune_fc2", h, P)
    concat = torch.cat([_modality_fc(W, "text_fc", text, training, P, drop,
                                     rate), img,
                        _modality_fc(W, "caption_text_fc", cap, training, P,
                                     drop, rate)], dim=1)
    g = batch_norm(W, "fusion.gated.gate_bn",
                   linear(W, "fusion.gated.gate_fc", concat, P), training, P)
    g = P.a(torch.softmax(F.relu(g), dim=1))
    fused = F.relu(batch_norm(W, "fusion.gated.reduce_bn",
                              linear(W, "fusion.gated.reduce_fc",
                                     P.a(g * concat), P), training, P))
    return batch_norm(W, "output_bn", linear(W, "output_fc", fused, P),
                      training, P)[:, 0]


def forward_flops(cfg: dict, n: int, tokens: Dict[str, np.ndarray]) -> float:
    img, head = cfg["image_encoder"], cfg["head"]
    t, c = cfg["text_encoder"], cfg["caption_encoder"]
    proj, fdim = head["proj_dim"], img["finetune_dim"]
    width = 2 * proj + fdim
    fixed = flops.resnet18(img["image_size"]) + flops.linears([
        (t["hidden_size"], proj), (c["hidden_size"], proj),
        (img["feature_dim"], fdim), (fdim, fdim), (width, width),
        (width, proj), (proj, head["num_classes"])])
    return float(np.sum(flops.encoder(tokens["text"], t["hidden_size"],
                                      t["intermediate_size"],
                                      t["num_hidden_layers"]))
                 + np.sum(flops.encoder(tokens["caption"], c["hidden_size"],
                                        c["intermediate_size"],
                                        c["num_hidden_layers"]))
                 + n * fixed)


def attention_parts(cfg: dict, n: int, tokens: Dict[str, np.ndarray]):
    return [(tokens["text"], cfg["text_encoder"]),
            (tokens["caption"], cfg["caption_encoder"])]
