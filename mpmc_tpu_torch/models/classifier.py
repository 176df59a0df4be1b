"""Classifier assemblies for subtasks 2A, 2B and 2C (port of
``mpmc_tpu/models/classifier.py``):

* ``TextClassifier`` (2A): text encoder, ``Pooler`` (any of the six modes),
  a Linear head named ``output``; ``PackedTextClassifier`` is its packed
  form;
* ``ImageClassifier`` (2B): image backbone, then a Linear ``output`` or the
  zoo's ``BinaryHead``;
* ``SimpleMultimodalClassifier`` (the organizers' simple 2C baseline, C28):
  the text encoder's last token, ResNet-50's 1000 logits, four Linears;
* ``MultimodalClassifier`` (2C flagship): text CLS features and caption CLS
  features each through Dropout+Linear+BN+ReLU, the image backbone through
  its fine-tune MLP (with dropout), concatenation fusion, and a Linear+BN
  head giving one logit; ``PackedMultimodalClassifier`` is its packed form.

Module names follow flax's, so ``models/convert.py`` maps weights by path.
Each class names its ``kind`` (the ``run_meta.json`` field) and the batch
keys its forward takes, in order (``inputs``).  ``model.train()`` is the
JAX package's ``train=True``: batch statistics in every BatchNorm and active
dropout.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.config import ImageEncoderConfig, ModelConfig, PoolingType
from mpmc_tpu_torch.models.bert import TextEncoder
from mpmc_tpu_torch.models.convnext import ConvNeXt, ConvNeXtBlock
from mpmc_tpu_torch.models.efficientnet import EfficientNet
from mpmc_tpu_torch.models.fusion import make_fusion
from mpmc_tpu_torch.models.norm import BatchNorm, Dropout
from mpmc_tpu_torch.models.pooling import Pooler
from mpmc_tpu_torch.models.resnet import (TinyResNet, resnet18, resnet50,
                                          resnext50_32x4d, seresnext50_32x4d)
from mpmc_tpu_torch.models.vit import BinaryHead, ViT
from mpmc_tpu_torch.ops.packing import packed_sample_view, unpack_cls

_BACKBONES = {"resnet18": resnet18, "resnet50": resnet50,
              "resnext50_32x4d": resnext50_32x4d,
              "seresnext50_32x4d": seresnext50_32x4d,
              "tiny_resnet": TinyResNet}
VIT_LARGE = dict(hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096)


def create_image_backbone(cfg: ImageEncoderConfig,
                          num_classes: int = 0) -> nn.Module:
    """The backbone of ``cfg.arch``, every name and alias the JAX factory
    takes: the ResNets, ``vit_base_16`` (``vit_base_patch16_224``,
    ``vit_base_patch16_384``), ``vit_base_32`` (``clip_vit_b32``),
    ``vit_large_16`` (``vit_large_patch16_384``), ``convnext_tiny`` and
    ``efficientnet_b0`` .. ``b4``; a ViT's positions are built for
    ``cfg.image_size``.  ``num_classes`` > 0 keeps its classifier head."""
    a = cfg.arch
    kw = dict(num_classes=num_classes, in_channels=1 if cfg.grayscale else 3)
    if a in _BACKBONES:
        return _BACKBONES[a](**kw)
    if a in ("vit_base_16", "vit_base_patch16_224", "vit_base_patch16_384"):
        return ViT(cfg.image_size, **kw)
    if a in ("vit_base_32", "clip_vit_b32"):
        return ViT(cfg.image_size, patch_size=32, **kw)
    if a in ("vit_large_16", "vit_large_patch16_384"):
        return ViT(cfg.image_size, **VIT_LARGE, **kw)
    if a == "convnext_tiny":
        return ConvNeXt(**kw)
    if a in ("efficientnet_b0", "efficientnet_b1", "efficientnet_b2",
             "efficientnet_b3", "efficientnet_b4"):
        return EfficientNet(a[-2:], **kw)
    raise ValueError(f"Unknown image arch: {a}")


class ImageEncoderWithHead(nn.Module):
    """Backbone features, then Linear, ReLU, Dropout, Linear."""

    def __init__(self, cfg: ImageEncoderConfig):
        super().__init__()
        self.backbone = create_image_backbone(cfg)
        self.finetune_fc1 = nn.Linear(self.backbone.feature_dim,
                                      cfg.finetune_dim)
        self.dropout = Dropout(cfg.finetune_dropout)
        self.finetune_fc2 = nn.Linear(cfg.finetune_dim, cfg.finetune_dim)

    def forward(self, image):
        h = F.relu(self.finetune_fc1(self.backbone(image)))
        return self.finetune_fc2(self.dropout(h))


class _ModalityFC(nn.Module):
    """Dropout, Linear(H, proj), BatchNorm, ReLU."""

    def __init__(self, in_dim: int, proj_dim: int, dropout: float):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.fc = nn.Linear(in_dim, proj_dim)
        self.bn = BatchNorm(proj_dim)

    def forward(self, x):
        return F.relu(self.bn(self.fc(self.dropout(x))))


class TextClassifier(nn.Module):
    """2A: encoder, pooler, Linear head; logits ``[B, num_classes]``."""

    kind = "text"
    inputs = ("text_ids", "text_mask")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg.text)
        self.pooler = Pooler(cfg.pooling, cfg.text.hidden_size)
        self.output = nn.Linear(cfg.text.hidden_size, cfg.num_classes)

    def forward(self, text_ids: torch.Tensor,
                text_mask: torch.Tensor) -> torch.Tensor:
        hidden = self.encoder(text_ids, text_mask)
        return self.output(self.pooler(hidden, text_mask))


class PackedTextClassifier(TextClassifier):
    """``TextClassifier`` over a packed batch (``ops/packing.py``): several
    samples per row under segment-masked attention with restarting
    positions; CLS pooling gathers each sample's first token, mean and
    attention pooling run on each sample's row masked to its own tokens,
    so every sample's logits are the unpacked forward's.  The same modules
    and parameters as ``TextClassifier``; only ``forward`` differs.  The
    unmasked poolings (max, cnn, nopooling) would mix neighbouring samples
    and are refused.

    ``packed`` holds ``ids``, ``segments``, ``positions`` ``[R, P]`` and
    the per-sample ``row_of``, ``slot_of``, ``start_of`` ``[B]``."""

    def __init__(self, cfg: ModelConfig):
        p = PoolingType(cfg.pooling)
        if p in (PoolingType.MAX, PoolingType.CNN, PoolingType.NOPOOLING):
            raise ValueError(f"pooling {p.value} is unmasked and cannot be "
                             "packed (ops/packing.py)")
        super().__init__(cfg)

    def forward(self, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
        seg = packed["segments"]
        hidden = self.encoder(packed["ids"], (seg > 0).to(torch.int32),
                              segments=seg, positions=packed["positions"])
        if self.pooler.pooling == PoolingType.CLS:
            pooled = unpack_cls(hidden, packed)
        else:
            pooled = self.pooler(*packed_sample_view(hidden, packed))
        return self.output(pooled)


class ImageClassifier(nn.Module):
    """2B: backbone, then a Linear ``output`` or, with ``binary_head``, the
    l2-normalized scaled ``BinaryHead``; logits ``[B, num_classes]``."""

    kind = "image"
    inputs = ("image",)

    def __init__(self, cfg: ModelConfig, binary_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.backbone = create_image_backbone(cfg.image)
        dim = self.backbone.feature_dim
        self.binary_head = (BinaryHead(dim, cfg.num_classes) if binary_head
                            else None)
        self.output = None if binary_head else nn.Linear(dim, cfg.num_classes)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(image)
        if self.binary_head is not None:
            return self.binary_head(feats)
        return self.output(feats)


class SimpleMultimodalClassifier(nn.Module):
    """The organizers' simple 2C baseline (C28): the text encoder's LAST
    token (the reference's ``[:, -1, :]``, a documented bug kept for
    parity, so the result depends on the padded length), Dropout(0.3),
    Linear to ``proj_dim``; the backbone's ``image_logits_dim`` logits,
    Linear to ``proj_dim``; concatenation, Linear, Linear to
    ``num_classes``.  No activations between the Linears."""

    kind = "simple"
    inputs = ("text_ids", "text_mask", "image")
    image_logits = 1000          # torchvision ResNet-50's ImageNet head

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = TextEncoder(cfg.text)
        self.dropout = Dropout(0.3)
        self.bert_fc = nn.Linear(cfg.text.hidden_size, cfg.proj_dim)
        self.backbone = create_image_backbone(cfg.image, self.image_logits)
        self.resnet_fc = nn.Linear(self.image_logits, cfg.proj_dim)
        self.fusion_fc = nn.Linear(2 * cfg.proj_dim, cfg.proj_dim)
        self.output_fc = nn.Linear(cfg.proj_dim, cfg.num_classes)

    def forward(self, text_ids: torch.Tensor, text_mask: torch.Tensor,
                image: torch.Tensor) -> torch.Tensor:
        hidden = self.text_model(text_ids, text_mask)
        t = self.bert_fc(self.dropout(hidden[:, -1]))
        i = self.resnet_fc(self.backbone(image))
        return self.output_fc(self.fusion_fc(torch.cat([t, i], dim=-1)))


class MultimodalClassifier(nn.Module):
    """2C: text + image (+ caption), fusion, single logit ``[B]``.

    The text and caption branches exist when the config has them (the JAX
    package decides at call time, which a torch module cannot)."""

    kind = "multimodal"
    inputs = ("text_ids", "text_mask", "image", "caption_ids", "caption_mask")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dims = []
        if cfg.text is not None:
            self.text_model = TextEncoder(cfg.text)
            self.text_fc = _ModalityFC(cfg.text.hidden_size, cfg.proj_dim,
                                       cfg.dropout)
            dims.append(cfg.proj_dim)
        self.image_model = ImageEncoderWithHead(cfg.image)
        dims.append(cfg.image.finetune_dim)
        if cfg.caption is not None:
            self.caption_text_model = TextEncoder(cfg.caption)
            self.caption_text_fc = _ModalityFC(cfg.caption.hidden_size,
                                               cfg.proj_dim, cfg.dropout)
            dims.append(cfg.proj_dim)
        self.fusion = make_fusion(cfg.fusion, cfg.proj_dim, dims)
        self.output_fc = nn.Linear(cfg.proj_dim, 1)
        self.output_bn = BatchNorm(1)

    def forward(self, text_ids: Optional[torch.Tensor],
                text_mask: Optional[torch.Tensor], image: torch.Tensor,
                caption_ids: Optional[torch.Tensor] = None,
                caption_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = []
        if self.cfg.text is not None:
            hidden = self.text_model(text_ids, text_mask)
            feats.append(self.text_fc(hidden[:, 0]))   # CLS pooling
        feats.append(self.image_model(image))
        if self.cfg.caption is not None:
            if caption_ids is None:
                raise ValueError("this model has a caption branch: pass "
                                 "caption_ids and caption_mask")
            cap_hidden = self.caption_text_model(caption_ids, caption_mask)
            feats.append(self.caption_text_fc(cap_hidden[:, 0]))
        return self._head(feats)

    def _head(self, feats) -> torch.Tensor:
        logit = self.output_bn(self.output_fc(self.fusion(*feats)))
        return logit[:, 0]


class PackedMultimodalClassifier(MultimodalClassifier):
    """``MultimodalClassifier`` with packed text and caption branches
    (``ops/packing.py``): several samples per row under segment-masked
    attention with restarting positions, each sample's CLS gathered back to
    sample order before the modality FCs, so fusion, BatchNorm and the head
    see exactly the unpacked batch.  The same modules and parameters as
    ``MultimodalClassifier``; only ``forward`` differs.

    ``text_packed`` / ``caption_packed`` hold ``ids``, ``segments``,
    ``positions`` ``[R, P]`` and the per-sample ``row_of``, ``start_of``
    ``[B]`` aligned with ``image``'s batch axis."""

    def forward(self, text_packed: Optional[Dict[str, torch.Tensor]],
                image: torch.Tensor,
                caption_packed: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        feats = []
        if self.cfg.text is not None:
            feats.append(self.text_fc(self._packed_cls(self.text_model,
                                                       text_packed)))
        feats.append(self.image_model(image))
        if self.cfg.caption is not None:
            if caption_packed is None:
                raise ValueError("this model has a caption branch: pass "
                                 "caption_packed")
            feats.append(self.caption_text_fc(self._packed_cls(
                self.caption_text_model, caption_packed)))
        return self._head(feats)

    @staticmethod
    def _packed_cls(encoder, packed):
        seg = packed["segments"]
        hidden = encoder(packed["ids"], (seg > 0).to(torch.int32),
                         segments=seg, positions=packed["positions"])
        return unpack_cls(hidden, packed)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator``: normal(0, 0.02) for linear
    and embedding weights (BERT's initializer range) and a ViT's positions,
    He-normal for convs, zero biases and class tokens, unit norm scales,
    running statistics (0, 1), and ConvNeXt's layer scale at its initial
    value, as the JAX modules initialize it."""
    for mod in model.modules():
        if isinstance(mod, ViT):
            nn.init.zeros_(mod.cls_token)
            nn.init.normal_(mod.pos_embed, 0.0, 0.02, generator=generator)
        elif isinstance(mod, ConvNeXtBlock):
            nn.init.constant_(mod.gamma, mod.layer_scale_init)
        elif isinstance(mod, (nn.Linear, nn.Embedding)):
            nn.init.normal_(mod.weight, 0.0, 0.02, generator=generator)
            if getattr(mod, "bias", None) is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)


MODEL_CLASSES = {cls.kind: cls for cls in (
    TextClassifier, ImageClassifier, SimpleMultimodalClassifier,
    MultimodalClassifier)}
PACKED_CLASSES = {"text": PackedTextClassifier,
                  "multimodal": PackedMultimodalClassifier}


def build_model(cfg: ModelConfig, device: torch.device,
                seed: Optional[int] = None, kind: str = "multimodal",
                binary_head: bool = False,
                packed: bool = False) -> nn.Module:
    """The classifier of ``kind`` (``text``, ``image``, ``simple`` or
    ``multimodal``; ``packed``: the text or multimodal model's packed form;
    ``binary_head``: the image model's ``BinaryHead``) on ``device`` in
    eval mode; with ``seed``, random weights from a generator seeded with
    it (otherwise the caller loads a state_dict)."""
    if kind not in MODEL_CLASSES:
        raise ValueError(f"unknown model kind {kind!r}")
    if packed and kind not in PACKED_CLASSES:
        raise ValueError(f"the {kind} model has no packed form")
    cls = PACKED_CLASSES[kind] if packed else MODEL_CLASSES[kind]
    with torch.device(device):
        model = cls(cfg, binary_head) if kind == "image" else cls(cfg)
    if seed is not None:
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()
