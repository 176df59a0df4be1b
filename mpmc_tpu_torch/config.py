"""Typed configuration for the PyTorch port.

A copy of the dataclasses and fields of ``mpmc_tpu/config.py`` that the
port reads.  Field names and defaults are identical, so a ``run_meta.json``
written by either package restores the same model variant here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Subtask(str, enum.Enum):
    A = "2A"  # text-only
    B = "2B"  # image-only
    C = "2C"  # multimodal


class PoolingType(str, enum.Enum):
    CLS = "cls"
    NOPOOLING = "nopooling"
    MAX = "max"
    MEAN = "mean"
    ATTENTION = "attention"
    CNN = "cnn"


class LossType(str, enum.Enum):
    FOCAL = "focal"           # sigmoid focal loss (2C: alpha=.25 gamma=2)
    CROSS_ENTROPY = "ce"      # 2-class CE (2A)


class FusionMethod(str, enum.Enum):
    CONCATENATION = "concatenation"
    MCA = "mca"
    CROSS_MODAL = "cross_modal"
    SELF_ATTENTION = "self_attention"


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """BERT-family encoder hyperparameters (AraBERT/RoBERTa compatible)."""

    vocab_size: int = 64000           # aubmindlab/bert-base-arabertv2
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0
    # RoBERTa-style position offset: positions start at pad_token_id+1.
    roberta_style_positions: bool = False
    gelu_approx: bool = False

    @staticmethod
    def arabertv2() -> "TextEncoderConfig":
        return TextEncoderConfig(vocab_size=64000)

    @staticmethod
    def qarib() -> "TextEncoderConfig":
        return TextEncoderConfig(vocab_size=64000)

    @staticmethod
    def roberta_base() -> "TextEncoderConfig":
        return TextEncoderConfig(
            vocab_size=50265, max_position_embeddings=514,
            type_vocab_size=1, pad_token_id=1, roberta_style_positions=True,
            layer_norm_eps=1e-5,
        )

    @staticmethod
    def distilbert_multilingual() -> "TextEncoderConfig":
        """distilbert-base-multilingual-cased: 6 layers of BERT-base."""
        return TextEncoderConfig(vocab_size=119547, num_layers=6)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "TextEncoderConfig":
        """Small config for tests/smoke runs."""
        return TextEncoderConfig(
            vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=128,
        )


@dataclasses.dataclass(frozen=True)
class ImageEncoderConfig:
    # resnet18 | resnet50 | resnext50_32x4d | seresnext50_32x4d | tiny_resnet
    # | vit_base_16 | vit_base_32 | vit_large_16 | convnext_tiny |
    # efficientnet_b0..b4, and the JAX factory's aliases
    arch: str = "resnet18"
    image_size: int = 224
    feature_dim: int = 512
    finetune_dim: int = 512
    finetune_dropout: float = 0.35
    patch_size: int = 16
    grayscale: bool = False

    @staticmethod
    def tiny() -> "ImageEncoderConfig":
        return ImageEncoderConfig(arch="tiny_resnet", image_size=64,
                                  feature_dim=64, finetune_dim=64)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    subtask: Subtask = Subtask.C
    text: Optional[TextEncoderConfig] = dataclasses.field(
        default_factory=TextEncoderConfig)
    caption: Optional[TextEncoderConfig] = dataclasses.field(
        default_factory=TextEncoderConfig.roberta_base)
    image: Optional[ImageEncoderConfig] = dataclasses.field(
        default_factory=ImageEncoderConfig)
    pooling: PoolingType = PoolingType.CLS
    fusion: FusionMethod = FusionMethod.CONCATENATION
    proj_dim: int = 512
    dropout: float = 0.3
    num_classes: int = 1              # 1: sigmoid + focal (2C); 2: softmax + CE
    max_text_len: int = 512
    max_caption_len: int = 512

    @staticmethod
    def small_2a() -> "ModelConfig":
        """The from-scratch small text model (no pretrained weights)."""
        return ModelConfig(
            subtask=Subtask.A,
            text=TextEncoderConfig(vocab_size=512, hidden_size=128,
                                   num_layers=4, num_heads=4,
                                   intermediate_size=256,
                                   max_position_embeddings=128),
            caption=None, image=None, num_classes=2, max_text_len=64)

    @staticmethod
    def small_2c() -> "ModelConfig":
        """The from-scratch small 2C model: small_2a's text encoder, a tiny
        ResNet image branch at 64 pixels, no caption branch, one logit."""
        return ModelConfig(
            subtask=Subtask.C,
            text=TextEncoderConfig(vocab_size=512, hidden_size=128,
                                   num_layers=4, num_heads=4,
                                   intermediate_size=256,
                                   max_position_embeddings=128),
            caption=None,
            image=ImageEncoderConfig(arch="tiny_resnet", image_size=64,
                                     feature_dim=64, finetune_dim=64),
            proj_dim=128, num_classes=1, max_text_len=64)

    @staticmethod
    def clip_style_2c() -> "ModelConfig":
        """The CLIP-style dual-encoder 2C preset: the default BERT text
        encoder and fusion head over a ViT-B/32 image trunk (768
        features), no caption branch."""
        return ModelConfig(
            image=ImageEncoderConfig(arch="vit_base_32", feature_dim=768),
            caption=None)

    @staticmethod
    def captions_2b() -> "ModelConfig":
        """The image + caption variant: no Arabic-text branch."""
        return ModelConfig(text=None)

    @staticmethod
    def simple_2c() -> "ModelConfig":
        """The organizers' simple 2C baseline (C28): a
        distilbert-multilingual text branch, ResNet-50's 1000 logits as the
        image branch, 2-class CE, no captions."""
        return ModelConfig(
            subtask=Subtask.C,
            text=TextEncoderConfig.distilbert_multilingual(),
            caption=None,
            image=ImageEncoderConfig(arch="resnet50", feature_dim=2048),
            num_classes=2, max_text_len=128)

    @staticmethod
    def tiny_2c() -> "ModelConfig":
        return ModelConfig(
            subtask=Subtask.C,
            text=TextEncoderConfig.tiny(),
            caption=TextEncoderConfig.tiny(),
            image=ImageEncoderConfig.tiny(),
            proj_dim=64, max_text_len=32, max_caption_len=16,
        )


def model_config_to_dict(cfg: ModelConfig) -> dict:
    """JSON-serializable dict of a ModelConfig (the ``run_meta.json`` form)."""
    d = dataclasses.asdict(cfg)

    def _plain(obj):
        if isinstance(obj, enum.Enum):
            return obj.value
        if isinstance(obj, dict):
            return {k: _plain(v) for k, v in obj.items()}
        return obj

    return _plain(d)


def model_config_from_dict(d: dict) -> ModelConfig:
    """Inverse of :func:`model_config_to_dict`."""
    d = dict(d)
    for key, cls in (("text", TextEncoderConfig),
                     ("caption", TextEncoderConfig),
                     ("image", ImageEncoderConfig)):
        if d.get(key) is not None:
            d[key] = cls(**d[key])
    d["subtask"] = Subtask(d["subtask"])
    d["pooling"] = PoolingType(d["pooling"])
    d["fusion"] = FusionMethod(d["fusion"])
    return ModelConfig(**d)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The data settings the port reads."""

    train_manifest: str = "data/arabic_memes_propaganda_araieval_24_train.json"
    dev_manifest: str = "data/arabic_memes_propaganda_araieval_24_dev.json"
    image_root: str = "."
    batch_size: int = 16
    eval_batch_size: int = 16         # the Trainer wrapper's eval batches
    num_folds: int = 5                # 2C: 5 folds over train
    fold_seed: int = 42
    fold_over_train_plus_dev: bool = False  # 2A: folds over train+dev
    cache_dir: str = ".cache"         # caption cache
    # Trim token arrays to the shortest multiple of this covering every real
    # token (``max_*_len`` stays the truncation cap).
    seq_bucket_multiple: int = 64
    # > 0: training packs the text tokens into segment-masked rows
    # (``train/packed.py``): 2A trains on batches of this many packed rows,
    # 2C packs each batch's text and caption tokens; eval stays unpacked.
    pack_rows: int = 0
    # The corpus vocab of a run without a vocab file: "words" (whole words
    # by frequency plus character pieces, at most ``corpus_vocab_size``
    # words) or "subword" (BPE-learned WordPiece pieces,
    # ``text/wordpiece_learn.py``, ``corpus_vocab_size`` pieces in all).
    corpus_vocab_mode: str = "words"
    corpus_vocab_size: int = 30000


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX package's ``TrainConfig`` that 2A and 2C
    training and eval read."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    loss: LossType = LossType.FOCAL
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    learning_rate: float = 1e-5
    encoder_lr_scale: float = 0.8     # text/image encoders at 0.8 * lr
    warmup_fraction: float = 0.1      # linear warmup over 10% of steps
    # "linear_warmup" (2C) or "constant" (2A: no schedule, the base LR).
    lr_schedule: str = "linear_warmup"
    grad_clip_norm: float = 1.0
    epochs: int = 8
    seed: int = 42
    eval_per_epoch: int = 2           # mid-epoch evals per epoch
    bf16: bool = True
    run_id: str = "mpmc_tpu"
    team_name: str = "kevinmathew"
    # TSV emission: None labels at the eval's Youden threshold (2C), 0.5
    # at argmax (2A); 2A also writes the val split's TSV.
    emit_threshold: Optional[float] = None
    prob_header: str = "prob"
    emit_val_tsv: bool = False
    checkpoint_dir: Optional[str] = None
    # Restore each fold's newest checkpoint under ``checkpoint_dir`` before
    # training: weights, optimizer state, step and the step's generator.
    resume: bool = False
    # Adam first-moment dtype ("bfloat16" under the fast recipe); None keeps
    # it f32.
    adam_mu_dtype: Optional[str] = None
    # "adam", or "factored": factored-RMS (Adafactor's second moment, no
    # first moment) for the word-embedding tables.
    embedding_optimizer: str = "adam"
    # > 0: corpus MLM pretraining (``train/pretrain.py``) of this many
    # epochs initializes the text encoder; ``mlm_pack`` packs its corpus.
    mlm_epochs: int = 0
    mlm_pack: bool = False
    # > 0: SimCLR contrastive pretraining (``train/pretrain_image.py``) of
    # this many epochs over the train images initializes the image backbone
    # (2B, and the 2C flagship).
    simclr_epochs: int = 0
    # > 0: the train loss mixes in the char-n-gram teacher's soft targets
    # (``train/distill.py``): (1 - λ)·loss(hard) + λ·CE(soft) per row.
    distill_lambda: float = 0.0
