"""Pretrained text encoders and image backbones spliced into a classifier
(port of ``mpmc_tpu/models/pretrained.py``).

A checkpoint is a file or a Hugging Face checkpoint directory
(:func:`load_state_dict`: ``pytorch_model.bin`` or ``model.safetensors``
in a directory, or a ``.bin``/``.pt``, ``.safetensors`` or ``.npz`` file).
It becomes the flax-layout numpy tree of the JAX package, which the port's
weight bridge (``models/convert.from_jax_variables``) loads:

* text (``--text-params``, ``--caption-params``): the flax-tree ``.npz``
  that corpus MLM pretraining writes in either package (``a/b/c`` keys and
  the ``__flax_encoder__`` marker, ``train/pretrain.save_encoder_params``),
  taken as it is; anything else is a BERT or RoBERTa state dict, converted
  by ``models/hf_convert.convert_bert_state_dict``.  It is spliced into the
  model's ``encoder`` (kind ``text``), ``text_model`` (kinds ``simple`` and
  ``multimodal``) or ``caption_text_model`` (the caption encoder of the
  ``multimodal`` kind); the model keeps its own pooler and token-type
  tables when the checkpoint lacks them.
* image (``--image-params``): the flax-tree ``.npz`` that SimCLR
  pretraining writes in either package (``params/...`` and
  ``batch_stats/...`` keys and the ``__flax_image_encoder__`` marker),
  taken as it is; anything else is a torchvision, timm or HF state dict of
  the model's backbone arch, converted by
  ``models/vision_convert.convert_image_state_dict`` (with its classifier
  head for the simple model's 1000-logit backbone).  It is spliced into the
  model's ``backbone`` (kinds ``image`` and ``simple``) or
  ``image_model.backbone`` (kind ``multimodal``), the BatchNorm running
  statistics into the ``BatchNorm`` buffers.

Either way the leaf set and every shape must equal the model's, so a
checkpoint of another arch or another vocab size raises instead of
training a half-random model.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
from torch import nn

from mpmc_tpu_torch.models.convert import (from_jax_variables, to_jax_params,
                                          to_jax_variables)

FLAX_MARKER = "__flax_encoder__"
FLAX_IMAGE_MARKER = "__flax_image_encoder__"
TEXT_SUBMODULE = {"text": "encoder", "simple": "text_model",
                  "multimodal": "text_model"}
CAPTION_SUBMODULE = "caption_text_model"
IMAGE_SUBMODULE = {"image": "backbone", "simple": "backbone",
                   "multimodal": "image_model.backbone"}


@dataclasses.dataclass(frozen=True)
class PretrainedSpec:
    """Paths of the text-encoder (``--text-params``), caption-encoder
    (``--caption-params``) and image-backbone (``--image-params``)
    checkpoints."""

    text: Optional[str] = None
    caption: Optional[str] = None
    image: Optional[str] = None

    def __bool__(self) -> bool:
        return bool(self.text or self.caption or self.image)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's tensors as numpy: an HF checkpoint directory, a
    ``.safetensors`` file (read with numpy), an ``.npz``, or any other file
    as a torch ``state_dict`` (``torch.load(weights_only=True)``)."""
    from mpmc_tpu_torch.models.hf_convert import (load_hf_checkpoint,
                                                  read_safetensors,
                                                  torch_state_dict)
    if os.path.isdir(path):
        return load_hf_checkpoint(path)
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    if path.endswith(".npz"):
        with np.load(path) as f:
            return dict(f)
    return torch_state_dict(path)


def flatten_params(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts to ``a/b/c`` keys (the npz layout)."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten_params(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    """Inverse of :func:`flatten_params`; skips the markers."""
    tree: Dict = {}
    for key, leaf in flat.items():
        if key in (FLAX_MARKER, FLAX_IMAGE_MARKER):
            continue
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(leaf)
    return tree


def save_encoder_params(encoder_tree: Dict, path: str) -> None:
    """Write an encoder's flax tree as the marked npz."""
    flat = flatten_params(encoder_tree)
    flat[FLAX_MARKER] = np.asarray(1)
    np.savez(path, **flat)


def read_text_params(path: str, text_cfg=None) -> Dict:
    """The encoder tree of a text checkpoint: a marked MLM npz as it is,
    else a BERT/RoBERTa state dict converted for ``text_cfg`` (its heads
    split the attention kernels)."""
    sd = load_state_dict(path)
    if FLAX_MARKER in sd:
        return unflatten_params(sd)
    if text_cfg is None:
        raise ValueError(f"{path}: a Hugging Face state dict needs the "
                         "encoder's config to be converted")
    from mpmc_tpu_torch.models.hf_convert import convert_bert_state_dict
    return convert_bert_state_dict(sd, text_cfg)


def infer_text_config_from_tree(tree: Dict):
    """A ``TextEncoderConfig`` from an encoder tree's shapes (an MLM npz
    carries no config): vocab and width from the word embeddings, heads
    from the query kernel, the layer count from the ``layer_<i>`` groups."""
    from mpmc_tpu_torch.config import TextEncoderConfig
    vocab, hidden = tree["word_embeddings"]["embedding"].shape
    max_pos = tree["position_embeddings"]["embedding"].shape[0]
    type_vocab = tree["token_type_embeddings"]["embedding"].shape[0]
    heads = tree["layer_0"]["attention"]["query"]["kernel"].shape[1]
    inter = tree["layer_0"]["intermediate"]["kernel"].shape[1]
    layers = sum(1 for k in tree if k.startswith("layer_"))
    return TextEncoderConfig(vocab_size=vocab, hidden_size=hidden,
                             num_layers=layers, num_heads=heads,
                             intermediate_size=inter,
                             max_position_embeddings=max_pos,
                             type_vocab_size=type_vocab)


def read_image_params(path: str, arch: Optional[str] = None,
                      num_classes: int = 0) -> Dict:
    """``{"params": tree, "batch_stats": tree}`` of an image checkpoint: a
    marked SimCLR npz as it is, else a torchvision/timm/HF state dict of
    backbone ``arch`` converted (``num_classes`` > 0 keeps its classifier
    head)."""
    sd = load_state_dict(path)
    if FLAX_IMAGE_MARKER in sd:
        tree = unflatten_params(sd)
        return {"params": tree.get("params", {}),
                "batch_stats": tree.get("batch_stats", {})}
    if arch is None:
        raise ValueError(f"{path}: a torchvision/timm/HF state dict needs "
                         "the backbone's arch to be converted")
    from mpmc_tpu_torch.models.vision_convert import convert_image_state_dict
    return convert_image_state_dict(sd, arch, num_classes)


def _spec(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple, Tuple]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_spec(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = tuple(np.shape(val))
    return out


def _validate(dst: Dict, src: Dict, where: str) -> None:
    d, s = _spec(dst), _spec(src)
    if d.keys() != s.keys():
        missing = sorted(d.keys() - s.keys())[:5]
        extra = sorted(s.keys() - d.keys())[:5]
        raise ValueError(
            f"pretrained splice at {where!r}: leaf sets differ (missing "
            f"from checkpoint: {missing}; unexpected: {extra})")
    for k in d:
        if d[k] != s[k]:
            raise ValueError(
                f"pretrained splice at {where!r}: shape mismatch at "
                f"{'/'.join(k)}: model {d[k]} vs checkpoint {s[k]}")


def _load(module: nn.Module, params: Dict, batch_stats: Dict) -> None:
    device = next(module.parameters()).device
    sd = module.state_dict()
    sd.update({k: v.to(device) for k, v in
               from_jax_variables(params, batch_stats).items()})
    module.load_state_dict(sd)


def _splice_text(model: nn.Module, where: str, path: str) -> None:
    encoder = model.get_submodule(where)
    own = to_jax_params(encoder)
    tree = read_text_params(path, encoder.cfg)
    for key in ("pooler", "token_type_embeddings"):
        if key in own and key not in tree:
            tree[key] = own[key]
    _validate(own, tree, where)
    _load(encoder, tree, {})


def _splice_image(model: nn.Module, where: str, arch: str, path: str
                  ) -> None:
    backbone = model.get_submodule(where)
    own, own_stats = to_jax_variables(backbone)
    n_cls = own["classifier"]["bias"].shape[0] if "classifier" in own else 0
    tree = read_image_params(path, arch, n_cls)
    _validate(own, tree["params"], f"params/{where}")
    if tree["batch_stats"]:
        _validate(own_stats, tree["batch_stats"], f"batch_stats/{where}")
    _load(backbone, tree["params"], tree["batch_stats"])


def apply_pretrained(model: nn.Module, kind: str,
                     spec: Optional[PretrainedSpec]) -> nn.Module:
    """Load ``spec.text`` into the text encoder, ``spec.caption`` into the
    caption encoder and ``spec.image`` into the image backbone of ``model``
    (a classifier of ``kind``) in place; returns the model.  A checkpoint
    for a part the kind does not have raises, as in the JAX package: the
    text model takes only a text checkpoint, the image model only an image
    one, the simple model no caption checkpoint."""
    if not spec:
        return model
    if spec.text:
        if kind not in TEXT_SUBMODULE:
            raise ValueError(f"the {kind} model has no text encoder")
        _splice_text(model, TEXT_SUBMODULE[kind], spec.text)
    if spec.caption:
        if kind != "multimodal" or model.cfg.caption is None:
            raise ValueError(f"the {kind} model has no caption encoder")
        _splice_text(model, CAPTION_SUBMODULE, spec.caption)
    if spec.image:
        if kind not in IMAGE_SUBMODULE:
            raise ValueError(f"the {kind} model has no image backbone")
        _splice_image(model, IMAGE_SUBMODULE[kind], model.cfg.image.arch,
                      spec.image)
    return model
