"""Pretrained text encoders and image backbones spliced into a classifier
(port of ``mpmc_tpu/models/pretrained.py`` for the flax-tree checkpoints).

A text checkpoint is a flax-tree ``.npz`` (``a/b/c`` keys of the encoder's
parameter tree in flax layouts, plus the ``__flax_encoder__`` marker), as
corpus MLM pretraining writes it in either package
(``train/pretrain.save_encoder_params``).  It is spliced into the model's
``encoder`` (kind ``text``) or ``text_model`` (kinds ``simple`` and
``multimodal``); the model keeps its own pooler and token-type tables when
the file lacks them.

An image checkpoint is the flax-tree ``.npz`` that SimCLR pretraining
writes in either package (``train/pretrain_image.save_image_encoder_params``):
``params/...`` and ``batch_stats/...`` keys of the backbone's trees plus the
``__flax_image_encoder__`` marker.  It is spliced into the model's
``backbone`` (kinds ``image`` and ``simple``) or ``image_model.backbone``
(kind ``multimodal``), the BatchNorm running statistics into the
``BatchNorm`` buffers.

Either way the leaf set and every shape must equal the model's.  Hugging
Face text state dicts and torchvision/timm image state dicts are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
from torch import nn

from mpmc_tpu_torch.models.convert import (from_jax_variables, to_jax_params,
                                          to_jax_variables)

FLAX_MARKER = "__flax_encoder__"
FLAX_IMAGE_MARKER = "__flax_image_encoder__"
TEXT_SUBMODULE = {"text": "encoder", "simple": "text_model",
                  "multimodal": "text_model"}
IMAGE_SUBMODULE = {"image": "backbone", "simple": "backbone",
                   "multimodal": "image_model.backbone"}


@dataclasses.dataclass(frozen=True)
class PretrainedSpec:
    """Paths of a text-encoder checkpoint (``--text-params``) and of an
    image-backbone checkpoint (``--image-params``)."""

    text: Optional[str] = None
    image: Optional[str] = None

    def __bool__(self) -> bool:
        return bool(self.text or self.image)


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


def read_text_params(path: str) -> Dict:
    """The flax tree of a marked encoder npz."""
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: only the flax-tree .npz of corpus MLM "
                         "pretraining is read; other text checkpoints "
                         "(Hugging Face state dicts) are not ported yet")
    with np.load(path) as f:
        flat = dict(f)
    if FLAX_MARKER not in flat:
        raise ValueError(f"{path}: no {FLAX_MARKER} entry; Hugging Face "
                         "state dicts are not ported yet")
    return unflatten_params(flat)


def read_image_params(path: str) -> Dict:
    """``{"params": tree, "batch_stats": tree}`` of a marked image-backbone
    npz."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            flat = dict(f)
        if FLAX_IMAGE_MARKER in flat:
            tree = unflatten_params(flat)
            return {"params": tree.get("params", {}),
                    "batch_stats": tree.get("batch_stats", {})}
    raise ValueError(f"{path}: only the flax-tree .npz of SimCLR pretraining "
                     f"(with its {FLAX_IMAGE_MARKER} entry) is read; "
                     "torchvision/timm image state dicts are not ported yet")


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


def apply_pretrained(model: nn.Module, kind: str,
                     spec: Optional[PretrainedSpec]) -> nn.Module:
    """Load ``spec.text`` into the text encoder and ``spec.image`` into the
    image backbone of ``model`` (a classifier of ``kind``) in place;
    returns the model."""
    if not spec:
        return model
    if spec.text:
        if kind not in TEXT_SUBMODULE:
            raise ValueError(f"the {kind} model has no text encoder")
        encoder = getattr(model, TEXT_SUBMODULE[kind])
        own = to_jax_params(encoder)
        tree = read_text_params(spec.text)
        for key in ("pooler", "token_type_embeddings"):
            if key in own and key not in tree:
                tree[key] = own[key]
        _validate(own, tree, TEXT_SUBMODULE[kind])
        _load(encoder, tree, {})
    if spec.image:
        if kind not in IMAGE_SUBMODULE:
            raise ValueError(f"the {kind} model has no image backbone")
        where = IMAGE_SUBMODULE[kind]
        backbone = model.get_submodule(where)
        own, own_stats = to_jax_variables(backbone)
        tree = read_image_params(spec.image)
        _validate(own, tree["params"], f"params/{where}")
        if tree["batch_stats"]:
            _validate(own_stats, tree["batch_stats"], f"batch_stats/{where}")
        _load(backbone, tree["params"], tree["batch_stats"])
    return model
