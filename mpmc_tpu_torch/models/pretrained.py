"""Pretrained text encoders spliced into a classifier (port of the text part
of ``mpmc_tpu/models/pretrained.py``).

The checkpoint is a flax-tree ``.npz`` (``a/b/c`` keys of the encoder's
parameter tree in flax layouts, plus the ``__flax_encoder__`` marker), as
corpus MLM pretraining writes it in either package
(``train/pretrain.save_encoder_params``).  It is spliced into the model's
``encoder`` (kind ``text``) or ``text_model`` (kinds ``simple`` and
``multimodal``); the leaf set and every shape must equal the model's, and
the model keeps its own pooler and token-type tables when the file lacks
them.  Hugging Face state dicts are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
from torch import nn

from mpmc_tpu_torch.models.convert import from_jax_variables, to_jax_params

FLAX_MARKER = "__flax_encoder__"
TEXT_SUBMODULE = {"text": "encoder", "simple": "text_model",
                  "multimodal": "text_model"}


@dataclasses.dataclass(frozen=True)
class PretrainedSpec:
    """Path of a text-encoder checkpoint (``--text-params``)."""

    text: Optional[str] = None

    def __bool__(self) -> bool:
        return bool(self.text)


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
    """Inverse of :func:`flatten_params`; skips the marker."""
    tree: Dict = {}
    for key, leaf in flat.items():
        if key == FLAX_MARKER:
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


def apply_pretrained(model: nn.Module, kind: str,
                     spec: Optional[PretrainedSpec]) -> nn.Module:
    """Load ``spec.text`` into the text encoder of ``model`` (a classifier
    of ``kind``) in place; returns the model."""
    if not spec:
        return model
    if kind not in TEXT_SUBMODULE:
        raise ValueError(f"the {kind} model has no text encoder")
    encoder = getattr(model, TEXT_SUBMODULE[kind])
    own = to_jax_params(encoder)
    tree = read_text_params(spec.text)
    for key in ("pooler", "token_type_embeddings"):
        if key in own and key not in tree:
            tree[key] = own[key]
    _validate(own, tree, TEXT_SUBMODULE[kind])
    device = next(encoder.parameters()).device
    encoder.load_state_dict({k: v.to(device) for k, v in
                             from_jax_variables(tree).items()})
    return model
