"""Weight bridge: the JAX package's classifier variables (text, image, simple
and multimodal models) to the port's ``state_dict``, and a text encoder's
weights back to the flax tree (``to_jax_params``).

Module names are the same on both sides, so keys map by path; layouts are
the inverse of the JAX package's converters (``models/hf_convert.py``,
``models/vision_convert.py``):

* Dense kernel ``[in, out]`` -> Linear weight ``[out, in]``;
* DenseGeneral q/k/v kernel ``[H, heads, hd]`` -> ``[heads*hd, H]`` (bias
  ``[heads, hd]`` -> ``[heads*hd]``), ``out`` kernel ``[heads, hd, H]`` ->
  ``[H, heads*hd]``;
* conv kernel HWIO -> OIHW (grouped convs too: I is in/groups on both
  sides); the CNN pooler's 1-D conv kernel ``[k, in, out]`` -> ``[out, in,
  k]``, told from a q/k/v kernel, also 3-D, by its module name ``conv1d``;
* LayerNorm / BatchNorm ``scale`` -> ``weight``, batch stats ``mean`` /
  ``var`` -> ``running_mean`` / ``running_var``; ``embedding`` -> ``weight``;
* parameters the modules declare themselves keep their name and layout:
  a ViT's ``cls_token`` ``[1, 1, H]`` and ``pos_embed`` ``[1, 1+N, H]``,
  ConvNeXt's layer scale ``gamma`` ``[dim]``.  A depthwise conv kernel
  (HW1C, ``feature_group_count`` = C) is a grouped conv like any other.

Flax names the fusion module itself (``make_fusion`` passes no name):
``ConcatAttention3_0`` or ``ConcatAttention_0`` becomes ``fusion``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_MODULE_RENAME = {"ConcatAttention3_0": "fusion", "ConcatAttention_0": "fusion"}
_STATS = {"mean": "running_mean", "var": "running_var"}
_AS_IS = ("cls_token", "pos_embed", "gamma")


def _param(path: Tuple[str, ...], name: str, x: np.ndarray
           ) -> Tuple[str, np.ndarray]:
    parent = path[-1] if path else ""
    if name == "embedding" or name == "scale":
        return "weight", x
    if name == "bias":
        return "bias", x.reshape(-1)          # q/k/v bias [heads, hd]
    if name in _AS_IS:
        return name, x
    if name != "kernel":
        raise KeyError(f"unknown parameter {'/'.join(path + (name,))}")
    if x.ndim == 2:
        return "weight", x.T
    if x.ndim == 3 and parent == "conv1d":    # 1-D conv [k, in, out]
        return "weight", x.transpose(2, 1, 0)
    if x.ndim == 3 and parent == "out":       # [heads, hd, H]
        return "weight", x.reshape(-1, x.shape[-1]).T
    if x.ndim == 3:                           # q/k/v [H, heads, hd]
        return "weight", x.reshape(x.shape[0], -1).T
    if x.ndim == 4:                           # conv HWIO
        return "weight", x.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel shape {x.shape} at {path}")


def from_jax_variables(params: Mapping,
                       batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (flax ``params`` and ``batch_stats``) to
    the port's ``state_dict`` (f32 tensors)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, path: Tuple[str, ...], stats: bool):
        for name, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, path + (_MODULE_RENAME.get(name, name),), stats)
                continue
            x = np.array(val, dtype=np.float32)
            if stats:
                leaf = _STATS[name]
            else:
                leaf, x = _param(path, name, x)
            sd[".".join(path + (leaf,))] = torch.from_numpy(
                np.ascontiguousarray(x))

    walk(params, (), False)
    if batch_stats:
        walk(batch_stats, (), True)
    return sd


def to_jax_params(encoder: nn.Module) -> Dict:
    """A port ``TextEncoder``'s weights as the flax parameter tree of the
    JAX package's encoder (nested dicts of f32 numpy arrays), the inverse
    of :func:`from_jax_variables` on that subtree: Linear ``[out, in]`` ->
    kernel ``[in, out]``; the attention's q/k/v weight ``[heads*hd, H]`` ->
    ``[H, heads, hd]`` (bias ``[heads, hd]``) and ``out`` ``[H, heads*hd]``
    -> ``[heads, hd, H]``; LayerNorm ``weight`` -> ``scale``; Embedding
    ``weight`` -> ``embedding``."""
    heads = encoder.cfg.num_heads
    tree: Dict = {}
    for name, mod in encoder.named_modules():
        if not any(True for _ in mod.parameters(recurse=False)):
            continue
        path = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        w = mod.weight.detach().cpu().float().numpy()
        b = (mod.bias.detach().cpu().float().numpy()
             if getattr(mod, "bias", None) is not None else None)
        if isinstance(mod, nn.Embedding):
            node["embedding"] = w
            continue
        if isinstance(mod, nn.LayerNorm):
            node["scale"], node["bias"] = w, b
            continue
        if not isinstance(mod, nn.Linear):
            raise TypeError(f"no flax layout for {type(mod).__name__} at "
                            f"{name}")
        if path[-1] in ("query", "key", "value"):
            node["kernel"] = w.T.reshape(w.shape[1], heads, -1)
            node["bias"] = b.reshape(heads, -1)
        elif path[-1] == "out" and path[-2:-1] == ["attention"]:
            node["kernel"] = w.T.reshape(heads, -1, w.shape[0])
            node["bias"] = b
        else:
            node["kernel"], node["bias"] = w.T, b
    return tree
