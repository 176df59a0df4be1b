"""Weight bridge: the JAX package's classifier variables (text, image, simple
and multimodal models) to the port's ``state_dict``, and a port module's
weights back to the flax trees (``to_jax_variables``: a text encoder, an
image backbone with its BatchNorm statistics).

Module names are the same on both sides, so keys map by path; layouts are
the inverse of the JAX package's converters (``models/hf_convert.py``,
``models/vision_convert.py``):

* Dense kernel ``[in, out]`` -> Linear weight ``[out, in]``;
* DenseGeneral q/k/v kernel ``[H, heads, hd]`` -> ``[heads*hd, H]`` (bias
  ``[heads, hd]`` -> ``[heads*hd]``), ``out`` kernel ``[heads, hd, H]`` ->
  ``[H, heads*hd]`` (the caption decoder's ``self_*`` and ``cross_*``
  projections likewise);
* conv kernel HWIO -> OIHW (grouped convs too: I is in/groups on both
  sides); the CNN pooler's 1-D conv kernel ``[k, in, out]`` -> ``[out, in,
  k]``, told from a q/k/v kernel, also 3-D, by its module name ``conv1d``;
* LayerNorm / BatchNorm ``scale`` -> ``weight``, batch stats ``mean`` /
  ``var`` -> ``running_mean`` / ``running_var``; ``embedding`` -> ``weight``;
* parameters the modules declare themselves keep their name and layout:
  a ViT's ``cls_token`` ``[1, 1, H]`` and ``pos_embed`` ``[1, 1+N, H]``,
  BLIP's ``class_embedding`` and ``position_embedding`` (the same shapes),
  ConvNeXt's layer scale ``gamma`` ``[dim]``.  A depthwise conv kernel
  (HW1C, ``feature_group_count`` = C) is a grouped conv like any other.

Flax names the fusion module itself (``make_fusion`` passes no name): its
class name with ``_0`` (``ConcatAttention_0``, ``MCA3_0``,
``CrossModalAttention_0`` ...) becomes ``fusion``.  The single-token and
self-attention fusions' q/k/v and ``out`` are DenseGeneral kernels like the
encoders'.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mpmc_tpu_torch.models.norm import BatchNorm

_MODULE_RENAME = {f"{cls}_0": "fusion" for cls in (
    "ConcatAttention", "ConcatAttention3", "MCA", "MCA3",
    "CrossModalAttention", "SelfAttentionFusion")}
_STATS = {"mean": "running_mean", "var": "running_var"}
_AS_IS = ("cls_token", "pos_embed", "gamma", "class_embedding",
          "position_embedding")
_QKV = ("query", "key", "value", "q", "k", "v")
# DenseGeneral output projections [heads, hd, H]: the encoders' ``out`` and
# the caption decoder's ``self_out`` / ``cross_out``.
_OUT = ("out", "self_out", "cross_out")


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
    if x.ndim == 3 and parent in _OUT:        # [heads, hd, H]
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


def to_jax_variables(module: nn.Module) -> Tuple[Dict, Dict]:
    """A port module's weights as the flax trees of its JAX counterpart,
    ``(params, batch_stats)`` (nested dicts of f32 numpy arrays), the
    inverse of :func:`from_jax_variables`: Linear ``[out, in]`` -> kernel
    ``[in, out]``; an attention's q/k/v weight ``[heads*hd, H]`` -> ``[H,
    heads, hd]`` (bias ``[heads, hd]``) and its ``out`` ``[H, heads*hd]``
    -> ``[heads, hd, H]`` (the Linears named ``query``/``key``/``value``/
    ``q``/``k``/``v``/``out`` of a module with ``num_heads``); conv OIHW ->
    HWIO, the CNN pooler's ``conv1d`` ``[out, in, k]`` -> ``[k, in, out]``;
    LayerNorm and BatchNorm ``weight`` -> ``scale``, BatchNorm running
    statistics -> ``batch_stats`` ``mean`` / ``var``; Embedding ``weight``
    -> ``embedding``; parameters a module declares itself keep their name
    and layout."""
    params: Dict = {}
    stats: Dict = {}

    def node(tree: Dict, path) -> Dict:
        for p in path:
            tree = tree.setdefault(p, {})
        return tree

    def f32(t: torch.Tensor) -> np.ndarray:
        # A copy: the numpy view of an f32 CPU tensor shares its memory,
        # which the module's next step would overwrite.
        return np.array(t.detach().cpu().float().numpy())

    mods = dict(module.named_modules())
    for name, mod in mods.items():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        path = name.split(".") if name else []
        leaf = node(params, path)
        parent = mods.get(".".join(path[:-1]))
        heads = getattr(parent, "num_heads", None) if path else None
        w, b = own.get("weight"), own.get("bias")
        if isinstance(mod, nn.Embedding):
            leaf["embedding"] = f32(w)
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            leaf["scale"], leaf["bias"] = f32(w), f32(b)
            if isinstance(mod, BatchNorm):
                st = node(stats, path)
                st["mean"] = f32(mod.running_mean)
                st["var"] = f32(mod.running_var)
        elif isinstance(mod, nn.Linear):
            w = f32(w)
            if heads and path[-1] in _QKV:
                leaf["kernel"] = w.T.reshape(w.shape[1], heads, -1)
                leaf["bias"] = f32(b).reshape(heads, -1)
            elif heads and path[-1] == "out":
                leaf["kernel"] = w.T.reshape(heads, -1, w.shape[0])
                leaf["bias"] = f32(b)
            else:
                leaf["kernel"] = w.T
                if b is not None:
                    leaf["bias"] = f32(b)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            leaf["kernel"] = (f32(w).transpose(2, 1, 0) if w.dim() == 3
                              else f32(w).transpose(2, 3, 1, 0))
            if b is not None:
                leaf["bias"] = f32(b)
        else:
            for pname, p in own.items():
                if pname not in _AS_IS:
                    raise TypeError(f"no flax layout for {pname} of "
                                    f"{type(mod).__name__} at {name}")
                leaf[pname] = f32(p)
    return params, stats


def stack_jax_variables(variables: Sequence[Tuple[Mapping,
                                                  Optional[Mapping]]]
                        ) -> Dict[str, torch.Tensor]:
    """F replicas' flax ``(params, batch_stats)`` as one stacked
    ``state_dict`` ``[F, ...]``: the model of a fold-parallel step
    (``parallel/fold_parallel.py``), fold f from ``variables[f]``."""
    sds = [from_jax_variables(p, s) for p, s in variables]
    return {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]}


def unstack_to_jax_variables(module: nn.Module,
                             stacked: Mapping[str, torch.Tensor]
                             ) -> List[Tuple[Dict, Dict]]:
    """The inverse of :func:`stack_jax_variables`: each fold's slice of
    ``stacked`` loaded into ``module`` (a port model of the replicas' kind
    and config, whose weights it overwrites) and converted by
    :func:`to_jax_variables`."""
    folds = len(next(iter(stacked.values())))
    out = []
    for f in range(folds):
        module.load_state_dict({k: v[f] for k, v in stacked.items()})
        out.append(to_jax_variables(module))
    return out


def to_jax_params(module: nn.Module) -> Dict:
    """The flax parameter tree of :func:`to_jax_variables`."""
    return to_jax_variables(module)[0]


def load_blip_params(model: nn.Module, params: Mapping) -> None:
    """The JAX package's ``BlipCaptioner`` parameter tree (nested dicts of
    numpy arrays, as ``convert_blip_state_dict`` in either package or
    ``BlipCaptioner.init`` give it) into the port's ``BlipCaptioner``
    (``models/blip.py``), every leaf: Dense kernels transposed, the patch
    convolution HWIO -> OIHW, LayerNorm ``scale`` -> ``weight``,
    embeddings, and the class token and positions as they are.  The
    module keeps its device and dtype; a module on the meta device takes
    the f32 CPU tensors themselves."""
    sd = from_jax_variables(params)
    if any(p.is_meta for p in model.parameters()):
        model.load_state_dict(sd, assign=True)
    else:
        model.load_state_dict(sd)
