"""Hugging Face BERT/RoBERTa checkpoint to the flax-layout parameter tree
(port of ``mpmc_tpu/models/hf_convert.py``).

Given a local HF checkpoint (a directory with ``pytorch_model.bin`` or
``model.safetensors``, or its state dict as numpy arrays), produce the
same numpy tree as the JAX package's converter: the flax layout of the
``TextEncoder`` parameters (``word_embeddings/embedding``,
``layer_<i>/attention/query/kernel`` ``[in, heads, head_dim]`` ...).  The
port's weight bridge (``models/convert.from_jax_variables``) then loads it
into the port's ``TextEncoder``, so the HF-to-port mapping has one place
where a layout can go wrong, shared with the JAX package.

Mapping (HF BERT -> tree):
  embeddings.{word,position,token_type}_embeddings.weight -> embedding tables
  embeddings.LayerNorm                                -> embeddings_ln
  encoder.layer.N.attention.self.{query,key,value}    -> layer_N/attention/{query,key,value}
  encoder.layer.N.attention.output.dense              -> layer_N/attention/out
  encoder.layer.N.attention.output.LayerNorm          -> layer_N/attention_ln
  encoder.layer.N.intermediate.dense                  -> layer_N/intermediate
  encoder.layer.N.output.dense                        -> layer_N/output
  encoder.layer.N.output.LayerNorm                    -> layer_N/output_ln
  pooler.dense                                        -> pooler

``model.safetensors`` is read with numpy (an 8-byte header length, a JSON
header, raw little-endian buffers), so no ``safetensors`` package is
needed; ``pytorch_model.bin`` goes through ``torch.load(weights_only=
True)``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from mpmc_tpu_torch.config import TextEncoderConfig


def _split_heads(w: np.ndarray, num_heads: int) -> np.ndarray:
    """HF [out, in] torch linear → flax DenseGeneral kernel [in, heads, head_dim]."""
    out_dim, in_dim = w.shape
    return np.ascontiguousarray(
        w.T.reshape(in_dim, num_heads, out_dim // num_heads))


def _linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def convert_bert_state_dict(sd: Dict[str, np.ndarray],
                            cfg: TextEncoderConfig) -> Dict:
    """Convert an HF BERT/RoBERTa state_dict (numpy values) to our tree."""
    sd = {k.removeprefix("bert.").removeprefix("roberta."): v
          for k, v in sd.items()}
    H = cfg.num_heads
    head_dim = cfg.hidden_size // H
    p: Dict = {}
    p["word_embeddings"] = {"embedding": sd["embeddings.word_embeddings.weight"]}
    p["position_embeddings"] = {
        "embedding": sd["embeddings.position_embeddings.weight"]}
    if cfg.type_vocab_size > 0 and "embeddings.token_type_embeddings.weight" in sd:
        p["token_type_embeddings"] = {
            "embedding": sd["embeddings.token_type_embeddings.weight"]}
    p["embeddings_ln"] = {"scale": sd["embeddings.LayerNorm.weight"],
                          "bias": sd["embeddings.LayerNorm.bias"]}
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}."
        attn = {}
        for name in ("query", "key", "value"):
            attn[name] = {
                "kernel": _split_heads(sd[pre + f"attention.self.{name}.weight"], H),
                "bias": sd[pre + f"attention.self.{name}.bias"].reshape(H, head_dim),
            }
        attn["out"] = {
            "kernel": np.ascontiguousarray(
                sd[pre + "attention.output.dense.weight"].T.reshape(
                    H, head_dim, cfg.hidden_size)),
            "bias": sd[pre + "attention.output.dense.bias"],
        }
        p[f"layer_{i}"] = {
            "attention": attn,
            "attention_ln": {
                "scale": sd[pre + "attention.output.LayerNorm.weight"],
                "bias": sd[pre + "attention.output.LayerNorm.bias"]},
            "intermediate": {
                "kernel": _linear(sd[pre + "intermediate.dense.weight"]),
                "bias": sd[pre + "intermediate.dense.bias"]},
            "output": {
                "kernel": _linear(sd[pre + "output.dense.weight"]),
                "bias": sd[pre + "output.dense.bias"]},
            "output_ln": {
                "scale": sd[pre + "output.LayerNorm.weight"],
                "bias": sd[pre + "output.LayerNorm.bias"]},
        }
    if "pooler.dense.weight" in sd:
        p["pooler"] = {"kernel": _linear(sd["pooler.dense.weight"]),
                       "bias": sd["pooler.dense.bias"]}
    return p


_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2",
                       "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
                       "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file's tensors as numpy arrays, read with numpy:
    a little-endian u64 header length, the JSON header (each tensor's
    dtype, shape and byte range in the buffer), then the buffer.  A dtype
    numpy has no type for (such as BF16) raises, as ``safetensors.numpy``
    refuses it."""
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        header = json.loads(f.read(n).decode("utf-8"))
        buf = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = buf[begin:end]
        if info["dtype"] in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(raw, _SAFETENSORS_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which is not read")
        out[name] = arr.reshape(info["shape"]).copy()
    return out


def torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch ``state_dict`` file (``.bin``, ``.pt``) as numpy arrays,
    through ``torch.load(weights_only=True)`` on the CPU."""
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def load_hf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A local HF checkpoint dir's tensors as numpy: ``model.safetensors``
    when it is there, else ``pytorch_model.bin``."""
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    return torch_state_dict(os.path.join(path, "pytorch_model.bin"))


def convert_checkpoint_dir(path: str, cfg: TextEncoderConfig) -> Dict:
    return convert_bert_state_dict(load_hf_checkpoint(path), cfg)
