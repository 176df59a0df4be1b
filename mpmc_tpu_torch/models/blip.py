"""BLIP captioner (port of ``mpmc_tpu/models/blip.py``).

The reference's third modality is ``Salesforce/blip-image-captioning-large``.
This is the JAX package's ``BlipCaptioner`` in PyTorch, module for module
and under the same names, so that a converted Hugging Face
``BlipForConditionalGeneration`` checkpoint loads through
:func:`convert_blip_state_dict` and the weight bridge
(``models/convert.load_blip_params``):

* vision (:class:`BlipVisionModel`): a ViT with a fused ``qkv``
  projection, pre-LN blocks, exact GELU, a class token, learned positions
  and a final ``post_layernorm``;
* text decoder (:class:`BlipTextDecoder`): BERT-style post-LN layers with
  causal self-attention, cross-attention over the whole vision sequence,
  then the MLP; the prediction head dense -> GELU -> LN -> vocab;
* :meth:`BlipCaptioner.generate`: greedy, conditioned on a prompt that
  includes BOS; the decoder reruns over all ``max_len`` tokens at every
  position, as the JAX ``lax.scan`` does (no KV cache).  On the card the
  whole decode is one CUDA graph replay per input shape
  (``train/graphs.GraphedCall``).

Attention: the vision self-attention and the decoder's cross-attention
(mode none) go through :func:`mpmc_tpu_torch.ops.attention.attention_forward`,
the CUDA forward kernel on a CUDA tensor and its plain version on the CPU;
the causal self-attention stays plain tensor operations (scores and
softmax in f32, the JAX module's additive -1e10 mask).  The JAX module
computes every attention as an einsum.  Precision follows the port's
rule: the caller casts the module to bf16 on the card and keeps f32 on the
CPU.  Images arrive in the JAX package's ``[B, H, W, C]`` layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.ops.attention import attention_forward
from mpmc_tpu_torch.train.graphs import GraphedCall

CAUSAL_NEG = -1e10                 # the JAX module's causal mask value


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    # vision
    v_hidden: int = 1024
    v_layers: int = 24
    v_heads: int = 16
    v_mlp: int = 4096
    image_size: int = 384
    patch_size: int = 16
    v_eps: float = 1e-5
    # text decoder
    vocab_size: int = 30524
    t_hidden: int = 768
    t_layers: int = 12
    t_heads: int = 12
    t_mlp: int = 3072
    max_positions: int = 512
    t_eps: float = 1e-12
    bos_token_id: int = 30522
    eos_token_id: int = 102
    pad_token_id: int = 0

    @staticmethod
    def tiny() -> "BlipConfig":
        return BlipConfig(v_hidden=24, v_layers=2, v_heads=4, v_mlp=48,
                          image_size=32, patch_size=8, vocab_size=64,
                          t_hidden=32, t_layers=2, t_heads=4, t_mlp=64,
                          max_positions=32, bos_token_id=1, eos_token_id=2)


class VisionLayer(nn.Module):
    """Pre-LN block: ``x + projection(attn(layer_norm1(x)))`` with q, k, v
    the three thirds of the fused ``qkv``, then ``x + fc2(gelu(fc1(
    layer_norm2(x))))``."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        H = cfg.v_hidden
        self.heads = cfg.v_heads
        self.layer_norm1 = nn.LayerNorm(H, cfg.v_eps)
        self.qkv = nn.Linear(H, 3 * H)
        self.projection = nn.Linear(H, H)
        self.layer_norm2 = nn.LayerNorm(H, cfg.v_eps)
        self.fc1 = nn.Linear(H, cfg.v_mlp)
        self.fc2 = nn.Linear(cfg.v_mlp, H)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, H = x.shape
        # Views of the fused projection: q, k, v start H and 2H elements
        # into each row (2,048 and 4,096 bytes at ViT-L's bf16 width, the
        # 16-byte alignment the bf16 kernel needs).
        qkv = self.qkv(self.layer_norm1(x)).view(B, S, 3, self.heads, -1)
        q, k, v = qkv.unbind(2)
        ctx = attention_forward(q, k, v, None, "none")[0]
        x = x + self.projection(ctx.reshape(B, S, H))
        h = F.gelu(self.fc1(self.layer_norm2(x)))
        return x + self.fc2(h)


class BlipVisionModel(nn.Module):
    """Patch convolution, class token, learned positions, ``v_layers``
    blocks and ``post_layernorm``: pixel values ``[B, H, W, 3]`` ->
    ``[B, 1 + P, v_hidden]``."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        H, p = cfg.v_hidden, cfg.patch_size
        self.num_layers = cfg.v_layers
        self.patch_embedding = nn.Conv2d(3, H, p, stride=p)
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, H))
        self.position_embedding = nn.Parameter(
            torch.zeros(1, (cfg.image_size // p) ** 2 + 1, H))
        for i in range(cfg.v_layers):
            setattr(self, f"layer_{i}", VisionLayer(cfg))
        self.post_layernorm = nn.LayerNorm(H, cfg.v_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixel_values.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)              # patches in row order
        B, _, H = x.shape
        x = torch.cat([self.class_embedding.expand(B, 1, H), x], dim=1)
        x = x + self.position_embedding[:, :x.shape[1]]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.post_layernorm(x)


class TextLayer(nn.Module):
    """Post-LN block: causal self-attention, cross-attention over the
    vision states, then the MLP, each followed by its residual LayerNorm."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        H = cfg.t_hidden
        self.heads = cfg.t_heads
        for prefix in ("self", "cross"):
            kv_width = H if prefix == "self" else cfg.v_hidden
            setattr(self, f"{prefix}_query", nn.Linear(H, H))
            setattr(self, f"{prefix}_key", nn.Linear(kv_width, H))
            setattr(self, f"{prefix}_value", nn.Linear(kv_width, H))
            setattr(self, f"{prefix}_out", nn.Linear(H, H))
            setattr(self, f"{prefix}_ln", nn.LayerNorm(H, cfg.t_eps))
        self.intermediate = nn.Linear(H, cfg.t_mlp)
        self.output = nn.Linear(cfg.t_mlp, H)
        self.output_ln = nn.LayerNorm(H, cfg.t_eps)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(x.shape[0], x.shape[1], self.heads, -1)

    def forward(self, x: torch.Tensor, enc: torch.Tensor,
                causal: torch.Tensor) -> torch.Tensor:
        B, S, H = x.shape
        q, k, v = (self._heads(f(x)) for f in (
            self.self_query, self.self_key, self.self_value))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        s = s / math.sqrt(q.shape[-1]) + causal
        p = torch.softmax(s, dim=-1).to(v.dtype)
        h = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H)
        x = self.self_ln(x + self.self_out(h))
        q = self._heads(self.cross_query(x))
        k = self._heads(self.cross_key(enc))
        v = self._heads(self.cross_value(enc))
        h = attention_forward(q, k, v, None, "none")[0].reshape(B, S, H)
        x = self.cross_ln(x + self.cross_out(h))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.output_ln(x + h)


class BlipTextDecoder(nn.Module):
    """Word and position embeddings, ``embeddings_ln``, ``t_layers``
    blocks under a causal mask, and the prediction head (``transform``,
    GELU, ``transform_ln``, ``decoder``): ids ``[B, S]`` -> logits ``[B,
    S, vocab_size]``."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        H = cfg.t_hidden
        self.num_layers = cfg.t_layers
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        self.position_embeddings = nn.Embedding(cfg.max_positions, H)
        self.embeddings_ln = nn.LayerNorm(H, cfg.t_eps)
        for i in range(cfg.t_layers):
            setattr(self, f"layer_{i}", TextLayer(cfg))
        self.transform = nn.Linear(H, H)
        self.transform_ln = nn.LayerNorm(H, cfg.t_eps)
        self.decoder = nn.Linear(H, cfg.vocab_size)

    def forward(self, input_ids: torch.Tensor,
                encoder_states: torch.Tensor) -> torch.Tensor:
        S = input_ids.shape[1]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings.weight[:S])
        x = self.embeddings_ln(x)
        allow = torch.ones(S, S, dtype=torch.bool,
                           device=input_ids.device).tril()
        causal = torch.where(allow, 0.0, CAUSAL_NEG)[None, None]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, encoder_states, causal)
        h = self.transform_ln(F.gelu(self.transform(x)))
        return self.decoder(h)


class BlipCaptioner(nn.Module):
    """``vision_model`` and ``text_decoder``; ``forward(pixel_values,
    input_ids)`` gives the decoder's logits over the vision states."""

    def __init__(self, cfg: BlipConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = BlipVisionModel(cfg)
        self.text_decoder = BlipTextDecoder(cfg)
        self.decode_graph = GraphedCall(self.generate_eager, self)

    def forward(self, pixel_values: torch.Tensor,
                input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_decoder(input_ids, self.vision_model(pixel_values))

    def generate(self, pixel_values: torch.Tensor, prompt_ids: torch.Tensor,
                 max_len: int = 32) -> torch.Tensor:
        """:meth:`generate_eager` as one CUDA graph replay per input shape
        on the card (the first call of a shape eager, the second
        captured); the loop itself on the CPU."""
        return self.decode_graph(pixel_values, prompt_ids, max_len=max_len)

    @torch.inference_mode()
    def generate_eager(self, pixel_values: torch.Tensor,
                       prompt_ids: torch.Tensor,
                       max_len: int = 32) -> torch.Tensor:
        """Greedy decode: the prompt ``[B, P]`` (BOS included), then at
        each position 1 .. max_len-1 the decoder over all ``max_len``
        tokens, the argmax of the previous position's logits written where
        ``pos >= P`` on rows not finished, a written EOS finishing its row;
        after EOS the row holds ``pad_token_id``.  ``[B, max_len]`` int64."""
        c = self.cfg
        enc = self.vision_model(pixel_values)
        B, P = prompt_ids.shape
        tokens = torch.full((B, max_len), c.pad_token_id, dtype=torch.long,
                            device=pixel_values.device)
        tokens[:, :P] = prompt_ids
        finished = torch.zeros(B, dtype=torch.bool, device=tokens.device)
        for pos in range(1, max_len):
            logits = self.text_decoder(tokens, enc)
            nxt = torch.argmax(logits[:, pos - 1], dim=-1)
            if pos < P:                  # inside the prompt: nothing written
                continue
            write = ~finished
            tokens[:, pos] = torch.where(write, nxt, tokens[:, pos])
            finished = finished | (write & (nxt == c.eos_token_id))
        return tokens


# ---------------------------------------------------------------------------
# HF conversion (numpy only, as the JAX package's)
# ---------------------------------------------------------------------------

def _lin(sd, key):
    return {"kernel": np.ascontiguousarray(sd[key + ".weight"].T),
            "bias": sd[key + ".bias"]}


def _ln(sd, key):
    return {"scale": sd[key + ".weight"], "bias": sd[key + ".bias"]}


def convert_blip_state_dict(sd: Dict[str, np.ndarray], cfg: BlipConfig
                            ) -> Dict:
    """HF ``BlipForConditionalGeneration`` state dict (numpy) -> the JAX
    package's parameter tree, leaf for leaf (``models/convert.
    load_blip_params`` carries it into :class:`BlipCaptioner`)."""
    p: Dict = {"vision_model": {}, "text_decoder": {}}
    v = p["vision_model"]
    v["class_embedding"] = sd["vision_model.embeddings.class_embedding"]
    v["position_embedding"] = sd["vision_model.embeddings.position_embedding"]
    w = sd["vision_model.embeddings.patch_embedding.weight"]  # [C,3,p,p]
    v["patch_embedding"] = {
        "kernel": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))),
        "bias": sd["vision_model.embeddings.patch_embedding.bias"]}
    for i in range(cfg.v_layers):
        pre = f"vision_model.encoder.layers.{i}."
        v[f"layer_{i}"] = {
            "layer_norm1": _ln(sd, pre + "layer_norm1"),
            "layer_norm2": _ln(sd, pre + "layer_norm2"),
            "qkv": _lin(sd, pre + "self_attn.qkv"),
            "projection": _lin(sd, pre + "self_attn.projection"),
            "fc1": _lin(sd, pre + "mlp.fc1"),
            "fc2": _lin(sd, pre + "mlp.fc2"),
        }
    v["post_layernorm"] = _ln(sd, "vision_model.post_layernorm")

    t = p["text_decoder"]
    te = "text_decoder.bert.embeddings."
    t["word_embeddings"] = {"embedding": sd[te + "word_embeddings.weight"]}
    t["position_embeddings"] = {
        "embedding": sd[te + "position_embeddings.weight"]}
    t["embeddings_ln"] = _ln(sd, te + "LayerNorm")
    for i in range(cfg.t_layers):
        pre = f"text_decoder.bert.encoder.layer.{i}."
        t[f"layer_{i}"] = {
            "self_query": _lin(sd, pre + "attention.self.query"),
            "self_key": _lin(sd, pre + "attention.self.key"),
            "self_value": _lin(sd, pre + "attention.self.value"),
            "self_out": _lin(sd, pre + "attention.output.dense"),
            "self_ln": _ln(sd, pre + "attention.output.LayerNorm"),
            "cross_query": _lin(sd, pre + "crossattention.self.query"),
            "cross_key": _lin(sd, pre + "crossattention.self.key"),
            "cross_value": _lin(sd, pre + "crossattention.self.value"),
            "cross_out": _lin(sd, pre + "crossattention.output.dense"),
            "cross_ln": _ln(sd, pre + "crossattention.output.LayerNorm"),
            "intermediate": _lin(sd, pre + "intermediate.dense"),
            "output": _lin(sd, pre + "output.dense"),
            "output_ln": _ln(sd, pre + "output.LayerNorm"),
        }
    t["transform"] = _lin(sd, "text_decoder.cls.predictions.transform.dense")
    t["transform_ln"] = _ln(sd,
                            "text_decoder.cls.predictions.transform.LayerNorm")
    t["decoder"] = {
        "kernel": np.ascontiguousarray(
            sd["text_decoder.cls.predictions.decoder.weight"].T),
        "bias": sd["text_decoder.cls.predictions.bias"]}
    return p
