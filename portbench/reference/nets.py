"""Plain float32 forward passes of the benchmark's models, written from the
published descriptions with ``torch`` operations only.

Every function reads its weights from one flat dict ``W`` keyed by
parameter name (the names the benchmark's weight generator gives,
``portbench/weights.py``), so the same tensors feed this reference and
the system under test.  Nothing here imports the system.

* BERT and RoBERTa encoders: post-LN, exact GELU, learned absolute
  positions (RoBERTa's start at ``pad_token_id + 1`` and count only real
  tokens), attention over each sequence's own tokens.
* ResNet-18 (torchvision's layout) and ViT-B/16 (pre-LN at 1e-6, a class
  token, learned positions).
* BatchNorm as flax computes it: the batch statistics of a training step
  are ``E[x]`` and ``max(E[x^2] - E[x]^2, 0)`` over every axis but the
  features; eval mode uses the running statistics.
* Dropout where the system applies it (each encoder's embeddings, its
  attention block's and its FFN's output before the residual; a model
  kind's own, in its head), with the keep masks the system drew
  (``drop``: by the system's module name, in this layout), each kept
  element scaled by ``1 / (1 - rate)``.  Without a mask a dropout is the
  identity.

These are the blocks; each model kind (``portbench/kinds/``) composes its
model's logits from them and its head.

``Precision`` says how the products and activations round: float32
throughout for the reference; for the control, the precision below the
system's bfloat16: every operand of a matrix product or convolution and
every activation in float8 e4m3, each tensor with its own scale.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _through(t: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded`` forward, the gradient straight through to ``t``."""
    return t + (rounded - t.detach())


class Precision:
    """``q(t)`` (a product's operand) and ``a(t)`` (any other activation):
    ``t`` itself, or with ``fp8`` rounded to float8 e4m3 after scaling its
    largest magnitude to 448, and scaled back; the gradient passes
    straight through.  ``record``, when a dict, receives each
    training-mode BatchNorm's batch mean and variance by name."""

    FP8_MAX = 448.0

    def __init__(self, fp8: bool = False, record: Optional[dict] = None):
        self.fp8, self.record = fp8, record

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        amax = t.detach().abs().max().clamp(min=1e-30)
        scale = amax / self.FP8_MAX
        return _through(t, (t.detach() / scale).to(torch.float8_e4m3fn).to(
            t.dtype) * scale)

    a = q


F32 = Precision()
CONTROL = Precision(fp8=True)


def linear(W: Weights, name: str, x: torch.Tensor, P: Precision
           ) -> torch.Tensor:
    y = torch.matmul(P.q(x), P.q(W[name + ".weight"]).t())
    bias = W.get(name + ".bias")
    return P.a(y if bias is None else y + bias)


def dropout(x: torch.Tensor, drop: Optional[dict], name: str, rate: float
            ) -> torch.Tensor:
    keep = None if drop is None else drop.get(name)
    if keep is None or rate == 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def layer_norm(W: Weights, name: str, x: torch.Tensor, eps: float,
               P: Precision) -> torch.Tensor:
    return P.a(F.layer_norm(x, (x.shape[-1],), W[name + ".weight"],
                            W[name + ".bias"], eps))


def batch_norm(W: Weights, name: str, x: torch.Tensor, training: bool,
               P: Precision, eps: float = 1e-5) -> torch.Tensor:
    """Normalizes dim 1 of ``[B, F]`` or NCHW as flax's BatchNorm does."""
    axes = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if training:
        mean = x.mean(dim=axes)
        var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
        if P.record is not None:
            P.record[name] = (mean.detach(), var.detach())
    else:
        mean, var = W[name + ".running_mean"], W[name + ".running_var"]
    inv = torch.rsqrt(var + eps) * W[name + ".weight"]
    return P.a((x - mean.view(shape)) * inv.view(shape)
               + W[name + ".bias"].view(shape))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_mask: Optional[torch.Tensor], P: Precision) -> torch.Tensor:
    """``[B, S, H, D]`` softmax attention; ``key_mask [B, S]`` (1 = a real
    token) removes the padding from every query's keys."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", P.q(q), P.q(k)) / math.sqrt(d)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask.bool()[:, None, None, :],
                                    float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return P.a(torch.einsum("bhqk,bkhd->bqhd", P.q(probs), P.q(v)))


def text_encoder(W: Weights, p: str, cfg: dict, ids: torch.Tensor,
                 mask: torch.Tensor, P: Precision,
                 drop: Optional[dict] = None) -> torch.Tensor:
    """BERT (``position_offset`` "bert") or RoBERTa ("roberta") encoder of
    right-padded ``ids [B, S]``; returns the last hidden states."""
    B, S = ids.shape
    H = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    if cfg["position_offset"] == "roberta":
        m = mask.long()
        positions = torch.cumsum(m, dim=1) * m + cfg["pad_token_id"]
    else:
        positions = torch.arange(S, device=ids.device).expand(B, S)
    x = W[p + "word_embeddings.weight"][ids.long()]
    x = x + W[p + "position_embeddings.weight"][positions]
    if cfg["type_vocab_size"] > 0:
        x = x + W[p + "token_type_embeddings.weight"][0]
    hid, att = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]
    x = dropout(layer_norm(W, p + "embeddings_ln", P.a(x), eps, P), drop,
                p + "embed_dropout", hid)
    shape = (B, S, heads, H // heads)
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{p}layer_{i}."
        q = linear(W, lp + "attention.query", x, P).view(shape)
        k = linear(W, lp + "attention.key", x, P).view(shape)
        v = linear(W, lp + "attention.value", x, P).view(shape)
        ctx = attention(q, k, v, mask, P).reshape(B, S, H)
        out = dropout(linear(W, lp + "attention.out", ctx, P), drop,
                      lp + "attention.dropout", att)
        x = layer_norm(W, lp + "attention_ln", P.a(x + out), eps, P)
        h = P.a(F.gelu(linear(W, lp + "intermediate", x, P)))
        out = dropout(linear(W, lp + "output", h, P), drop, lp + "dropout",
                      hid)
        x = layer_norm(W, lp + "output_ln", P.a(x + out), eps, P)
    return x


def conv(W: Weights, name: str, x: torch.Tensor, stride: int, padding: int,
         P: Precision) -> torch.Tensor:
    return P.a(F.conv2d(P.q(x), P.q(W[name + ".weight"]),
                        W.get(name + ".bias"), stride=stride,
                        padding=padding))


def resnet18(W: Weights, p: str, x: torch.Tensor, training: bool,
             P: Precision) -> torch.Tensor:
    """Pooled ``[B, 512]`` features of NHWC ``x``."""
    y = x.permute(0, 3, 1, 2)
    y = F.relu(batch_norm(W, p + "stem_bn", conv(W, p + "stem_conv", y, 2, 3,
                                                  P), training, P))
    y = F.max_pool2d(y, 3, 2, 1)
    ch = 64
    for si, width in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            stride = 2 if (bi == 0 and si > 0) else 1
            bp = f"{p}stage{si}_block{bi}."
            h = F.relu(batch_norm(W, bp + "bn1", conv(W, bp + "conv1", y,
                                                      stride, 1, P), training,
                                  P))
            h = batch_norm(W, bp + "bn2", conv(W, bp + "conv2", h, 1, 1, P),
                           training, P)
            if stride != 1 or ch != width:
                res = batch_norm(W, bp + "downsample_bn",
                                 conv(W, bp + "downsample_conv", y, stride, 0,
                                      P), training, P)
            else:
                res = y
            y = P.a(F.relu(h + res))
            ch = width
    return y.mean(dim=(2, 3))


def vit(W: Weights, p: str, cfg: dict, x: torch.Tensor, P: Precision
        ) -> torch.Tensor:
    """The class token's ``[B, hidden]`` features of NHWC ``x``."""
    H = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    patch = cfg["patch_size"]
    y = conv(W, p + "patch_embed", x.permute(0, 3, 1, 2), patch, 0, P)
    y = y.flatten(2).transpose(1, 2)
    B, N, _ = y.shape
    y = torch.cat([W[p + "cls_token"].expand(B, 1, H), y], dim=1)
    y = P.a(y + W[p + "pos_embed"])
    S = N + 1
    shape = (B, S, heads, H // heads)
    for i in range(cfg["num_hidden_layers"]):
        lp = f"{p}layer_{i}."
        h = layer_norm(W, lp + "ln1", y, eps, P)
        ctx = attention(linear(W, lp + "q", h, P).view(shape),
                        linear(W, lp + "k", h, P).view(shape),
                        linear(W, lp + "v", h, P).view(shape), None, P)
        y = P.a(y + linear(W, lp + "out", ctx.reshape(B, S, H), P))
        h = layer_norm(W, lp + "ln2", y, eps, P)
        y = P.a(y + linear(W, lp + "mlp2",
                           P.a(F.gelu(linear(W, lp + "mlp1", h, P))), P))
    return layer_norm(W, p + "ln_final", y[:, 0], eps, P)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC to ImageNet-normalized float32 (the eval transform)."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    return (images_u8.to(torch.float32) / 255.0 - mean) / std
