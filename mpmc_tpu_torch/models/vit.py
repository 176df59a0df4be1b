"""Vision Transformer encoders and the 2B zoo's ``BinaryHead`` (port of
``mpmc_tpu/models/vit.py``).

ViT-B/16, ViT-B/32 and ViT-L/16: the patch embedding is a strided
convolution, then a class token and learned positions, pre-LN encoder
layers (LayerNorm at epsilon 1e-6, exact GELU) whose attention core is
:func:`mpmc_tpu_torch.ops.attention.dot_product_attention` in mode ``none``
(the CUDA kernels on the card, never SDPA), a final LayerNorm and the class
token's features.  The positions depend on the number of patches, so the
module is built for one ``image_size``: ``1 + (image_size // patch)**2``
tokens, 197 for 16-pixel patches at 224 and 577 at 384.  Images arrive in
the JAX package's ``[B, H, W, C]`` layout, as for the ResNets.  The JAX
module's dropout is 0 wherever the factory builds it, so there is none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.ops.attention import dot_product_attention
from mpmc_tpu_torch.parallel.collectives import copy_to_group, row_parallel


class ViTEncoderLayer(nn.Module):
    """Pre-LN block: ``x + out(attn(ln1(x)))``, then ``x + mlp2(gelu(mlp1(
    ln2(x))))``; q, k, v and out are the JAX module's DenseGeneral layers
    flattened over (heads, head_dim)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 ln_eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        width = num_heads * self.head_dim
        self.ln1 = nn.LayerNorm(hidden_size, ln_eps)
        self.q = nn.Linear(hidden_size, width)
        self.k = nn.Linear(hidden_size, width)
        self.v = nn.Linear(hidden_size, width)
        self.out = nn.Linear(width, hidden_size)
        self.ln2 = nn.LayerNorm(hidden_size, ln_eps)
        self.mlp1 = nn.Linear(hidden_size, mlp_dim)
        self.mlp2 = nn.Linear(mlp_dim, hidden_size)
        # Tensor parallelism (parallel/tp.py): the group over which the
        # heads and the MLP's hidden units are split.
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        shape = (B, S, self.num_heads, self.head_dim)
        h = self.ln1(x)
        if self.tp is not None:
            h = copy_to_group(h, self.tp)
        ctx = dot_product_attention(self.q(h).view(shape),
                                    self.k(h).view(shape),
                                    self.v(h).view(shape))
        x = x + row_parallel(self.out, ctx.reshape(B, S, -1), self.tp)
        h = self.ln2(x)
        if self.tp is not None:
            h = copy_to_group(h, self.tp)
        return x + row_parallel(self.mlp2, F.gelu(self.mlp1(h)), self.tp)


class ViT(nn.Module):
    """Returns the class token's features ``[B, hidden_size]`` after the
    final LayerNorm, or with ``num_classes`` the ``classifier`` logits;
    ``return_tokens=True`` returns the whole normalized token sequence
    ``[B, 1 + N, hidden_size]`` (class token, then the patches), a caption
    decoder's cross-attention memory."""

    def __init__(self, image_size: int, patch_size: int = 16,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 num_classes: int = 0, in_channels: int = 3,
                 ln_eps: float = 1e-6):
        super().__init__()
        self.feature_dim = hidden_size
        self.num_layers = num_layers
        self.patch_embed = nn.Conv2d(in_channels, hidden_size, patch_size,
                                     patch_size)
        tokens = 1 + (image_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden_size))
        for i in range(num_layers):
            setattr(self, f"layer_{i}", ViTEncoderLayer(
                hidden_size, num_heads, mlp_dim, ln_eps))
        self.ln_final = nn.LayerNorm(hidden_size, ln_eps)
        self.classifier = (nn.Linear(hidden_size, num_classes)
                           if num_classes else None)

    def forward(self, x: torch.Tensor,
                return_tokens: bool = False) -> torch.Tensor:
        y = self.patch_embed(x.permute(0, 3, 1, 2))   # [B, hidden, h, w]
        y = y.flatten(2).transpose(1, 2)              # patches in row order
        B, _, width = y.shape
        y = torch.cat([self.cls_token.expand(B, 1, width), y], dim=1)
        y = y + self.pos_embed
        for i in range(self.num_layers):
            y = getattr(self, f"layer_{i}")(y)
        if return_tokens:
            return self.ln_final(y)
        feats = self.ln_final(y[:, 0])                # LayerNorm is per token
        return self.classifier(feats) if self.classifier is not None else feats


class BinaryHead(nn.Module):
    """l2-normalize the features (1e-12 inside the square root), then a
    Linear named ``fc`` (the JAX head's scale, 1 wherever it is built, is
    left out)."""

    def __init__(self, in_features: int, num_classes: int = 2):
        super().__init__()
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(feats ** 2, dim=-1, keepdim=True) + 1e-12)
        return self.fc(feats / norm)
