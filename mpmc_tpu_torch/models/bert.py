"""BERT-family text encoder (port of ``mpmc_tpu/models/bert.py``).

Post-LayerNorm transformer encoder with learned absolute positions; the
attention core is :func:`mpmc_tpu_torch.ops.attention.dot_product_attention`
(the CUDA kernel on the card).  Module and parameter names follow the JAX
package's tree (``word_embeddings``, ``layer_{i}.attention.query`` ...) so
``models/convert.py`` maps one onto the other by name.  Dropout follows
the JAX package: after the embedding LayerNorm and after each attention
and FFN output (``hidden_dropout``, ``attention_dropout``), active only in
training mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.config import TextEncoderConfig
from mpmc_tpu_torch.models.norm import Dropout
from mpmc_tpu_torch.ops.attention import dot_product_attention
from mpmc_tpu_torch.parallel.collectives import copy_to_group, row_parallel


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        width = self.num_heads * self.head_dim
        self.query = nn.Linear(cfg.hidden_size, width)
        self.key = nn.Linear(cfg.hidden_size, width)
        self.value = nn.Linear(cfg.hidden_size, width)
        self.out = nn.Linear(width, cfg.hidden_size)
        self.dropout = Dropout(cfg.attention_dropout)
        # A sequence-parallel impl ("ring" or "ulysses") and its process
        # group (parallel/sp.py), else the plain attention.
        self.impl, self.group = "auto", None
        # Tensor parallelism (parallel/tp.py): the process group over which
        # the heads are split; this rank holds num_heads of them.
        self.tp = None

    def forward(self, x, mask, segments=None):
        B, S, _ = x.shape
        shape = (B, S, self.num_heads, self.head_dim)
        if self.tp is not None:
            x = copy_to_group(x, self.tp)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        ctx = dot_product_attention(q, k, v, mask, segments=segments,
                                    impl=self.impl, group=self.group)
        return self.dropout(row_parallel(self.out, ctx.reshape(B, S, -1),
                                         self.tp))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.gelu_approx = "tanh" if cfg.gelu_approx else "none"
        self.attention = MultiHeadSelfAttention(cfg)
        self.attention_ln = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.output_ln = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout)
        self.tp = None              # the MLP's tensor-parallel group

    def forward(self, x, mask, segments=None):
        # Post-LN (BERT-style): sublayer, residual, LayerNorm.
        x = self.attention_ln(x + self.attention(x, mask, segments))
        h = x if self.tp is None else copy_to_group(x, self.tp)
        h = F.gelu(self.intermediate(h), approximate=self.gelu_approx)
        return self.output_ln(x + self.dropout(row_parallel(self.output, h,
                                                            self.tp)))


class TextEncoder(nn.Module):
    """Returns last_hidden_state ``[B, S, H]`` (and the pooler output on
    request)."""

    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                      cfg.hidden_size)
        self.embeddings_ln = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.embed_dropout = Dropout(cfg.hidden_dropout)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", EncoderLayer(cfg))
        # Kept so checkpoints carry it; computed only when asked for.
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def embed(self, input_ids, attention_mask,
              token_type_ids: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None):
        """word + position (+ type) embeddings, LayerNorm, dropout.

        ``positions`` overrides the position ids with 0-based per-sample
        offsets (sequence packing); the RoBERTa offset applies on top."""
        c = self.cfg
        B, S = input_ids.shape
        if positions is not None:
            if c.roberta_style_positions:
                positions = positions + (c.pad_token_id + 1)
        elif c.roberta_style_positions:
            # RoBERTa: positions count non-pad tokens, offset by pad_id+1.
            m = attention_mask.long()
            positions = torch.cumsum(m, dim=1) * m + c.pad_token_id
        else:
            positions = torch.arange(S, device=input_ids.device).expand(B, S)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions.long()))
        if c.type_vocab_size > 0:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids)
        return self.embed_dropout(self.embeddings_ln(x))

    def forward(self, input_ids, attention_mask,
                token_type_ids: Optional[torch.Tensor] = None,
                return_pooled: bool = False,
                segments: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None):
        x = self.embed(input_ids, attention_mask, token_type_ids, positions)
        mask = attention_mask.to(torch.float32)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, segments)
        if return_pooled:
            return x, torch.tanh(self.pooler(x[:, 0]))
        return x
