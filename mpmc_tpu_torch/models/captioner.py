"""Image captioning stage (port of ``mpmc_tpu/models/captioner.py``).

* :class:`ImageCaptioner` -- a ViT encoder (its whole normalized token
  sequence, projected, is the memory) and a causal decoder with
  cross-attention over it.  The decoder's causal self-attention is plain
  tensor ops with the reference's additive -1e9 mask; its cross-attention
  is :func:`mpmc_tpu_torch.ops.attention.attention_forward` in mode
  ``none``, which launches the CUDA kernel on a CUDA tensor or raises.
  ``generate`` decodes greedily on the device, as the JAX ``lax.scan``
  does: every position reruns the decoder over all ``max_len`` tokens (no
  KV cache) and nothing is read back per token.
* :func:`make_scratch_caption_fn` -- the from-scratch captioner over a
  corpus caption vocab, random weights from a seeded generator, as a
  ``generate_fn`` for :func:`precompute_captions`.  It runs in IEEE f32
  (TF32 off) on any device.  Random weights cannot match across
  frameworks, so its cache tag names this package: a cache directory that
  both packages share never serves one package's captions to the other.
* :func:`precompute_captions` -- one caption per image with a JSON disk
  cache keyed by the paths, the prompt and the generator's tag; without a
  generator the deterministic placeholder ``"a meme of <first 8 hex of
  sha256(path)>"``, in the same cache file the JAX package writes.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mpmc_tpu_torch.models.vit import ViT
from mpmc_tpu_torch.ops.attention import NEG_INF, attention_forward

PROMPT = "a meme of"
LN_EPS = 1e-6                      # flax LayerNorm's default


class DecoderLayer(nn.Module):
    """Pre-LN decoder block: causal self-attention, cross-attention over
    the image memory, then the MLP (exact GELU).  q/k/v and the output
    projections are the JAX module's DenseGeneral layers flattened over
    (heads, head_dim): with ``hidden % heads != 0`` they are ``heads *
    (hidden // heads)`` wide (126 at hidden 128 and 6 heads, D = 21)."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.num_heads = heads
        self.head_dim = hidden // heads
        width = heads * self.head_dim
        self.ln1 = nn.LayerNorm(hidden, LN_EPS)
        self.self_q = nn.Linear(hidden, width)
        self.self_k = nn.Linear(hidden, width)
        self.self_v = nn.Linear(hidden, width)
        self.self_out = nn.Linear(width, hidden)
        self.ln2 = nn.LayerNorm(hidden, LN_EPS)
        self.cross_q = nn.Linear(hidden, width)
        self.cross_k = nn.Linear(hidden, width)
        self.cross_v = nn.Linear(hidden, width)
        self.cross_out = nn.Linear(width, hidden)
        self.ln3 = nn.LayerNorm(hidden, LN_EPS)
        self.mlp1 = nn.Linear(hidden, 4 * hidden)
        self.mlp2 = nn.Linear(4 * hidden, hidden)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.view(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def forward(self, x: torch.Tensor, img_feats: torch.Tensor,
                causal: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        h = self.ln1(x)
        q, k, v = (self._heads(f(h)) for f in (self.self_q, self.self_k,
                                               self.self_v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        scores = scores / math.sqrt(self.head_dim) + causal
        ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
        x = x + self.self_out(ctx.reshape(B, S, -1))
        h = self.ln2(x)
        q = self._heads(self.cross_q(h))
        k = self._heads(self.cross_k(img_feats))
        v = self._heads(self.cross_v(img_feats))
        ctx = attention_forward(q, k, v, None, "none")[0]
        x = x + self.cross_out(ctx.reshape(B, S, -1))
        h = F.gelu(self.mlp1(self.ln3(x)))
        return x + self.mlp2(h)


class CaptionDecoder(nn.Module):
    """Token and learned position embeddings (``pos_embed[:, :S]``),
    ``layers`` decoder blocks under a causal mask, a final LayerNorm and
    the LM head."""

    def __init__(self, vocab_size: int, hidden: int = 384, layers: int = 4,
                 heads: int = 6, max_len: int = 32):
        super().__init__()
        self.num_layers = layers
        self.tok_embed = nn.Embedding(vocab_size, hidden)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, hidden))
        for i in range(layers):
            setattr(self, f"layer_{i}", DecoderLayer(hidden, heads))
        self.ln_final = nn.LayerNorm(hidden, LN_EPS)
        self.lm_head = nn.Linear(hidden, vocab_size)

    def forward(self, token_ids: torch.Tensor,
                img_feats: torch.Tensor) -> torch.Tensor:
        S = token_ids.shape[1]
        x = self.tok_embed(token_ids) + self.pos_embed[:, :S]
        allow = torch.ones(S, S, dtype=torch.bool,
                           device=token_ids.device).tril()
        causal = torch.where(allow, 0.0, NEG_INF).to(x.dtype)[None, None]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, img_feats, causal)
        return self.lm_head(self.ln_final(x))


class ImageCaptioner(nn.Module):
    """ViT encoder + causal decoder.  The decoder keeps its default 6
    heads, as the JAX module builds it (``dec_hidden // 6`` per head)."""

    def __init__(self, vocab_size: int, image_size: int = 224,
                 patch_size: int = 16, enc_hidden: int = 384,
                 enc_layers: int = 4, enc_heads: int = 6,
                 dec_hidden: int = 384, dec_layers: int = 4,
                 max_len: int = 32):
        super().__init__()
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.encoder = ViT(image_size, patch_size=patch_size,
                           hidden_size=enc_hidden, num_layers=enc_layers,
                           num_heads=enc_heads, mlp_dim=4 * enc_hidden)
        self.proj = nn.Linear(enc_hidden, dec_hidden)
        self.decoder = CaptionDecoder(vocab_size, dec_hidden, dec_layers,
                                      max_len=max_len)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """The projected token sequence ``[B, 1 + N, dec_hidden]``."""
        return self.proj(self.encoder(images, return_tokens=True))

    def forward(self, images: torch.Tensor,
                token_ids: torch.Tensor) -> torch.Tensor:
        return self.decoder(token_ids, self.encode_image(images))

    @torch.inference_mode()
    def generate(self, images: torch.Tensor, prompt_ids: torch.Tensor,
                 eos_id: int, pad_id: int = 0) -> torch.Tensor:
        """Greedy decode of ``[B, max_len]`` token ids after the prompt
        ``prompt_ids [B, P]``: at each position 1 .. max_len-1 the decoder
        reruns over all ``max_len`` tokens, the argmax of the previous
        position's logits is written where ``pos >= P`` and the row is not
        finished, and a written ``eos_id`` finishes the row."""
        B, P = prompt_ids.shape
        img = self.encode_image(images)
        tokens = torch.full((B, self.max_len), pad_id, dtype=torch.long,
                            device=images.device)
        tokens[:, :P] = prompt_ids
        finished = torch.zeros(B, dtype=torch.bool, device=images.device)
        for pos in range(1, self.max_len):
            logits = self.decoder(tokens, img)
            nxt = torch.argmax(logits[:, pos - 1], dim=-1)
            write = ~finished if pos >= P else torch.zeros_like(finished)
            tokens[:, pos] = torch.where(write, nxt, tokens[:, pos])
            finished = finished | (write & (nxt == eos_id))
        return tokens


def init_flax_like(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator`` with the flax initializers the JAX
    module's ``init`` uses: LeCun-normal (a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in) for linear and
    conv kernels, normal(0, 1) embeddings, normal(0, 0.02) positions, zero
    biases and class token, unit LayerNorm scales."""
    def lecun(w: torch.Tensor, fan_in: int) -> None:
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ViT):
                mod.cls_token.zero_()
                nn.init.normal_(mod.pos_embed, 0.0, 0.02, generator=generator)
            elif isinstance(mod, CaptionDecoder):
                nn.init.normal_(mod.pos_embed, 0.0, 0.02, generator=generator)
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, 0.0, 1.0, generator=generator)
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                lecun(mod.weight, mod.weight[0].numel())
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)


def make_decode_fn(vocab: Dict[str, int],
                   skip_tokens=("[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]")
                   ) -> Callable:
    """ids -> text through a WordPiece vocab: ``##`` pieces merge into the
    word before them, special tokens are dropped."""
    inv = {i: t for t, i in vocab.items()}
    skip = {vocab[t] for t in skip_tokens if t in vocab}

    def decode(row) -> str:
        words: List[str] = []
        for t in np.asarray(row).tolist():
            t = int(t)
            if t in skip:
                continue
            tok = inv.get(t, "")
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            elif tok:
                words.append(tok)
        return " ".join(words)

    return decode


def make_scratch_caption_fn(corpus_texts: Sequence[str], *,
                            image_size: int = 224, seed: int = 0,
                            prompt: str = PROMPT, max_len: int = 24,
                            device: Optional[torch.device] = None):
    """The from-scratch captioner as a ``generate_fn`` for
    :func:`precompute_captions`: a corpus vocab over the prompt and
    ``corpus_texts`` (4,000 words at most), an :class:`ImageCaptioner`
    (ViT of 2 layers, 128 wide, 4 heads at ``image_size``; decoder of 2
    layers, 128 wide, 6 heads of 21) with random weights from a CPU
    generator seeded with ``seed`` (the same on every device), run on
    ``device`` (CUDA by default), greedy decoding of ``max_len`` tokens,
    decoded to words.  Returns ``(generate_fn, tokenizer)``;
    ``generate_fn(images_u8 [b, H, W, 3])`` gives ``b`` captions, carries
    this package's ``cache_tag`` and its model as ``captioner``."""
    from mpmc_tpu_torch.cli.experiments import corpus_wordpiece_vocab
    from mpmc_tpu_torch.image.augment import eval_preprocess
    from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer
    from mpmc_tpu_torch.train.pretrain_image import ieee_f32

    device = torch.device(device or "cuda")
    vocab = corpus_wordpiece_vocab([prompt] + list(corpus_texts),
                                   max_words=4000)
    tok = WordPieceTokenizer(vocab)
    cap = ImageCaptioner(vocab_size=max(vocab.values()) + 1,
                         image_size=image_size, enc_hidden=128,
                         enc_layers=2, enc_heads=4, dec_hidden=128,
                         dec_layers=2, max_len=max_len)
    init_flax_like(cap, torch.Generator().manual_seed(seed))
    cap = cap.to(device).eval()
    prompt_ids = torch.tensor([tok.tokenize_to_ids(prompt)], device=device)
    decode = make_decode_fn(vocab)

    def generate_fn(images_u8) -> List[str]:
        images = torch.as_tensor(np.ascontiguousarray(images_u8),
                                 device=device)
        with ieee_f32():
            out = cap.generate(eval_preprocess(images),
                               prompt_ids.expand(len(images), -1),
                               eos_id=tok.sep_id)
        return [decode(row) for row in out.cpu().numpy()]

    generate_fn.cache_tag = f"scratch-captioner-torch-{seed}-{image_size}"
    generate_fn.captioner = cap
    return generate_fn, tok


def precompute_captions(img_paths: Sequence[str],
                        images_u8: Optional[np.ndarray] = None, *,
                        cache_dir: Optional[str] = None,
                        prompt: str = PROMPT, batch_size: int = 64,
                        generate_fn: Optional[Callable] = None) -> List[str]:
    """One caption per image path, cached as JSON under ``cache_dir`` with a
    key over the paths, the prompt and the generator's tag (its
    ``cache_tag``, else its name; ``placeholder`` without one).  With
    ``generate_fn`` the images ``images_u8`` are captioned in batches of
    ``batch_size``; without one each path gets the placeholder caption."""
    if generate_fn is not None:
        gen_tag = getattr(generate_fn, "cache_tag",
                          getattr(generate_fn, "__name__", "generate_fn"))
    else:
        gen_tag = "placeholder"
    cache_path = None
    cache = {}
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        key = hashlib.sha256(("\n".join(img_paths) + prompt + "\x00"
                              + gen_tag).encode()).hexdigest()[:16]
        cache_path = os.path.join(cache_dir, f"captions_{key}.json")
        if os.path.exists(cache_path):
            with open(cache_path) as f:
                cache = json.load(f)
            if all(p in cache for p in img_paths):
                return [cache[p] for p in img_paths]
    if generate_fn is not None:
        caps = []
        for s in range(0, len(img_paths), batch_size):
            caps.extend(generate_fn(images_u8[s:s + batch_size]))
    else:
        caps = [f"{prompt} {hashlib.sha256(p.encode()).hexdigest()[:8]}"
                for p in img_paths]
    if cache_path:
        cache.update(dict(zip(img_paths, caps)))
        with open(cache_path, "w") as f:
            json.dump(cache, f)
    return caps
