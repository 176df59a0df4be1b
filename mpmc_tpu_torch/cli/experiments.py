"""Host-side text preparation shared by the port's entry points (copy of
the serving half of ``mpmc_tpu/cli/experiments.py``): corpus vocabulary,
tokenization and sequence-length bucketing."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from mpmc_tpu_torch.io.manifest import Manifest
from mpmc_tpu_torch.text.normalize import preprocess_arabic_tweet
from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer


def corpus_wordpiece_vocab(texts, max_words: int = 30000) -> Dict[str, int]:
    """Corpus-derived WordPiece vocab for runs without a pretrained vocab
    file: whole words by frequency, then ``##`` and bare character pieces."""
    words: Dict[str, int] = {}
    for t in texts:
        for w in t.split():
            words[w] = words.get(w, 0) + 1
    top = sorted(words, key=words.get, reverse=True)[:max_words]
    chars = sorted({c for w in top for c in w})
    tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + top
              + ["##" + c for c in chars] + chars)
    return {t: i for i, t in enumerate(dict.fromkeys(tokens))}


def build_tokenizer(texts, vocab_path: Optional[str]) -> WordPieceTokenizer:
    """The vocab file when one exists, else a corpus vocab over ``texts``."""
    if vocab_path and os.path.exists(vocab_path):
        return WordPieceTokenizer.from_file(vocab_path)
    return WordPieceTokenizer(corpus_wordpiece_vocab(texts))


def prepare_text(manifest: Manifest, tok: WordPieceTokenizer, max_len: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    texts = [preprocess_arabic_tweet(t) for t in manifest.texts]
    return tok.encode_batch(texts, max_len)


def bucket_seq_len(masks, multiple: int, cap: int) -> int:
    """Shortest padded length covering every real token across the given
    attention masks, rounded up to ``multiple``, capped at ``cap``.
    Trimming trailing all-PAD columns is exact for CLS pooling: padded keys
    are masked out and padded queries are never read."""
    longest = 0
    for m in masks:
        if m is not None and m.size:
            longest = max(longest, int(np.max(np.sum(m, axis=-1))))
    length = max(multiple, ((longest + multiple - 1) // multiple) * multiple)
    return min(cap, length)


def bucket_trim(data: Dict[str, np.ndarray], ids_key: str, mask_key: str,
                length: int) -> None:
    """In-place trim of one (ids, mask) pair to ``length`` columns."""
    data[ids_key] = np.ascontiguousarray(data[ids_key][:, :length])
    data[mask_key] = np.ascontiguousarray(data[mask_key][:, :length])
