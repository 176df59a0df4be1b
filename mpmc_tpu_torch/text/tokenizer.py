"""Unified batch tokenization front-end (port of
``mpmc_tpu/text/tokenizer.py``, the host side of the input pipeline).

Wraps the WordPiece / byte-BPE implementations (and, when built, the C++
batch tokenizer from ``native/tokenizer.cpp``) behind one API that emits the
fixed-shape int32 ``[B, L]`` id/mask arrays the model consumes —
replacing the reference's per-sample ``tokenizer.encode_plus`` calls inside
``Dataset.__getitem__`` (``Multimodal_example_task2C.py:273-289``), which
re-tokenize every epoch.  Here tokenization is a one-time pass, cached in
memory, with the arrays sliced per batch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class TokenizedBatch:
    ids: np.ndarray    # int32 [B, L]
    mask: np.ndarray   # int32 [B, L]


class BatchTokenizer:
    """Tokenize a full split once; serve fixed-shape batches.

    ``backend`` is any object with ``encode_batch(texts, max_length) ->
    (ids, mask)`` — WordPieceTokenizer, ByteLevelBPETokenizer, or the ctypes
    wrapper over the C++ tokenizer (mpmc_tpu_torch.text.native).
    """

    def __init__(self, backend, max_length: int,
                 normalizer: Optional[Callable[[str], str]] = None,
                 cache_dir: Optional[str] = None,
                 cache_salt: str = ""):
        self.backend = backend
        self.max_length = max_length
        self.normalizer = normalizer
        self.cache_dir = cache_dir
        # MUST identify the vocab: the same text corpus tokenized under two
        # different vocabs yields different ids, and a salt-less cache
        # silently serves one vocab's ids to the other — out-of-range ids
        # that turn the whole downstream model non-finite (found the hard
        # way: a 2A-vocab cache entry poisoned a 2C run's MLM stage).
        self.cache_salt = cache_salt

    def _cache_key(self, texts: Sequence[str]) -> str:
        h = hashlib.sha256()
        h.update(str(self.max_length).encode())
        h.update(type(self.backend).__name__.encode())
        h.update(self.cache_salt.encode())
        if self.normalizer is not None:
            h.update(getattr(self.normalizer, "__name__", "norm").encode())
        for t in texts:
            h.update(t.encode("utf-8", "replace"))
            h.update(b"\x00")
        return h.hexdigest()[:24]

    def __call__(self, texts: Sequence[str]) -> TokenizedBatch:
        if self.cache_dir:
            key = self._cache_key(texts)
            path = os.path.join(self.cache_dir, f"tok_{key}.npz")
            if os.path.exists(path):
                z = np.load(path)
                return TokenizedBatch(z["ids"], z["mask"])
        if self.normalizer is not None:
            texts = [self.normalizer(t) for t in texts]
        ids, mask = self.backend.encode_batch(list(texts), self.max_length)
        batch = TokenizedBatch(ids.astype(np.int32), mask.astype(np.int32))
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            # Written whole, then renamed: a concurrent reader of the same
            # key never sees a partial file.
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.savez(f, ids=batch.ids, mask=batch.mask)
            os.replace(tmp, path)
        return batch


class HybridWordPieceTokenizer:
    """Python-held vocab with the C++ batch tokenizer on the encode path.

    The drivers need the Python-side surface (``vocab`` for encoder sizing,
    ``save`` for predict-time vocab persistence) AND the GIL-free
    multi-threaded C++ encoder (``native/tokenizer.cpp``) for the actual
    corpus pass — this class is both: the WordPiece vocab is loaded in
    Python, ``encode_batch`` delegates to ``NativeWordPieceTokenizer``
    through the ``BatchTokenizer`` npz disk cache.  Token-id parity between
    the two backends is pinned by tests/test_torch_native.py.
    """

    def __init__(self, vocab, vocab_path: str,
                 cache_dir: Optional[str] = None,
                 do_lower_case: bool = False):
        from mpmc_tpu_torch.text.native import NativeWordPieceTokenizer
        from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer
        self._py = WordPieceTokenizer(vocab, do_lower_case=do_lower_case)
        self._native = NativeWordPieceTokenizer(
            vocab_path, do_lower_case=do_lower_case)
        self._cache_dir = cache_dir
        # Vocab fingerprint for the npz cache key (see BatchTokenizer
        # cache_salt): entries from a different vocab must never be served.
        self._vocab_sig = hashlib.sha256(
            "\n".join(f"{t}\t{i}" for t, i in sorted(vocab.items(),
                                                     key=lambda kv: kv[1])
                      ).encode("utf-8")).hexdigest()[:16]
        self.backend_name = "native-c++"

    @property
    def vocab(self):
        return self._py.vocab

    def save(self, vocab_path: str) -> None:
        self._py.save(vocab_path)

    def encode(self, text: str, max_length: int):
        ids, mask = self.encode_batch([text], max_length)
        return ids[0], mask[0]

    def encode_batch(self, texts: Sequence[str], max_length: int):
        bt = BatchTokenizer(self._native, max_length,
                            cache_dir=self._cache_dir,
                            cache_salt=self._vocab_sig)
        out = bt(list(texts))
        return out.ids, out.mask
