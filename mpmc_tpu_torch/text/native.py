"""Python wrapper over the C++ batch WordPiece tokenizer (port of
``mpmc_tpu/text/native.py`` over the port's own build of
``native/tokenizer.cpp``).

Same ``encode_batch`` surface as ``WordPieceTokenizer`` (the pure-Python
oracle), so ``BatchTokenizer`` accepts either backend; parity is pinned by
tests/test_torch_native.py.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from mpmc_tpu_torch import native_lib


class NativeWordPieceTokenizer:
    def __init__(self, vocab_path: str, do_lower_case: bool = False,
                 num_threads: int = 8, strip_accents=None):
        lib = native_lib.load("tokenizer")
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        # Case folding + accent stripping are character-local, so they are
        # applied up front in the wrapper with full-Unicode semantics
        # (str.lower + NFD-drop-Mn, matching HF BertTokenizer / the Python
        # oracle): the C++ path's own lowering is ASCII-only and would
        # diverge on non-ASCII uncased vocabs.  The C++ core always runs
        # case-preserving.
        self.do_lower_case = do_lower_case
        self.strip_accents = (do_lower_case if strip_accents is None
                              else strip_accents)
        self._handle = lib.wp_create(vocab_path.encode(), 0)
        if not self._handle:
            raise ValueError(f"failed to load vocab {vocab_path} "
                             "(must contain [CLS]/[SEP]/[PAD]/[UNK])")
        self.num_threads = num_threads

    def _normalize(self, text: str) -> str:
        import unicodedata
        if self.do_lower_case:
            text = text.lower()
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        return text

    @staticmethod
    def available() -> bool:
        return native_lib.load("tokenizer") is not None

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.wp_destroy(self._handle)
        except Exception:
            pass

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(texts)
        ids = np.empty((n, max_length), dtype=np.int32)
        mask = np.empty((n, max_length), dtype=np.int32)
        if n == 0:
            return ids, mask
        if self.do_lower_case or self.strip_accents:
            texts = [self._normalize(t) for t in texts]
        encoded = [t.encode("utf-8") for t in texts]
        arr = (ctypes.c_char_p * n)(*encoded)
        self._lib.wp_encode_batch(
            self._handle, arr, n, max_length,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.num_threads)
        return ids, mask

    def encode(self, text: str, max_length: int):
        ids, mask = self.encode_batch([text], max_length)
        return ids[0], mask[0]
