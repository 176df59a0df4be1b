"""BERT-style WordPiece tokenizer, pure Python (copy of
``mpmc_tpu/text/wordpiece.py``): a basic tokenizer (unicode cleanup,
whitespace and punctuation splitting, optional lowercasing and accent
stripping, CJK isolation) followed by greedy longest-match WordPiece with
``##`` continuation pieces.  Vocabulary format: one token per line.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII symbol blocks count as punctuation (BERT convention).
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """Unicode cleanup + whitespace/punctuation/CJK splitting."""

    def __init__(self, do_lower_case: bool = False,
                 strip_accents: Optional[bool] = None):
        self.do_lower_case = do_lower_case
        # HF semantics: strip_accents defaults to the value of do_lower_case.
        self.strip_accents = (do_lower_case if strip_accents is None
                              else strip_accents)

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
            if self.strip_accents:
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return tokens

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces if p]


class WordPieceTokenizer:
    """Greedy longest-match WordPiece with BERT special-token framing."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = False,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 max_chars_per_word: int = 100,
                 strip_accents: Optional[bool] = None):
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case, strip_accents)
        self.unk_token = unk_token
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.unk_id = vocab[unk_token]
        self.max_chars_per_word = max_chars_per_word

    @classmethod
    def from_file(cls, vocab_path: str, **kw) -> "WordPieceTokenizer":
        return cls(load_vocab(vocab_path), **kw)

    def save(self, vocab_path: str) -> None:
        """Write the vocab one token per line (line index = id), the file
        :meth:`from_file` reads."""
        items = sorted(self.vocab.items(), key=lambda kv: kv[1])
        for i, (_, vid) in enumerate(items):
            if i != vid:
                raise ValueError("vocab ids must be contiguous to save")
        with open(vocab_path, "w", encoding="utf-8") as f:
            f.write("\n".join(tok for tok, _ in items) + "\n")

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def tokenize_to_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self.basic.tokenize(text):
            ids.extend(self._wordpiece(word))
        return ids

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """[CLS] ids [SEP] framing, truncation + padding to ``max_length``
        (mirrors the reference's ``encode_plus(..., max_length=512,
        padding='max_length', truncation=True)`` calls)."""
        body = self.tokenize_to_ids(text)[: max_length - 2]
        ids = [self.cls_id] + body + [self.sep_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids.extend([self.pad_id] * pad)
        mask.extend([0] * pad)
        return (np.asarray(ids, dtype=np.int32),
                np.asarray(mask, dtype=np.int32))

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.empty((len(texts), max_length), dtype=np.int32)
        mask = np.empty((len(texts), max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t, max_length)
        return ids, mask
