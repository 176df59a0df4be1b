"""Byte-level BPE tokenizer (GPT-2/RoBERTa family), pure Python (port of
``mpmc_tpu/text/bpe.py``).

The reference's caption branch tokenizes BLIP captions with
``AutoTokenizer.from_pretrained("roberta-base")`` (reference
``Multimodal_example_task2C.py:219,283-289``).  This is the first-party
equivalent: GPT-2 byte→unicode mapping, GPT-2 regex pre-tokenization, ranked
merge loop, and RoBERTa ``<s> ... </s>`` framing with pad-id 1.

Files: standard HF ``vocab.json`` (token→id) + ``merges.txt`` (one merge per
line, highest priority first).
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

# GPT-2's pre-tokenization pattern (contractions, letter runs, digit runs,
# symbol runs, whitespace runs).
_PRETOK_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ByteLevelBPETokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 bos_token: str = "<s>", eos_token: str = "</s>",
                 pad_token: str = "<pad>", unk_token: str = "<unk>"):
        self.vocab = vocab
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_map = bytes_to_unicode()
        self.bos_id = vocab[bos_token]
        self.eos_id = vocab[eos_token]
        self.pad_id = vocab[pad_token]
        self.unk_id = vocab.get(unk_token, 0)
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str, **kw
                   ) -> "ByteLevelBPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            a, b = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == b:
                    new_word.append(a + b)
                    i = j + 2
                else:
                    new_word.append(word[j])
                    i = j + 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize_to_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in _PRETOK_RE.findall(text):
            mapped = "".join(self.byte_map[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.vocab.get(piece, self.unk_id))
        return ids

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        body = self.tokenize_to_ids(text)[: max_length - 2]
        ids = [self.bos_id] + body + [self.eos_id]
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
