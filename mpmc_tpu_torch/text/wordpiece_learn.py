"""Corpus WordPiece vocabulary learner (copy of
``mpmc_tpu/text/wordpiece_learn.py``; pure Python).

The default corpus vocab (``cli.experiments.corpus_wordpiece_vocab``) is
whole words plus a single-character fallback.  This module learns a subword
vocabulary instead: frequency-weighted BPE merges over the corpus word
counts, written in WordPiece surface form (the first piece plain, the
continuations ``##``-prefixed), so the greedy longest-match
``text.wordpiece.WordPieceTokenizer`` reads the learned vocab unchanged.
For the same texts it gives the JAX package's vocab dict, piece for piece
and id for id.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

log = logging.getLogger(__name__)

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def _word_counts(texts: Sequence[str]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for t in texts:
        for w in t.split():
            counts[w] = counts.get(w, 0) + 1
    return counts


def learn_wordpiece_vocab(texts: Sequence[str], vocab_size: int = 8000,
                          min_pair_freq: int = 2) -> Dict[str, int]:
    """Learn a WordPiece vocab of ≤ ``vocab_size`` entries from raw texts.

    Standard BPE: start from characters (continuations carry the ``##``
    prefix), repeatedly merge the most frequent adjacent symbol pair
    (frequency = sum of containing-word counts) until the vocab budget is
    reached or no pair clears ``min_pair_freq``.  A merge of ``(a, ##b)``
    yields ``a+b`` (plain if ``a`` is word-initial, ``##a+b`` otherwise) —
    the WordPiece surface convention, so greedy longest-match re-derives
    the merges at encode time.
    """
    counts = _word_counts(texts)
    # word → current symbol sequence
    seqs: Dict[str, List[str]] = {
        w: [w[0]] + ["##" + c for c in w[1:]] for w in counts if w}
    base = sorted({s for seq in seqs.values() for s in seq})
    vocab_list: List[str] = list(SPECIALS) + base
    budget = max(vocab_size - len(vocab_list), 0)
    known = set(vocab_list)

    # Incremental pair bookkeeping (recounting everything per merge is
    # O(vocab_size × corpus symbols): hours at --corpus-vocab-size 30000).
    # Maintain global pair frequencies plus an inverted index
    # pair → words containing it; each merge touches only those words.
    pair_freq: Dict[Tuple[str, str], int] = {}
    pair_words: Dict[Tuple[str, str], set] = {}

    def _count(seq: List[str], w: str, c: int, sign: int) -> None:
        for p in zip(seq, seq[1:]):
            f = pair_freq.get(p, 0) + sign * c
            if f > 0:
                pair_freq[p] = f
                if sign > 0:
                    pair_words.setdefault(p, set()).add(w)
                else:
                    # Drop w from the inverted index even when p survives
                    # globally: a merge may have removed p from THIS word,
                    # and a stale entry would make a later merge of p rescan
                    # w for nothing.  The following +1 pass over the word's
                    # new seq re-adds w iff it still contains p.
                    s = pair_words.get(p)
                    if s is not None:
                        s.discard(w)
            else:
                pair_freq.pop(p, None)
                pair_words.pop(p, None)

    for w, seq in seqs.items():
        _count(seq, w, counts[w], +1)

    for _ in range(budget):
        if not pair_freq:
            break
        # deterministic: max by (freq, pair) so ties break lexically
        (a, b), best = max(pair_freq.items(), key=lambda kv: (kv[1], kv[0]))
        if best < min_pair_freq:
            break
        merged = a + b[2:] if b.startswith("##") else a + b
        for w in list(pair_words.get((a, b), ())):
            seq, c = seqs[w], counts[w]
            _count(seq, w, c, -1)
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
            _count(out, w, c, +1)
        # the merged pair must be gone (guards index-staleness bugs)
        pair_freq.pop((a, b), None)
        pair_words.pop((a, b), None)
        if merged not in known:
            vocab_list.append(merged)
            known.add(merged)

    log.info("learned WordPiece vocab: %d pieces (%d base chars, "
             "%d merges) from %d words",
             len(vocab_list), len(base),
             len(vocab_list) - len(base) - len(SPECIALS), len(counts))
    return {t: i for i, t in enumerate(vocab_list)}
