"""The port's corpus vocabularies (mpmc_tpu_torch) against the JAX package:
the BPE learner's vocab dict piece for piece and id for id, and
``build_tokenizer``'s token ids in the ``words`` and ``subword`` modes
(the JAX side fronts its vocab with the C++ tokenizer when that is built;
the ids must be equal either way), on a seeded synthetic Arabic corpus."""

import dataclasses

import numpy as np
import pytest

from mpmc_tpu.cli.experiments import build_tokenizer as j_build_tokenizer
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.text.wordpiece_learn import SPECIALS as J_SPECIALS
from mpmc_tpu.text.wordpiece_learn import \
    learn_wordpiece_vocab as j_learn_wordpiece_vocab
from mpmc_tpu_torch.cli.experiments import build_tokenizer
from mpmc_tpu_torch.config import DataConfig, TrainConfig
from mpmc_tpu_torch.text.wordpiece_learn import (SPECIALS,
                                                 learn_wordpiece_vocab)

LETTERS = "ابتثجحخدذرزسشصضطظعغفقكلمنهوي"


def _corpus(seed: int, n: int = 120):
    """Texts of 3 to 14 words drawn from a 300-word pool with a Zipf-like
    frequency (stems shared between words, so merges have pairs to find)."""
    rng = np.random.default_rng(seed)
    stems = ["".join(rng.choice(list(LETTERS), rng.integers(2, 4)))
             for _ in range(40)]
    pool = [s + "".join(rng.choice(list(LETTERS), rng.integers(0, 4)))
            for s in rng.choice(stems, 300)]
    weights = 1.0 / np.arange(1, len(pool) + 1)
    weights /= weights.sum()
    return [" ".join(rng.choice(pool, rng.integers(3, 15), p=weights))
            for _ in range(n)]


@pytest.mark.parametrize("seed,vocab_size,min_pair_freq",
                         [(0, 200, 2), (1, 600, 2), (2, 5000, 1),
                          (3, 40, 2)])
def test_learned_vocab_equals_jax(seed, vocab_size, min_pair_freq):
    texts = _corpus(seed)
    got = learn_wordpiece_vocab(texts, vocab_size, min_pair_freq)
    want = j_learn_wordpiece_vocab(texts, vocab_size, min_pair_freq)
    assert SPECIALS == J_SPECIALS
    assert list(got.items()) == list(want.items())
    # the budget caps the merges; the specials and base symbols always stay
    base = {w[0] for t in texts for w in t.split()} | {
        "##" + c for t in texts for w in t.split() for c in w[1:]}
    assert len(got) <= max(vocab_size, len(SPECIALS) + len(base))


@pytest.mark.parametrize("mode,size", [("words", 30000), ("words", 50),
                                       ("subword", 300), ("subword", 3000)])
def test_build_tokenizer_ids_equal_jax(tmp_path, mode, size):
    texts = _corpus(7)
    tok = build_tokenizer(texts, None, mode, size)
    jtok = j_build_tokenizer(texts, None, cache_dir=str(tmp_path / "jax"),
                             corpus_vocab_mode=mode, corpus_vocab_size=size)
    assert dict(tok.vocab) == dict(jtok.vocab)
    probe = texts[:40] + _corpus(8, 20)       # unseen words too
    ids, mask = tok.encode_batch(probe, 48)
    jids, jmask = jtok.encode_batch(probe, 48)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    # a vocab file wins over the mode, in both packages
    path = str(tmp_path / "vocab.txt")
    tok.save(path)
    again = build_tokenizer(_corpus(9), path, "subword", 10)
    assert dict(again.vocab) == dict(tok.vocab)


def test_build_tokenizer_refuses_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match="unknown corpus_vocab_mode"):
        build_tokenizer(_corpus(0), None, "bytes", 100)
    with pytest.raises(ValueError, match="unknown corpus_vocab_mode"):
        j_build_tokenizer(_corpus(0), None, cache_dir=str(tmp_path),
                          corpus_vocab_mode="bytes")


def test_config_fields_equal_jax():
    """The new DataConfig and TrainConfig fields carry the JAX names and
    defaults."""
    for port, jax_cls, names in (
            (DataConfig, JDataConfig, ("corpus_vocab_mode",
                                       "corpus_vocab_size")),
            (TrainConfig, JTrainConfig, ("distill_lambda",))):
        ours = {f.name: f.default for f in dataclasses.fields(port)}
        theirs = {f.name: f.default for f in dataclasses.fields(jax_cls)}
        for name in names:
            assert ours[name] == theirs[name], name
