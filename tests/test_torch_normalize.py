"""The BERTweet normalizer, ``demojize`` and the Arabic cleanup in the port
(``mpmc_tpu_torch/text/normalize.py``) against the JAX package's: equal
strings on ``tests/test_text.py``'s inputs and on a seeded corpus of
tweets with emoji, URLs, mentions, hashtags, contractions, ellipses and
a.m./p.m., with ``nltk``'s ``TweetTokenizer`` and with the regex the
module falls back to without it."""

import builtins

import numpy as np
import pytest

from mpmc_tpu.text import normalize as jnorm
from mpmc_tpu_torch import text as ptext
from mpmc_tpu_torch.text import normalize as pnorm

TEXT_PY_INPUTS = [
    "check @someone and https://x.co/abc … now",
    "I can't believe it's here",
    "it's",
    "hi 😀",
    "صباح الخير #propaganda https://t.co/xyz hello 😀",
    "hello مرحبا world بكم",
]
PIECES = ["@user_1", "@Someone", "https://t.co/Ab9", "http://x.org/p?q=1",
          "www.example.com/a", "#Propaganda", "😀", "🇪🇬", "❤️", "☀", "🤔",
          "can't", "won't", "I'm", "you're", "it's", "we'll", "they'd",
          "I've", "ain't", "cannot", "don’t", "…", "...", "p.m.", "a.m.",
          "5 p . m .", "7 a . m", "HELLO", "world", "!", "?!", ",", "مرحبا",
          "كذبة", "2024", "e-mail", "U.S.A.", ":-)", "<3", "’"]


def _corpus(n=200, seed=15):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 12))
        words = [PIECES[int(i)] for i in rng.integers(0, len(PIECES), k)]
        sep = [" " if rng.random() < 0.85 else "" for _ in words]
        out.append("".join(w + s for w, s in zip(words, sep)).strip())
    return out


@pytest.fixture(params=["nltk", "regex"])
def tokenizer(request, monkeypatch):
    """Both modules tokenize with ``nltk`` (when it is installed) or, with
    its import refused, with the fallback regex."""
    if request.param == "regex":
        real = builtins.__import__

        def refuse(name, *args, **kwargs):
            if name.startswith("nltk"):
                raise ImportError(name)
            return real(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", refuse)
    else:
        pytest.importorskip("nltk")
    return request.param


def test_normalize_tweet_equals_jax(tokenizer):
    for text in TEXT_PY_INPUTS + _corpus():
        assert ptext.normalize_tweet(text) == jnorm.normalize_tweet(text), \
            text


def _codepoint_corpus(n=3000, seed=16):
    """Texts of code points around every range the two normalizers test:
    ASCII, the Arabic blocks and their neighbours, the emoji ranges and
    their edges."""
    rng = np.random.default_rng(seed)
    points = [*range(0x20, 0x7F), *range(0x5FF, 0x701), *range(0x74F, 0x781),
              *range(0xFB4F, 0xFB60), *range(0xFDF0, 0xFE01),
              *range(0xFE6F, 0xFF00), *range(0x1F2F0, 0x1F320),
              0x25FF, 0x2600, 0x27BF, 0x27C0, 0x2AFF, 0x2B00, 0x2BFF, 0x2C00,
              0xFE0E, 0xFE0F, 0xFE10, 0x1F1E5, 0x1F1E6, 0x1F1FF, 0x1EFFF,
              0x1F000, 0x1F0FF, 0x1FAFF, 0x1FB00]
    pool = [chr(c) for c in points]
    return ["".join(rng.choice(pool, int(rng.integers(0, 40))))
            for _ in range(n)]


def test_demojize_equals_jax():
    for text in TEXT_PY_INPUTS + _corpus() + _codepoint_corpus():
        assert ptext.demojize(text) == jnorm.demojize(text), text
    assert pnorm._FALLBACK_TOKEN_RE.pattern == jnorm._FALLBACK_TOKEN_RE.pattern


def test_arabic_cleanup_equals_jax():
    """``remove_non_arabic_words`` and the whole Arabic cleanup (regex
    character classes over the same code-point ranges as the JAX
    package's loops) give the JAX package's strings."""
    for text in TEXT_PY_INPUTS + _corpus() + _codepoint_corpus():
        assert (ptext.remove_non_arabic_words(text)
                == jnorm.remove_non_arabic_words(text)), text
        assert (ptext.preprocess_arabic_tweet(text)
                == jnorm.preprocess_arabic_tweet(text)), text


def test_normalize_tweet_examples():
    out = ptext.normalize_tweet("check @someone and https://x.co/abc … now")
    assert "@USER" in out and "HTTPURL" in out and "…" not in out
    assert ptext.normalize_tweet("I can't believe it's here") == \
        "I can't believe it 's here"
