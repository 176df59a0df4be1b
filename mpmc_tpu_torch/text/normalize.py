"""Text normalization (copy of ``mpmc_tpu/text/normalize.py``), two
pipelines:

* ``normalize_tweet``: BERTweet-style English tweet normalization
  (reference ``baselines/TweetNormalizer.py:11-54``): @user -> ``@USER``,
  http/www -> ``HTTPURL``, single-char emoji demojized, ``’``/``…``
  re-spelled, contraction re-spacing, a.m./p.m. fix-ups.
* ``preprocess_arabic_tweet``: the competitor's Arabic cleanup
  (reference ``example_scripts/textmodel_example_task2A.py:101-123``):
  demojize, strip hashtags and URLs, normalize hamza and lam-alef, strip
  tashkeel and diacritics, drop non-Arabic tokens.

Dependency-free: the Unicode transforms are the tables below.  When
``nltk`` is importable its ``TweetTokenizer`` tokenizes tweets (BERTweet's
tokenization), else a regex does.
"""

from __future__ import annotations

import re
import unicodedata
from functools import lru_cache
from typing import List

# --------------------------------------------------------------------------
# Emoji handling
# --------------------------------------------------------------------------

# Supplementary ranges that cover the overwhelming majority of emoji.
_EMOJI_RANGES = (
    (0x1F300, 0x1FAFF),  # symbols & pictographs, supplemental, extended-A
    (0x1F1E6, 0x1F1FF),  # regional indicators
    (0x2600, 0x27BF),    # misc symbols + dingbats
    (0x2B00, 0x2BFF),
    (0xFE0F, 0xFE0F),    # variation selector-16
    (0x1F000, 0x1F0FF),
)


_EMOJI_RE = re.compile(
    "[" + "".join(f"{chr(lo)}-{chr(hi)}" for lo, hi in _EMOJI_RANGES) + "]")


def _is_emoji_char(ch: str) -> bool:
    return _EMOJI_RE.match(ch) is not None


@lru_cache(maxsize=4096)
def _demojize_char(ch: str) -> str:
    """Single char → ``:name:`` in the ``emoji`` package's style
    (lowercase, spaces→underscores)."""
    try:
        name = unicodedata.name(ch).lower().replace(" ", "_").replace("-", "_")
    except ValueError:
        return ch
    return f":{name}:"


def demojize(text: str) -> str:
    """Replace emoji codepoints with ``:name:`` tokens.

    Divergence note: the reference calls ``emoji.demojize(..., language='ar')``
    which emits *Arabic* emoji names; without that package's data tables we
    emit Unicode character names.  The downstream effect is identical for the
    2A pipeline because ``remove_non_arabic_words`` drops the Latin-script
    emoji tokens either way.
    """
    return _EMOJI_RE.sub(lambda m: _demojize_char(m.group()), text)


# --------------------------------------------------------------------------
# BERTweet-style tweet normalization (C2)
# --------------------------------------------------------------------------

_FALLBACK_TOKEN_RE = re.compile(
    r"https?://\S+|www\.\S+|@\w+|#\w+|[\w'؀-ۿ]+|[^\s\w]", re.UNICODE)


def _tweet_tokenize(text: str) -> List[str]:
    try:
        from nltk.tokenize import TweetTokenizer
        return TweetTokenizer().tokenize(text)
    except Exception:
        return _FALLBACK_TOKEN_RE.findall(text)


def _normalize_token(token: str) -> str:
    lower = token.lower()
    if token.startswith("@"):
        return "@USER"
    if lower.startswith("http") or lower.startswith("www"):
        return "HTTPURL"
    if len(token) == 1:
        return _demojize_char(token) if _is_emoji_char(token) else (
            "'" if token == "’" else "..." if token == "…" else token)
    return token


def normalize_tweet(tweet: str) -> str:
    """BERTweet tweet normalization (reference TweetNormalizer.py:28-54)."""
    tokens = _tweet_tokenize(tweet.replace("’", "'").replace("…", "..."))
    norm = " ".join(_normalize_token(t) for t in tokens)
    norm = (norm.replace("cannot ", "can not ")
                .replace("n't ", " n't ")
                .replace("n 't ", " n't ")
                .replace("ca n't", "can't")
                .replace("ai n't", "ain't"))
    norm = (norm.replace("'m ", " 'm ")
                .replace("'re ", " 're ")
                .replace("'s ", " 's ")
                .replace("'ll ", " 'll ")
                .replace("'d ", " 'd ")
                .replace("'ve ", " 've "))
    norm = (norm.replace(" p . m .", "  p.m.")
                .replace(" p . m ", " p.m ")
                .replace(" a . m .", " a.m.")
                .replace(" a . m ", " a.m "))
    return " ".join(norm.split())


# --------------------------------------------------------------------------
# Arabic normalization (C3)
# --------------------------------------------------------------------------

# Alef variants → bare alef; remaining hamza carriers → bare hamza
# (pyarabic.normalize.normalize_hamza 'uniform' behavior).
_ALEFAT_RE = re.compile("[آأإٱٲٳٵ]")  # آأإٱٲٳٵ
_HAMZAT_RE = re.compile("[ؤئ]")                                # ؤئ
# Lam-alef presentation ligatures → لا (pyarabic normalize_lamalef).
_LAMALEF_RE = re.compile("[ﻵﻶﻷﻸﻹﻺﻻﻼ]")
# Tashkeel: fathatan..sukun + superscript alef (U+064B–U+0652, U+0670).
_TASHKEEL_RE = re.compile("[ً-ْٰ]")
# Wider diacritics: Quranic annotation marks + tatweel-adjacent combining marks.
_DIACRITICS_RE = re.compile("[ؐ-ؚۖ-ۜ۟-۪ۨ-ۭ]")

_HASHTAG_RE = re.compile(r"#\S+")
_URL_RE = re.compile(r"https?:\/\/\S+")

# Arabic script ranges (pyarabic is_arabicrange: U+0600–U+06FF plus
# supplement/presentation forms).
_ARABIC_RANGES = ((0x0600, 0x06FF), (0x0750, 0x077F),
                  (0xFB50, 0xFDFF), (0xFE70, 0xFEFF))


def normalize_hamza(text: str) -> str:
    text = _ALEFAT_RE.sub("ا", text)   # → ا
    return _HAMZAT_RE.sub("ء", text)   # → ء


def normalize_lamalef(text: str) -> str:
    return _LAMALEF_RE.sub("لا", text)  # → لا


def strip_tashkeel(text: str) -> str:
    return _TASHKEEL_RE.sub("", text)


def strip_diacritics(text: str) -> str:
    return _DIACRITICS_RE.sub("", text)


_ARABIC_WORD_RE = re.compile(
    "[" + "".join(f"{chr(lo)}-{chr(hi)}" for lo, hi in _ARABIC_RANGES) + "]+")


def _is_arabic_word(word: str) -> bool:
    return _ARABIC_WORD_RE.fullmatch(word) is not None


def remove_non_arabic_words(text: str) -> str:
    """Keep only tokens made entirely of Arabic-range characters
    (reference ``remove_english_words``, textmodel_example_task2A.py:101-104)."""
    return " ".join(w for w in text.split() if _is_arabic_word(w))


def preprocess_arabic_tweet(tweet: str) -> str:
    """Full 2A Arabic cleanup (reference textmodel_example_task2A.py:106-123)."""
    tweet = demojize(tweet)
    tweet = _HASHTAG_RE.sub(" ", tweet)
    tweet = _URL_RE.sub(" ", tweet)
    tweet = normalize_hamza(tweet)
    tweet = normalize_lamalef(tweet)
    tweet = strip_tashkeel(tweet)
    tweet = strip_diacritics(tweet)
    tweet = remove_non_arabic_words(tweet)
    return tweet.strip()
