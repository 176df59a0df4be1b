"""Arabic text normalization (copy of the Arabic half of
``mpmc_tpu/text/normalize.py``): demojize, strip hashtags and URLs,
normalize hamza and lam-alef, strip tashkeel and diacritics, drop
non-Arabic tokens.  Dependency-free; the BERTweet English normalizer is not
on the serving path and is not copied.
"""

from __future__ import annotations

import re
import unicodedata
from functools import lru_cache

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


def _is_emoji_char(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _EMOJI_RANGES)


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
    if not any(_is_emoji_char(c) for c in text):
        return text
    return "".join(_demojize_char(c) if _is_emoji_char(c) else c for c in text)


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


def _is_arabic_word(word: str) -> bool:
    return bool(word) and all(
        any(lo <= ord(c) <= hi for lo, hi in _ARABIC_RANGES) for c in word)


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
