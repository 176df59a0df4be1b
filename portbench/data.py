"""Synthetic memes from the seed: the one generator that every traffic mix
parameterises (``portbench/traffic/*.json``).

A meme is a text of ``words`` tokens between a leading and a trailing
special token, a caption of ``caption_tokens`` tokens with the same two,
an image of uint8 pixels at the configuration's size, and a label.  Token
ids are uniform over each vocabulary above its special ids.

Every seed gets the same multiset of lengths and labels: word counts are
the quantiles ``(i + 0.5) / n`` of a log-normal law clipped to
``[words_min, words_max]``, caption lengths evenly spaced over their range,
``round(propaganda_share * n)`` positive labels.  The seed decides only
which meme gets which, the token ids and the pixels; so two seeds do the
same amount of work.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import numpy as np
import torch

from portbench.weights import sub_seed

DATA_STREAM = 2

# Special ids of the two tokenizers: BERT's [PAD] 0, [CLS] 2, [SEP] 3
# (ids below 5 are special); RoBERTa's <s> 0, <pad> 1, </s> 2.
SPECIAL = {"bert": {"pad": 0, "first": 2, "last": 3, "low": 5},
           "roberta": {"pad": 1, "first": 0, "last": 2, "low": 3}}


def word_counts(n: int, t: dict) -> np.ndarray:
    law = statistics.NormalDist(math.log(t["words_median"]), t["words_sigma"])
    q = np.array([math.exp(law.inv_cdf((i + 0.5) / n)) for i in range(n)])
    return np.clip(np.rint(q), t["words_min"], t["words_max"]).astype(np.int64)


def caption_lengths(n: int, t: dict) -> np.ndarray:
    lo, hi = t["caption_tokens_min"], t["caption_tokens_max"]
    return lo + np.floor((np.arange(n) + 0.5) / n * (hi - lo + 1)).astype(
        np.int64)


def token_rows(lengths: np.ndarray, width: int, enc: dict,
               g: torch.Generator, device: torch.device):
    """``ids``, ``mask`` int32 ``[n, width]``: each row's ``lengths`` real
    tokens (first and last special), then padding."""
    sp = SPECIAL[enc["position_offset"]]
    n = len(lengths)
    ids = torch.randint(sp["low"], enc["vocab_size"], (n, width),
                        generator=g, device=device, dtype=torch.int32)
    pos = torch.arange(width, device=device)[None, :]
    ln = torch.as_tensor(lengths, device=device)[:, None]
    ids = torch.where(pos == 0, sp["first"], ids)
    ids = torch.where(pos == ln - 1, sp["last"], ids)
    mask = pos < ln
    ids = torch.where(mask, ids, sp["pad"]).to(torch.int32)
    return ids.cpu().numpy(), mask.to(torch.int32).cpu().numpy()


def make_memes(cfg: dict, traffic: dict, n: int, seed: int, split: int,
               device: torch.device) -> Dict[str, np.ndarray]:
    """``n`` memes of split number ``split`` as host arrays: ``image`` uint8
    ``[n, S, S, 3]``, ``label`` int32, and for a model with text branches
    ``text_ids``/``text_mask`` ``[n, max_text_len]`` and
    ``caption_ids``/``caption_mask`` ``[n, max_caption_len]``."""
    rng = np.random.default_rng(sub_seed(seed, DATA_STREAM * 100 + split))
    g = torch.Generator(device=device).manual_seed(
        sub_seed(seed, DATA_STREAM * 100 + 50 + split))
    size = cfg["image_encoder"]["image_size"]
    pos = int(round(traffic["propaganda_share"] * n))
    out = {"label": rng.permutation(np.r_[np.ones(pos, np.int32),
                                          np.zeros(n - pos, np.int32)])}
    if cfg["kind"] == "multimodal":
        head = cfg["head"]
        words = rng.permutation(word_counts(n, traffic))
        out["text_ids"], out["text_mask"] = token_rows(
            words + 2, head["max_text_len"], cfg["text_encoder"], g, device)
        caps = rng.permutation(caption_lengths(n, traffic))
        out["caption_ids"], out["caption_mask"] = token_rows(
            caps, head["max_caption_len"], cfg["caption_encoder"], g, device)
    out["image"] = torch.randint(0, 256, (n, size, size, 3), generator=g,
                                 device=device, dtype=torch.uint8
                                 ).cpu().numpy()
    return out
