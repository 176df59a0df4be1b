"""Caption precomputation (port of the placeholder branch and JSON cache of
``precompute_captions`` in ``mpmc_tpu/models/captioner.py``).  Without a
captioning model every image gets the deterministic caption
``"a meme of <first 8 hex of sha256(path)>"``.  The BLIP captioner waits."""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence


PROMPT = "a meme of"


def precompute_captions(img_paths: Sequence[str],
                        cache_dir: Optional[str] = None) -> List[str]:
    """One caption per image path, cached as JSON under ``cache_dir`` with a
    key over the paths, the prompt and the generator's identity (the same
    file name the JAX package uses for placeholder captions)."""
    cache_path = None
    cache = {}
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        key = hashlib.sha256(("\n".join(img_paths) + PROMPT + "\x00"
                              + "placeholder").encode()).hexdigest()[:16]
        cache_path = os.path.join(cache_dir, f"captions_{key}.json")
        if os.path.exists(cache_path):
            with open(cache_path) as f:
                cache = json.load(f)
            if all(p in cache for p in img_paths):
                return [cache[p] for p in img_paths]
    caps = [f"{PROMPT} {hashlib.sha256(p.encode()).hexdigest()[:8]}"
            for p in img_paths]
    if cache_path:
        cache.update(dict(zip(img_paths, caps)))
        with open(cache_path, "w") as f:
            json.dump(cache, f)
    return caps
