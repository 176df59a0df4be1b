"""Host-side image decode and resize (copy of ``mpmc_tpu/image/decode.py``
without its native backend).

Backends: PIL when it is installed, and deterministic synthetic pixels
derived from the path hash when the file is missing or undecodable (the
meme images are distributed separately from the manifests).  Output:
uint8 RGB ``[H, W, 3]`` at the requested size (grayscale ``[H, W, 1]``).
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


def _synthetic(path: str, size: int, channels: int) -> np.ndarray:
    """Deterministic pseudo-image derived from the path hash."""
    seed = int.from_bytes(hashlib.sha256(path.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (8, 8, channels), dtype=np.uint8)
    reps = (size + 7) // 8
    img = np.tile(base, (reps, reps, 1))[:size, :size]
    return np.ascontiguousarray(img)


def decode_image(path: str, size: int = 224, grayscale: bool = False,
                 root: str = ".",
                 missing: Optional[list] = None) -> np.ndarray:
    """Decode one image file to uint8 ``[size, size, C]``.

    A missing or undecodable file yields deterministic synthetic pixels and
    its path is appended to ``missing``."""
    channels = 1 if grayscale else 3
    full = os.path.join(root, path)
    if not os.path.exists(full):
        if missing is not None:
            missing.append(path)
        return _synthetic(path, size, channels)
    try:
        from PIL import Image
    except ImportError:
        if missing is not None:
            missing.append(path)
        return _synthetic(path, size, channels)
    try:
        with Image.open(full) as im:
            im = im.convert("L" if grayscale else "RGB")
            im = im.resize((size, size), Image.BILINEAR)
            arr = np.asarray(im, dtype=np.uint8)
    except (OSError, ValueError):
        if missing is not None:
            missing.append(path)
        return _synthetic(path, size, channels)
    return arr[..., None] if grayscale else arr


def decode_batch(paths: Sequence[str], size: int = 224,
                 grayscale: bool = False, root: str = ".",
                 num_threads: int = 8, strict: bool = False) -> np.ndarray:
    """Parallel decode to uint8 ``[N, size, size, C]``.

    Missing or undecodable files are logged with a count; ``strict=True``
    raises instead."""
    from concurrent.futures import ThreadPoolExecutor
    out = np.empty((len(paths), size, size, 1 if grayscale else 3), np.uint8)
    missing: list = []

    def work(i):
        out[i] = decode_image(paths[i], size, grayscale, root, missing)

    if len(paths) > 1 and num_threads > 1:
        with ThreadPoolExecutor(num_threads) as ex:
            list(ex.map(work, range(len(paths))))
    else:
        for i in range(len(paths)):
            work(i)
    if missing:
        msg = (f"{len(missing)}/{len(paths)} images missing or undecodable "
               f"under root={root!r} (e.g. {missing[0]!r}) — synthetic "
               f"pixels substituted")
        if strict:
            raise FileNotFoundError(msg)
        log.warning("%s", msg)
    return out
