"""Host-side image decode and resize (port of ``mpmc_tpu/image/decode.py``).

Three backends, tried in this order, as in the JAX package:

1. ``native/image_decode.cpp``: libjpeg (with ``scale_denom`` prescaling)
   and libpng decode plus its own bilinear resize, loaded through ctypes
   (``image/native.py``), threadable because ctypes releases the GIL;
2. PIL, when the native library cannot build or the file is not a JPEG or
   PNG it decodes;
3. deterministic synthetic pixels derived from the path hash when the file
   is missing or undecodable (the meme images are distributed separately
   from the manifests).

The two packages therefore give a model the same pixels for the same file.
Output: uint8 RGB ``[H, W, 3]`` at the requested size (grayscale
``[H, W, 1]``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

_native = None
_native_checked = False
_native_lock = threading.Lock()

# Images decoded by each backend.  A run zeroes the counts before its path
# and reads them after to show which backend really ran.
backend_counts: Dict[str, int] = {"native": 0, "pil": 0, "synthetic": 0}
_count_lock = threading.Lock()


def _count(backend: str) -> None:
    with _count_lock:
        backend_counts[backend] += 1


def _load_native():
    """The native decoder module when its library builds, else None.  Under
    a lock: ``decode_batch``'s threads all ask at once, and none may take
    the PIL path while the library is still building."""
    global _native, _native_checked
    with _native_lock:
        if not _native_checked:
            from mpmc_tpu_torch.image import native
            _native = native if native.available() else None
            _native_checked = True
    return _native


def _synthetic(path: str, size: int, channels: int) -> np.ndarray:
    """Deterministic pseudo-image derived from the path hash."""
    seed = int.from_bytes(hashlib.sha256(path.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (8, 8, channels), dtype=np.uint8)
    reps = (size + 7) // 8
    img = np.tile(base, (reps, reps, 1))[:size, :size]
    return np.ascontiguousarray(img)


def _missing(path: str, size: int, channels: int,
             missing: Optional[list]) -> np.ndarray:
    if missing is not None:
        missing.append(path)
    _count("synthetic")
    return _synthetic(path, size, channels)


def decode_image(path: str, size: int = 224, grayscale: bool = False,
                 root: str = ".",
                 missing: Optional[list] = None) -> np.ndarray:
    """Decode one image file to uint8 ``[size, size, C]``.

    A missing or undecodable file yields deterministic synthetic pixels and
    its path is appended to ``missing``."""
    channels = 1 if grayscale else 3
    full = os.path.join(root, path)
    if not os.path.exists(full):
        return _missing(path, size, channels, missing)

    native = _load_native()
    if native is not None:
        out = native.decode_resize(full, size, grayscale)
        if out is not None:
            _count("native")
            return out

    try:
        from PIL import Image
    except ImportError:
        return _missing(path, size, channels, missing)
    try:
        with Image.open(full) as im:
            im = im.convert("L" if grayscale else "RGB")
            im = im.resize((size, size), Image.BILINEAR)
            arr = np.asarray(im, dtype=np.uint8)
    except (OSError, ValueError):
        return _missing(path, size, channels, missing)
    _count("pil")
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
