"""The image input pipeline (port of ``mpmc_tpu/image/pipeline.py``).

The whole split is decoded once, multi-threaded (``image/decode.py``:
native, then PIL), into a uint8 host cache; at ArAIEval scale
(2143 x 224 x 224 x 3, about 308 MB) it fits in host memory.  The drivers
then keep the cache on the device, and augmentation runs there
(``image/augment.py``), so after the first pass the host does no per-epoch
image work.  :meth:`ImagePipeline.batches` also streams padded batches from
the cache ahead of use on a background thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from mpmc_tpu_torch.image.decode import decode_batch


class ImagePipeline:
    def __init__(self, paths: Sequence[str], root: str = ".",
                 size: int = 224, grayscale: bool = False,
                 decode_threads: int = 16, strict: bool = False):
        self.paths = list(paths)
        self.root = root
        self.size = size
        self.grayscale = grayscale
        self.decode_threads = decode_threads
        self.strict = strict
        self._cache: Optional[np.ndarray] = None

    def preload(self) -> np.ndarray:
        """Decode the whole split once to uint8 ``[N, size, size, C]``."""
        if self._cache is None:
            self._cache = decode_batch(self.paths, self.size, self.grayscale,
                                       self.root, self.decode_threads,
                                       strict=self.strict)
        return self._cache

    def __len__(self) -> int:
        return len(self.paths)

    def batches(self, indices: np.ndarray, batch_size: int,
                put: Callable[[np.ndarray], object] = lambda x: x,
                prefetch: int = 2) -> Iterator[object]:
        """Yield ``(put(batch), n_valid)`` for the rows ``indices`` in
        order, ``batch_size`` at a time, the last batch zero-padded to
        ``batch_size``.  A background thread slices and runs ``put`` (a
        copy to the device, say) up to ``prefetch`` batches ahead; an
        exception there is raised here."""
        cache = self.preload()
        starts = range(0, len(indices), batch_size)
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        STOP = object()
        errs = []

        def producer():
            try:
                for s in starts:
                    take = indices[s:s + batch_size]
                    batch = cache[take]
                    if len(take) < batch_size:  # pad for static shapes
                        pad = np.zeros((batch_size - len(take),)
                                       + batch.shape[1:], batch.dtype)
                        batch = np.concatenate([batch, pad])
                    q.put((put(batch), len(take)))
            except BaseException as e:  # surface on the consumer thread
                errs.append(e)
            q.put(STOP)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is STOP:
                break
            yield item
        if errs:
            raise errs[0]
