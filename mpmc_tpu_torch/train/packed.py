"""Packed 2C training plan (copy of ``PackedMultimodalPlan`` and port of the
batch adapter ``make_packed_multimodal_apply_fn`` in
``mpmc_tpu/train/packed.py``).

Every training batch keeps the same ``batch_size`` samples as unpacked
training (image branch per sample, the same valid-weighted loss), but the
text and caption tokens of those samples are packed into ``[R, pack_len]``
rows, so both text encoders run fewer rows.  The row budgets R are the
largest first-fit-decreasing row count over the epoch's batches, rounded
up to ``row_multiple`` and never shrinking across epochs, so every batch of
an epoch has one shape.  With ``resident_images`` a batch carries
``img_idx`` (rows of the image store on the device) instead of pixels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from mpmc_tpu_torch.ops.packing import pack_sequences


@dataclasses.dataclass
class PackedMultimodalPlan:
    """Per-epoch packed batch factory for ``train.loop.fit``."""

    data: Dict[str, np.ndarray]
    batch_size: int
    abs_idx: Optional[np.ndarray] = None
    resident_images: bool = False
    row_multiple: int = 2

    def __post_init__(self):
        n = len(self.data["label"])
        self.steps_per_epoch = -(-n // self.batch_size)
        self.has_caption = "caption_ids" in self.data
        self.text_len = int(self.data["text_ids"].shape[1])
        self.caption_len = (int(self.data["caption_ids"].shape[1])
                            if self.has_caption else 0)
        self._mult = max(int(self.row_multiple), 1)
        self._budget_t = self._mult
        self._budget_c = self._mult

    @property
    def row_budgets(self) -> Tuple[int, int]:
        """The current text and caption row budgets ``(R, Rc)``."""
        return self._budget_t, self._budget_c

    @staticmethod
    def _ffd_rows(mask_rows, pack_len) -> int:
        lengths = np.maximum(np.minimum(mask_rows.sum(axis=1), pack_len), 1)
        packed = pack_sequences(
            np.zeros((len(lengths), pack_len), np.int32),
            (np.arange(pack_len)[None, :] < lengths[:, None]), pack_len)
        return packed.num_rows

    @staticmethod
    def _pad_rows(packed, budget):
        pad = budget - packed.ids.shape[0]
        if pad < 0:
            raise ValueError("packed rows exceed the epoch budget")
        return (np.pad(packed.ids, ((0, pad), (0, 0))),
                np.pad(packed.segments, ((0, pad), (0, 0))),
                np.pad(packed.positions, ((0, pad), (0, 0))))

    def epoch_iter(self, rng: np.random.Generator
                   ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        """Shuffle with ``rng``, then yield ``(batch, n_valid)`` per step
        (the short last batch is filled by wrapping around the order)."""
        d = self.data
        n = len(d["label"])
        bs = self.batch_size
        idx = rng.permutation(n)
        takes = []
        for start in range(0, n, bs):
            take = idx[start:start + bs]
            if len(take) < bs:
                take = np.concatenate([take, np.resize(idx, bs - len(take))])
            takes.append((take, min(bs, n - start)))
        m = self._mult
        bt = max(self._ffd_rows(d["text_mask"][t], self.text_len)
                 for t, _ in takes)
        self._budget_t = max(self._budget_t, -(-bt // m) * m)
        if self.has_caption:
            bc = max(self._ffd_rows(d["caption_mask"][t], self.caption_len)
                     for t, _ in takes)
            self._budget_c = max(self._budget_c, -(-bc // m) * m)
        skip = {"text_ids", "text_mask", "caption_ids", "caption_mask"}
        if self.resident_images:
            skip.add("image")
        for take, k in takes:
            batch = {kk: d[kk][take] for kk in d if kk not in skip}
            if self.resident_images:
                src = (self.abs_idx[take] if self.abs_idx is not None
                       else take)
                batch["img_idx"] = np.asarray(src, np.int32)
            tp = pack_sequences(d["text_ids"][take], d["text_mask"][take],
                                self.text_len)
            ids, segs, poss = self._pad_rows(tp, self._budget_t)
            batch.update(t_ids=ids, t_segments=segs, t_positions=poss,
                         t_row_of=tp.row_of, t_slot_of=tp.slot_of,
                         t_start_of=tp.start_of)
            if self.has_caption:
                cp = pack_sequences(d["caption_ids"][take],
                                    d["caption_mask"][take],
                                    self.caption_len)
                cids, csegs, cposs = self._pad_rows(cp, self._budget_c)
                batch.update(c_ids=cids, c_segments=csegs,
                             c_positions=cposs, c_row_of=cp.row_of,
                             c_slot_of=cp.slot_of, c_start_of=cp.start_of)
            batch["valid"] = (np.arange(bs) < k).astype(np.float32)
            yield batch, k


def packed_model_inputs(batch: Dict) -> Tuple[Dict, Optional[Dict]]:
    """The plan's batch layout as ``PackedMultimodalClassifier``'s
    ``(text_packed, caption_packed)`` arguments."""

    def branch(prefix):
        return {key: batch[f"{prefix}_{key}"]
                for key in ("ids", "segments", "positions", "row_of",
                            "slot_of", "start_of")}

    return branch("t"), (branch("c") if "c_ids" in batch else None)
