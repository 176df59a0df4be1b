"""Packed training plans (copies of ``PackedTrainPlan`` and
``PackedMultimodalPlan``, and port of the batch adapters
``make_packed_text_apply_fn`` and ``make_packed_multimodal_apply_fn`` in
``mpmc_tpu/train/packed.py``).

2A (``PackedTrainPlan``): each epoch packs the whole shuffled train split
once into ``[pack_len]`` rows, and a step takes ``rows_per_batch`` of them.
The loss stays per sample: each batch carries ``rows_per_batch x
max_segments`` sample slots (``row_of``, ``slot_of``, ``start_of`` local to
the batch, ``label``, ``valid``), the unused ones zero with ``valid`` 0.
First-fit-decreasing places samples in sorted-length order, so its row count
depends only on the multiset of lengths: one pack of the unshuffled split
gives every epoch's row budget, and the last row chunk is padded with zero
rows.

2C (``PackedMultimodalPlan``): every training batch keeps the same ``batch_size`` samples as unpacked
training (image branch per sample, the same valid-weighted loss), but the
text and caption tokens of those samples are packed into ``[R, pack_len]``
rows, so both text encoders run fewer rows.  The row budgets R are the
largest first-fit-decreasing row count over the epoch's batches, rounded
up to ``row_multiple`` and never shrinking across epochs, so every batch of
an epoch has one shape.  With ``resident_images`` a batch carries
``img_idx`` (rows of the image store on the device) instead of pixels.

Under data parallelism (``shard`` ``(rank, size)``) every rank draws the
same epoch and yields its own part of each global batch: 2A the rank's
``rows_per_batch / size`` consecutive rows with the samples packed there,
2C the rank's ``batch_size / size`` samples, packed on their own into rows
whose budgets cover every rank's part, so that all ranks step with one
shape.  ``size`` 1 gives the unsharded batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from mpmc_tpu_torch.ops.packing import pack_sequences


@dataclasses.dataclass
class PackedTrainPlan:
    """Per-epoch packed 2A batch factory for ``train.loop.fit``: batches of
    ``t_ids``, ``t_segments``, ``t_positions`` ``[G, P]`` and ``t_row_of``,
    ``t_slot_of``, ``t_start_of``, ``label``, ``valid`` ``[G *
    max_segments]``, and ``soft`` (the distillation targets, 0.5 in the
    empty slots) when the data has a ``soft`` column."""

    data: Dict[str, np.ndarray]
    pack_len: int
    rows_per_batch: int
    max_segments: int = 16
    shard: Tuple[int, int] = (0, 1)

    def __post_init__(self):
        if self.rows_per_batch % self.shard[1]:
            raise ValueError(
                f"--pack-rows={self.rows_per_batch} not divisible by the "
                f"data-axis extent {self.shard[1]}")
        probe = pack_sequences(self.data["text_ids"], self.data["text_mask"],
                               self.pack_len, max_segments=self.max_segments)
        self.row_budget = probe.num_rows
        self.steps_per_epoch = -(-self.row_budget // self.rows_per_batch)
        self.samples_per_batch = (self.rows_per_batch // self.shard[1]
                                  * self.max_segments)

    @property
    def row_budgets(self) -> Tuple[int]:
        """The packed rows per epoch, ``(R,)``."""
        return (self.row_budget,)

    def epoch_iter(self, rng: np.random.Generator
                   ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        """Shuffle with ``rng``, pack the whole epoch, then yield
        ``(batch, n_valid)`` per step of ``rows_per_batch`` rows."""
        d = self.data
        perm = rng.permutation(len(d["label"]))
        packed = pack_sequences(d["text_ids"][perm], d["text_mask"][perm],
                                self.pack_len, num_rows=self.row_budget,
                                max_segments=self.max_segments)
        labels = np.asarray(d["label"])[perm]
        soft = (np.asarray(d["soft"], np.float32)[perm] if "soft" in d
                else None)
        G, cap = self.rows_per_batch, self.samples_per_batch
        rank, size = self.shard
        g = G // size
        for step_start in range(0, self.row_budget, G):
            start = step_start + rank * g
            rows = slice(start, start + g)
            pad = ((0, g - packed.ids[rows].shape[0]), (0, 0))
            members = np.nonzero((packed.row_of >= start)
                                 & (packed.row_of < start + g))[0]
            k = len(members)
            if k > cap:
                raise ValueError("more samples in a batch than its slots")
            batch = {"t_ids": np.pad(packed.ids[rows], pad),
                     "t_segments": np.pad(packed.segments[rows], pad),
                     "t_positions": np.pad(packed.positions[rows], pad)}
            for key, src in (("t_row_of", packed.row_of - start),
                             ("t_slot_of", packed.slot_of),
                             ("t_start_of", packed.start_of)):
                batch[key] = np.zeros(cap, np.int32)
                batch[key][:k] = src[members]
            batch["label"] = np.zeros(cap, labels.dtype)
            batch["label"][:k] = labels[members]
            batch["valid"] = (np.arange(cap) < k).astype(np.float32)
            if soft is not None:
                batch["soft"] = np.full(cap, 0.5, np.float32)
                batch["soft"][:k] = soft[members]
            yield batch, k


@dataclasses.dataclass
class PackedMultimodalPlan:
    """Per-epoch packed batch factory for ``train.loop.fit``; every
    per-sample column of the data (``label``, and ``soft`` when it has the
    distillation targets) goes into the batch as it is."""

    data: Dict[str, np.ndarray]
    batch_size: int
    abs_idx: Optional[np.ndarray] = None
    resident_images: bool = False
    row_multiple: int = 2
    shard: Tuple[int, int] = (0, 1)

    def __post_init__(self):
        if self.batch_size % self.shard[1]:
            raise ValueError(
                f"batch_size={self.batch_size} not divisible by the "
                f"data-axis extent {self.shard[1]}")
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
        rank, size = self.shard
        per = bs // size
        takes, parts = [], []
        for start in range(0, n, bs):
            take = idx[start:start + bs]
            if len(take) < bs:
                take = np.concatenate([take, np.resize(idx, bs - len(take))])
            k = min(bs, n - start)
            parts += [take[p * per:(p + 1) * per] for p in range(size)]
            takes.append((take[rank * per:(rank + 1) * per],
                          min(max(k - rank * per, 0), per)))
        m = self._mult
        bt = max(self._ffd_rows(d["text_mask"][t], self.text_len)
                 for t in parts)
        self._budget_t = max(self._budget_t, -(-bt // m) * m)
        if self.has_caption:
            bc = max(self._ffd_rows(d["caption_mask"][t], self.caption_len)
                     for t in parts)
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
            batch["valid"] = (np.arange(per) < k).astype(np.float32)
            yield batch, k


def packed_model_inputs(batch: Dict) -> Tuple[Dict, Optional[Dict]]:
    """A plan's batch layout as the packed models' arguments: ``(text_packed,
    caption_packed)`` (``PackedTextClassifier`` takes the first; a batch
    without caption rows gives None for the second)."""

    def branch(prefix):
        return {key: batch[f"{prefix}_{key}"]
                for key in ("ids", "segments", "positions", "row_of",
                            "slot_of", "start_of")}

    return branch("t"), (branch("c") if "c_ids" in batch else None)
