"""Sequence packing: many short samples per transformer row (copy of
``pack_sequences`` and port of ``packed_sample_view`` and ``unpack_cls`` in
``mpmc_tpu/ops/packing.py``).

Several samples lie end to end in one row and stay independent through
segment-masked attention (token i attends token j iff both carry the same
non-zero segment id); per-segment position ids restart at 0, so each
sample's numbers are those of the unpacked forward.  The packer is a
deterministic first-fit-decreasing bin packer on the host (numpy); the
device side gathers each sample's CLS from its row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    """Fixed-shape packed view of B variable-length samples in R rows."""

    ids: np.ndarray        # [R, P] int32 packed token ids (0-padded)
    segments: np.ndarray   # [R, P] int32 segment ids; 0 = padding
    positions: np.ndarray  # [R, P] int32, restart at 0 per segment
    row_of: np.ndarray     # [B] int32 packed row of sample b
    slot_of: np.ndarray    # [B] int32 segment id of sample b in its row
    start_of: np.ndarray   # [B] int32 offset of sample b's first token

    @property
    def num_rows(self) -> int:
        return self.ids.shape[0]


def pack_sequences(ids: np.ndarray, mask: np.ndarray, pack_len: int,
                   num_rows: Optional[int] = None,
                   max_segments: Optional[int] = None) -> PackedBatch:
    """First-fit-decreasing packing of ``[B, S]`` right-padded ids into
    ``[R, pack_len]`` rows (stable sort by decreasing length, ties by
    index).  Samples longer than ``pack_len`` are truncated; an empty
    sample still gets a one-token slot.  ``num_rows`` pins R (raises if
    the packing needs more); ``max_segments`` caps the samples per row."""
    ids = np.asarray(ids)
    mask = np.asarray(mask)
    B = ids.shape[0]
    raw_lengths = mask.sum(axis=1).astype(np.int64)
    if not np.array_equal(
            mask.astype(bool),
            np.arange(mask.shape[1])[None, :] < raw_lengths[:, None]):
        raise ValueError("pack_sequences requires right-padded prefix masks "
                         "(mask rows must be 1...1 0...0)")
    lengths = np.maximum(np.minimum(raw_lengths, pack_len), 1)
    order = np.argsort(-lengths, kind="stable")

    used: list = []      # tokens used per open row
    slots: list = []     # segments opened per row
    row_of = np.zeros(B, np.int32)
    slot_of = np.zeros(B, np.int32)
    start_of = np.zeros(B, np.int32)
    cap = max_segments or B
    for b in order:
        L = int(lengths[b])
        for r, u in enumerate(used):
            if u + L <= pack_len and slots[r] < cap:
                break
        else:
            r = len(used)
            used.append(0)
            slots.append(0)
        row_of[b] = r
        start_of[b] = used[r]
        slots[r] += 1
        slot_of[b] = slots[r]
        used[r] += L

    R = len(used)
    if num_rows is not None:
        if R > num_rows:
            raise ValueError(f"packing needs {R} rows of {pack_len} but "
                             f"num_rows={num_rows}")
        R = num_rows
    out_ids = np.zeros((R, pack_len), ids.dtype)
    segments = np.zeros((R, pack_len), np.int32)
    positions = np.zeros((R, pack_len), np.int32)
    for b in range(B):
        L = int(lengths[b])
        r, s0 = int(row_of[b]), int(start_of[b])
        out_ids[r, s0:s0 + L] = ids[b, :L]
        segments[r, s0:s0 + L] = int(slot_of[b])
        positions[r, s0:s0 + L] = np.arange(L)
    return PackedBatch(out_ids, segments, positions, row_of, slot_of,
                       start_of)


def packed_sample_view(hidden: torch.Tensor,
                       packed: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample view of packed encoder output for the masked poolers:
    ``[R, P, H] -> ([B, P, H], [B, P])``, row b being sample b's packed row
    and the int32 mask selecting exactly its own tokens.  A padding slot
    (``row_of`` and ``slot_of`` 0) selects row 0's padding tokens, or
    none."""
    row_of = packed["row_of"].long()
    mask = packed["segments"][row_of] == packed["slot_of"][:, None]
    return hidden[row_of], mask.to(torch.int32)


def unpack_cls(hidden: torch.Tensor, packed: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """CLS pooling over a packed batch: each sample's first token,
    ``[R, P, H] -> [B, H]``."""
    return hidden[packed["row_of"].long(), packed["start_of"].long()]
