"""Delta-compression filters for the compressed row wire.

The port's own numpy copy of ``multiverso_tpu/utils/quantization.py``
(reference util/quantization_util.h), bitwise the same:

* ``SparseFilter`` (quantization_util.h:95-137): (index, value) pairs when
  more than half of the entries are zero (``|x| <= clip``), else the dense
  payload;
* ``RowOneBitsFilter``: 1-bit quantization with per-row error feedback for
  ``compress="1bit"`` (sign bits for a bucket-padded lane layout plus
  per-row positive and negative means; the quantization error of every
  pushed row feeds that row's next push; Seide et al. 2014);
* ``OneBitsFilter``: the same for one whole tensor with two means (the
  reference declares it with an empty body, quantization_util.h:160-161).

The filters run on the worker's host; the tables rebuild the dense rows on
the device (``tables/matrix_table.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SparseFilter:
    """Threshold sparsifier: a value with ``|x| <= clip`` counts as zero."""

    def __init__(self, clip: float = 0.0):
        self.clip = float(clip)

    def compress(self, dense: np.ndarray
                 ) -> Tuple[bool, np.ndarray, np.ndarray]:
        """(is_sparse, indices, values): sparse iff strictly more than half
        the entries are zero; when dense wins, the indices are empty and
        the values are the flattened input."""
        flat = np.asarray(dense).ravel()
        nonzero = np.abs(flat) > self.clip
        if int(nonzero.sum()) * 2 < flat.size:
            idx = np.nonzero(nonzero)[0].astype(np.int32)
            return True, idx, flat[idx]
        return False, np.empty(0, np.int32), flat

    def decompress(self, is_sparse: bool, indices: np.ndarray,
                   values: np.ndarray, size: int,
                   dtype=np.float32) -> np.ndarray:
        if not is_sparse:
            return np.asarray(values, dtype=dtype).reshape(size)
        out = np.zeros(size, dtype=dtype)
        out[indices] = values
        return out


class RowOneBitsFilter:
    """Row-addressed 1-bit quantization with error feedback. The residual
    is row-sparse: a compact (slots, cols) buffer and an id -> slot map,
    grown 2x, so only pushed rows cost memory. Wire cost: 1 bit an
    element plus 8 bytes a row."""

    def __init__(self, num_rows: int, num_cols: int):
        self.num_rows = int(num_rows)
        self.num_cols = int(num_cols)
        self._slot: dict = {}
        self._buf = np.zeros((0, self.num_cols), np.float32)

    def _slots_for(self, row_ids: np.ndarray) -> np.ndarray:
        slot = self._slot
        slots = np.fromiter((slot.setdefault(int(r), len(slot))
                             for r in row_ids), np.int64, len(row_ids))
        if len(slot) > len(self._buf):
            grown = np.zeros((max(64, 2 * len(slot)), self.num_cols),
                             np.float32)
            grown[: len(self._buf)] = self._buf
            self._buf = grown
        return slots

    def compress(self, row_ids: np.ndarray, deltas: np.ndarray,
                 bucket: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row_ids (k,), deltas (k, cols), bucket >= k) -> (packed sign
        bits for bucket * cols lanes, pos_means (k,), neg_means (k,))."""
        slots = self._slots_for(np.asarray(row_ids).ravel())
        deltas = np.asarray(deltas, np.float32).reshape(len(row_ids),
                                                        self.num_cols)
        x = deltas + self._buf[slots]
        pos = x >= 0.0
        npos = pos.sum(axis=1)
        pos_means = (np.where(pos, x, 0).sum(axis=1)
                     / np.maximum(npos, 1)).astype(np.float32)
        neg_means = (np.where(~pos, x, 0).sum(axis=1)
                     / np.maximum(self.num_cols - npos, 1)).astype(np.float32)
        recon = np.where(pos, pos_means[:, None], neg_means[:, None])
        self._buf[slots] = x - recon    # error feedback
        lanes = np.zeros(bucket * self.num_cols, bool)
        lanes[: pos.size] = pos.ravel()
        return np.packbits(lanes), pos_means, neg_means


class OneBitsFilter:
    """1-bit quantization of one tensor with error feedback: the residual
    joins the next delta before it is quantized. Wire cost: 1 bit an
    element plus two float means."""

    def __init__(self):
        self._residual = None

    def compress(self, dense: np.ndarray) -> Tuple[np.ndarray, float, float]:
        """-> (packed sign bits, positive mean, negative mean)."""
        flat = np.asarray(dense, np.float32).ravel()
        if self._residual is None:
            self._residual = np.zeros_like(flat)
        if flat.size != self._residual.size:
            raise ValueError(
                f"OneBitsFilter is per-tensor stateful: got {flat.size} "
                f"elements, residual holds {self._residual.size}")
        x = flat + self._residual
        pos = x >= 0.0
        pos_mean = float(x[pos].mean()) if pos.any() else 0.0
        neg_mean = float(x[~pos].mean()) if (~pos).any() else 0.0
        recon = np.where(pos, np.float32(pos_mean), np.float32(neg_mean))
        self._residual = x - recon      # error feedback
        return np.packbits(pos), pos_mean, neg_mean

    def decompress(self, bits: np.ndarray, pos_mean: float, neg_mean: float,
                   size: int, dtype=np.float32) -> np.ndarray:
        unpacked = np.unpackbits(np.asarray(bits, np.uint8))
        if unpacked.size < size:
            raise ValueError(f"packed payload holds {unpacked.size} bits, "
                             f"caller asked for {size}")
        pos = unpacked[:size].astype(bool)
        return np.where(pos, dtype(pos_mean), dtype(neg_mean))
