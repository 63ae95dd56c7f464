"""SparseMatrixTable — MatrixTable + per-(worker, row) freshness bits.

Counterpart of ``multiverso_tpu/tables/sparse_matrix_table.py`` (reference
sparse_matrix_table.h/.cpp), single-process: the server keeps an
``up_to_date`` bit per (worker, row). An Add from worker w marks the
touched rows stale for every OTHER worker (UpdateAddState,
sparse_matrix_table.cpp:200-223); a Get from worker w returns only the rows
stale for w and re-marks them fresh, falling back to row 0 when nothing
changed (UpdateGetState, sparse_matrix_table.cpp:226-259); ``worker_id ==
-1`` fetches every row. Gets therefore return ``(row_ids, rows)``.

The bits are host state (a numpy bool matrix): deciding which rows to ship
is host logic; the row data moves through the parent's gather kernel. The
bits change only AFTER an Add applied, so a rejected Add leaves them alone,
and a Get validates its ids before it touches them. ``compress`` is the
parent's compressed row wire; a compressed Add marks its rows stale like
any other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from multiverso_tpu_torch.tables.matrix_table import (MatrixServerTable,
                                                      MatrixTableOption,
                                                      MatrixWorkerTable)
from multiverso_tpu_torch.updaters.base import AddOption, GetOption


@dataclass
class SparseMatrixTableOption(MatrixTableOption):
    def make_server(self, zoo):
        return SparseMatrixServerTable(self.num_rows, self.num_cols,
                                       self.dtype, zoo, self.updater_type,
                                       self.initializer,
                                       compress=self.compress)

    def make_worker(self, zoo):
        return SparseMatrixWorkerTable(self.num_rows, self.num_cols,
                                       self.dtype, compress=self.compress)


class SparseMatrixServerTable(MatrixServerTable):
    def __init__(self, num_rows, num_cols, dtype, zoo, updater_type=None,
                 initializer=None, compress=None):
        super().__init__(num_rows, num_cols, dtype, zoo, updater_type,
                         initializer, compress=compress)
        self._num_workers = zoo.num_workers
        # all fresh at start (reference ctor, sparse_matrix_table.cpp:184-196)
        self.up_to_date = np.ones((zoo.num_workers, num_rows), dtype=bool)

    def _keeper(self, worker_id: int) -> Optional[int]:
        """The worker whose own push this was, or None for an id outside
        [0, num_workers) — a push no worker owns: everyone goes stale."""
        return worker_id if 0 <= worker_id < self._num_workers else None

    def _mark_stale(self, keeper: Optional[int],
                    row_ids: Optional[np.ndarray]) -> None:
        """reference UpdateAddState: ``row_ids`` (None = all) go stale for
        every worker but ``keeper``."""
        mask = np.ones(self.up_to_date.shape[0], dtype=bool)
        if keeper is not None:
            mask[keeper] = False
        if row_ids is None:
            self.up_to_date[mask, :] = False
        else:
            cols = np.asarray(row_ids, np.int64).ravel()
            self.up_to_date[np.ix_(mask, cols)] = False

    def _update_get_state(self, worker_id: int,
                          row_ids: Optional[np.ndarray]) -> np.ndarray:
        """reference UpdateGetState: the row ids to ship, re-marked fresh
        (``worker_id == -1``: every row, no bit changes)."""
        if worker_id == -1:
            return np.arange(self.num_rows, dtype=np.int32)
        if row_ids is None:
            stale = np.nonzero(~self.up_to_date[worker_id])[0]
        else:
            ids = np.asarray(row_ids, np.int64).ravel()
            # validate BEFORE touching the bits: a rejected Get must not
            # mark rows fresh (negative ids would silently wrap)
            self._check_ids(ids)
            stale = ids[~self.up_to_date[worker_id, ids]]
        if stale.size == 0:
            # all fresh: still ship row 0 (sparse_matrix_table.cpp:255-257)
            return np.zeros(1, dtype=np.int32)
        self.up_to_date[worker_id, stale] = True
        return stale.astype(np.int32)

    def _note_add(self, option: Optional[AddOption], row_ids) -> None:
        opt = option or AddOption()
        self._mark_stale(self._keeper(opt.worker_id),
                         None if row_ids is None
                         else np.asarray(row_ids, np.int32).ravel())

    def ProcessAdd(self, values: Optional[np.ndarray] = None,
                   option: Optional[AddOption] = None,
                   row_ids: Optional[np.ndarray] = None,
                   compressed: Optional[dict] = None) -> None:
        super().ProcessAdd(values, option, row_ids, compressed)
        self._note_add(option, row_ids if compressed is None
                       else compressed["row_ids"])

    def ProcessAddRun(self, payloads) -> bool:
        """The parent's merged window Add, then every payload's freshness
        transition in message order (the engine serves no Get between a
        run's Adds, so this equals applying them one by one)."""
        if not super().ProcessAddRun(payloads):
            return False
        for p in payloads:
            self._note_add(p.get("option"), p.get("row_ids"))
        return True

    def ProcessGetAsync(self, option: Optional[GetOption] = None,
                        row_ids=None):
        # a sparse Get MUTATES the bits and returns (ids, rows): the
        # matrix table's two-phase Get (and the engine's Get dedup) would
        # bypass the protocol
        return None

    def ProcessGet(self, option: Optional[GetOption] = None,
                   row_ids=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (row_ids, rows): the server decides which rows move."""
        worker_id = option.worker_id if option is not None else -1
        if self._keeper(worker_id) is None:
            worker_id = -1
        out_ids = self._update_get_state(
            worker_id, None if row_ids is None
            else np.asarray(row_ids, np.int64))
        rows = MatrixServerTable.ProcessGetAsync(self, option, out_ids)()
        return out_ids, rows


class SparseMatrixWorkerTable(MatrixWorkerTable):
    """Worker half: Get returns (row_ids, rows), since the server picks the
    rows (reference sparse ProcessReplyGet fills only returned rows)."""

    def Get(self, option: Optional[GetOption] = None):
        if option is None:
            option = GetOption(worker_id=self._zoo.current_worker_id())
        return self.Wait(self.GetAsync({"row_ids": None}, option))

    def GetRows(self, row_ids, option: Optional[GetOption] = None):
        if option is None:
            option = GetOption(worker_id=self._zoo.current_worker_id())
        ids = np.asarray(row_ids, np.int32)
        return self.Wait(self.GetAsync({"row_ids": ids}, option))
