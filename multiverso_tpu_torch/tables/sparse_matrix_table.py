"""SparseMatrixTable — MatrixTable + per-(worker, row) freshness bits.

Counterpart of ``multiverso_tpu/tables/sparse_matrix_table.py`` (reference
sparse_matrix_table.h/.cpp): the server keeps an
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

Multi-process worlds (the JAX package's design): the bit matrix is
replicated per process and keyed by GLOBAL worker id ``rank * num_workers
+ local_wid``, each (process, worker thread) pair a consumer of its own.
The engine hands every rank's (worker, rows) parts of each collective Add
and Get to every process, and each applies every part's transition in rank
order: the event stream one shared server would see, so the replicas
cannot diverge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.tables.matrix_table import (MatrixServerTable,
                                                      MatrixTableOption,
                                                      MatrixWorkerTable)
from multiverso_tpu_torch.updaters.base import AddOption, GetOption
from multiverso_tpu_torch.utils.log import CHECK


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
        self._procs = multihost.world_size()
        self._rank = multihost.world_rank()
        self._workers_per_proc = zoo.num_workers
        if self._procs > 1:
            # every rank maps global worker ids from its own flag: a
            # -num_workers mismatch would silently diverge the bits
            counts = multihost.host_allgather_objects(zoo.num_workers)
            CHECK(all(c == counts[0] for c in counts),
                  f"-num_workers diverges across processes: {counts}")
        # all fresh at start (reference ctor, sparse_matrix_table.cpp:184-196)
        self.up_to_date = np.ones((self._procs * zoo.num_workers, num_rows),
                                  dtype=bool)

    def _gwid(self, rank: int, worker_id: int) -> Optional[int]:
        """Global worker id, or None for an id outside [0, num_workers) —
        a push no worker owns: everyone goes stale."""
        if not 0 <= worker_id < self._workers_per_proc:
            return None
        return rank * self._workers_per_proc + worker_id

    def _mark_stale(self, keeper: Optional[int],
                    row_ids: Optional[np.ndarray]) -> None:
        """reference UpdateAddState: ``row_ids`` (None = all) go stale for
        every global worker but ``keeper``."""
        mask = np.ones(self.up_to_date.shape[0], dtype=bool)
        if keeper is not None:
            mask[keeper] = False
        if row_ids is None:
            self.up_to_date[mask, :] = False
        else:
            cols = np.asarray(row_ids, np.int64).ravel()
            self.up_to_date[np.ix_(mask, cols)] = False

    def _update_get_state(self, gwid: int,
                          row_ids: Optional[np.ndarray]) -> np.ndarray:
        """reference UpdateGetState: the row ids to ship, re-marked fresh
        (``gwid == -1``: every row, no bit changes)."""
        if gwid == -1:
            return np.arange(self.num_rows, dtype=np.int32)
        if row_ids is None:
            stale = np.nonzero(~self.up_to_date[gwid])[0]
        else:
            ids = np.asarray(row_ids, np.int64).ravel()
            # validate BEFORE touching the bits: a rejected Get must not
            # mark rows fresh (negative ids would silently wrap)
            self._check_ids(ids)
            stale = ids[~self.up_to_date[gwid, ids]]
        if stale.size == 0:
            # all fresh: still ship row 0 (sparse_matrix_table.cpp:255-257)
            return np.zeros(1, dtype=np.int32)
        self.up_to_date[gwid, stale] = True
        return stale.astype(np.int32)

    def _note_add_parts(self, option: AddOption, parts) -> None:
        """Every rank's id set of an applied Add, in rank order: each part
        keeps its own global keeper fresh (the options agree across ranks,
        so one Add has one local worker id everywhere)."""
        for rank, part_ids in enumerate(parts):
            self._mark_stale(self._gwid(rank, option.worker_id),
                             None if part_ids is None
                             else np.asarray(part_ids, np.int32).ravel())

    def _note_add(self, option: Optional[AddOption], row_ids) -> None:
        self._note_add_parts(option or AddOption(), [row_ids])

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

    def _get_ids(self, parts) -> list:
        """Run one collective Get's freshness transitions for every rank's
        ``(worker_id, row_ids)`` part in rank order; returns every rank's
        ids to ship."""
        outs = []
        for rank, (wid, part_ids) in enumerate(parts):
            gwid = self._gwid(rank, wid)
            outs.append(self._update_get_state(
                -1 if gwid is None else gwid,
                None if part_ids is None else np.asarray(part_ids,
                                                         np.int64)))
        return outs

    @staticmethod
    def _decode_part(p: dict):
        opt = p.get("option")
        return (opt.worker_id if opt is not None else -1, p.get("row_ids"))

    def ProcessGet(self, option: Optional[GetOption] = None,
                   row_ids=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (row_ids, rows): the server decides which rows move."""
        return self.ProcessGetParts([{"option": option, "row_ids": row_ids}],
                                    0)

    def ProcessGetParts(self, parts, my_rank: int):
        """Every rank's freshness transitions in rank order, then this
        rank's rows from its replica."""
        out_ids = self._get_ids([self._decode_part(p)
                                 for p in parts])[my_rank]
        rows = MatrixServerTable.ProcessGetAsync(self, None, out_ids)()
        return out_ids, rows

    def ProcessGetWindowParts(self, positions, my_rank: int):
        """A segment's Gets: the transitions strictly in position order
        (they mutate the bits), then ONE gather over the union of this
        rank's ids (no Add applies between a segment's Gets, so every
        position reads the same rows), sliced per position."""
        per_pos = []
        for parts in positions:
            try:
                per_pos.append(self._get_ids(
                    [self._decode_part(p) for p in parts])[my_rank])
            except Exception as exc:
                # _update_get_state validates before it touches the bits
                per_pos.append(exc)
        ok = [o for o in per_pos if not isinstance(o, Exception)]
        if not ok:
            return per_pos
        union = np.unique(np.concatenate(ok)).astype(np.int32)
        rows_u = MatrixServerTable.ProcessGetAsync(self, None, union)()
        return [o if isinstance(o, Exception)
                else (o, rows_u[np.searchsorted(union, o)]) for o in per_pos]


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
