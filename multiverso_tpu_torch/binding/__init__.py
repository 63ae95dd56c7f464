"""Reference-compatible Python binding surface.

Counterpart of ``multiverso_tpu/binding/__init__.py`` (reference
binding/python/multiverso/api.py, tables.py): ``init(sync=)``,
``shutdown``, ``barrier``, ``workers_num``, ``worker_id``, ``server_id``,
``is_master_worker``, ``ArrayTableHandler`` and ``MatrixTableHandler`` with
the master-initializes convention (reference tables.py:49-58: every worker
adds at construction, blocking; only the master contributes the init
value, the others zeros, so the BSP clocks stay aligned).

The tables live where the world runs: on ``cuda:0`` unless ``args`` asks
for the CPU (``-mv_device=cpu``). ``add(..., sync=False)`` is a
fire-and-forget ``AddFireForget``, so consecutive async pushes to one table
are combined on the worker (``-mv_write_combine``) as in the JAX package.

Usage::

    import multiverso_tpu_torch.binding as mv
    mv.init()
    t = mv.ArrayTableHandler(1000, init_value=w0)
    t.add(grad); w = t.get()
    mv.shutdown()
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import multiverso_tpu_torch as _core
from multiverso_tpu_torch.tables import ArrayTableOption, MatrixTableOption


def init(sync: bool = False, args: Optional[Sequence[str]] = None) -> None:
    """Bring up the world (reference api.py:12-34; ``-sync=true`` when
    asked)."""
    argv = list(args or [])
    if sync:
        argv.append("-sync=true")
    _core.MV_Init(argv)


def shutdown() -> None:
    _core.MV_ShutDown()


def barrier() -> None:
    _core.MV_Barrier()


def workers_num() -> int:
    return _core.MV_NumWorkers()


def worker_id() -> int:
    return _core.MV_WorkerId()


def server_id() -> int:
    return _core.MV_ServerId()


def is_master_worker() -> bool:
    """Worker 0 owns one-time work: init values, validation, result output
    (reference api.py:68-75)."""
    return worker_id() == 0


class TableHandler:
    """reference tables.py:14-31."""

    def get(self):
        raise NotImplementedError

    def add(self, data, sync: bool = False):
        raise NotImplementedError


class ArrayTableHandler(TableHandler):
    """1-D float32 table (reference tables.py:38-84)."""

    def __init__(self, size: int, init_value=None):
        self._size = size
        self._table = _core.MV_CreateTable(ArrayTableOption(size=size))
        if init_value is not None:
            init_value = np.asarray(init_value, np.float32)
            # master-initializes: everyone adds, only the master's add is
            # the init value
            self.add(init_value if is_master_worker()
                     else np.zeros(init_value.shape, np.float32), sync=True)

    def get(self) -> np.ndarray:
        return self._table.Get()

    def add(self, data, sync: bool = False) -> None:
        data = np.asarray(data, np.float32)
        assert data.size == self._size
        if sync:
            self._table.Add(data)
        else:
            self._table.AddFireForget(data)


class MatrixTableHandler(TableHandler):
    """2-D float32 table with whole-table or row-set access (reference
    tables.py:87-165)."""

    def __init__(self, num_row: int, num_col: int, init_value=None):
        self._num_row = num_row
        self._num_col = num_col
        self._table = _core.MV_CreateTable(
            MatrixTableOption(num_rows=num_row, num_cols=num_col))
        if init_value is not None:
            init_value = np.asarray(init_value, np.float32).reshape(num_row,
                                                                    num_col)
            self.add(init_value if is_master_worker()
                     else np.zeros(init_value.shape, np.float32), sync=True)

    def get(self, row_ids=None) -> np.ndarray:
        if row_ids is None:
            return self._table.Get()
        return self._table.GetRows(np.asarray(row_ids, np.int32))

    def add(self, data, row_ids=None, sync: bool = False) -> None:
        data = np.asarray(data, np.float32)
        if row_ids is None:
            assert data.size == self._num_row * self._num_col
            if sync:
                self._table.Add(data)
            else:
                self._table.AddFireForget(data)
        else:
            row_ids = np.asarray(row_ids, np.int32)
            data = data.reshape(len(row_ids), self._num_col)
            if sync:
                self._table.AddRows(row_ids, data)
            else:
                self._table.AddFireForget(data, row_ids=row_ids)
