"""One coalesced serving read of callers whose ids come in different
integer dtypes (the port's serving front-end, on the CPU).

Two callers are held back (``_hold_for_tests``) so that they coalesce on
one snapshot into ONE union read, one with int64 ids and one with uint64
ids, on each of three snapshots:

* a host-resident Matrix snapshot;
* a host-resident Array snapshot;
* a KV snapshot holding the keys 2**60 and 2**60 + 1, which a float64
  union cannot tell apart.

Each caller must be served exactly its own rows or values, as it is
served alone, and a uint64 id above the int64 maximum must raise
``ValueError`` at admission. The front-end casts every caller's ids to
int64 when it admits them. The JAX package's front-end promotes such a
union to float64 (ROADMAP.md §3), so no JAX equality is expected here.
"""

import threading
import time

import numpy as np
import pytest
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch import serving
from multiverso_tpu_torch.tables import (ArrayTableOption, KVTableOption,
                                         MatrixTableOption)

torch.set_num_threads(1)

ROWS, COLS, SIZE = 40, 3, 16
BIG = 2 ** 60


def _matrix():
    t = mv.MV_CreateTable(MatrixTableOption(num_rows=ROWS, num_cols=COLS))
    t.AddRows(np.arange(ROWS, dtype=np.int32),
              np.arange(ROWS * COLS, dtype=np.float32).reshape(ROWS, COLS))
    return t, np.array([3, 17, 39, 0]), np.array([38, 17, 2], np.uint64)


def _array():
    t = mv.MV_CreateTable(ArrayTableOption(size=SIZE))
    t.Add(np.arange(SIZE, dtype=np.float32) * 2 + 1)
    return t, np.array([15, 0, 7]), np.array([7, 9, 1, 14], np.uint64)


def _kv():
    t = mv.MV_CreateTable(KVTableOption())
    t.Add(np.array([BIG, BIG + 1, 5], np.int64),
          np.array([1.0, 2.0, 3.0], np.float32))
    return t, np.array([BIG + 1, 5, 11]), np.array([BIG, BIG + 1],
                                                    np.uint64)


@pytest.mark.parametrize("make", [_matrix, _array, _kv],
                         ids=["matrix_host", "array_host", "kv"])
def test_mixed_dtype_callers_share_one_read(make):
    mv.MV_Init(["-mv_device=cpu", "-mv_serving_residence=host"])
    try:
        table, ids64, idsu = make()
        v = mv.MV_PublishSnapshot()
        plane = serving.get_plane()
        fe = plane.frontend
        snap = plane.store.get(v).tables[table.table_id]
        if hasattr(snap, "residence"):
            assert snap.residence == "host"
        # each caller served alone: the reference for the coalesced read
        alone = [fe.lookup(table.table_id, ids64, version=v),
                 fe.lookup(table.table_id, idsu, version=v)]
        if make is _kv:
            np.testing.assert_array_equal(alone[0], [2.0, 3.0, 0.0])
            np.testing.assert_array_equal(alone[1], [1.0, 2.0])
        reads0 = snap.dispatches
        fe._hold_for_tests = threading.Event()
        if fe._thread is not None:
            time.sleep(0.35)          # a running dispatcher reaches the hold
        tickets = [fe.lookup_async(table.table_id, ids64, version=v),
                   fe.lookup_async(table.table_id, idsu, version=v)]
        with pytest.raises(ValueError, match="int64 maximum"):
            fe.lookup_async(table.table_id,
                            np.array([1, 2 ** 63 + 5], np.uint64), version=v)
        hold, fe._hold_for_tests = fe._hold_for_tests, None
        hold.set()
        got = [t.Wait(10.0) for t in tickets]
        assert snap.dispatches == reads0 + 1       # ONE union read
        for g, want in zip(got, alone):
            assert g.dtype == want.dtype
            np.testing.assert_array_equal(g, want)
    finally:
        mv.MV_ShutDown()
