"""The whole-table reads' logical layout, cut on the table's device, on the
CPU.

(1) ``MatrixServerTable._logical`` against numpy cutting the same storage
    on the host, bitwise, for every layout a table can have: pad columns
    cut (5 of 8 stored) or none (8 of 8), rows not a multiple of the
    shards' block (37 over 3 and 4 shards), float32 and int32, with and
    without the per-worker aux leaves' leading axis;
(2) a MatrixTable's whole Get (momentum: the device path serves it on the
    CPU too), ``raw()`` and ``aux_to_logical`` hand the caller fresh
    arrays: two Gets share no memory with each other or the storage,
    writing into one leaves the next as it was, a write to the storage
    after a Get's dispatch does not reach its reply (the snapshot an
    engine window takes before its Adds), and the aux leaves come back as
    ``aux_from_logical`` laid them down;
(3) the same ownership for an ArrayTable's whole Get.
"""

import types

import numpy as np
import torch

from multiverso_tpu_torch import api as mv
from multiverso_tpu_torch.parallel.mesh import ceil_block_rows
from multiverso_tpu_torch.tables import ArrayTableOption, MatrixTableOption
from multiverso_tpu_torch.tables.matrix_table import (MatrixServerTable,
                                                      padded_cols)
from multiverso_tpu_torch.updaters.base import AddOption

# C = 8 leaves no pad column: the logical view is then the storage itself
R, C, K = 40, 8, 10


def _logical_host(storage, num_servers, block_rows, num_rows, num_cols):
    """The logical layout cut from host storage with numpy: (padded_rows,
    store_cols) -> (num_rows, num_cols), shard by shard."""
    shard_rows = storage.shape[0] // num_servers
    blocks = storage.reshape(num_servers, shard_rows,
                             storage.shape[1])[:, :block_rows, :num_cols]
    return blocks.reshape(-1, num_cols)[:num_rows]


# (server shards, logical rows, logical cols, dtype, leading dims)
LAYOUTS = [(1, 37, 5, torch.float32, ()), (1, 37, 8, torch.int32, ()),
           (3, 37, 5, torch.float32, ()), (3, 37, 5, torch.int32, ()),
           (4, 37, 6, torch.float32, (2,)), (1, 40, 5, torch.int32, (3,))]


def _layout(num_servers, num_rows, num_cols):
    """A stand-in carrying a table's layout fields and ``_logical``, so
    layouts of more than the one server shard a world has are reachable."""
    block = ceil_block_rows(num_rows, num_servers)
    layout = types.SimpleNamespace(
        num_servers=num_servers, block_rows=block, shard_rows=block + 1,
        num_rows=num_rows, num_cols=num_cols,
        store_cols=padded_cols(num_cols))
    layout._logical = types.MethodType(MatrixServerTable._logical, layout)
    return layout


def test_logical_cut_on_the_device_is_the_host_cut():
    for num_servers, num_rows, num_cols, dtype, lead in LAYOUTS:
        case = (num_servers, num_rows, num_cols, dtype, lead)
        layout = _layout(num_servers, num_rows, num_cols)
        rng = np.random.default_rng(num_servers * 100 + num_rows + num_cols)
        shape = lead + (num_servers * layout.shard_rows, layout.store_cols)
        if dtype == torch.float32:
            host = rng.standard_normal(shape).astype(np.float32)
            host.reshape(-1)[:3] = (np.nan, -0.0, np.inf)
        else:
            host = rng.integers(-2**31, 2**31, shape).astype(np.int32)
        want = np.stack([
            _logical_host(h, num_servers, layout.block_rows, num_rows,
                          num_cols)
            for h in host.reshape((-1,) + shape[-2:])]).reshape(
                lead + (num_rows, num_cols))
        view = layout._logical(torch.from_numpy(host))
        assert view.dtype == dtype and view.shape == want.shape, case
        assert view.numpy().tobytes() == want.tobytes(), case


def _check_owned(table, storage):
    first, second = table.Get(), table.Get()
    assert not np.shares_memory(first, second)
    assert not np.shares_memory(first, storage)
    np.testing.assert_array_equal(first, second)
    kept = second.copy()
    first[...] = 99.0
    np.testing.assert_array_equal(table.Get(), kept)
    return kept


def test_matrix_whole_reads_are_caller_owned():
    rng = np.random.default_rng(12)
    mv.MV_Init(["-mv_device=cpu"])
    try:
        t = mv.MV_CreateTable(MatrixTableOption(
            num_rows=R, num_cols=C, updater_type="momentum"))
        for _ in range(2):
            t.AddRows(rng.permutation(R)[:K].astype(np.int32),
                      rng.integers(-3, 4, (K, C)).astype(np.float32),
                      AddOption(momentum=0.5))
        srv = t.server()
        storage = srv.state["data"].numpy()
        whole = _check_owned(t, storage)
        finalize = srv.ProcessGetAsync()
        srv.state["data"].add_(1.0)
        np.testing.assert_array_equal(finalize(), whole)
        srv.state["data"].sub_(1.0)
        raw = srv.raw()
        np.testing.assert_array_equal(raw, whole)
        assert not np.shares_memory(raw, storage)
        leaf = srv.state["aux"]["smooth"]
        logical = srv.aux_to_logical(leaf)
        assert logical.shape == (R, C) and np.any(logical)
        assert not np.shares_memory(logical, leaf.numpy())
        assert srv.aux_from_logical(logical).tobytes() == \
            leaf.numpy().tobytes()
    finally:
        mv.MV_ShutDown()


def test_array_whole_gets_are_caller_owned():
    rng = np.random.default_rng(13)
    mv.MV_Init(["-mv_device=cpu"])
    try:
        t = mv.MV_CreateTable(ArrayTableOption(size=R * C))
        delta = rng.integers(-3, 4, R * C).astype(np.float32)
        t.Add(delta)
        kept = _check_owned(t, t.server().state["data"].numpy())
        np.testing.assert_array_equal(kept, delta)
    finally:
        mv.MV_ShutDown()
