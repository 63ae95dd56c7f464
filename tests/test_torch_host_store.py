"""The CPU host plane: a matrix table on the CPU with the add or sgd
updater applies and serves its host verbs through the repo's native host
store (``native.NativeHostStore``), against the JAX package's native
mirror on the CPU backend (the counterparts of ``tests/test_tables.py``'s
``TestNativeHostMirror``).

(a) One verb script in a JAX world and a port world, one after the other
    (``-mv_write_combine=0`` in both, so fire-and-forget bursts reach the
    engine as merged runs), for the add and the sgd updater: blocking row
    Adds with duplicates (float deltas) on half the rows, bursts of one
    id set and of mixed id sets on the other half (integer-valued deltas
    on integer rows: the grouping of a run into windows is timing, and
    integer sums are exact in any order), a
    whole-table Add, row and whole-table Gets. The store engages in both
    packages, every Get is bitwise the JAX package's, ``raw()`` after the
    sync too; the pool's tallies rise by exactly the store's threaded
    calls; the watchdog's sample carries ``pool_inline_busy`` and
    ``pool_parallel``, and ``apply_pool_sat`` reads them (it no longer
    HOLDs for want of evidence).
(b) A device-plane write drops the mirror and the rebuild stays
    consistent, as in the JAX package; the byte ledger, probed from a
    sampler thread, reports ``host_mirror_bytes`` and never syncs a dirty
    mirror; a publish copies from the mirror; the ineligible tables
    (momentum, compression) never ride the store.
"""

import threading

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

ROWS, COLS = 4096, 64        # 1,100 rows or more are over the pool's floor


def _native_or_skip():
    from multiverso_tpu_torch import native
    if native.lib() is None:
        pytest.skip(f"no C++ toolchain: {native.last_build_error}")


def _script(mv, tables, updater):
    """The verb script; returns (what the Gets saw, the server table)."""
    rng = np.random.default_rng(17)
    t = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS, updater_type=updater))
    seen = []
    half = ROWS // 2
    for _ in range(4):
        ids = rng.integers(0, half, 1600).astype(np.int32)   # duplicates
        t.AddRows(ids, rng.standard_normal((1600, COLS)).astype(np.float32))
        seen.append(t.GetRows(np.unique(ids)[:300]))
    # the bursts on the other half: integer rows stay exact however the
    # windows group them
    same = (half + rng.choice(half, 1100, replace=False)).astype(np.int32)
    for _ in range(6):
        t.AddFireForget(rng.integers(-4, 5, (1100, COLS)).astype(np.float32),
                        row_ids=same)
    for _ in range(6):
        ids = (half + rng.integers(0, half, 1500)).astype(np.int32)
        t.AddFireForget(rng.integers(-4, 5, (1500, COLS)).astype(np.float32),
                        row_ids=ids)
    seen.append(t.GetRows(same))
    t.Add(rng.standard_normal((ROWS, COLS)).astype(np.float32))
    seen.append(t.Get())
    return seen, t.server()


def _jax_run(updater):
    import multiverso_tpu as jmv
    from multiverso_tpu import tables
    jmv.MV_Init(["-mv_write_combine=0"])
    try:
        seen, srv = _script(jmv, tables, updater)
        assert srv._nat_store is not None, "the JAX mirror did not engage"
        return seen, srv.raw()
    finally:
        jmv.MV_ShutDown()


class _Counting:
    """Counts the store's threaded calls (each one pool dispatch)."""

    def __init__(self, monkeypatch):
        from multiverso_tpu_torch import native
        self.n = 0
        for name in ("add_rows", "get_rows", "add_all"):
            orig = getattr(native.NativeHostStore, name)
            monkeypatch.setattr(native.NativeHostStore, name,
                                self._wrap(orig))

    def _wrap(self, orig):
        def wrapped(store, *a):
            self.n += 1
            return orig(store, *a)
        return wrapped


def _tallies(ps):
    return ps["parallel_runs"] + ps["inline_busy"] + ps["inline_small"]


@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_host_verbs_ride_the_store_as_in_jax(updater, monkeypatch):
    _native_or_skip()
    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch import native, tables
    from multiverso_tpu_torch.telemetry import watchdog
    jseen, jraw = _jax_run(updater)
    calls = _Counting(monkeypatch)
    tmv.MV_Init(["-mv_device=cpu", "-mv_write_combine=0"])
    try:
        before = native.pool_stats()
        s0 = watchdog.collect_sample()
        tseen, srv = _script(tmv, tables, updater)
        after = native.pool_stats()
        s1 = watchdog.collect_sample()
        assert srv._nat_store is not None and srv._native_host_ok
        assert native.USES["host_store"] > 0
        # 4 Adds, 4 Gets, the runs (how the bursts group into windows is
        # timing), the Get of the burst rows and the whole-table Add
        assert calls.n >= 17
        assert _tallies(after) - _tallies(before) == calls.n
        assert after["pool_threads"] >= 1
        for s in (s0, s1):
            assert {"pool_inline_busy", "pool_parallel"} <= set(s)
        assert s1["pool_parallel"] - s0["pool_parallel"] == \
            after["parallel_runs"] - before["parallel_runs"]
        assert s1["pool_inline_busy"] - s0["pool_inline_busy"] == \
            after["inline_busy"] - before["inline_busy"]
        eligible = (s1["pool_parallel"] + s1["pool_inline_busy"]
                    - s0["pool_parallel"] - s0["pool_inline_busy"])
        assert eligible >= 8
        # with >= 8 pool-eligible applies the rule decides: it fires on a
        # one-thread pool (every apply ran inline), clears otherwise
        verdict = watchdog.ApplyPoolSaturationRule().check([s0, s1])
        assert verdict is not watchdog.HOLD
        assert (verdict is None) == (after["pool_threads"] > 1)
        assert srv._nat_dirty
        traw = srv.raw()            # the state read syncs the mirror back
        assert not srv._nat_dirty and srv._nat_store is not None
    finally:
        tmv.MV_ShutDown()
    assert len(tseen) == len(jseen)
    for i, (t, j) in enumerate(zip(tseen, jseen)):
        assert t.dtype == np.float32 and t.shape == j.shape, i
        assert t.tobytes() == j.tobytes(), f"Get {i} differs from JAX"
    assert traw.tobytes() == jraw.tobytes()


def _device_write_script(mv, tables, to_np):
    t = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=64,
                                                   num_cols=6))
    srv = t.server()
    ids = np.arange(64, dtype=np.int32)
    t.AddRows(ids, np.full((64, 6), 2.0, np.float32))        # the store
    assert srv._nat_store is not None and srv._nat_dirty
    srv.device_apply_rows(np.array([0, 1, 1], np.int32),
                          np.ones((3, 6), np.float32))
    assert srv._nat_store is None          # the device write dropped it
    got = [t.GetRows(ids)]                 # the mirror is rebuilt
    assert srv._nat_store is not None
    got.append(to_np(srv.device_fetch_rows(np.array([1, 5], np.int32))))
    t.AddRows(np.array([5], np.int32), np.full((1, 6), 0.5, np.float32))
    got.append(t.Get())
    return got, srv


def test_device_writes_ledger_and_publish(monkeypatch):
    _native_or_skip()
    import multiverso_tpu as jmv
    import multiverso_tpu_torch as tmv
    from multiverso_tpu import tables as jtables
    from multiverso_tpu_torch import tables
    from multiverso_tpu_torch.telemetry import accounting
    jmv.MV_Init(["-mv_write_combine=0"])
    try:
        jgot, _ = _device_write_script(jmv, jtables, np.asarray)
    finally:
        jmv.MV_ShutDown()
    tmv.MV_Init(["-mv_device=cpu"])
    try:
        tgot, srv = _device_write_script(tmv, tables,
                                         lambda x: x.detach().numpy())
        for t, j in zip(tgot, jgot):
            assert t.tobytes() == j.tobytes()
        assert srv._nat_dirty
        # the ledger, from a sampler thread: the mirror's logical bytes,
        # and the dirty mirror left alone
        monkeypatch.setattr(
            type(srv), "state",
            property(lambda s: pytest.fail("the ledger read state"),
                     type(srv).state.fset))
        box = {}
        th = threading.Thread(
            target=lambda: box.update(rep=accounting.memory_report()))
        th.start()
        th.join(30)
        monkeypatch.undo()
        assert srv._nat_dirty
        per = {r["table_id"]: r for r in
               box["rep"]["components"]["tables"]["per_table"]}
        rec = per[srv.table_id]
        assert rec["host_mirror_bytes"] == 64 * 6 * 4
        assert rec["device_bytes"] == 65 * 8 * 4    # storage, trash row
        assert box["rep"]["components"]["tables"]["totals"][
            "host_mirror_bytes"] == 64 * 6 * 4
        # a publish copies from the mirror: the snapshot is the table
        v = tmv.MV_PublishSnapshot()
        want = tgot[-1]
        got = tmv.MV_ServingLookup(srv.table_id, np.arange(64), version=v)
        assert np.asarray(got).tobytes() == want.tobytes()
        assert srv._nat_store is not None and srv._nat_dirty
        # ineligible tables never ride the store
        for opt in (tables.MatrixTableOption(num_rows=8, num_cols=4,
                                             updater_type="momentum"),
                    tables.MatrixTableOption(num_rows=8, num_cols=4,
                                             compress="sparse")):
            w = tmv.MV_CreateTable(opt)
            w.AddRows(np.arange(8, dtype=np.int32),
                      np.ones((8, 4), np.float32))
            w.GetRows(np.arange(8, dtype=np.int32))
            assert not w.server()._native_host_ok
            assert w.server()._nat_store is None
    finally:
        tmv.MV_ShutDown()
