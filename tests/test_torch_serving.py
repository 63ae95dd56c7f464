"""The port's serving plane against the JAX package's.

Each test runs one seeded script in a JAX-package world
(``-mv_write_combine=0``, so every Add reaches the engine as its own
message, as in the port) and then in a port world on the CPU
(``-mv_device=cpu``), one after the other, and compares what the two
served: exactly for the linear updaters (integer-valued deltas keep every
sum exact), to rtol 1e-6, atol 1e-6 for AdaGrad and momentum (float32
transcendentals in two libraries, as in tests/test_torch_tables.py).

(1) the publish cut, on the async, sharded (``-mv_engine_shards=2``) and
    BSP engines: Adds (blocking and fire-and-forget) before the cut are
    in, Adds after it are out, for all four families at once; served rows
    equal the training Get at the cut; ``-mv_serving_residence=device``
    (legal on the CPU: one process, no aux state) serves its storage copy
    after later in-place Adds, and AdaGrad's table takes host residence;
    sparse serving leaves the freshness bits alone; a checkpoint saved
    right after a publish (tests/test_serving.py's parity) restores the
    published rows exactly;
(2) the store: retention under ``-mv_serving_keep``, nested pins holding a
    version past it, unpin evicting, the typed error of a lookup before
    any publish or of an evicted version;
(3) the front-end: concurrent lookups held back (``_hold_for_tests``)
    coalesce into ONE union read, overload sheds as a typed
    ``ServingOverloaded``, a per-request deadline raises
    ``DeadlineExceeded``, bad and float ids fail only their caller, and
    ``stop()`` fails the queued lookups.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

ROWS, COLS = 24, 5
ENGINES = ([], ["-mv_engine_shards=2"], ["-sync=true"])


def _ns(pkg):
    """The package ``pkg`` ("jax" or "torch") and the modules the scripts
    use, under one set of names."""
    if pkg == "jax":
        import multiverso_tpu as mv
        from multiverso_tpu import serving, tables
        from multiverso_tpu.failsafe import errors
        from multiverso_tpu.updaters.base import AddOption, GetOption
        from multiverso_tpu.zoo import Zoo
        argv = ["-mv_write_combine=0"]
    else:
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch import serving, tables
        from multiverso_tpu_torch.failsafe import errors
        from multiverso_tpu_torch.updaters.base import AddOption, GetOption
        from multiverso_tpu_torch.zoo import Zoo
        argv = ["-mv_device=cpu"]
    return SimpleNamespace(pkg=pkg, mv=mv, tables=tables, serving=serving,
                           errors=errors, AddOption=AddOption,
                           GetOption=GetOption, Zoo=Zoo, argv=argv)


def _world(pkg, argv, body):
    ns = _ns(pkg)
    ns.mv.MV_Init(ns.argv + list(argv))
    try:
        return body(ns)
    finally:
        ns.mv.MV_ShutDown()


def _both(argv, body):
    return _world("jax", argv, body), _world("torch", argv, body)


def _close(key: str) -> bool:
    return key.startswith(("ada", "mom"))


def _assert_match(jres: dict, tres: dict, what: str) -> None:
    assert set(jres) == set(tres), (what, set(jres) ^ set(tres))
    for k in jres:
        if _close(k):
            np.testing.assert_allclose(tres[k], jres[k], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(tres[k], jres[k],
                                          err_msg=f"{what} {k}")


def _residence(ns, ts) -> str:
    if ns.pkg == "jax":
        return "device" if getattr(ts, "_dev", None) is not None else "host"
    return ts.residence


# -- (1) the publish cut ----------------------------------------------------

def _cut_script(ns, tmp_path=None):
    """Four families and two more updaters take seeded Adds, a publish
    cuts them, more Adds follow; returns what was served and the training
    Gets at the cut, and checks each package against itself."""
    mv, tables = ns.mv, ns.tables
    rng = np.random.default_rng(5)
    mopt = ns.AddOption(momentum=0.5)
    mat = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=ROWS,
                                                     num_cols=COLS))
    sgd = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS, updater_type="sgd"))
    ada = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS, updater_type="adagrad"))
    mom = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS, updater_type="momentum"))
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=10))
    kv = mv.MV_CreateTable(tables.KVTableOption())
    sp = mv.MV_CreateTable(tables.SparseMatrixTableOption(num_rows=16,
                                                          num_cols=3))
    all_ids = np.arange(ROWS, dtype=np.int32)
    keys = np.array([3, 7, 1 << 40, 12, 99], np.int64)

    def adds(r, scale=1.0):
        ids = np.sort(rng.choice(ROWS, 8, replace=False)).astype(np.int32)
        d = (rng.integers(-3, 4, (8, COLS)) * scale).astype(np.float32)
        mat.AddRows(ids, d)
        sgd.AddFireForget(d, row_ids=ids)
        ada.AddRows(ids, rng.standard_normal((8, COLS)).astype(np.float32))
        mom.AddRows(ids, rng.standard_normal((8, COLS)).astype(np.float32),
                    mopt)
        arr.AddFireForget(rng.integers(-2, 3, 10).astype(np.float32))
        kv.Add(keys[rng.integers(0, len(keys), 3)],
               rng.integers(1, 4, 3).astype(np.float32))
        sp.AddRows(np.array([r % 16, (r + 5) % 16], np.int32),
                   np.full((2, 3), scale, np.float32))

    for r in range(4):
        adds(r)
    # fire-and-forget pushes right before the cut are in
    mat.AddFireForget(np.full((ROWS, COLS), 0.5, np.float32), row_ids=all_ids)
    train = {"mat": mat.GetRows(all_ids), "sgd": sgd.GetRows(all_ids),
             "ada": ada.GetRows(all_ids), "mom": mom.GetRows(all_ids),
             "arr": arr.Get(), "kv": kv.Get(keys),
             "sp": sp.Get(ns.GetOption(worker_id=-1))[1]}
    v = mv.MV_PublishSnapshot()
    if tmp_path is not None:
        # the checkpoint at the next stream position names the same state
        mv.MV_SaveCheckpoint(f"file://{tmp_path}/{ns.pkg}.mvt")
    for r in range(3):                     # training goes on past the cut
        adds(r, scale=100.0)
    srv = ns.Zoo.Get().server_tables[sp.table_id]
    bits = srv.up_to_date.copy()
    served = {"mat": mv.MV_ServingLookup(mat, all_ids, version=v),
              "sgd": mv.MV_ServingLookup(sgd, all_ids[::-1], version=v),
              "ada": mv.MV_ServingLookup(ada, all_ids, version=v),
              "mom": mv.MV_ServingLookup(mom, None, version=v),
              "arr": mv.MV_ServingLookup(arr, None, version=v),
              "kv": mv.MV_ServingLookup(kv, keys, version=v),
              "sp": mv.MV_ServingLookup(sp, np.arange(16), version=v)}
    # sparse serving reads leave the freshness bits alone
    np.testing.assert_array_equal(srv.up_to_date, bits)
    for k, want in train.items():
        got = served[k][::-1] if k == "sgd" else served[k]
        np.testing.assert_array_equal(got, want, err_msg=f"{ns.pkg} {k}")
    live = mat.GetRows(all_ids)
    assert not np.array_equal(live, served["mat"])   # training moved on
    snap = ns.serving.get_plane().store.get(v)
    res = {f"{k}_served": x for k, x in served.items()}
    res["residence"] = np.array([_residence(ns, snap.tables[t.table_id])
                                 for t in (mat, ada, arr, kv)])
    if tmp_path is not None:
        mv.MV_LoadCheckpoint(f"file://{tmp_path}/{ns.pkg}.mvt")
        np.testing.assert_array_equal(mat.GetRows(all_ids), served["mat"])
        np.testing.assert_array_equal(kv.Get(keys), served["kv"])
        np.testing.assert_array_equal(ada.GetRows(all_ids), served["ada"])
    return res


def _engine_cut_script(ns):
    """``_cut_script`` plus the engine it ran on and, on the sharded
    engine, the cross-stream cuts that fenced every shard."""
    eng = ns.Zoo.Get().server_engine
    res = _cut_script(ns)
    res["engine"] = np.array(type(eng).__name__)
    res["fenced"] = np.array(getattr(eng, "cut_count", 0) >= 1)
    return res


def test_publish_cut_matches_jax(tmp_path):
    engines = []
    for argv in ENGINES:
        jres, tres = _both(argv, _engine_cut_script)
        _assert_match(jres, tres, f"engine {argv}")
        assert list(tres["residence"]) == ["host"] * 4
        engines.append((str(tres["engine"]), bool(tres["fenced"])))
    assert engines == [("ShardedServer", True), ("ShardedServer", True),
                       ("SyncServer", False)]
    # device residence on the CPU: the aux-free matrix serves its storage
    # copy after later in-place Adds; AdaGrad keeps host residence
    jres, tres = _both(["-mv_serving_residence=device"], _cut_script)
    _assert_match(jres, tres, "residence=device")
    assert list(tres["residence"]) == ["device", "host", "host", "host"]
    assert list(jres["residence"]) == list(tres["residence"])
    # a checkpoint and a snapshot taken at adjacent stream positions agree
    jres = _world("jax", [], lambda ns: _cut_script(ns, tmp_path))
    tres = _world("torch", [], lambda ns: _cut_script(ns, tmp_path))
    _assert_match(jres, tres, "checkpoint at the cut")


# -- (2) the store -------------------------------------------------------------

def _store_script(ns):
    mv, tables = ns.mv, ns.tables
    if ns.pkg == "jax":
        from multiverso_tpu.telemetry import metrics
    else:
        from multiverso_tpu_torch.telemetry import metrics
    counts = [metrics.counter(f"serving.{n}") for n in ("publishes",
                                                        "evictions")]
    c0 = [c.value for c in counts]
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=4))
    with pytest.raises(KeyError):             # nothing published yet
        mv.MV_ServingLookup(arr, None)
    store = ns.serving.get_plane().store
    out = {}
    arr.Add(np.full(4, 7.0, np.float32))
    v1 = mv.MV_PublishSnapshot()
    assert mv.MV_PinVersion(v1) == v1
    mv.MV_PinVersion(v1)                       # pins nest
    arr.Add(np.ones(4, np.float32))
    vs = [mv.MV_PublishSnapshot() for _ in range(3)]
    out["live_pinned"] = np.array(store.live_versions())
    # read-your-version: the pinned cut is immutable
    out["pinned"] = mv.MV_ServingLookup(arr, None, version=v1)
    out["latest"] = mv.MV_ServingLookup(arr, None)
    with pytest.raises(KeyError):              # evicted by retention
        mv.MV_ServingLookup(arr, None, version=vs[0])
    mv.MV_UnpinVersion(v1)
    assert v1 in store.live_versions()         # one pin still holds it
    mv.MV_UnpinVersion(v1)
    out["live_unpinned"] = np.array(store.live_versions())
    with pytest.raises(KeyError):
        mv.MV_PinVersion(v1)
    mv.MV_UnpinVersion(vs[-1])                 # no pin: a logged no-op
    assert store.latest_version() == vs[-1]
    # both packages' serving.publishes / serving.evictions counters
    assert [c.value - v for c, v in zip(counts, c0)] == [4, 2]
    out["versions"] = np.array([v1] + vs)
    return out


def _keep_script(ns):
    """``-mv_serving_keep=3``: three versions live, then a shutdown drops
    every snapshot (the next world starts from a fresh plane)."""
    arr = ns.mv.MV_CreateTable(ns.tables.ArrayTableOption(size=2))
    for i in range(5):
        arr.Add(np.ones(2, np.float32))
        ns.mv.MV_PublishSnapshot()
    return {"live": np.array(ns.serving.get_plane().store.live_versions())}


def test_store_retention_and_pins_match_jax():
    jres, tres = _both([], _store_script)
    _assert_match(jres, tres, "store")
    np.testing.assert_array_equal(tres["live_pinned"], [1, 3, 4])
    np.testing.assert_array_equal(tres["live_unpinned"], [3, 4])
    np.testing.assert_array_equal(tres["pinned"], np.full(4, 7.0))
    jres, tres = _both(["-mv_serving_keep=3"], _keep_script)
    _assert_match(jres, tres, "keep=3")
    np.testing.assert_array_equal(tres["live"], [3, 4, 5])
    from multiverso_tpu_torch import serving
    assert serving.peek_plane() is None        # Zoo.Stop dropped it


# -- (3) the front-end -----------------------------------------------------------

def _hold(fe):
    """Park the dispatcher BEFORE it pops; give a running one an idle poll
    to reach the hold."""
    fe._hold_for_tests = threading.Event()
    if fe._thread is not None:
        time.sleep(0.35)


def _release(fe):
    hold, fe._hold_for_tests = fe._hold_for_tests, None
    if hold is not None:
        hold.set()


def _frontend_script(ns):
    mv, tables = ns.mv, ns.tables
    out = {}
    mat = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=64,
                                                     num_cols=4))
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=4))
    all_ids = np.arange(64, dtype=np.int32)
    mat.AddRows(all_ids, np.arange(64 * 4, dtype=np.float32).reshape(64, 4))
    arr.Add(np.ones(4, np.float32))
    v = mv.MV_PublishSnapshot()
    plane = ns.serving.get_plane()
    fe = plane.frontend
    # eight concurrent callers of one (version, table): ONE union read
    _hold(fe)
    tickets = [fe.lookup_async(mat.table_id,
                               np.arange(i * 8, i * 8 + 8)[::-1], version=v)
               for i in range(8)]
    # a bad and a float id fail their own caller only, at admission
    with pytest.raises(ValueError):
        fe.lookup_async(mat.table_id, np.array([3, 64]), version=v)
    with pytest.raises(ValueError):
        fe.lookup_async(mat.table_id, np.array([1.5]), version=v)
    with pytest.raises(KeyError):              # a table without a snapshot
        fe.lookup_async(99, np.array([0]), version=v)
    _release(fe)
    out["coalesced"] = np.stack([t.Wait(10.0) for t in tickets])
    assert plane.store.get(v).tables[mat.table_id].dispatches == 1
    # overload sheds typed; the admitted lookups still serve
    mv.MV_SetFlag("mv_serving_max_inflight", 2)
    try:
        _hold(fe)
        t1 = fe.lookup_async(arr.table_id, None, version=v)
        t2 = fe.lookup_async(arr.table_id, np.array([2, 0]), version=v)
        with pytest.raises(ns.errors.ServingOverloaded):
            fe.lookup_async(arr.table_id, None, version=v)
        _release(fe)
        out["admitted"] = np.concatenate([t1.Wait(10.0), t2.Wait(10.0)])
    finally:
        mv.MV_SetFlag("mv_serving_max_inflight", 4096)
    # a per-request deadline raises typed, bounded
    _hold(fe)
    try:
        t0 = time.monotonic()
        with pytest.raises(ns.errors.DeadlineExceeded):
            fe.lookup(arr.table_id, None, version=v, deadline=0.2)
        assert time.monotonic() - t0 < 5.0
    finally:
        _release(fe)
    # the coalesce window: callers inside it share a read
    mv.MV_SetFlag("mv_serving_batch_window_s", 0.2)
    try:
        got = [None] * 4

        def caller(i):
            got[i] = mv.MV_ServingLookup(mat, np.array([i, 63 - i]),
                                         version=v, deadline=10.0)

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(4)]
        [t.start() for t in threads]
        [t.join(20) for t in threads]
        assert not any(t.is_alive() for t in threads)
        out["windowed"] = np.stack(got)
    finally:
        mv.MV_SetFlag("mv_serving_batch_window_s", 0.0)
    # stop() fails the queued lookups and sheds new ones (a front-end
    # whose dispatcher never started, so the lookup stays queued)
    idle = ns.serving.ServingFrontend(plane.store)
    ticket = ns.serving.LookupTicket()
    idle._q.Push((plane.store.get(v), arr.table_id, None, ticket))
    idle.stop()
    with pytest.raises(ns.errors.ServingOverloaded):
        ticket.Wait(5.0)
    with pytest.raises(ns.errors.ServingOverloaded):
        idle.lookup_async(arr.table_id, None, version=v)
    return out


def test_frontend_matches_jax():
    jres, tres = _both([], _frontend_script)
    _assert_match(jres, tres, "frontend")
    want = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    np.testing.assert_array_equal(
        tres["coalesced"],
        np.stack([want[np.arange(i * 8, i * 8 + 8)[::-1]]
                  for i in range(8)]))

    def stats(ns):
        if ns.pkg == "jax":
            from multiverso_tpu.telemetry import metrics
        else:
            from multiverso_tpu_torch.telemetry import metrics
        mat = ns.mv.MV_CreateTable(ns.tables.MatrixTableOption(num_rows=8,
                                                               num_cols=2))
        v = ns.mv.MV_PublishSnapshot()
        fe = ns.serving.get_plane().frontend
        s0 = metrics.snapshot()
        _hold(fe)
        tickets = [fe.lookup_async(mat.table_id, np.array([i]), version=v)
                   for i in range(5)]
        _release(fe)
        [t.Wait(10.0) for t in tickets]
        s1 = metrics.snapshot()

        def diff(name, key="value"):
            return s1[name][key] - s0.get(name, {}).get(key, 0)

        return {"lookups": diff("serving.lookups"),
                "dispatches": diff("serving.dispatches"),
                "shed": diff("serving.shed"),
                "batches": diff("serving.batch_size", "count"),
                "batched": diff("serving.batch_size", "sum"),
                "latencies": diff("serving.latency_s", "count"),
                "p50": s1["serving.latency_s"]["p50"]}

    # the serving.* instruments of one held batch, in both packages
    for pkg in ("jax", "torch"):
        s = _world(pkg, [], stats)
        assert (s["lookups"], s["dispatches"], s["batches"]) == (5, 1, 1)
        assert s["batched"] == 5 and s["shed"] == 0
        assert s["latencies"] == 5 and s["p50"] > 0