"""Worker-side write combining and the staleness-bounded Get cache, the
port against the JAX package at the JAX package's defaults, on the CPU.

Each script runs on the same numpy inputs in a JAX-package world and then
in a port world (``-mv_device=cpu``), one after the other.

(a) One process, ``-mv_write_combine`` at its default (8) and at 3:
    fire-and-forget ``AddRows`` bursts on add, momentum and AdaGrad
    Matrix tables, KV ``AddFireForget``, a SparseMatrix table (its
    freshness bits read by a second worker), an Array table and a
    compressed table (both decline), interleaved with every ordering
    point: a tracked Get on another table, ``MV_Barrier`` from both
    workers, an untracked ``MV_MultiAdd`` (it flushes its own table only),
    ``MV_SaveCheckpoint`` and ``MV_PublishSnapshot``. Every table, every
    buffer length and buffered byte count (``worker_ledger_bytes``)
    observed between the verbs and the published rows are bitwise JAX's
    (AdaGrad to rtol 1e-6, atol 1e-6); so are the Add messages the engine received and the
    combine hits (each package's ``worker.write_combine_hits`` counter). A ``-sync=true`` world combines
    nothing in either package. Then, in the port alone, 8 worker threads
    push to one shared table with the interpreter switching threads every
    microsecond: the table equals the oracle, and every push is counted
    once, as a message's first member or as a hit.
(b) ``-mv_engine_shards=4`` with ``-mv_get_staleness`` at 1 and 2: the
    hit/miss sequence of repeated Gets equals JAX's
    ``worker.get_cache_hits`` sequence and the expected one: entries age
    by the windows of their own shard only (a busy neighbour shard does
    not expire them), the worker's own Add invalidates them
    (read-your-writes), and a hit is bitwise the miss it copies. A fill
    is dated at its Get's submit, one window either way, so the window
    counts are chosen to hold whichever window it got; a Get that first
    flushes a buffered Add can be a further window off, so the script
    follows that probe with a tracked Add before its last fill. The
    cached bytes equal JAX's. On ``-sync=true`` the cache is off. KV ``raw()`` equals JAX's.
(c) A two-rank world at the default (``tests/_mh_child.py`` mode
    ``combine``): the replicas bitwise equal across the ranks and to the
    JAX two-rank world, and the Add messages of each rank's engine equal.
"""

import sys
import threading
from types import SimpleNamespace

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)

R, C, K = 48, 4, 12


def _ns(pkg, argv):
    if pkg == "jax":
        import multiverso_tpu as mv
        from multiverso_tpu import tables
        from multiverso_tpu.message import MsgType
        from multiverso_tpu.telemetry import metrics as tmetrics
        from multiverso_tpu.updaters.base import AddOption, GetOption
        from multiverso_tpu.zoo import Zoo
        mv.MV_Init(list(argv))
        eng = Zoo.Get().server_engine
        adds = [0]
        recv, recv_multi = eng.Receive, eng.receive_multi

        def counting(msg):
            adds[0] += msg.msg_type == MsgType.Request_Add
            return recv(msg)

        def counting_multi(members):
            adds[0] += sum(m.msg_type == MsgType.Request_Add
                           for m in members)
            return recv_multi(members)

        eng.Receive, eng.receive_multi = counting, counting_multi

        def stat(name):
            return int(tmetrics.snapshot().get(name, {}).get("value", 0))

        def counts():
            return {"adds": adds[0],
                    "write_combine_hits": stat("worker.write_combine_hits"),
                    "get_cache_hits": stat("worker.get_cache_hits")}
    else:
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch import tables
        from multiverso_tpu_torch.telemetry import metrics as tmetrics
        from multiverso_tpu_torch.updaters.base import AddOption, GetOption
        from multiverso_tpu_torch.zoo import Zoo
        mv.MV_Init(["-mv_device=cpu"] + list(argv))

        def stat(name):
            return int(tmetrics.snapshot().get(name, {}).get("value", 0))

        def counts():
            return {"adds": Zoo.Get().server_engine.add_messages,
                    "write_combine_hits": stat("worker.write_combine_hits"),
                    "get_cache_hits": stat("worker.get_cache_hits")}
    return SimpleNamespace(pkg=pkg, mv=mv, tables=tables, Zoo=Zoo,
                           AddOption=AddOption, GetOption=GetOption,
                           counts=counts)


def _both(argv, script, *args):
    """``script(ns, *args)`` in a JAX world, then in a port world."""
    out = []
    for pkg in ("jax", "torch"):
        ns = _ns(pkg, argv)
        try:
            out.append(script(ns, *args))
        finally:
            ns.mv.MV_ShutDown()
    return out


def _same(jrec, trec, close=()):
    """Bitwise, except the keys in ``close``: rtol 1e-6, atol 1e-6 (AdaGrad's
    float32 square roots in two libraries, as in tests/test_torch_tables.py)."""
    assert jrec.keys() == trec.keys()
    for k in jrec:
        j, t = np.asarray(jrec[k]), np.asarray(trec[k])
        assert j.shape == t.shape, k
        if k in close:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(t, j, err_msg=k)


# -- (a) combining at the ordering points ----------------------------------------

def _combine_script(ns, ckpt):
    mv, T = ns.mv, ns.tables
    rng = np.random.default_rng(31)
    mom_opt = ns.AddOption(worker_id=0, momentum=0.5)
    tabs = {
        "add": mv.MV_CreateTable(T.MatrixTableOption(num_rows=R, num_cols=C)),
        "mom": mv.MV_CreateTable(T.MatrixTableOption(
            num_rows=R, num_cols=C, updater_type="momentum")),
        "ada": mv.MV_CreateTable(T.MatrixTableOption(
            num_rows=R, num_cols=C, updater_type="adagrad")),
        "kv": mv.MV_CreateTable(T.KVTableOption()),
        "sp": mv.MV_CreateTable(T.SparseMatrixTableOption(num_rows=R,
                                                          num_cols=C)),
        "arr": mv.MV_CreateTable(T.ArrayTableOption(size=16)),
        "comp": mv.MV_CreateTable(T.MatrixTableOption(
            num_rows=R, num_cols=C, compress="sparse")),
        "other": mv.MV_CreateTable(T.MatrixTableOption(num_rows=R,
                                                       num_cols=C)),
    }
    rec = {}
    c0 = ns.counts()

    def burst(n):
        for _ in range(n):
            ids = rng.integers(0, R, K).astype(np.int32)
            d = rng.integers(-3, 4, (K, C)).astype(np.float32)
            tabs["add"].AddFireForget(d, row_ids=ids)
            tabs["mom"].AddFireForget(d, row_ids=ids, option=mom_opt)
            tabs["ada"].AddFireForget(d * 0.25, row_ids=ids)
            tabs["sp"].AddFireForget(d, row_ids=ids)
            tabs["kv"].AddFireForget(
                rng.integers(0, 30, 5).astype(np.int64) * 7919,
                rng.integers(-2, 3, 5).astype(np.float32))
            if rng.random() < 0.3:
                tabs["arr"].AddFireForget(rng.integers(-2, 3, 16).astype(
                    np.float32))
            if rng.random() < 0.3:
                sparse = np.where(rng.random((K, C)) < 0.8, 0, d)
                tabs["comp"].AddFireForget(sparse.astype(np.float32),
                                           row_ids=ids)

    def buffers(tag):
        rec[f"buf_{tag}"] = [len(t._wc_buf) for t in tabs.values()]
        rec[f"ledger_{tag}"] = [t.worker_ledger_bytes()["write_combine_bytes"]
                                for t in tabs.values()]

    burst(11)
    buffers("burst")
    rec["tracked_get"] = tabs["other"].GetRows(np.arange(R, dtype=np.int32))
    buffers("tracked_get")
    burst(5)

    def barrier(w):
        with ns.Zoo.Get().worker_context(w):
            mv.MV_Barrier()

    ths = [threading.Thread(target=barrier, args=(w,)) for w in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(60)
    assert not any(th.is_alive() for th in ths)
    buffers("barrier")
    burst(5)
    ids = rng.integers(0, R, K).astype(np.int32)
    mv.MV_MultiAdd([(tabs["add"], {"row_ids": ids, "values": np.ones(
        (K, C), np.float32)})], track=False)
    buffers("multi_add")
    burst(4)
    mv.MV_SaveCheckpoint(ckpt)
    buffers("checkpoint")
    burst(3)
    v = mv.MV_PublishSnapshot()
    buffers("publish")
    rec["published"] = mv.MV_ServingLookup(tabs["add"], None, version=v)
    burst(6)
    buffers("final")
    for name in ("add", "mom", "ada", "comp", "other"):
        rec[name] = tabs[name].Get()
    rec["arr"] = tabs["arr"].Get()
    rec["kv"] = tabs["kv"].Get(np.arange(30, dtype=np.int64) * 7919)
    # the sparse table's freshness bits, as worker 1 (which wrote
    # nothing) and then worker 0 see them
    for w in (1, 0, 1):
        got_ids, rows = tabs["sp"].GetRows(
            np.arange(R, dtype=np.int32), option=ns.GetOption(worker_id=w))
        rec[f"sp_ids_{w}"], rec[f"sp_rows_{w}"] = got_ids, rows
    c1 = ns.counts()
    rec["adds"] = c1["adds"] - c0["adds"]
    rec["hits"] = c1["write_combine_hits"] - c0["write_combine_hits"]
    return rec


def _bsp_script(ns):
    t = ns.mv.MV_CreateTable(ns.tables.MatrixTableOption(num_rows=R,
                                                         num_cols=C))
    rng = np.random.default_rng(32)
    c0 = ns.counts()
    bufs = []
    for _ in range(6):
        t.AddFireForget(rng.integers(-3, 4, (K, C)).astype(np.float32),
                        row_ids=rng.integers(0, R, K).astype(np.int32))
        bufs.append(len(t._wc_buf))
    got = t.Get()
    c1 = ns.counts()
    return {"bufs": bufs, "get": got, "adds": c1["adds"] - c0["adds"],
            "hits": c1["write_combine_hits"] - c0["write_combine_hits"]}


def _threaded_pushes():
    """8 worker threads push fire-and-forget Adds to ONE shared table
    (each thread its own worker id, so the buffer flushes on every option
    change) with the interpreter switching threads every microsecond."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.zoo import Zoo
    workers, pushes = 8, 150
    mv.MV_Init(["-mv_device=cpu", f"-num_workers={workers}"])
    switch = sys.getswitchinterval()
    try:
        t = mv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C))
        from multiverso_tpu_torch.telemetry import metrics as tmetrics
        hits = tmetrics.counter("worker.write_combine_hits")
        eng = Zoo.Get().server_engine
        m0, h0 = eng.add_messages, hits.value
        sys.setswitchinterval(1e-6)

        def worker(w):
            with Zoo.Get().worker_context(w):
                g = np.random.default_rng([34, w])
                for _ in range(pushes):
                    t.AddFireForget(np.ones((K, C), np.float32),
                                    row_ids=g.integers(0, R, K).astype(
                                        np.int32))

        ths = [threading.Thread(target=worker, args=(w,))
               for w in range(workers)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(120)
        assert not any(th.is_alive() for th in ths)
        sys.setswitchinterval(switch)
        got = t.Get()
        oracle = np.zeros((R, C), np.float32)
        for w in range(workers):
            g = np.random.default_rng([34, w])
            for _ in range(pushes):
                np.add.at(oracle, g.integers(0, R, K), 1.0)
        np.testing.assert_array_equal(got, oracle)
        # every push is the first of a message or a hit, exactly once
        assert (eng.add_messages - m0 + hits.value - h0
                == workers * pushes)
    finally:
        sys.setswitchinterval(switch)
        mv.MV_ShutDown()


def test_combining_matches_jax_at_the_ordering_points(tmp_path):
    for cap, argv in ((8, []), (3, ["-mv_write_combine=3"])):
        jrec, trec = _both(["-num_workers=2"] + argv, _combine_script,
                           str(tmp_path / f"ckpt{cap}.mvt"))
        _same(jrec, trec, close=("ada",))
        # 5 combinable tables x 34 pushes, in messages of at most cap
        assert trec["hits"] > 0 and trec["adds"] < 5 * 34 + 40
        assert trec["buf_burst"][:5] == [11 % cap] * 5
        assert trec["ledger_burst"][0] == (11 % cap) * K * (C + 1) * 4
        assert trec["buf_tracked_get"] == [0] * 8
        assert trec["buf_barrier"] == [0] * 8
        assert trec["buf_multi_add"][0] == 0
        assert trec["buf_multi_add"][1:5] == [5 % cap] * 4
    jrec, trec = _both(["-sync=true"], _bsp_script)
    _same(jrec, trec)
    assert trec["bufs"] == [0] * 6 and trec["hits"] == 0
    assert trec["adds"] == 6
    _threaded_pushes()


# -- (b) the Get cache on the sharded engine --------------------------------------

def _cache_script(ns, staleness):
    """Tables 0..4 on 4 shards: 0 and 4 share shard 0, 1 is a neighbour.
    Returns each probed Get's hit flag and result."""
    mv, T = ns.mv, ns.tables
    tabs = [mv.MV_CreateTable(T.MatrixTableOption(num_rows=R, num_cols=C))
            for _ in range(4)]
    kv = mv.MV_CreateTable(T.KVTableOption())
    a, neighbour, same_shard = tabs[0], tabs[1], kv
    ids = np.arange(0, R, 3, dtype=np.int32)
    keys = np.array([3, 1 << 40, 77], np.int64)
    rng = np.random.default_rng(33)
    a.AddRows(ids, rng.integers(-3, 4, (len(ids), C)).astype(np.float32))
    kv.Add(keys, np.array([1.0, 2.0, 3.0], np.float32))
    rec = {"hits": [], "rows": []}

    def probe():
        h0 = ns.counts()["get_cache_hits"]
        rows = a.GetRows(ids)
        rec["hits"].append(ns.counts()["get_cache_hits"] - h0)
        rec["rows"].append(rows)

    served = [0]

    def windows(table, n):
        """n tracked Gets on ``table``, each its own window: every request
        differs, so none is a cache hit"""
        for _ in range(n):
            served[0] += 1
            if table is kv:
                kv.Get(np.array([1000 + served[0]], np.int64))
            else:
                table.GetRows(np.array([served[0] % R], np.int32))

    probe()                                  # miss: fills
    probe()                                  # 0 windows since: hit
    windows(same_shard, staleness - 1)
    probe()                                  # s - 1 windows: hit
    windows(neighbour, 5)
    probe()                                  # another shard's: still a hit
    windows(same_shard, 2)
    probe()                                  # s + 1 windows: expired
    probe()                                  # refilled: hit
    a.AddRows(ids[:2], np.ones((2, C), np.float32))
    probe()                                  # own write: miss
    a.AddFireForget(np.ones((2, C), np.float32), row_ids=ids[2:4])
    probe()                                  # own buffered write: miss
    # that miss flushed the buffered Add ahead of its Get, so its fill may
    # be dated before or after the flushed Add's window; a tracked Add
    # applies before it returns, so the next fill is dated at a quiet
    # stream and the last probe is a hit on every schedule
    a.AddRows(ids[4:6], np.ones((2, C), np.float32))
    probe()                                  # own write: miss
    probe()                                  # hit
    rec["rows"] = np.stack(rec["rows"])
    rec["hits"] = np.array(rec["hits"])
    rec["kv"] = kv.Get(keys)
    rec["raw"] = np.array(sorted(kv.raw().items()), np.float64)
    rec["cache_bytes"] = a.worker_ledger_bytes()["get_cache_bytes"]
    return rec


def _bsp_cache_script(ns):
    t = ns.mv.MV_CreateTable(ns.tables.MatrixTableOption(num_rows=R,
                                                         num_cols=C))
    h0 = ns.counts()["get_cache_hits"]
    rows = [t.GetRows(np.arange(4, dtype=np.int32)) for _ in range(4)]
    return {"hits": ns.counts()["get_cache_hits"] - h0,
            "rows": np.stack(rows)}


def test_get_cache_matches_jax_on_the_sharded_engine():
    for staleness in (1, 2):
        argv = ["-mv_engine_shards=4", f"-mv_get_staleness={staleness}"]
        jrec, trec = _both(argv, _cache_script, staleness)
        _same(jrec, trec)
        np.testing.assert_array_equal(
            trec["hits"], [0, 1, 1, 1, 0, 1, 0, 0, 0, 1])
        rows = trec["rows"]
        np.testing.assert_array_equal(rows[1], rows[0])   # hits copy the miss
        np.testing.assert_array_equal(rows[4], rows[0])
        np.testing.assert_array_equal(rows[6][:2], rows[0][:2] + 1)
        np.testing.assert_array_equal(rows[7][2:4], rows[0][2:4] + 1)
        np.testing.assert_array_equal(rows[8][4:6], rows[0][4:6] + 1)
        np.testing.assert_array_equal(rows[9], rows[8])
        assert trec["cache_bytes"] == trec["rows"][0].nbytes
        raw = dict(trec["raw"].tolist())
        assert raw.pop(3) == 1.0 and raw.pop(77) == 3.0
        assert raw.pop(float(1 << 40)) == 2.0
        assert raw and not any(raw.values())    # the window Gets' zeros
    jrec, trec = _both(["-sync=true", "-mv_get_staleness=2"],
                       _bsp_cache_script)
    _same(jrec, trec)
    assert trec["hits"] == 0


# -- (c) two ranks at the default --------------------------------------------------

def test_two_rank_combining_matches_jax(tmp_path):
    jres, _ = run_world("jax", "combine", tmp_path, timeout=240)
    tres, _ = run_world("torch", "combine", tmp_path, timeout=240)
    for k in tres[0]:
        np.testing.assert_array_equal(tres[0][k], tres[1][k], err_msg=k)
        np.testing.assert_array_equal(jres[0][k], jres[1][k], err_msg=k)
        np.testing.assert_array_equal(tres[0][k], jres[0][k], err_msg=k)
    assert int(tres[0]["adds"]) < int(tres[0]["pushes"])
