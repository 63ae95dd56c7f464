"""The port's replica plane units against the JAX package's, on the CPU.

(1) The codec: the journals (rows, keys, all), ``merge_descriptors`` on
    the same intervals in both packages, and the sealed blobs: with
    ``-mv_compress`` off and the bundles' wall clock fixed, the port's
    base and delta blobs of a snapshot are the JAX package's bytes; with
    the codecs on (RLE ids, bf16 / int8 rows for a lossy-opted table),
    each package's ``decode`` + ``MirrorStore.apply`` reads the other's
    blob to the same arrays. A flipped byte raises the typed
    ``WireCorruption``; the mirror refuses a replayed version and a delta
    that skips past it; a clean table's arrays carry forward, shared with
    the new snapshot; a kv delta merges updated and new keys.
(2) The journal marks at every Add path of the four families: one verb
    script (blocking, fire-and-forget bursts the engine merges through
    ``ProcessAddRun``, a whole-table Add, a compressed table, a sparse
    table, kv and array Adds, a quiet interval) in a JAX world and in a
    port world with ``-mv_replica_fanout``; the descriptors each publish
    cut drains are equal, cut by cut and table by table.
(3) The protocol edges against the JAX ends: the flat lookup frames
    crossing both ways (zero-copy read-only rows, the typed corruption
    error), the relay mailbox's overflow and ``needs_base`` on the port's
    coordinator driven by either package's client, ``unreachable_verdict``
    at its boundary and the hold window across a takeover, the
    ``latest_known`` max-merge under contention, the ``replica_lag`` rule
    and the publisher's watchdog sample, healthz report and ledger probe
    against the JAX package's on the same records, and the content-
    addressed encode cache.
"""

import socket
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)


def _pkgs():
    from multiverso_tpu.parallel import seal as jseal
    from multiverso_tpu.replica import delta as jdelta
    from multiverso_tpu.serving import snapshot as jsnap
    from multiverso_tpu_torch.replica import delta as tdelta
    from multiverso_tpu_torch.serving import snapshot as tsnap
    return (SimpleNamespace(delta=jdelta, snap=jsnap, seal=jseal),
            SimpleNamespace(delta=tdelta, snap=tsnap))


def _set_flags(compress: bool, lossy: str = "") -> None:
    from multiverso_tpu.utils.configure import SetCMDFlag as jset
    from multiverso_tpu_torch.utils.configure import SetCMDFlag as tset
    for setf in (jset, tset):
        setf("mv_compress", compress)
        setf("mv_compress_lossy", lossy)


def _tables(snap, rows, keys, vals, vec):
    return {0: snap.MatrixSnapshot.host(rows),
            1: snap.KVSnapshot(keys, vals),
            2: snap.VectorSnapshot(vec)}


def _snapshot(snap, version, tables):
    return snap.Snapshot(version=version, created_wall=1234.5,
                         window_epoch=7, tables=tables)


def _mirror_arrays(snapshot) -> dict:
    out = {}
    for tid, ts in snapshot.tables.items():
        if hasattr(ts, "items"):
            k, v = ts.items()
            out[tid] = (np.array(k), np.array(v))
        else:
            out[tid] = (np.array(ts.full()),)
    return out


def test_codec_journals_and_blobs_match_jax(monkeypatch):
    j, t = _pkgs()
    # both ends pick the same CRC engine (the JAX seal caches its choice)
    monkeypatch.setattr(j.seal, "_crc32c_native", False)
    monkeypatch.setattr(j.seal, "_crc32c_charp", False)
    for pkg in (j, t):
        monkeypatch.setattr(pkg.delta, "time",
                            SimpleNamespace(time=lambda: 99.25))

    # the journals, in both packages
    for pkg in (j, t):
        jr = pkg.delta.TableJournal("rows", num_rows=10)
        jr.mark_rows(np.array([3, 7]))
        jr.mark_rows(np.array([3, 5]))
        d = jr.drain()
        assert d["kind"] == "rows" and d["ids"].tolist() == [3, 5, 7]
        assert jr.drain()["ids"].size == 0
        jr.mark_rows(None)
        assert jr.drain() == {"kind": "all"}
        jk = pkg.delta.TableJournal("keys")
        src = np.array([9, 2, 9], np.int64)
        jk.mark_keys(src)
        src[:] = 0                      # the journal copied
        jk.mark_keys(np.array([2, 11], np.int64))
        assert jk.drain()["keys"].tolist() == [2, 9, 11]
        ja = pkg.delta.TableJournal("all")
        assert ja.drain() == {"kind": "none"}
        ja.mark_all()
        assert ja.drain() == {"kind": "all"}
        with pytest.raises(Exception, match="unknown journal kind"):
            pkg.delta.TableJournal("cols")

    # merge_descriptors: equal results on the same intervals
    def rows(*ids):
        return {"kind": "rows", "ids": np.asarray(ids, np.int64)}

    def keys(*ks):
        return {"kind": "keys", "keys": np.asarray(ks, np.int64)}

    cases = [[rows(1, 2), {"kind": "none"}, rows(2, 5)], [rows(1), None],
             [{"kind": "none"}], [rows(1), {"kind": "all"}],
             [keys(9, 4), keys(4, 1)], [], [rows(), rows(3)]]
    for case in cases:
        a, b = j.delta.merge_descriptors(case), t.delta.merge_descriptors(
            case)
        assert a.keys() == b.keys() and a["kind"] == b["kind"], case
        for k in ("ids", "keys"):
            if k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        assert j.delta.descriptor_nbytes(a) == t.delta.descriptor_nbytes(b)
    with pytest.raises(Exception, match="mixed journal kinds"):
        t.delta.merge_descriptors([rows(1), keys(2)])

    # the blobs: the JAX package's bytes with the codecs off
    rng = np.random.default_rng(0)
    rows1 = rng.standard_normal((300, 8)).astype(np.float32)
    keys1 = np.array([40, 1, 9, 17], np.int64)
    vals1 = np.array([1.5, -2.0, 3.25, 0.5], np.float32)
    vec1 = rng.standard_normal(6).astype(np.float32)
    rows2 = rows1.copy()
    dirty = np.array([2, 17, 100, 101, 102, 250], np.int64)
    rows2[dirty] += 1.0
    keys2 = np.array([40, 1, 9, 17, 5], np.int64)
    vals2 = np.array([1.5, 7.0, 3.25, 0.5, 4.0], np.float32)
    descs = {0: {"kind": "rows", "ids": dirty},
             1: {"kind": "keys", "keys": np.array([1, 5], np.int64)},
             2: {"kind": "none"}}

    def blobs(pkg):
        s1 = _snapshot(pkg.snap, 1, _tables(pkg.snap, rows1, keys1, vals1,
                                            vec1))
        s2 = _snapshot(pkg.snap, 2, _tables(pkg.snap, rows2, keys2, vals2,
                                            vec1))
        return (pkg.delta.encode_base(s1),
                pkg.delta.encode_delta(s2, 1, descs),
                pkg.delta.encode_delta(s2, 1, {0: descs[0]}))

    _set_flags(False)
    jb, tb = blobs(j), blobs(t)
    for a, b in zip(jb, tb):
        assert a == b
    assert len(tb[1]) < rows1.nbytes / 2

    # decode + apply in both packages, each of both packages' blobs: the
    # same arrays, bitwise (the codecs off, then on with table 0 lossy)
    try:
        for flags in ((False, ""), (True, ""), (True, "0")):
            _set_flags(*flags)
            produced = {"jax": blobs(j), "torch": blobs(t)}
            got = {}
            for src, bl in produced.items():
                for name, pkg in (("jax", j), ("torch", t)):
                    m = pkg.delta.MirrorStore()
                    s1 = m.apply(pkg.delta.decode(bl[0]))
                    s2 = m.apply(pkg.delta.decode(bl[1]))
                    got[(src, name)] = (_mirror_arrays(s1),
                                        _mirror_arrays(s2))
            ref = got[("jax", "jax")]
            for key, val in got.items():
                for s_ref, s_got in zip(ref, val):
                    assert s_ref.keys() == s_got.keys(), (flags, key)
                    for tid in s_ref:
                        for a, b in zip(s_ref[tid], s_got[tid]):
                            np.testing.assert_array_equal(
                                a, b, err_msg=f"{flags} {key} table {tid}")
            if flags == (True, "0"):
                # lossy rows ride envelopes: the blobs shrink
                assert len(produced["torch"][0]) < len(tb[0])
    finally:
        _set_flags(False)

    # the codecs off: the round trip is exact, a clean table carries
    # forward, a kv delta merges updated and new keys
    m = t.delta.MirrorStore()
    s1 = m.apply(t.delta.decode(tb[0]))
    s2 = m.apply(t.delta.decode(tb[1]))
    np.testing.assert_array_equal(s1.tables[0].full(), rows1)
    np.testing.assert_array_equal(s2.tables[0].full(), rows2)
    np.testing.assert_array_equal(s1.tables[0].full(), rows1)  # immutable
    assert s2.tables[1].lookup_union(np.array([1, 5, 40, 777])).tolist() \
        == [7.0, 4.0, 1.5, 0.0]
    assert s2.tables[2]._values is s1.tables[2]._values    # carried
    assert s2.version == 2 and s2.window_epoch == 7
    assert m.mirror_bytes() == rows2.nbytes + keys2.nbytes + vals2.nbytes \
        + vec1.nbytes

    # the typed corruption error, before any parse
    from multiverso_tpu_torch.failsafe.errors import WireCorruption
    bad = bytearray(tb[0])
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(WireCorruption):
        t.delta.decode(bytes(bad))
    # the mirror refuses a replay and a delta that skips past it
    m = t.delta.MirrorStore()
    base = t.delta.decode(tb[0])
    m.apply(base)
    with pytest.raises(Exception, match="not newer"):
        m.apply(t.delta.decode(tb[0]))
    gap = t.delta.decode(t.delta.encode_delta(
        _snapshot(t.snap, 9, _tables(t.snap, rows2, keys2, vals2, vec1)),
        8, {0: {"kind": "none"}}))
    with pytest.raises(Exception, match="resync"):
        m.apply(gap)
    # a row delta of a table the mirror's base did not carry
    fresh = t.delta.MirrorStore()
    fresh.apply(t.delta.decode(t.delta.encode_base(_snapshot(
        t.snap, 1, {2: t.snap.VectorSnapshot(vec1)}))))
    with pytest.raises(Exception, match="never seen"):
        fresh.apply(t.delta.decode(tb[1]))


# -- (2) the journal marks at every Add path --------------------------------


def _ns(pkg):
    if pkg == "jax":
        import multiverso_tpu as mv
        from multiverso_tpu import tables
        from multiverso_tpu.replica import publisher
        from multiverso_tpu.tables import matrix_table
        from multiverso_tpu.zoo import Zoo
        argv = ["-mv_write_combine=0"]
    else:
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch import tables
        from multiverso_tpu_torch.replica import publisher
        from multiverso_tpu_torch.tables import matrix_table
        from multiverso_tpu_torch.zoo import Zoo
        argv = ["-mv_device=cpu", "-mv_write_combine=0"]
    return SimpleNamespace(mv=mv, tables=tables, publisher=publisher,
                           matrix_table=matrix_table, Zoo=Zoo, argv=argv)


R, C = 64, 4


def _journal_script(ns, runs: list) -> dict:
    """The verb script: every publish cut's drained descriptors, by
    version then table id."""
    mv, tb = ns.mv, ns.tables
    rng = np.random.default_rng(3)
    orig_run = ns.matrix_table.MatrixServerTable.ProcessAddRun

    def spy(self, payloads):
        ok = orig_run(self, payloads)
        runs.append(bool(ok))
        return ok

    ns.matrix_table.MatrixServerTable.ProcessAddRun = spy
    mv.MV_Init(ns.argv + ["-mv_replica_fanout=true"])
    try:
        mat = mv.MV_CreateTable(tb.MatrixTableOption(num_rows=R,
                                                     num_cols=C))
        ada = mv.MV_CreateTable(tb.MatrixTableOption(
            num_rows=R, num_cols=C, updater_type="adagrad"))
        cmp = mv.MV_CreateTable(tb.MatrixTableOption(
            num_rows=R, num_cols=C, compress="sparse"))
        spm = mv.MV_CreateTable(tb.SparseMatrixTableOption(num_rows=R,
                                                           num_cols=C))
        kv = mv.MV_CreateTable(tb.KVTableOption())
        arr = mv.MV_CreateTable(tb.ArrayTableOption(size=9))
        pub = ns.publisher._publisher
        cuts = {}

        def cut():
            v = mv.MV_PublishSnapshot()
            with pub._lock:
                cuts[v] = {tid: dict(d) for tid, d in pub._dirty[v].items()}

        def ids(n):
            return np.sort(rng.choice(R, n, replace=False)).astype(np.int32)

        def vals(n):
            return rng.integers(-3, 4, (n, C)).astype(np.float32)

        # 1: blocking Adds on every family
        mat.AddRows(ids(5), vals(5))
        ada.AddRows(ids(4), vals(4))
        i = ids(6)
        d = vals(6)
        d[:, 1:] = 0.0                  # mostly zeros: the sparse filter
        cmp.AddRows(i, d)
        spm.AddRows(ids(3), vals(3))
        kv.Add(np.array([5, 70, 5], np.int64),
               np.array([1, 2, 3], np.float32))
        arr.Add(np.ones(9, np.float32))
        cut()
        # 2: fire-and-forget bursts (the engine merges a window's Adds of
        # one table through ProcessAddRun), then a blocking Get to drain
        for _ in range(8):
            mat.AddFireForget(vals(3), row_ids=ids(3))
        for _ in range(3):
            spm.AddFireForget(vals(2), row_ids=ids(2))
            kv.AddFireForget(rng.integers(0, 1 << 40, 4).astype(np.int64),
                             np.ones(4, np.float32))
        arr.AddFireForget(np.ones(9, np.float32))
        mat.GetRows(np.arange(4, dtype=np.int32))
        ns.Zoo.Get().DrainServer()
        cut()
        # 3: a whole-table Add, a compressed Add, nothing elsewhere
        mat.Add(np.ones((R, C), np.float32))
        i = ids(7)
        d = vals(7)
        d[:, :3] = 0.0
        cmp.AddRows(i, d)
        cut()
        # 4: a quiet interval
        cut()
        # 5: kv alone, the same keys twice
        kv.Add(np.array([70, 70, 9], np.int64), np.ones(3, np.float32))
        cut()
        return cuts
    finally:
        mv.MV_ShutDown()
        ns.matrix_table.MatrixServerTable.ProcessAddRun = orig_run


def test_journal_marks_every_add_path_as_jax_does():
    jruns, truns = [], []
    want = _journal_script(_ns("jax"), jruns)
    got = _journal_script(_ns("torch"), truns)
    assert any(truns), "the port's merged ProcessAddRun never ran"
    assert list(got) == list(want) == [1, 2, 3, 4, 5]
    for v in want:
        assert got[v].keys() == want[v].keys(), v
        for tid in want[v]:
            a, b = want[v][tid], got[v][tid]
            assert a["kind"] == b["kind"], (v, tid, a, b)
            for k in ("ids", "keys"):
                if k in a:
                    np.testing.assert_array_equal(b[k], a[k],
                                                  err_msg=f"v{v} t{tid}")
    # what the script means: every family marked at every path
    kinds = {v: {tid: d["kind"] for tid, d in got[v].items()} for v in got}
    assert kinds[1] == {0: "rows", 1: "rows", 2: "rows", 3: "rows",
                        4: "keys", 5: "all"}
    assert kinds[2][0] == "rows" and got[2][0]["ids"].size > 3
    assert kinds[2][3] == "rows" and kinds[2][4] == "keys"
    assert kinds[2][5] == "all" and got[2][1]["ids"].size == 0
    assert kinds[3][0] == "all" and kinds[3][2] == "rows"
    assert kinds[4] == {0: "rows", 1: "rows", 2: "rows", 3: "rows",
                        4: "keys", 5: "none"}
    assert all(got[4][t]["ids"].size == 0 for t in range(4))
    assert got[5][4]["keys"].tolist() == [9, 70]


# -- (3) the protocol edges ---------------------------------------------------


def _hammer(n, fn):
    ths = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(60)


def test_protocol_edges_match_the_jax_ends(monkeypatch):
    from multiverso_tpu.elastic.coordinator import \
        MemberClient as JMemberClient
    from multiverso_tpu.parallel import seal as jseal
    from multiverso_tpu.replica import publisher as jpub
    from multiverso_tpu.replica import replica as jrep
    from multiverso_tpu.telemetry import watchdog as jwd
    from multiverso_tpu_torch.elastic.coordinator import (Coordinator,
                                                          MemberClient)
    from multiverso_tpu_torch.failsafe.errors import WireCorruption
    from multiverso_tpu_torch.parallel import flat
    from multiverso_tpu_torch.replica import delta as tdelta
    from multiverso_tpu_torch.replica import publisher as tpub
    from multiverso_tpu_torch.replica import replica as trep
    from multiverso_tpu_torch.serving.snapshot import (MatrixSnapshot,
                                                       Snapshot)
    from multiverso_tpu_torch.telemetry import watchdog as twd
    monkeypatch.setattr(jseal, "_crc32c_native", False)
    monkeypatch.setattr(jseal, "_crc32c_charp", False)

    # the flat lookup frames cross both ways
    for send, recv in ((trep._send_flat, jrep._recv_flat),
                       (jrep._send_flat, trep._recv_flat),
                       (trep._send_flat, trep._recv_flat)):
        a, b = socket.socketpair()
        try:
            rows = np.arange(64, dtype=np.float32).reshape(16, 4)
            send(a, {"op": "lookup", "table_id": 3,
                     "ids": np.arange(16, dtype=np.int64),
                     "version": None, "deadline": 0.5,
                     flat.TRACE_KEY: [7, 9]})
            req = recv(b)
            assert req["op"] == "lookup" and req["table_id"] == 3
            assert req["ids"].dtype == np.int64
            assert req["version"] is None and req["deadline"] == 0.5
            assert list(req[flat.TRACE_KEY]) == [7, 9]
            send(b, {"rows": rows})
            resp = recv(a)
            np.testing.assert_array_equal(resp["rows"], rows)
            assert resp["rows"].base is not None
            assert not resp["rows"].flags.writeable
        finally:
            a.close()
            b.close()
    a, b = socket.socketpair()
    try:
        blob = bytearray(flat.encode_frame({"rows": np.ones(8)}))
        blob[7] ^= 0x04
        a.sendall(struct.pack("<I", len(blob)) + bytes(blob))
        with pytest.raises(WireCorruption):
            trep._recv_flat(b)
    finally:
        a.close()
        b.close()

    # the relay mailbox: overflow is a resync, not an eviction; the same
    # answers to either package's client
    answers = {}
    for name, client in (("jax", JMemberClient), ("torch", MemberClient)):
        c = Coordinator("127.0.0.1", 0, lease_s=5.0)
        try:
            cl = client("127.0.0.1", c.port, 0, 5.0)
            rid = cl.call("replica_join", mode="relay")["rid"]
            seen = [bool(cl.call("replica_put", rid=rid, version=v,
                                 blob=b"x")["overflow"])
                    for v in range(1, 6)]
            rec = cl.call("replica_roster")["replicas"][0]
            cl.call("replica_put", rid=rid, version=6, blob=b"base")
            got = cl.call("replica_fetch", rid=rid, timeout=5.0)
            answers[name] = (seen, rec["status"], rec["needs_base"],
                             rec["mailbox_depth"], got["version"],
                             got["blob"])
        finally:
            c.stop()
    assert answers["jax"] == answers["torch"] == (
        [False] * 4 + [True], "live", True, 0, 6, b"base")

    # the hold-vs-die boundary and the hold window across a takeover
    for silent in (0.0, 19.999999, 20.0, 21.0, 3.0, 30.0):
        for hold in (20.0, 30.0):
            assert trep.unreachable_verdict(silent, hold) == \
                jrep.unreachable_verdict(silent, hold)
    assert trep.unreachable_verdict(20.0, 20.0) == "die"
    assert trep.unreachable_verdict(20.0 - 1e-6, 20.0) == "hold"
    assert (trep._HOLD_FLOOR_S, trep._HOLD_LEASES) == (
        jrep._HOLD_FLOOR_S, jrep._HOLD_LEASES)
    for lease in (0.5, 2.0, 5.0):
        hold = max(trep._HOLD_FLOOR_S, trep._HOLD_LEASES * lease)
        assert hold > lease + 2.0
        assert trep.Replica("127.0.0.1", 1, mode="relay",
                            lease_s=lease).hold_s == hold
    assert trep._MAX_LOOKUP_FRAME == jrep._MAX_LOOKUP_FRAME

    # latest_known: a locked max-merge under contention
    rep = trep.Replica("127.0.0.1", 1, mode="relay")
    seen, seen_lock = [], threading.Lock()

    def advance(i):
        for v in range(200):
            rep._advance_latest(v * 8 + i)
            with seen_lock:
                seen.append(rep.latest_known)

    _hammer(8, advance)
    assert rep.latest_known == 199 * 8 + 7 == max(seen)
    assert rep.exit_code is None
    with rep._state_lock:
        pass

    # the replica_lag rule on the same tick records
    records = [{}, {"replica_subscribers": 0},
               {"replica_subscribers": 2, "replica_lag_versions": 0},
               {"replica_subscribers": 2, "replica_lag_versions": 3},
               {"replica_subscribers": 1, "replica_lag_versions": 9,
                "replica_rollup_age_max_s": 30.0},
               {"replica_subscribers": 1, "replica_lag_versions": 9,
                "replica_rollup_age_max_s": 1.0}]
    jr, tr = jwd.ReplicaLagRule(), twd.ReplicaLagRule()
    for rec in records:
        a, b = jr.check([rec]), tr.check([rec])
        assert (a is jwd.HOLD) == (b is twd.HOLD) and (
            a is jwd.HOLD or a == b), rec
    assert [type(r).__name__ for r in twd.default_rules()] == \
        [type(r).__name__ for r in jwd.default_rules()]

    # the publisher's sample, healthz report and ledger probe
    roster = [{"rid": 1, "mode": "shm", "status": "live", "acked": 3,
               "rollup_age_s": 0.5, "needs_base": False},
              {"rid": 2, "mode": "relay", "status": "dead", "acked": 1,
               "rollup_age_s": None, "needs_base": False},
              {"rid": 3, "mode": "tcp", "status": "live", "acked": -1,
               "rollup_age_s": 12.0, "needs_base": True}]
    out = {}
    for name, mod in (("jax", jpub), ("torch", tpub)):
        pub = mod.ReplicaPublisher(zoo=None, active=True)
        pub._roster, pub.latest, pub.max_lag = roster, 5, 2
        pub.endpoint, pub.fanout_bytes = "127.0.0.1:1", 77
        table = SimpleNamespace(_pub_journal=tdelta.TableJournal(
            "rows", num_rows=40))
        table._pub_journal.mark_rows(np.arange(3))
        pub.zoo = SimpleNamespace(server_engine=SimpleNamespace(
            store_=[table]))
        pub._dirty[5] = {0: {"kind": "rows",
                             "ids": np.arange(6, dtype=np.int64)}}
        monkeypatch.setattr(mod, "_publisher", pub)
        out[name] = (mod.peek_sample(), mod.status_report(),
                     mod.ledger_bytes())
    assert out["jax"] == out["torch"]
    assert out["torch"][0] == {"replica_subscribers": 2,
                               "replica_lag_versions": 2,
                               "replica_rollup_age_max_s": 12.0}
    assert out["torch"][2] == {"journal_bytes": 40, "dirty_set_bytes": 48,
                               "retained_versions": 1}

    # the content-addressed encode cache (tests/test_compress.py's drill)
    _set_flags(True)
    try:
        pub = tpub.ReplicaPublisher(zoo=None, active=True)
        state = np.random.default_rng(1).standard_normal(
            (500, 8)).astype(np.float32)
        snap = Snapshot(version=2, created_wall=time.time(),
                        window_epoch=0,
                        tables={0: MatrixSnapshot.host(state)})
        ids = np.arange(0, 500, 50, dtype=np.int64)
        with pub._lock:
            pub._dirty[1] = {0: {"kind": "rows", "ids": ids}}
            pub._dirty[2] = {0: {"kind": "rows", "ids": ids + 1}}
            pub.latest = 2
        rec = {"acked": 0, "needs_base": False}
        blob1, kind1 = pub._encode_for(rec, snap)
        blob2, kind2 = pub._encode_for(dict(rec), snap)
        assert kind1 == kind2 == "delta" and blob2 is blob1
        blob3, _ = pub._encode_for({"acked": 1, "needs_base": False}, snap)
        assert blob3 is not blob1
        _set_flags(True, "0")       # a flag flip misses the cache
        blob4, _ = pub._encode_for(dict(rec), snap)
        assert blob4 is not blob1 and len(blob4) < len(blob1)
        assert pub._encode_for({"acked": 0, "needs_base": True},
                               snap)[1] == "base"
        snap3 = Snapshot(version=3, created_wall=time.time(),
                         window_epoch=0,
                         tables={0: MatrixSnapshot.host(state)})
        with pub._lock:
            pub._dirty[3] = {0: {"kind": "rows", "ids": ids}}
        pub._encode_for({"acked": -1, "needs_base": True}, snap3)
        assert all(k[2] == 3 for k in pub._enc_cache)
        # a pruned interval resyncs with a base
        assert pub._encode_for({"acked": 0, "needs_base": False},
                               snap3)[1] == "delta"
        with pub._lock:
            del pub._dirty[1]
        pub._enc_version = -1
        assert pub._encode_for({"acked": 0, "needs_base": False},
                               snap3)[1] == "base"
    finally:
        _set_flags(False)
    # the shm session token names the reader's pid
    assert tpub.token_pid("1a2bp3c4") == 0x1a2b
    assert tpub.token_pid("1a2b3c4") is None
