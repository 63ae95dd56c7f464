"""The byte ledger's snapshot and tcp-wire probes
(``telemetry/accounting.py``), held to the JAX package's keys and to the
JAX ledger test (``tests/test_watchdog.py``'s per-component check).

(a) With a serving plane running (three publishes at the default
    ``-mv_serving_keep`` of 2): ``snapshots.per_version`` holds exactly
    the live versions, each at its snapshot's ``nbytes()``, their sum is
    ``snapshots.bytes`` and the ``mem.snapshots.bytes`` gauge, and the
    families reconcile to ``total_bytes``.
(b) A tcp wire (a port end meshed with a JAX end over loopback, then a
    pair of port ends installed as a world's active wire): ``mem_bytes``
    has the JAX keys, the two packages' ends agree on the stream count
    and the frame high-watermark after the same exchanges, and the
    ledger's ``shm`` component carries the port's probe, excluded from
    the total as a high-watermark.
"""

import threading

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.telemetry import accounting
from multiverso_tpu_torch.telemetry import metrics
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

TCP_KEYS = {"inbuf_bytes", "stream_count", "frame_hw_bytes"}


def _reconciles(rep) -> None:
    comps = rep["components"]
    t = comps["tables"]["totals"]
    expect = (t["device_bytes"] + t["host_mirror_bytes"] + t["host_bytes"]
              + comps["snapshots"]["bytes"]
              + comps["flight"]["bytes_estimate"]
              + comps["dedup"]["bytes_estimate"]
              + comps["tables"]["write_combine_bytes"]
              + comps["tables"]["get_cache_bytes"]
              + (comps["shm"] or {}).get("segment_bytes", 0)
              + (comps["replica"] or {}).get("journal_bytes", 0)
              + (comps["replica"] or {}).get("dirty_set_bytes", 0))
    assert rep["total_bytes"] == expect
    snap = metrics.snapshot()
    assert snap["mem.total_bytes"]["value"] == rep["total_bytes"]
    assert snap["mem.snapshots.bytes"]["value"] == comps["snapshots"]["bytes"]


def test_live_snapshots_are_counted():
    from multiverso_tpu_torch.serving import peek_plane
    from multiverso_tpu_torch.tables import KVTableOption, MatrixTableOption
    mv.MV_Init(["-mv_device=cpu"])
    try:
        mat = mv.MV_CreateTable(MatrixTableOption(num_rows=1000,
                                                  num_cols=16))
        kv = mv.MV_CreateTable(KVTableOption())
        g = np.random.default_rng(3)
        versions = []
        for _ in range(3):
            mat.AddRows(np.arange(100, dtype=np.int32),
                        g.standard_normal((100, 16)).astype(np.float32))
            kv.Add(g.integers(0, 10 ** 6, 50), np.ones(50, np.float32))
            versions.append(mv.MV_PublishSnapshot())
        rep = accounting.memory_report()
        comps = rep["components"]
        assert set(comps["snapshots"]) == {"per_version", "bytes"}
        store = peek_plane().store
        live = store.live_versions()
        assert live == versions[-2:]
        per = comps["snapshots"]["per_version"]
        assert sorted(per) == sorted(str(v) for v in live)
        for v in live:
            assert per[str(v)] == store.get(v).nbytes() > 1000 * 16 * 4
        assert comps["snapshots"]["bytes"] == sum(per.values())
        assert store.retained_bytes() == {v: per[str(v)] for v in live}
        _reconciles(rep)
        assert rep["total_bytes"] > comps["snapshots"]["bytes"]
    finally:
        mv.MV_ShutDown()


def _both(fns, timeout=30):
    errs = []

    def run(fn):
        try:
            fn()
        except BaseException as exc:    # reported to the caller
            errs.append(exc)

    ts = [threading.Thread(target=run, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "wire exchange deadlocked"
    assert not errs, errs


def _exchange_rounds(ends, sizes):
    for i, n in enumerate(sizes):
        _both([lambda w=w, r=r: w.exchange(bytes([r + 1]) * (n + 7 * r), 0)
               for r, w in enumerate(ends)])


def test_tcp_wire_probe_has_the_jax_keys(monkeypatch):
    from multiverso_tpu.parallel import seal as jseal
    from multiverso_tpu.parallel.tcp_wire import TcpWire as JWire
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.parallel.tcp_wire import TcpWire as TWire
    monkeypatch.setattr(jseal, "_crc32c_native", False)
    monkeypatch.setattr(jseal, "_crc32c_charp", False)
    sizes = (10, 9000, 30000, 0, 4096)
    # a JAX end and a port end: the same keys, the same counts
    ends = [JWire("tok", 0, 2, 2, 4096), TWire("tok", 1, 2, 2, 4096)]
    try:
        eps = {r: ends[r].listen_endpoints() for r in (0, 1)}
        _both([lambda w=w: w.connect(eps) for w in ends])
        _exchange_rounds(ends, sizes)
        jm, tm = ends[0].mem_bytes(), ends[1].mem_bytes()
        assert set(jm) == set(tm) == TCP_KEYS
        assert tm["stream_count"] == jm["stream_count"] == 2
        assert tm["frame_hw_bytes"] == 30000 + 7
        assert jm["frame_hw_bytes"] == 30000
        assert tm["inbuf_bytes"] == jm["inbuf_bytes"] == 0
    finally:
        for w in ends:
            w.close()
    # two port ends, one installed as a world's active wire
    ends = [TWire("tok2", r, 2, 1, 4096) for r in (0, 1)]
    mv.MV_Init(["-mv_device=cpu"])
    try:
        eps = {r: ends[r].listen_endpoints() for r in (0, 1)}
        _both([lambda w=w: w.connect(eps) for w in ends])
        _exchange_rounds(ends, sizes)
        monkeypatch.setattr(multihost, "active_wire", lambda: ends[0])
        rep = accounting.memory_report()
        wire = rep["components"]["shm"]
        assert wire == ends[0].mem_bytes()
        assert set(wire) == TCP_KEYS and wire["stream_count"] == 1
        assert wire["frame_hw_bytes"] == 30000
        snap = metrics.snapshot()
        assert snap["mem.shm.frame_hw_bytes"]["value"] == 30000
        assert snap["mem.shm.segment_bytes"]["value"] == 0
        _reconciles(rep)
    finally:
        mv.MV_ShutDown()
        for w in ends:
            w.close()
