"""The port's replica plane live on the CPU: a trainer and reader processes.

(a) One port trainer (``-mv_replica_fanout``, the matrix table's
    snapshots device-resident: ``-mv_serving_residence=device``, legal on
    the CPU) with a relay, a tcp and an shm reader
    (``python -m multiverso_tpu_torch.replica.replica``), the JAX live
    tests' shapes (``tests/test_replica.py`` ``TestReplicaRelayLive``,
    ``tests/test_tcp_wire.py`` ``TestReplicaTcpSubscriber``): each reader
    reaches v1 from a base and v2 (1% churn) from a delta of at most 10%
    of the base, serves both versions bitwise the trainer's
    ``MV_ServingLookup`` (matrix rows, KV keys with absent ones), holds
    the keep=2 pair, rode its own transport, and made no CUDA context (its
    status file).
(b) The kill drill (``TestReplicaKillDrill`` and the replica half of
    ``tests/test_fleet.py``'s drill): two shm readers, one armed with
    ``--chaos-spec serving.delay:1@0.2``; after lookups on both, the fleet
    fold names the delayed reader as the p99 outlier (``fleet_report``
    and ``/fleet``); then the other reader is SIGKILLed: its lease expires,
    the publisher evicts it (``replica.evictions``), the trainer keeps
    publishing, ``/healthz``'s ``replica`` section names it (status still
    ok), the Dashboard prints the ``[Replica]`` line and the ledger's
    ``mem.replica.journal_bytes`` carries the journals.
(c) Across the packages: the JAX package's reader (``multiverso_tpu.
    replica.replica``, numpy only) subscribes over shm to the port's
    trainer and serves the port's rows bitwise at both versions.

Tolerance: bitwise.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from tests._jax_native_from_port import JAX_READER_SRC
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _spawn(endpoint, tmp_path, name, mode="shm", lease=3.0, extra=(),
           jax=False):
    """Start one reader process; (process, status file path)."""
    sf = str(tmp_path / f"{name}.json")
    args = ["--addr", endpoint, "--mode", mode, "--lease", str(lease),
            "--status-file", sf, *extra]
    if jax:
        from multiverso_tpu_torch import native
        lib = native.build()
        cmd = [sys.executable, "-c", JAX_READER_SRC,
               "" if lib is None else str(lib), *args]
    else:
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.replica.replica",
               *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.STDOUT), sf


def _status(proc, sf, timeout=60.0) -> dict:
    deadline = time.monotonic() + timeout
    while not os.path.exists(sf):
        assert proc.poll() is None, f"reader exited ({proc.poll()})"
        assert time.monotonic() < deadline, "the reader never came up"
        time.sleep(0.05)
    with open(sf) as f:
        return json.load(f)


def _wait(client, version, timeout=60.0) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        st = client.status()
        if (st["latest"] or -1) >= version:
            return st
        assert time.monotonic() < deadline, f"never reached v{version}: {st}"
        time.sleep(0.05)


def _counter(name):
    from multiverso_tpu_torch.telemetry import metrics
    return metrics.snapshot().get(name, {}).get("value", 0)


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def test_relay_tcp_and_shm_readers_follow_the_trainer(tmp_path):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.replica import publisher
    from multiverso_tpu_torch.replica.replica import ReplicaClient
    from multiverso_tpu_torch.tables import KVTableOption, MatrixTableOption
    R, C = 3000, 16
    mv.MV_Init(["-mv_device=cpu", "-mv_replica_fanout=true",
                "-mv_serving_residence=device"])
    procs = []
    try:
        ep = publisher.publisher_endpoint()
        mat = mv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C))
        kvt = mv.MV_CreateTable(KVTableOption())
        rng = np.random.default_rng(0)
        mat.AddRows(np.arange(R, dtype=np.int32),
                    rng.standard_normal((R, C)).astype(np.float32))
        kvt.Add(np.array([3, 8], np.int64), np.array([1.0, 2.0], np.float32))
        v1 = mv.MV_PublishSnapshot()
        started = [_spawn(ep, tmp_path, m, mode=m)
                   for m in ("relay", "tcp", "shm")]
        procs = [p for p, _ in started]
        stats = [_status(p, sf) for p, sf in started]
        clients = [ReplicaClient("127.0.0.1", st["serve_port"])
                   for st in stats]
        for rc in clients:
            _wait(rc, v1)
        base = _counter("replica.fanout_bytes")
        assert base > 3 * R * C * 4         # three bases carried the table
        sel = rng.choice(R, R // 100, replace=False).astype(np.int32)
        mat.AddRows(sel, np.ones((len(sel), C), np.float32))
        kvt.Add(np.array([8, 21], np.int64), np.array([5.0, 6.0], np.float32))
        v2 = mv.MV_PublishSnapshot()
        for rc in clients:
            _wait(rc, v2)
        deltas = _counter("replica.fanout_bytes") - base
        assert 0 < deltas <= 0.10 * base, (deltas, base)
        assert _counter("replica.fanout_encode_reuse") >= 4
        ids = np.sort(rng.choice(R, 64, replace=False))
        keys = [3, 8, 21, 999]
        for rc, st in zip(clients, stats):
            for v in (v1, v2):
                assert np.array_equal(
                    rc.lookup(0, ids, version=v),
                    mv.MV_ServingLookup(mat, ids, version=v)), (st, v)
            assert np.array_equal(
                rc.lookup(1, keys, version=v2),
                mv.MV_ServingLookup(kvt, keys, version=v2))
            status = rc.status()
            assert status["live_versions"] == [v1, v2]
            assert status["jax_free"] and status["lag_versions"] == 0
            assert st["cuda_initialized"] is False and st["pid"] > 0
        modes = {s["rid"]: s["mode"]
                 for s in publisher.status_report()["subscribers"]}
        assert sorted(modes[st["rid"]] for st in stats) == \
            ["relay", "shm", "tcp"]
        assert _counter("tcp_wire.exchanges") > 0
        assert _counter("shm_wire.exchanges") > 0
        for rc in clients:
            rc.close()
    finally:
        _stop(procs)
        mv.MV_ShutDown()


def _get(port, path):
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30).read())


def test_kill_drill_healthz_dashboard_ledger_and_fleet_outlier(tmp_path):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import replica
    from multiverso_tpu_torch.replica import publisher
    from multiverso_tpu_torch.replica.replica import ReplicaClient
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.telemetry import accounting, fleet, ops
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    delay, n = 0.2, 30
    mv.MV_Init(["-mv_device=cpu", "-mv_replica_fanout=true",
                "-mv_ops_port=0"])
    procs = []
    try:
        ep = publisher.publisher_endpoint()
        mat = mv.MV_CreateTable(MatrixTableOption(num_rows=64, num_cols=4))
        mat.AddRows(np.arange(64, dtype=np.int32),
                    np.ones((64, 4), np.float32))
        v1 = mv.MV_PublishSnapshot()
        fast = _spawn(ep, tmp_path, "fast", lease=2.0)
        slow = _spawn(ep, tmp_path, "slow", lease=2.0,
                      extra=("--chaos-spec", f"serving.delay:1.0@{delay}",
                             "--chaos-seed", "7"))
        procs = [fast[0], slow[0]]
        st_fast, st_slow = _status(*fast), _status(*slow)
        rc_fast = ReplicaClient("127.0.0.1", st_fast["serve_port"])
        rc_slow = ReplicaClient("127.0.0.1", st_slow["serve_port"])
        _wait(rc_fast, v1)
        _wait(rc_slow, v1)
        ids = np.arange(16, dtype=np.int32)
        want = mv.MV_ServingLookup(mat, ids, version=v1)
        for _ in range(n):
            assert np.array_equal(rc_fast.lookup(0, ids, version=v1), want)
            assert np.array_equal(rc_slow.lookup(0, ids, version=v1), want)
        m_fast = f"replica:{st_fast['rid']}"
        m_slow = f"replica:{st_slow['rid']}"
        deadline = time.monotonic() + 30.0
        while True:
            rep = fleet.fleet_report()
            rows = {r["member"]: r for r in rep["members"]}
            served = rep["digests"].get("digest.replica.serve_s",
                                        {"count": 0})["count"]
            if served >= 2 * n and {m_fast, m_slow} <= set(rows):
                break
            assert time.monotonic() < deadline, rep
            time.sleep(0.1)
        assert rows[m_slow]["p99_s"] >= delay / 2, rows[m_slow]
        assert rows[m_fast]["p99_s"] < rows[m_slow]["p99_s"], rows
        assert rep["binding_p99"]["member"] == m_slow, rep["binding_p99"]
        body = _get(ops.port(), "/fleet")
        assert body["binding_p99"]["member"] == m_slow
        # the ledger carries the publish journals
        rep_mem = accounting.memory_report()["components"]["replica"]
        assert rep_mem["journal_bytes"] >= 64
        accounting.refresh()
        assert _counter("mem.replica.journal_bytes") == \
            rep_mem["journal_bytes"] + rep_mem["dirty_set_bytes"]
        # a silent death: no goodbye RPC
        ev0 = _counter("replica.evictions")
        fast[0].send_signal(signal.SIGKILL)
        fast[0].wait()
        deadline = time.monotonic() + 20.0
        while _counter("replica.evictions") < ev0 + 1:
            assert time.monotonic() < deadline, publisher.status_report()
            time.sleep(0.05)
        states = {s["rid"]: s["state"]
                  for s in publisher.status_report()["subscribers"]}
        assert states[st_fast["rid"]] in ("dead", "evicted")
        assert states[st_slow["rid"]] == "live"
        mat.AddRows(np.arange(8, dtype=np.int32), np.ones((8, 4), np.float32))
        v2 = mv.MV_PublishSnapshot()
        assert v2 == v1 + 1
        _wait(rc_slow, v2)
        health = _get(ops.port(), "/healthz")
        subs = {s["rid"]: s for s in health["replica"]["subscribers"]}
        assert subs[st_fast["rid"]]["state"] in ("dead", "evicted")
        assert subs[st_slow["rid"]]["state"] == "live"
        assert health["status"] == "ok"     # a departed reader is not a
        assert "not_running" not in health  # trainer health problem
        line = replica.status_lines()[0]
        assert line.startswith("[Replica] subscribers = 1 live / 2 known")
        assert line in Dashboard.DisplayAll()
        rc_fast.close()
        rc_slow.close()
    finally:
        _stop(procs)
        mv.MV_ShutDown()


def test_jax_reader_follows_the_port_trainer(tmp_path):
    import multiverso_tpu_torch as mv
    from multiverso_tpu.replica.replica import ReplicaClient
    from multiverso_tpu_torch.replica import publisher
    from multiverso_tpu_torch.tables import KVTableOption, MatrixTableOption
    R, C = 500, 8
    mv.MV_Init(["-mv_device=cpu", "-mv_replica_fanout=true"])
    procs = []
    try:
        ep = publisher.publisher_endpoint()
        mat = mv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C))
        kvt = mv.MV_CreateTable(KVTableOption())
        rng = np.random.default_rng(4)
        mat.AddRows(np.arange(R, dtype=np.int32),
                    rng.standard_normal((R, C)).astype(np.float32))
        kvt.Add(np.array([1, 2, 3], np.int64), np.ones(3, np.float32))
        v1 = mv.MV_PublishSnapshot()
        proc, sf = _spawn(ep, tmp_path, "jax_reader", jax=True)
        procs = [proc]
        st = _status(proc, sf)
        rc = ReplicaClient("127.0.0.1", st["serve_port"])
        _wait(rc, v1)
        sel = rng.choice(R, 20, replace=False).astype(np.int32)
        mat.AddRows(sel, rng.standard_normal((20, C)).astype(np.float32))
        kvt.Add(np.array([3, 40], np.int64), np.ones(2, np.float32))
        v2 = mv.MV_PublishSnapshot()
        status = _wait(rc, v2)
        assert status["jax_free"] and status["live_versions"] == [v1, v2]
        ids = np.arange(R, dtype=np.int32)
        for v in (v1, v2):
            assert np.array_equal(rc.lookup(0, ids, version=v),
                                  mv.MV_ServingLookup(mat, ids, version=v))
            assert np.array_equal(
                rc.lookup(1, [1, 3, 40, 77], version=v),
                mv.MV_ServingLookup(kvt, [1, 3, 40, 77], version=v))
        subs = publisher.status_report()["subscribers"]
        assert [(s["mode"], s["state"]) for s in subs] == [("shm", "live")]
        rc.close()
    finally:
        _stop(procs)
        mv.MV_ShutDown()
