"""The port's ops endpoint, byte ledger and watchdog.

(1) the ``-mv_ops_port`` endpoint of a world hammered from two threads
    (``-mv_watchdog_s`` and ``-mv_row_sketch`` armed): ``/metrics`` parses
    as Prometheus text and its counters only go up between scrapes,
    ``/healthz`` answers 200 "ok" and names the JAX planes that do not run
    here, ``/flight``, ``/perf`` (row skew, phases), ``/alerts`` (ticking)
    and ``/memory`` answer, an unknown path is a 404; after the engine's
    loop thread dies ``/healthz`` answers 503; after ``MV_ShutDown`` the
    port is closed and no ops or watchdog thread is left; and the FIRST
    scrape of a fresh empty world (its own interpreter) carries every
    ``mv_mem_*`` family of the JAX package at zero and the seven local
    ``mv_alert_*`` families at zero;
(2) the ledger: each table's ``device_bytes`` is its tensors' storage bytes
    (a momentum table twice its data, for the aux state), ``mem.*`` and
    ``/memory`` reconcile, and a probe launches no row kernel, calls no
    ``.cpu()``/``.item()`` and no ``torch.cuda.synchronize``;
(3) the watchdog's seven local rules give the JAX rules' verdicts on the
    same sample history, and the port's evaluator fires a rule only after
    ``fire_after`` breaching ticks, holds it on ticks without evidence,
    clears it after ``clear_after`` healthy ticks, and counts and records
    the alert (``alert.<rule>`` counter and flight event).
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import ROOT, _libpath


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _prometheus(text):
    """{sample name: value} of a Prometheus text body; every line is a
    ``# TYPE`` line or ``name value``."""
    out, kinds = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out, kinds


def test_ops_endpoint_health_and_teardown():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.message import MsgType
    from multiverso_tpu_torch.tables import KVTableOption, MatrixTableOption
    from multiverso_tpu_torch.telemetry import metrics, ops
    from multiverso_tpu_torch.zoo import Zoo
    mv.MV_Init(["-mv_device=cpu", "-mv_ops_port=0", "-mv_watchdog_s=0.05",
                "-mv_row_sketch=32", "-num_workers=2",
                "-mv_engine_shards=1"])
    try:
        port = ops.port()
        mat = mv.MV_CreateTable(MatrixTableOption(num_rows=64, num_cols=4))
        kv = mv.MV_CreateTable(KVTableOption())
        # the registry is process-wide: earlier worlds' counts stay in it
        base = {n: metrics.counter(f"table.matrix0.{n}.count").value
                for n in ("add", "get")}

        def hammer(w):
            g = np.random.default_rng([3, w])
            with Zoo.Get().worker_context(w):
                for _ in range(30):
                    ids = g.integers(0, 8, 4).astype(np.int32)
                    mat.AddRows(ids, np.ones((4, 4), np.float32))
                    mat.GetRows(ids)
                    kv.Add(ids.astype(np.int64), np.ones(4, np.float32))
        ths = [threading.Thread(target=hammer, args=(w,)) for w in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
        code, body = _get(port, "/metrics")
        assert code == 200
        first, kinds = _prometheus(body)
        assert first["mv_table_matrix0_add_count"] == base["add"] + 60
        mat.GetRows(np.arange(4, dtype=np.int32))
        code, body = _get(port, "/metrics")
        second, _ = _prometheus(body)
        for name, kind in kinds.items():
            if kind == "counter":
                assert second[name] >= first[name], name
        assert second["mv_table_matrix0_get_count"] == base["get"] + 61
        code, body = _get(port, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok", health
        # the replica plane is off here: no section, as in the JAX
        # document (and no not_running key)
        assert "replica" not in health and "not_running" not in health
        code, body = _get(port, "/flight")
        assert code == 200 and json.loads(body)["recorded"] > 0
        code, body = _get(port, "/perf")
        perf = json.loads(body)
        assert code == 200 and "apply" in perf["phases"]
        assert perf["row_skew"][0]["total"] > 0
        code, body = _get(port, "/alerts")
        assert code == 200 and json.loads(body)["enabled"]
        code, body = _get(port, "/memory")
        assert code == 200 and json.loads(body)["total_bytes"] > 0
        assert _get(port, "/nope")[0] == 404
        # the engine's loop thread dies: /healthz flips to 503
        with pytest.raises(RuntimeError):
            Zoo.Get().CallOnEngine(
                MsgType.Request_StoreLoad,
                lambda: (_ for _ in ()).throw(SystemExit("killed")),
                "a test kill")
        code, body = _get(port, "/healthz")
        assert code == 503 and json.loads(body)["status"] == "dead"
    finally:
        mv.MV_ShutDown()
    assert ops.port() is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5)
    left = {t.name for t in threading.enumerate()}
    assert not left & {"mvt-ops-http", "mvt-watchdog", "mvt-stats-reporter"}
    # the first scrape of an empty world, in an interpreter of its own
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_telemetry_child.py"),
         "scrape0", _libpath()], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    scr = json.loads(res.stdout.strip().splitlines()[-1])
    jmem = {k: v for k, v in scr["jax"]["samples"].items()
            if k.startswith("mv_mem_")}
    tmem = {k: v for k, v in scr["torch"]["samples"].items()
            if k.startswith("mv_mem_")}
    assert tmem == jmem and len(tmem) == 12 and not any(tmem.values())
    talert = {k: v for k, v in scr["torch"]["samples"].items()
              if k.startswith("mv_alert_")}
    assert set(talert) == {f"mv_alert_{r}" for r in (
        "shard_imbalance", "shm_backpressure", "apply_pool_sat",
        "mailbox_backlog", "snapshot_stale", "memory_growth", "straggler",
        "replica_lag", "fleet_p99_breach", "member_qps_outlier",
        "rollup_stale", "coordinator_failover")}
    assert set(talert) == {k for k in scr["jax"]["samples"]
                           if k.startswith("mv_alert_")}
    assert not any(talert.values())


def test_ledger_reconciles_and_a_probe_launches_nothing(monkeypatch):
    import torch

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import ops as rows_ops
    from multiverso_tpu_torch.ops import cuda_rows
    from multiverso_tpu_torch.tables import KVTableOption, MatrixTableOption
    from multiverso_tpu_torch.telemetry import accounting, metrics
    mv.MV_Init(["-mv_device=cpu"])
    try:
        add = mv.MV_CreateTable(MatrixTableOption(num_rows=100, num_cols=50))
        mom = mv.MV_CreateTable(MatrixTableOption(num_rows=100, num_cols=50,
                                                  updater_type="momentum"))
        kv = mv.MV_CreateTable(KVTableOption())
        ids = np.arange(10, dtype=np.int32)
        for t in (add, mom):
            t.AddRows(ids, np.ones((10, 50), np.float32))
        kv.Add(np.arange(5, dtype=np.int64), np.ones(5, np.float32))
        calls = []

        def spy(name, fn):
            def wrapped(*a, **k):
                calls.append(name)
                return fn(*a, **k)
            return wrapped

        for name in ("gather_rows", "update_rows", "scatter_set_rows"):
            monkeypatch.setattr(rows_ops, name,
                                spy(name, getattr(rows_ops, name)))
        for name in ("cpu", "item", "numpy", "tolist"):
            monkeypatch.setattr(torch.Tensor, name,
                                spy(name, getattr(torch.Tensor, name)))
        monkeypatch.setattr(torch.cuda, "synchronize",
                            spy("synchronize", torch.cuda.synchronize))
        launches = dict(cuda_rows.LAUNCHES)
        box = {}
        th = threading.Thread(      # a sampler thread, as the watchdog's
            target=lambda: box.update(rep=accounting.memory_report()))
        th.start()
        th.join(30)
        monkeypatch.undo()
        assert calls == [] and cuda_rows.LAUNCHES == launches
        rep = box["rep"]
        per = {r["table_id"]: r for r in rep["components"]["tables"][
            "per_table"]}
        data_b = add.server().state["data"].untyped_storage().nbytes()
        assert per[0]["device_bytes"] == data_b == 101 * 52 * 4
        assert per[1]["device_bytes"] == 2 * data_b
        assert per[2]["device_bytes"] == \
            kv.server()._values.untyped_storage().nbytes()
        tot = rep["components"]["tables"]["totals"]
        assert tot["device_bytes"] == sum(r["device_bytes"]
                                          for r in per.values())
        snap = metrics.snapshot()
        assert snap["mem.tables.device_bytes"]["value"] == \
            tot["device_bytes"]
        assert snap["mem.total_bytes"]["value"] == rep["total_bytes"]
        assert rep["total_bytes"] == sum(
            snap[n]["value"] for n in accounting.MEM_FAMILIES
            if n not in ("mem.total_bytes", "mem.shm.frame_hw_bytes"))
    finally:
        mv.MV_ShutDown()


def _samples():
    """A tick history that breaches, holds and recovers several rules."""
    out = []
    t = 0.0
    depth = 0
    for i in range(16):
        t += 0.5
        breach = 3 <= i < 9
        depth = depth + 40 if breach else 0
        busy = 2.0 if breach else 0.2
        out.append({
            "t": t, "mailbox_depth": depth, "exchanges": 10.0 * i,
            "apply_s": (0.5 if breach else 0.01) * i,
            "exchange_wait_s": 0.001 * i,
            "shm_rounds": 5.0 * i, "shm_writer_stall_s": 0.3 * i,
            "mem_total": (1 << 21) * (1.2 ** i if breach else 1),
            "shards": [{"shard": 0, "apply_busy_s": busy * i},
                       {"shard": 1, "apply_busy_s": 0.2 * i}]})
    return out


def test_watchdog_rules_and_hysteresis_match_jax():
    from multiverso_tpu.telemetry import watchdog as jwd
    from multiverso_tpu_torch.telemetry import flight, metrics
    from multiverso_tpu_torch.telemetry import watchdog as twd
    names = [r.name for r in twd.default_rules()]
    assert names == ["shard_imbalance", "shm_backpressure",
                     "apply_pool_sat", "mailbox_backlog", "snapshot_stale",
                     "memory_growth", "straggler", "replica_lag",
                     "fleet_p99_breach", "member_qps_outlier",
                     "rollup_stale", "coordinator_failover"]
    samples = _samples()
    for name in names:
        trule = next(r for r in twd.default_rules() if r.name == name)
        jrule = next(r for r in jwd.default_rules() if r.name == name)
        assert type(trule).__name__ == type(jrule).__name__
        for k in range(1, len(samples) + 1):
            tv, jv = trule.check(samples[:k]), jrule.check(samples[:k])
            assert (tv is twd.HOLD) == (jv is jwd.HOLD), (name, k)
            if tv is not twd.HOLD:
                assert tv == jv, (name, k)
    wd = twd.Watchdog(60.0, rules=[twd.MailboxBacklogRule()])
    c0 = metrics.counter("alert.mailbox_backlog").value
    fired = [wd.evaluate(s) for s in samples]
    # depth 0, 40, 80 over ticks 2-4 is the first rising window past 64:
    # breaches at ticks 4 and 5, so fire_after=2 fires at tick 5; it
    # clears clear_after=3 healthy ticks after the backlog is gone
    assert [i for i, f in enumerate(fired) if f] == [5]
    assert metrics.counter("alert.mailbox_backlog").value == c0 + 1
    assert wd.active_alerts() == []
    assert wd.report()["rules"]["mailbox_backlog"]["good"] >= 3
    kinds = [e["detail"] for e in flight.events()
             if e["kind"] == "alert.mailbox_backlog"]
    assert kinds[-1] == "cleared" and len(kinds) >= 2
    # a HOLD tick (no evidence) moves nothing
    hold = twd.Watchdog(60.0, rules=[twd.StragglerRule()])
    assert hold.evaluate({"t": 0.0}) == [] and hold.evaluate({"t": 1.0}) \
        == []
    assert hold.report()["rules"]["straggler"] == {
        "active": False, "bad": 0, "good": 0, "last_detail": None}
