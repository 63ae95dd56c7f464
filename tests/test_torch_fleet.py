"""The port's fleet rollup plane held against the JAX package's.

(a) The rollup codec across the packages, and the trace merge: the seeded
    rollups
    (``tests/_elastic_seed.py`` ``fleet_rollups``: four members'
    request digests at two arrival times) encoded by each package decode
    in the other to the same records, digest vectors included (the Digest
    merge law is the same vector layout in both); ``merge_traces`` of three
    seeded per-process dumps (clock anchors, matched client/server span
    pairs) equal to the JAX package's, and the ``--trace`` CLI writing
    that merge.
(b) The accumulator and the watchdog: each package folds its rollups at
    injected clocks (``FleetAccumulator.ingest(blob, now)``, never a wall
    sleep): the same ``report`` and ``peek_sample`` at every step, and the
    same verdicts of ``fleet_p99_breach``, ``member_qps_outlier`` and
    ``rollup_stale`` on those samples; the ``[Fleet]`` Dashboard line of
    the module fold is empty before any rollup and names every member
    after.
(c) The ops documents and the Dashboard in a live port world, empty and
    populated: without ``-mv_elastic``, ``/fleet`` is the empty fleet and
    ``/healthz`` names no elastic plane; with it, the member heartbeat
    carries this rank's rollup to the coordinator, ``/fleet`` shows the
    member (the JAX report's keys plus the coordinator client's posture),
    ``/healthz`` carries the elastic view and the client posture, and the
    Dashboard prints the ``[Elastic]``, ``[CoordHA]`` and ``[Fleet]``
    lines. As in the JAX document, ``/healthz`` has no ``not_running`` key
    and no ``replica`` section while the replica plane is off; with
    ``-mv_replica_fanout`` and a reader joined (a relay reader process
    riding the elastic coordinator) its ``replica`` section lists the
    reader and the Dashboard prints the ``[Replica]`` line.

Tolerance: equal records (bitwise floats) in (a) and (b).
"""

import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _child(mode: str, pkg: str, outdir) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_elastic_child.py"), mode,
         pkg, str(outdir)], env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _records(rollups):
    return [dict(r, digests={n: [float(x) for x in v]
                             for n, v in r["digests"].items()})
            for r in rollups]


def _dumps(seed: int) -> list:
    """Three processes' trace dumps: skewed (wall, mono) anchors, spans,
    and client/server pairs sharing trace ids across the dumps."""
    rng = np.random.default_rng(seed)
    dumps = []
    for k in range(3):
        events = [{"ph": "M", "name": "process_name", "pid": k,
                   "args": {"name": f"rank {k}"}}]
        for i in range(12):
            ts = float(rng.uniform(0, 1e6))
            dur = float(rng.uniform(10, 500))
            cat = ("client", "server", "mv")[(i + k) % 3]
            events.append({"ph": "X", "name": f"s{i}", "cat": cat,
                           "pid": k, "tid": 1, "ts": ts, "dur": dur,
                           "args": {"trace_id": int(i % 5)}})
        dumps.append({"traceEvents": events,
                      "clock": {"wall_s": 1.7e9 + k * 0.25
                                + float(rng.uniform(0, 0.01)),
                                "mono_us": float(rng.uniform(0, 1e7))}})
    return dumps


def test_rollup_codec_decodes_across_packages(tmp_path):
    from multiverso_tpu.telemetry import fleet as jfleet
    from multiverso_tpu_torch.telemetry import fleet as tfleet
    dumps = _dumps(23)
    merged = tfleet.merge_traces(json.loads(json.dumps(dumps)))
    assert merged == jfleet.merge_traces(json.loads(json.dumps(dumps)))
    assert merged["merge"]["n_dumps"] == 3
    assert merged["merge"]["n_span_pairs"] > 0
    paths = []
    for k, d in enumerate(dumps):
        paths.append(str(tmp_path / f"trace{k}.json"))
        with open(paths[-1], "w") as f:
            json.dump(d, f)
    out = str(tmp_path / "merged.json")
    assert tfleet.main(["--trace", "-o", out] + paths) == 0
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(merged))

    from multiverso_tpu_torch.telemetry import fleet, metrics
    from tests._elastic_seed import fleet_rollups
    _child("fleet", "torch", tmp_path)
    jax_side = _child("fleet", "jax", tmp_path)
    want = _records(fleet_rollups(fleet, metrics))
    # the JAX package decoded the port's blobs ...
    assert jax_side["decoded"] == json.loads(json.dumps(want))
    # ... and the port decodes the JAX package's
    raw = (tmp_path / "jax_rollups.bin").read_bytes()
    got, pos = [], 0
    while pos < len(raw):
        n = int.from_bytes(raw[pos:pos + 8], "little")
        got.append(fleet.decode_rollup(raw[pos + 8:pos + 8 + n]))
        pos += 8 + n
    assert got == want
    # the digest merge: the fleet vector of the four members is the
    # vector merge of theirs, whichever package folds it
    vecs = [np.asarray(r["digests"]["digest.worker.rtt_s"]) for r in want]
    merged = metrics.Digest.empty_vector()
    for v in vecs[:4]:
        merged = metrics.Digest.merge_vec(merged, v)
    assert merged[0] == sum(v[0] for v in vecs[:4])


def test_accumulator_report_and_fleet_rules_match_jax(tmp_path):
    got = _child("fleet", "torch", tmp_path)
    want = _child("fleet", "jax", tmp_path)
    for key in ("reports", "samples", "verdicts", "empty_lines",
                "line_count", "line_head"):
        assert got[key] == want[key], key
    assert got["empty_lines"] == [] and got["line_count"] == 1
    assert got["line_head"] == ["[Fleet] members=4"]
    rep = got["reports"][-1]
    assert rep["n_members"] == 4 and rep["binding_p99"]["member"] == "rank3"
    v = got["verdicts"]
    assert v["fleet_p99_breach"][0].startswith("fleet-merged request p99")
    assert v["member_qps_outlier"][0] == "HOLD"
    assert v["member_qps_outlier"][1].startswith("member rank2")
    assert v["rollup_stale"][:2] == [None, None]
    assert v["rollup_stale"][2].startswith("member rank0 rollup")


def _get(port: int, path: str) -> dict:
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30).read())


def test_fleet_healthz_and_dashboard_empty_and_populated():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.telemetry import fleet, ops
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    mv.MV_Init(["-mv_device=cpu", "-mv_ops_port=0"])
    try:
        empty = _get(ops.port(), "/fleet")
        assert empty["n_members"] == 0 and empty["members"] == []
        assert "coordinator_ha" not in empty
        health = _get(ops.port(), "/healthz")
        assert "elastic" not in health and "coordinator_ha" not in health
        # the JAX document names no plane that is off (policy and replica
        # are ported, and off here: no "policy" line, no "replica"
        # section, no not_running key)
        assert "not_running" not in health and "replica" not in health
        assert "policy" not in health
        assert not any(ln.startswith(("[Elastic]", "[CoordHA]"))
                       for ln in Dashboard._ops_lines())
        assert fleet.status_lines() == []
    finally:
        mv.MV_ShutDown()
    mv.MV_Init(["-mv_device=cpu", "-mv_ops_port=0", "-mv_elastic=true",
                "-mv_elastic_lease_s=0.3", "-mv_replica_fanout=true"])
    reader = None
    try:
        from multiverso_tpu_torch import replica
        from multiverso_tpu_torch.replica import publisher
        reader = subprocess.Popen(
            [sys.executable, "-m", "multiverso_tpu_torch.replica.replica",
             "--addr", publisher.publisher_endpoint(), "--mode", "relay",
             "--lease", "5"], cwd=str(ROOT), stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 20.0
        while fleet.fleet_report()["n_members"] == 0:
            assert time.monotonic() < deadline, "no heartbeat rollup"
            time.sleep(0.05)
        doc = _get(ops.port(), "/fleet")
        keys = set(json.loads(json.dumps(fleet.FleetAccumulator().report())))
        assert set(doc) == keys | {"coordinator_ha"}
        assert [m["member"] for m in doc["members"]] == ["rank0"]
        assert doc["members"][0]["role"] == "trainer"
        assert doc["coordinator_ha"]["standby"] == "solo"
        health = _get(ops.port(), "/healthz")
        assert health["elastic"]["epoch"] == 0
        assert health["elastic"]["members"] == [0]
        assert health["coordinator_ha"]["failover_gen"] == 0
        lines = Dashboard._ops_lines()
        assert "[Elastic] epoch = 0, members = 1 [0]" in lines, lines
        assert any(ln.startswith("[CoordHA] endpoint = 127.0.0.1:")
                   for ln in lines), lines
        assert fleet.status_lines()[0].startswith("[Fleet] members=")
        # the reader joins through the elastic coordinator: /healthz's
        # replica section and the Dashboard's [Replica] line name it
        deadline = time.monotonic() + 60.0
        while not publisher.status_report()["subscribers"]:
            assert reader.poll() is None, "the reader exited"
            assert time.monotonic() < deadline, "the reader never joined"
            time.sleep(0.05)
        health = _get(ops.port(), "/healthz")
        assert "not_running" not in health
        subs = health["replica"]["subscribers"]
        assert [(s["mode"], s["state"]) for s in subs] == [("relay", "live")]
        assert health["replica"]["active"] is True
        line = replica.status_lines()[0]
        assert line.startswith("[Replica] subscribers = 1 live / 1 known")
        assert line in Dashboard.DisplayAll()
    finally:
        if reader is not None:
            reader.kill()
            reader.wait()
        mv.MV_ShutDown()
    assert fleet.fleet_report()["n_members"] == 0   # cleared at Stop
