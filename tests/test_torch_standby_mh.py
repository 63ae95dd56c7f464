"""The port's coordinator standby across processes, on the CPU.

(a) The kill -9 drill of ``tests/test_failover.py``
    (``TestKillNineDrill``) against ``python -m
    multiverso_tpu_torch.elastic.standby``: a standby process, a
    ``--primary`` process replicating to it, a member client over both
    endpoints that stages a policy action and hammers shard_puts, SIGKILL
    of the primary mid-hammer. The successor answers every acked blob,
    keeps member 0 active, reports standby "solo", answers the
    re-delivered policy action as a duplicate, and the client counts a
    failover: the same outcome as the JAX package's processes in the same
    drill (``tests/_elastic_child.py kill9``, one interpreter a package).
    Neither port process created a CUDA context (their status files).
(b) A two-rank world (shm wire, ``-mv_elastic``, ``-mv_standby`` and a
    two-endpoint ``-mv_coordinator``) beside a standby process: three
    rounds and a sync, then ``coord.kill`` fires on rank 0's coordinator
    (the chaos site, armed by ``MV_SetFlag``); the first op after it lands
    on the successor, three more rounds and a sync ride the successor, no
    member is evicted, each rank failed over, ``elastic.standby_degraded``
    stayed 0, the successor's digest at takeover equals the dead
    primary's, and the tables (an add table with integer deltas and a
    momentum table) end BITWISE equal to a no-kill world run with the same
    rounds in the same processes.

Each child runs under its own subprocess timeout.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child(mode: str, pkg: str, outdir) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_elastic_child.py"), mode,
         pkg, str(outdir)], env=env, capture_output=True, text=True,
        timeout=90)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_kill9_drill_matches_jax(tmp_path):
    got = _child("kill9", "torch", tmp_path)
    want = _child("kill9", "jax", tmp_path)
    # the JAX status files carry no CUDA key; everything else is equal
    for key in ("primary_status", "successor_status"):
        assert got[key].pop("cuda_initialized") is False, got[key]
        want[key].pop("cuda_initialized")
    assert got == want
    assert got == {
        "primary_status": {"role": "primary", "standby": "replicated"},
        "first_put_dup": False,
        "successor_status": {"role": "successor", "port_is_serve": True,
                             "records_ge_1": True},
        "acked_any": True, "all_acked_present": True, "status0": "active",
        "standby": "solo", "redelivered_dup": True, "failed_over": True}


_RANK = r'''
import hashlib, json, os, sys, time
rank, port, port2, succ, log_port, out = sys.argv[1:7]
rank = int(rank)
import numpy as np
import multiverso_tpu_torch as mv
from multiverso_tpu_torch import elastic
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.tables import MatrixTableOption
from multiverso_tpu_torch.telemetry import metrics
from multiverso_tpu_torch.updaters.base import AddOption

R, C, A, B = 40, 4, 3, 3
LEASE = 2.0
base = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
        "-dist_size=2", "-mv_device=cpu", "-mv_deadline_s=30"]
mopt = AddOption(momentum=0.5)


def batch(r, who):
    g = np.random.default_rng(100 * r + who)
    ids = np.sort(g.choice(R, 12, replace=False)).astype(np.int32)
    return ids, g.integers(-4, 5, (12, C)).astype(np.float32)


def train(add, mom, r):
    ids, d = batch(r, rank)
    add.AddRows(ids, d)
    mom.AddRows(ids, d, mopt)
    add.GetRows(ids)


def tables():
    return (mv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C)),
            mv.MV_CreateTable(MatrixTableOption(
                num_rows=R, num_cols=C, updater_type="momentum")))


def digest(add, mom):
    return [hashlib.sha256(t.Get().tobytes()).hexdigest()
            for t in (add, mom)]


res = {}
mv.MV_Init(base + [
    "-mv_elastic=true", f"-mv_elastic_lease_s={LEASE}",
    f"-mv_coordinator=127.0.0.1:{port2},127.0.0.1:{succ}",
    f"-mv_standby=127.0.0.1:{log_port}"])
assert multihost.wire_name() == "shm", multihost.wire_name()
add, mom = tables()
for r in range(A):
    train(add, mom, r)
assert mv.MV_ElasticSync() == 0
st = elastic._state
if rank == 0:
    res["standby_before"] = elastic.ha_status()["standby"]
    mv.MV_SetFlag("chaos_spec", "coord.kill:1.0")
    t0 = time.perf_counter()
    st.client.call("state", timeout=30.0)   # dies mid-op, lands on succ
    res["kill_to_successor_s"] = time.perf_counter() - t0
    mv.MV_SetFlag("chaos_spec", "")
    res["primary_digest"] = st.coordinator.state_digest()
for r in range(A, A + B):
    train(add, mom, r)
assert mv.MV_ElasticSync() == 0
state = st.client.call("state", timeout=30.0)
res["statuses"] = state["statuses"]
res["successor_standby"] = state["standby"]
res["failover_gen"] = st.client.failover_gen
res["members"] = list(mv.MV_ElasticMembers())
snap = metrics.snapshot()
res["degraded"] = snap.get("elastic.standby_degraded", {}).get("value", 0)
mv.MV_Barrier()
res["killed"] = digest(add, mom)
mv.MV_ShutDown(finalize_net=False)

mv.MV_Init(base)                    # the no-kill oracle world
add, mom = tables()
for r in range(A + B):
    train(add, mom, r)
mv.MV_Barrier()
res["oracle"] = digest(add, mom)
mv.MV_ShutDown()
with open(out, "w") as f:
    json.dump(res, f)
print(f"child {rank} STANDBY-KILL OK", flush=True)
os._exit(0)
'''


def _wait_status(path, role, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as fh:
                st = json.load(fh)
            if st.get("role") == role:
                return st
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"no {role!r} status in {path}")


def test_two_rank_world_survives_a_primary_kill_bitwise(tmp_path):
    child = tmp_path / "rank.py"
    child.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    port, port2, succ = _free_port(), _free_port(), _free_port()
    status = str(tmp_path / "standby.json")
    standby = subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.elastic.standby",
         "--listen", "127.0.0.1:0", "--serve", f"127.0.0.1:{succ}",
         "--lease", "1.0", "--coord-lease", "2.0", "--status-file",
         status], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT)
    procs = []
    try:
        log_port = _wait_status(status, "standby")["log_port"]
        outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, str(child), str(r), str(port), str(port2),
             str(succ), str(log_port), outs[r]], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = [p.communicate(timeout=90)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and "STANDBY-KILL OK" in log, \
                f"rank {r} failed:\n{log[-3000:]}"
        sst = _wait_status(status, "successor")
    finally:
        for p in procs + [standby]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    r0, r1 = (json.load(open(o)) for o in outs)
    assert r0["standby_before"] == "replicated"
    assert sst["cuda_initialized"] is False and sst["records"] >= 1
    assert sst["digest"] == r0["primary_digest"]
    for r in (r0, r1):
        assert r["statuses"] == {"0": "active", "1": "active"}, r
        assert r["successor_standby"] == "solo"
        assert r["failover_gen"] >= 1 and r["members"] == [0, 1]
        assert r["degraded"] == 0
        assert r["killed"] == r["oracle"]
    assert r0["killed"] == r1["killed"]
    assert r0["killed"][0] != r0["killed"][1]      # momentum applied
    assert r0["kill_to_successor_s"] < 10.0
