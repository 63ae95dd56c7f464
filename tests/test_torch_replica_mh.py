"""The replica plane across two ranks, the port against the JAX package.

(a) The JAX package's two-rank drill (``tests/test_replica.py``
    ``_TWO_PROC_CHILD``: ``-mv_replica_fanout`` with
    ``-mv_replica_addr``, 4 rounds, publish and pin v1, a same-host shm
    reader on rank 0 reaching it from a base, 1 more round, publish and
    pin v2, which it reaches as a delta) in both packages on the same
    seeds (``tests/_mh_child.py`` mode ``replica``, each package with its
    own reader process): each reader's lookups at v1 and v2 bitwise its
    rank's pinned ``MV_ServingLookup``, the port's reader serving the JAX
    reader's rows, its live versions the keep=2 pair, and no host
    collective round on either rank across the reader's lookup window.
(b) The outage (mode ``replica_outage``, the port): two ranks under
    ``-mv_elastic`` with a standby process (``python -m
    multiverso_tpu_torch.elastic.standby``) and both coordinator endpoints
    in ``-mv_coordinator``; rank 0's shm reader joins through the ordered
    endpoint list and reaches v1; ``coord.kill`` ends rank 0's
    coordinator; more rounds and v2, which the publisher re-ships through
    the successor's roster after seeing the failover. The reader held
    (still running, ``unreachable_verdict`` "hold" over the outage), made
    no CUDA context, and serves v1 and v2 bitwise both ranks' pinned
    lookups.

Tolerance: bitwise.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

from tests._mh_worlds import ROOT, free_port, run_world


def test_two_rank_drill_matches_jax(tmp_path):
    got, _ = run_world("torch", "replica", tmp_path,
                       f"-mv_replica_addr=127.0.0.1:{free_port()}",
                       timeout=180)
    want, _ = run_world("jax", "replica", tmp_path,
                        f"-mv_replica_addr=127.0.0.1:{free_port()}",
                        timeout=180)
    for res in (got, want):
        r0, r1 = res
        np.testing.assert_array_equal(r0["oracle1"], r1["oracle1"])
        np.testing.assert_array_equal(r0["oracle2"], r1["oracle2"])
        np.testing.assert_array_equal(r0["reader_all1"], r0["oracle1"])
        np.testing.assert_array_equal(r0["reader_all2"], r0["oracle2"])
        assert r0["live"].tolist() == r0["versions"].tolist()
        assert int(r0["rounds"]) == 0 and int(r1["rounds"]) == 0
        assert not np.array_equal(r0["oracle1"], r0["oracle2"])
    for key in ("oracle1", "oracle2", "reader1", "reader2", "reader_all1",
                "reader_all2", "versions"):
        np.testing.assert_array_equal(got[0][key], want[0][key],
                                      err_msg=key)


def _wait_status(path, role, timeout=60.0):
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


def test_reader_holds_through_a_coordinator_kill(tmp_path):
    port2, succ = free_port(), free_port()
    status = str(tmp_path / "standby.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    standby = subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.elastic.standby",
         "--listen", "127.0.0.1:0", "--serve", f"127.0.0.1:{succ}",
         "--lease", "1.0", "--coord-lease", "2.0", "--status-file",
         status], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT)
    try:
        log_port = _wait_status(status, "standby")["log_port"]
        res, _ = run_world(
            "torch", "replica_outage", tmp_path, "-mv_elastic=true",
            "-mv_elastic_lease_s=2",
            f"-mv_coordinator=127.0.0.1:{port2},127.0.0.1:{succ}",
            f"-mv_standby=127.0.0.1:{log_port}", timeout=180)
        sst = _wait_status(status, "successor")
    finally:
        standby.kill()
        standby.wait()
    r0, r1 = res
    assert sst["records"] >= 1 and sst["cuda_initialized"] is False
    assert bool(r0["reader_running"]) and bool(r0["verdict_hold"])
    assert int(r0["failover_gen"]) >= 1
    assert bool(r0["cuda_initialized"]) is False
    for k in ("oracle1", "oracle2"):
        np.testing.assert_array_equal(r0[k], r1[k])
    np.testing.assert_array_equal(r0["reader1"], r0["oracle1"])
    np.testing.assert_array_equal(r0["reader2"], r0["oracle2"])
    assert not np.array_equal(r0["oracle1"], r0["oracle2"])

