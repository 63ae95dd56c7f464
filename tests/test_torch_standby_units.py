"""The port's coordinator standby held against the JAX package's.

Each package runs ``tests/_elastic_child.py ha`` in an interpreter of its
own (the coordinators count into process-wide metrics registries):

(a) One mixed op script (register, hb, two shard_puts, a policy_put and
    its duplicate, two replica_joins, replica_ack, replica_roster with a
    version, replica_hb, replica_evict, leave) sent by two member clients
    to a primary that ships its op log to an in-process ``StandbyServer``:
    the same replies, the same stored records (kind, seq and data: the
    op-log grammar), and after ``force_takeover`` the successor's
    ``state_digest()`` equal to the live primary's and to the JAX
    package's for the same script.
(b) An acked ``shard_put`` survives ``simulate_kill`` (no goodbye) on the
    successor, bit-exact, with no spurious eviction; 25 heartbeats compact
    to one ``hb`` record beside the ``register``; a stopped standby
    degrades the primary to solo (``state`` says so) and the primary still
    serves.
(c) The takeover lease (``tests/test_failover.py`` ``TestLeaseBoundary``):
    never before the primary is seen, expired at exactly ``lease_s`` and
    after, never after a takeover; ``rebase_clocks`` stops a stale member
    and replica clock from reaping and flags the replica for a fresh base.

Tolerance: equal JSON records and equal digests.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

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


@pytest.fixture(scope="module")
def ha(tmp_path_factory):
    out = tmp_path_factory.mktemp("ha")
    return _child("ha", "torch", out), _child("ha", "jax", out)


def test_replayed_successor_digest_equals_live_and_jax(ha):
    got, want = ha
    g, w = got["script"], want["script"]
    assert g["replies"] == w["replies"]
    assert g["records"] == w["records"]
    assert g["live"] == g["replayed"] == w["live"] == w["replayed"]
    assert g["state"] == w["state"]
    assert g["takeover_ms_set"] and g["again_is_same"]
    kinds = [r["kind"] for r in g["records"]]
    # one record per mutation: the duplicate policy_put logs nothing, and
    # the standby kept the one newest hb of member 0
    assert kinds == ["register", "register", "hb", "shard_put",
                     "shard_put", "policy_put", "replica_join",
                     "replica_join", "replica_ack", "latest",
                     "replica_hb", "replica_evict", "leave"], kinds
    assert g["replies"][6]["dup"] is True
    assert g["state"]["policy_staged"] == 1
    assert g["state"]["replicas"] == {"1": "live", "2": "evicted"}
    assert g["state"]["standby"] == "solo"


def test_acked_op_survives_kill_hb_compacts_and_standby_loss_degrades(ha):
    got, want = ha
    for key in ("kill", "compact", "degrade"):
        assert got[key] == want[key], key
    assert got["kill"]["blob"] == {"bytes": b"acked-before-death".hex()}
    assert got["kill"]["status"] == "active"
    assert got["compact"] == {"count": 2, "kinds": ["register", "hb"]}
    d = got["degrade"]
    assert (d["before"], d["after"], d["state"]) == (
        "replicated", "degraded", "degraded")
    assert d["solo_get"] == {"bytes": b"solo".hex()}


def test_takeover_lease_boundary_and_clock_rebase(ha):
    got, want = ha
    assert got["lease"] == want["lease"]
    assert got["rebase"] == want["rebase"]
    assert got["lease"] == {"before_seen": False,
                            "edges": [False, True, True],
                            "after_takeover": False}
    stale, rebased = got["rebase"]
    assert stale["members"] == [0, 1] and stale["replicas"] == [1]
    assert rebased == {"members": [], "replicas": [], "needs_base": [True]}
