"""The port's elastic units held against the JAX package's.

(a) The re-partition math (``shard_ranges``, ``shard_owner_map``,
    ``plan_moves``, ``plan_routing``, ``shard_shippers``) over the N -> M
    matrix, equal to ``multiverso_tpu.elastic.rebalance``; the shard-move
    wire over every table family (Matrix with momentum aux, Array,
    SparseMatrix, KV): the same seeded tables in a JAX world and a port
    world, each package's frames split by BOTH packages' ``split_frame``
    into equal shard records and joined back by the OTHER package's
    ``join_shards`` to the same bytes; a port frame restored into a fresh
    port table equal to the JAX table (``read_table_frame`` across the
    packages), and torn coverage and a flipped bit refused.
(b) One scripted coordinator op sequence (``tests/_elastic_child.py``
    ``coord``: register, hb, leave with a duplicate and from rank 0, sync,
    cut, deduped shard_put, manifest, commit, join staging with a
    duplicate, dead_check under an injected clock, the shrink's commit,
    xchg/gbar, the policy ops, the replica ops with a reap under an
    injected clock, state) sent to each package's ``Coordinator``: the
    same replies and the same ``state_digest()`` after every step.
(c) The dialer: endpoint parsing and the failover order (a refused
    endpoint then a live one, ``mark_failed`` rotation, the typed
    ``CoordinatorUnreachable``), equal in both packages.

Tolerance: bitwise (equal bytes, equal records, equal digests).
"""

import itertools
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

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


def _tables(mv, opts, rng):
    """The JAX shard-wire test's four families (the matrix with momentum,
    so a frame carries an aux tail), seeded."""
    mat = mv.MV_CreateTable(opts["matrix"](num_rows=13, num_cols=3,
                                           updater_type="momentum_sgd"))
    mat.AddRows(np.arange(13, dtype=np.int32),
                rng.standard_normal((13, 3)).astype(np.float32))
    arr = mv.MV_CreateTable(opts["array"](size=11))
    arr.Add(rng.standard_normal(11).astype(np.float32))
    sp = mv.MV_CreateTable(opts["sparse"](num_rows=9, num_cols=4))
    sp.AddRows(np.arange(9, dtype=np.int32),
               rng.standard_normal((9, 4)).astype(np.float32))
    kv = mv.MV_CreateTable(opts["kv"]())
    kv.Add(np.array([5, 1, 9], np.int64),
           np.array([1.5, 2.5, 3.5], np.float32))


def _jax_frames():
    import multiverso_tpu as jmv
    from multiverso_tpu.elastic.rebalance import capture_cut
    from multiverso_tpu.tables import (ArrayTableOption, KVTableOption,
                                       MatrixTableOption,
                                       SparseMatrixTableOption)
    from multiverso_tpu.zoo import Zoo
    jmv.MV_Init(["-mv_write_combine=0"])
    try:
        _tables(jmv, {"matrix": MatrixTableOption, "array": ArrayTableOption,
                      "sparse": SparseMatrixTableOption,
                      "kv": KVTableOption}, np.random.default_rng(9))
        Zoo.Get().DrainServer()
        return (capture_cut(Zoo.Get().server_tables),
                Zoo.Get().server_tables[0].raw())
    finally:
        jmv.MV_ShutDown()


def test_rebalance_math_and_shard_wire_match_jax():
    from multiverso_tpu.elastic import rebalance as jr
    from multiverso_tpu_torch.elastic import rebalance as tr
    for count in (0, 1, 5, 16, 48):
        for n, m in itertools.product((1, 2, 3, 4), repeat=2):
            assert tr.shard_ranges(count, m) == jr.shard_ranges(count, m)
            old, new = list(range(n)), [0, 2, 5][:m] if m <= 3 else \
                list(range(m))
            assert tr.plan_moves(count, old, new) == \
                jr.plan_moves(count, old, new), (count, n, m)
            assert tr.shard_owner_map(count, new[::-1]) == \
                jr.shard_owner_map(count, new[::-1])
            assert tr.shard_shippers(m, old) == jr.shard_shippers(m, old)
    rng = np.random.default_rng(4)
    for _ in range(40):
        slots = list(range(int(rng.integers(1, 5))))
        load = {s: float(rng.exponential(1.0)) for s in slots}
        routing = {t: int(rng.choice(slots)) for t in range(5)}
        verbs = {s: {t: int(rng.integers(0, 9)) for t in routing}
                 for s in slots}
        assert tr.plan_routing(load, verbs, routing, slots) == \
            jr.plan_routing(load, verbs, routing, slots)

    jframes, jraw = _jax_frames()
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.checkpoint import read_table_frame
    from multiverso_tpu_torch.failsafe.errors import WireCorruption
    from multiverso_tpu_torch.tables import (ArrayTableOption,
                                             KVTableOption,
                                             MatrixTableOption,
                                             SparseMatrixTableOption)
    from multiverso_tpu_torch.utils.log import FatalError
    from multiverso_tpu_torch.zoo import Zoo
    from multiverso_tpu_torch.parallel import seal
    mv.MV_Init(["-mv_device=cpu", "-mv_write_combine=0"])
    try:
        _tables(mv, {"matrix": MatrixTableOption, "array": ArrayTableOption,
                     "sparse": SparseMatrixTableOption,
                     "kv": KVTableOption}, np.random.default_rng(9))
        zoo = Zoo.Get()
        zoo.DrainServer()
        tframes = tr.capture_cut(zoo.server_tables)
        assert len(tframes) == len(jframes) == 4
        for frames in (tframes, jframes):
            for frame in frames:
                for nshards in (1, 2, 3):
                    ts = tr.split_frame(frame, nshards, epoch=7)
                    js = jr.split_frame(frame, nshards, epoch=7)
                    assert [pickle.loads(seal.open_frame(b)) for b in ts] \
                        == [pickle.loads(seal.open_frame(b)) for b in js]
                    assert jr.join_shards(ts[::-1]) == frame
                    assert tr.join_shards(js[::-1]) == frame
        # the JAX frame of the momentum matrix restores into a fresh port
        # table (data and aux) equal to the JAX table
        for frame in (tframes[0], jframes[0]):
            option = zoo.server_tables[0]._mv_option
            rebuilt = option.make_server(zoo)
            read_table_frame(rebuilt, frame)
            np.testing.assert_array_equal(rebuilt.raw(), jraw)
            assert tr.capture_cut([rebuilt]) == [tframes[0]]
        shards = tr.split_frame(tframes[0], 3, epoch=1)
        with pytest.raises(FatalError):        # lost rows
            tr.join_shards(shards[:2])
        with pytest.raises(FatalError):        # a duplicated shard
            tr.join_shards(shards + [shards[1]])
        flipped = bytearray(shards[1])
        flipped[len(flipped) // 2] ^= 0x40
        with pytest.raises(WireCorruption):    # the seal catches the flip
            tr.join_shards([shards[0], bytes(flipped), shards[2]])
    finally:
        mv.MV_ShutDown()


def test_coordinator_op_script_matches_jax(tmp_path):
    got = _child("coord", "torch", tmp_path)
    want = _child("coord", "jax", tmp_path)
    assert [s["step"] for s in got["steps"]] == [
        "register", "hb", "leave", "sync", "cut", "shard_put", "manifest",
        "commit", "join", "reap", "dead_check", "commit_death", "xchg",
        "policy", "replica", "replica_reap", "state"]
    for g, w in zip(got["steps"], want["steps"]):
        assert g == w, (g["step"], g, w)
    # the script reached what it stages: rank 0 refused a drain, the
    # duplicate shard ignored, the death staged by the injected clock
    steps = {s["step"]: s["replies"] for s in got["steps"]}
    assert steps["leave"][2] == {"raised": "FatalError", "check": True}
    assert steps["shard_put"][1]["dup"] is True
    assert steps["shard_put"][3]["blob"] == {"bytes": b"abc".hex()}
    assert steps["dead_check"][0]["transition"]["members"] == [0]
    assert steps["state"][0]["statuses"] == {"0": "active", "1": "reaped",
                                             "2": "left"}
    # the policy and replica ops reached what they stage: the duplicate
    # put answered from the seen-set, the pull drained the one action,
    # the relay blob fetched, the evicted replica told so, the stale
    # lease reaped
    assert steps["policy"][1]["dup"] is True
    assert [a["id"] for a in steps["policy"][2]["actions"]] == [
        "tune:mv_apply_workers:4>6:g0"]
    assert steps["replica"][5]["blob"] == {"bytes": b"delta-7".hex()}
    assert steps["replica"][8] == {"evicted": True, "latest": 7}
    assert steps["replica_reap"][0] == [1]
    assert steps["state"][0]["replicas"] == {"1": "dead", "2": "evicted"}


def test_dialer_parsing_and_failover_match_jax(tmp_path):
    got = _child("dialer", "torch", tmp_path)
    want = _child("dialer", "jax", tmp_path)
    assert got == want
    assert got["landed_on_live"] and got["active_index"] == 1
    assert got["after_mark_failed"] == 0 and got["failover_gen_after"] == 0
    assert got["unreachable"][:2] == ["CoordinatorUnreachable", True]
