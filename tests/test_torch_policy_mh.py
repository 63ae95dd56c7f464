"""The policy plane across two processes: the JAX package's drills
(``tests/test_policy.py`` ``_SKEW_CHILD`` and ``_DRAIN_CHILD``) on
``multiverso_tpu_torch``, over the shm wire, on the CPU.

(a) The hot-table skew: a two-shard engine on each rank, four tables,
    tables 0 and 2 (both on shard 0 by the modulo map) carrying the
    traffic, ``MV_PolicySync`` every fourth iteration with the policy
    staging at a policy-only authority (``-mv_policy_addr``). The live
    watchdog's ``shard_imbalance`` drives at least one route install,
    agreed on both ranks; a fixed hot burst afterwards lands balanced
    (max/mean of the two streams' apply seconds under 1.5) and the alert
    clears; the final tables are BITWISE those of a ``-mv_policy=false``
    world run with the same verbs in the same processes.
(b) The clean control: balanced traffic over all four tables with every
    rule armed installs nothing (no route, tune, drain or revert event),
    and its tables are BITWISE those of the ``-mv_policy=false`` world.
(c) The straggler drain: rank 1 stalls every window apply
    (``apply.delay``), its ``straggler`` alert stages a drain of itself,
    and at one ``MV_PolicySync`` rank 1 leaves while rank 0 syncs; the
    survivor trains on at epoch 1 alone and its table is BITWISE the
    oracle of the verbs both ranks issued (integer-valued deltas), which
    a ``-mv_policy=false`` world cannot reach (nothing drains there).

Tolerance: bitwise. Each child runs under its own subprocess timeout.
"""

import os
import socket
import subprocess
import sys

_SKEW_CHILD = r'''
import json, os, sys, time, urllib.request
rank, port, pport, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
import numpy as np
import multiverso_tpu_torch as mv
from multiverso_tpu_torch.tables import MatrixTableOption
from multiverso_tpu_torch.telemetry import flight, ops
from multiverso_tpu_torch.zoo import Zoo

R, C, ITERS = 512, 32, 48


def alerts_active():
    url = f"http://127.0.0.1:{ops.port()}/alerts"
    body = json.loads(urllib.request.urlopen(url, timeout=10).read())
    return sorted(a["rule"] for a in body["alerts"])


def world(policy_on):
    args = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2", "-mv_device=cpu", "-mv_engine_shards=2",
            "-mv_deadline_s=60", "-mv_watchdog_s=0.15", "-mv_ops_port=0"]
    if policy_on:
        rules = "shard_imbalance" if mode == "skew" else "all"
        args += ["-mv_policy=true",
                 f"-mv_policy_addr=127.0.0.1:{pport}",
                 f"-mv_policy_rules={rules}",
                 "-mv_policy_sustain=2", "-mv_policy_cooldown_s=2.0",
                 "-mv_policy_window_s=30", "-mv_policy_max_actions=2"]
    flight._reset_for_tests()
    mv.MV_Init(args)
    eng = Zoo.Get().server_engine
    assert type(eng).__name__ == "ShardedServer", type(eng)
    tabs = [mv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C))
            for _ in range(4)]
    ids = np.arange(R, dtype=np.int32)
    rng = np.random.default_rng(11 + rank)
    hot = [tabs[0], tabs[2]] if mode == "skew" else tabs
    burst = 16 if mode == "skew" else 8
    for i in range(ITERS):
        d = rng.integers(-3, 4, (R, C)).astype(np.float32)
        for _ in range(burst):
            for t in hot:
                t.AddFireForget(d, row_ids=ids)
        if i % 7 == 3:
            tabs[1].AddFireForget(np.ones((4, C), np.float32),
                                  row_ids=ids[:4])
            tabs[3].AddFireForget(np.ones((4, C), np.float32),
                                  row_ids=ids[:4])
        tabs[0].Wait(tabs[0].GetAsyncHandle(row_ids=ids[:8]))
        if policy_on and i % 4 == 3:
            mv.MV_PolicySync()
    mv.MV_Barrier()
    report = mv.MV_PolicyReport() if policy_on else None
    rr = eng.routing_report()
    final = [t.GetRows(ids) for t in tabs]
    post, cleared = None, None
    if policy_on and mode == "skew":
        d = np.ones((R, C), np.float32)
        s0 = {s["shard"]: s["apply_busy_s"] for s in eng.shard_states()}
        for _ in range(30):
            tabs[0].AddFireForget(d, row_ids=ids)
            tabs[2].AddFireForget(d, row_ids=ids)
        tabs[0].GetRows(ids)
        tabs[2].GetRows(ids)
        s1 = {s["shard"]: s["apply_busy_s"] for s in eng.shard_states()}
        post = {k: s1[k] - s0.get(k, 0.0) for k in s1}
        deadline = time.time() + 10
        cleared = "shard_imbalance" not in alerts_active()
        while not cleared and time.time() < deadline:
            time.sleep(0.2)
            cleared = "shard_imbalance" not in alerts_active()
    ring = {e["kind"] for e in flight.events()}
    mv.MV_Barrier()
    mv.MV_ShutDown(finalize_net=not policy_on)
    return final, report, rr, post, cleared, ring


def main():
    f1, rep, rr, post, cleared, ring = world(True)
    if mode == "skew":
        assert rep["installed"] >= 1, rep
        assert rr["overrides"], rr
        moved = sorted(rr["overrides"])
        assert set(moved) <= {0, 2} and rr["overrides"][moved[0]] == 1, rr
        assert "policy.route" in ring, ring
        assert rep["staged"] == 0 or "policy.staged" in ring, (rep, ring)
        d0, d1 = post.get(0, 0.0), post.get(1, 0.0)
        assert d0 > 0 and d1 > 0, post
        ratio = max(d0, d1) / (0.5 * (d0 + d1))
        assert ratio < 1.5, (post, rr)
        assert cleared, "shard_imbalance never cleared post-action"
    else:
        assert rep["installed"] == 0 and rep["drains"] == 0, rep
        assert rr["overrides"] == {}, rr
        assert not any(k in ("policy.route", "policy.tune", "policy.drain",
                             "policy.revert") for k in ring), sorted(ring)
    f2, rep2, rr2, _, _, ring2 = world(False)
    assert rr2["overrides"] == {}, rr2
    assert not any(k.startswith("policy.") for k in ring2), ring2
    for a, b in zip(f1, f2):
        np.testing.assert_array_equal(a, b)
    print(f"child {rank} routing {rr['overrides']} installed "
          f"{rep['installed']} post {post}", flush=True)


try:
    main()
except BaseException:
    import traceback
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
print(f"child {rank} POLICY-{mode.upper()} OK", flush=True)
os._exit(0)
'''

_DRAIN_CHILD = r'''
import os, sys
rank, port, pport = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
import multiverso_tpu_torch as mv
from multiverso_tpu_torch import elastic
from multiverso_tpu_torch.tables import MatrixTableOption
from multiverso_tpu_torch.telemetry import flight

args = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
        "-dist_size=2", "-mv_device=cpu", "-mv_deadline_s=60",
        "-mv_elastic=true", f"-mv_elastic_addr=127.0.0.1:{pport}",
        "-mv_watchdog_s=0.15", "-mv_policy=true",
        "-mv_policy_rules=straggler", "-mv_policy_sustain=1",
        "-mv_policy_cooldown_s=5.0"]
if rank == 1:
    # the deliberate straggler (rank 0 hosts the authority and never
    # drains): 40 ms more per window apply
    args.append("-chaos_spec=apply.delay:1.0@0.04")


def main():
    mv.MV_Init(args)
    tab = mv.MV_CreateTable(MatrixTableOption(num_rows=256, num_cols=16))
    ids = np.arange(256, dtype=np.int32)
    d = np.ones((256, 16), np.float32)
    tab.AddRows(ids, d)
    mv.MV_Barrier()
    drained_at = None
    # a FIXED iteration count (never wall time: the delayed rank runs
    # slower per window, and a timed loop would diverge the verb streams)
    for i in range(48):
        for _ in range(4):
            tab.AddFireForget(d, row_ids=ids)
        tab.Wait(tab.GetAsyncHandle(row_ids=ids[:16]))
        if i % 6 == 5:
            acts = mv.MV_PolicySync()
            if any(a.get("kind") == "drain" for a in acts):
                drained_at = i
                break
    assert drained_at is not None, "the straggler drain never actuated"
    assert elastic.epoch() == 1, elastic.epoch()
    assert "policy.drain" in {e["kind"] for e in flight.events()}
    if rank == 1:
        assert elastic.is_departed()
    else:
        assert tuple(elastic.members()) == (0,), elastic.members()
        for _ in range(4):
            tab.AddFireForget(d, row_ids=ids)
        got = tab.GetRows(ids)
        # the oracle of the verbs issued: the first Add and 4 a loop
        # iteration from both ranks up to the drain, 4 more from rank 0
        want = np.full((256, 16), 2 * (1 + 4 * (drained_at + 1)) + 4,
                       np.float32)
        np.testing.assert_array_equal(got, want)
        rep = mv.MV_PolicyReport()
        assert rep["drains"] == 1, rep
    print(f"child {rank} drained at iteration {drained_at}", flush=True)
    mv.MV_ShutDown()


try:
    main()
except BaseException:
    import traceback
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)
print(f"child {rank} POLICY-DRAIN OK", flush=True)
os._exit(0)
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(child_src, tmp_path, expect, *args, timeout=150):
    child = tmp_path / "policy_child.py"
    child.write_text(child_src)
    ports = [_free_port(), _free_port()]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(r), str(ports[0]), str(ports[1]),
         *args], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and expect in out, \
            f"rank {r} failed:\n{out[-4000:]}"


def test_hot_table_skew_corrected_bitwise_policy_off(tmp_path):
    _run_two(_SKEW_CHILD, tmp_path, "POLICY-SKEW OK", "skew")


def test_clean_soak_installs_nothing(tmp_path):
    _run_two(_SKEW_CHILD, tmp_path, "POLICY-CLEAN OK", "clean")


def test_straggler_escalates_to_a_guarded_drain(tmp_path):
    _run_two(_DRAIN_CHILD, tmp_path, "POLICY-DRAIN OK")
