"""The port's elastic plane across two processes: the JAX package's two
drills (``tests/test_elastic.py`` ``_GRACEFUL_CHILD`` and ``_KILL_CHILD``)
on ``multiverso_tpu_torch``, over the shm wire, on the CPU.

(a) Drain -> train -> re-admit: both ranks train, sync, rank 1 drains
    (``MV_ElasticLeave``), its verbs then fail typed, rank 0 trains alone,
    rank 1 re-joins (``MV_ElasticJoin``) through the shard-move plane and
    both train again on the coordinator relay, with the ``membership.*``
    chaos sites at 1.0. Both ranks end BITWISE equal to the fixed-world
    oracle (integer-valued deltas), with the ``membership.epoch`` events
    at epochs 1 and 2, ``shard.moved`` and ``membership.cut`` on rank 0,
    ``/healthz`` naming the epoch and the Dashboard's ``[Elastic]`` line.
(b) The silent death: rank 1 ``os._exit(3)``s after a sync under a chaos
    spec; the survivor's next verb fails into the lease consult, catches
    exactly one ``MembershipChanged``, ends at epoch 1 with members
    ``(0,)`` and ``MV_Size() == 1``, and is BITWISE equal to the
    shrunk-world oracle, with ``membership.epoch`` in the flight ring.

Tolerance: bitwise in both. Each child runs under its own subprocess
timeout, well under a minute on this sandbox.
"""

import os
import socket
import subprocess
import sys

_HDR = r'''
import os, sys
rank, port, port2 = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
import multiverso_tpu_torch as mv
'''

_GRACEFUL_CHILD = _HDR + r'''
from multiverso_tpu_torch.failsafe.errors import MembershipChanged
from multiverso_tpu_torch.tables import MatrixTableOption

R, C = 24, 4
A_STEPS, B_STEPS, C_STEPS = 4, 3, 3
mv.MV_Init([f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2", "-mv_device=cpu", "-mv_deadline_s=30",
            "-mv_elastic=true", f"-mv_elastic_addr=127.0.0.1:{port2}",
            "-mv_ops_port=0",
            "-chaos_spec=membership.leave:1.0,membership.join:1.0",
            "-chaos_seed=5"])
from multiverso_tpu_torch.parallel import multihost
assert multihost.wire_name() == "shm", multihost.wire_name()
mat = mv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C))


def step_add(step, r):
    # integer-valued f32 deltas: sums are exact, parity is bitwise
    ids = np.array([r, 8 + (step % 5), 20], np.int32)
    deltas = np.full((3, C), float(step + 1 + r), np.float32)
    return ids, deltas


for step in range(A_STEPS):                       # phase A: both ranks
    mat.AddRows(*step_add(step, rank))
assert mv.MV_ElasticSync() == 0

if rank == 1:
    assert mv.MV_ElasticLeave() == 1              # drain 2 -> 1
    assert mv.MV_ElasticMembers() == (0,)
    try:
        mat.GetRows(np.arange(R, dtype=np.int32))
        raise AssertionError("departed member served a verb")
    except MembershipChanged:
        pass                                      # typed, not a hang
    assert mv.MV_ElasticJoin() == 2               # re-admit 1 -> 2
else:
    assert mv.MV_ElasticSync() == 1               # applies the drain
    assert mv.MV_Size() == 1
    for step in range(A_STEPS, A_STEPS + B_STEPS):
        mat.AddRows(*step_add(step, 0))           # phase B: rank 0 solo
    import time as _time
    for _ in range(400):
        if mv.MV_ElasticSync() == 2:
            break
        _time.sleep(0.025)
    assert mv.MV_ElasticEpoch() == 2

assert mv.MV_ElasticMembers() == (0, 1)
assert mv.MV_Size() == 2
assert multihost.wire_name() == "relay", multihost.wire_name()
# the post-rejoin steady-state sync: the re-admitted member's rendezvous
# generation was re-aligned at install
assert mv.MV_ElasticSync() == 2
for step in range(A_STEPS + B_STEPS,
                  A_STEPS + B_STEPS + C_STEPS):   # phase C: both again
    mat.AddRows(*step_add(step, rank))
mv.MV_Barrier()

got = mat.GetRows(np.arange(R, dtype=np.int32))
oracle = np.zeros((R, C), np.float32)
for step in range(A_STEPS):
    for r in range(2):
        ids, d = step_add(step, r); np.add.at(oracle, ids, d)
for step in range(A_STEPS, A_STEPS + B_STEPS):
    ids, d = step_add(step, 0); np.add.at(oracle, ids, d)
for step in range(A_STEPS + B_STEPS, A_STEPS + B_STEPS + C_STEPS):
    for r in range(2):
        ids, d = step_add(step, r); np.add.at(oracle, ids, d)
np.testing.assert_array_equal(got, oracle)        # bitwise

snap = mv.MV_MetricsSnapshot()
assert snap["chaos.membership.leave"]["value"] >= 1, snap
assert snap["chaos.membership.join"]["value"] >= 1, snap
import multiverso_tpu_torch.elastic as el
causes = [t["cause"] for t in el.transitions()]
assert causes == (["graceful", "join"] if rank == 1
                  else ["graceful", "graceful"]), causes
from multiverso_tpu_torch.telemetry import flight
kinds = [e["kind"] for e in flight.events()]
assert "membership.epoch" in kinds, kinds
if rank == 0:
    assert "shard.moved" in kinds, kinds
    assert "membership.cut" in kinds, kinds
    import json as _json
    import urllib.request as _url
    from multiverso_tpu_torch.telemetry import ops as _tops
    h = _json.loads(_url.urlopen(
        f"http://127.0.0.1:{_tops.port()}/healthz", timeout=30).read())
    assert h["elastic"]["epoch"] == 2, h
    assert h["elastic"]["members"] == [0, 1], h
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    assert any("[Elastic] epoch = 2" in ln
               for ln in Dashboard._ops_lines()), Dashboard._ops_lines()
ep_events = [e for e in flight.events() if e["kind"] == "membership.epoch"]
assert [e["mepoch"] for e in ep_events] == [1, 2], ep_events
mv.MV_Barrier()
mv.MV_ShutDown()
print(f"child {rank} ELASTIC-DRILL OK", flush=True)
'''

_KILL_CHILD = _HDR + r'''
from multiverso_tpu_torch.failsafe import chaos
from multiverso_tpu_torch.failsafe.errors import MembershipChanged
from multiverso_tpu_torch.tables import MatrixTableOption

R, C = 32, 4
A_STEPS, B_STEPS = 6, 5
SPEC = ("mailbox.dup:0.1,mailbox.delay:0.1@0.002,verb.transient:0.08,"
        "verb.failack:0.08")
mv.MV_Init([f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2", "-mv_device=cpu", "-mv_deadline_s=4",
            "-mv_max_retries=10", "-mv_elastic=true",
            f"-mv_elastic_addr=127.0.0.1:{port2}",
            f"-chaos_spec={SPEC}", "-chaos_seed=77", "-mv_ops_port=0"])
mat = mv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C))
rng = np.random.default_rng(500 + rank)


def train_step(gen):
    ids = np.sort(gen.choice(R, 5, replace=False)).astype(np.int32)
    deltas = gen.integers(-4, 5, (5, C)).astype(np.float32)
    mat.AddRows(ids, deltas)


for step in range(A_STEPS):       # phase A: both ranks, chaos armed
    train_step(rng)
chaos.quiesce()
assert mv.MV_ElasticSync() == 0   # the snapshot cut the survivor resumes from

if rank == 1:
    os._exit(3)                   # SILENT death: heartbeats just stop

step, transitioned = A_STEPS, 0
while step < A_STEPS + B_STEPS:
    saved = rng.bit_generator.state
    try:
        train_step(rng)
        step += 1
    except MembershipChanged as exc:
        transitioned += 1
        assert tuple(exc.members) == (0,), exc.members
        rng.bit_generator.state = saved   # effects rolled back: re-run
assert transitioned == 1, transitioned
assert mv.MV_ElasticEpoch() == 1
assert mv.MV_ElasticMembers() == (0,)
assert mv.MV_Size() == 1

chaos.quiesce()
mv.MV_SetFlag("chaos_spec", "")
chaos.quiesce()
got = mat.GetRows(np.arange(R, dtype=np.int32))

# shrunk-world oracle: phase A from BOTH ranks (applied before the cut)
# and phase B from the survivor only
oracle = np.zeros((R, C), np.float32)
for r in range(2):
    gen = np.random.default_rng(500 + r)
    for _ in range(A_STEPS):
        ids = np.sort(gen.choice(R, 5, replace=False)).astype(np.int32)
        np.add.at(oracle, ids,
                  gen.integers(-4, 5, (5, C)).astype(np.float32))
gen = np.random.default_rng(500)
for _ in range(A_STEPS):
    gen.choice(R, 5, replace=False); gen.integers(-4, 5, (5, C))
for _ in range(B_STEPS):
    ids = np.sort(gen.choice(R, 5, replace=False)).astype(np.int32)
    np.add.at(oracle, ids,
              gen.integers(-4, 5, (5, C)).astype(np.float32))
np.testing.assert_array_equal(got, oracle)        # bitwise

from multiverso_tpu_torch.telemetry import flight
kinds = [e["kind"] for e in flight.events()]
assert "membership.epoch" in kinds, kinds
mv.MV_ShutDown()
print(f"child {rank} ELASTIC-KILL OK", flush=True)
# the dead peer's gloo connections are gone: skip interpreter teardown,
# as the JAX drill does
os._exit(0)
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(child_src, tmp_path, expect, dead_rank=None, timeout=55):
    child = tmp_path / "elastic_child.py"
    child.write_text(child_src)
    ports = [_free_port(), _free_port()]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(r), str(ports[0]), str(ports[1])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if r == dead_rank:
            assert p.returncode == 3, \
                f"rank {r} should have died deliberately:\n{out[-800:]}"
        else:
            assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
            assert expect in out, out[-800:]


def test_drain_train_readmit_bitwise(tmp_path):
    _run_two(_GRACEFUL_CHILD, tmp_path, "ELASTIC-DRILL OK")


def test_silent_death_resumes_from_the_cut(tmp_path):
    _run_two(_KILL_CHILD, tmp_path, "ELASTIC-KILL OK", dead_rank=1)
