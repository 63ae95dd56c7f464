"""The device window transport across two processes on the CPU, where it
rides its shared-memory plain version (``shm-plain``), against the port's
host-wire turns and the JAX package's device-wire world.

(1) Transport turns: ``tests/_mh_child.py`` mode ``transport`` (the JAX
    package's ``_TRANSPORT_CHILD`` world: a 256 x 16 matrix, a 2048-float
    array and a KV table, then sgd and AdaGrad matrices) in the port at
    ``-window_transport`` host, device and auto with a 1024-byte floor, and
    in the JAX package at that auto. The device-wire Add positions equal
    the JAX world's (2 after its three Adds; 0 in the host turn); every turn
    is bitwise the port's host turn on both ranks; the add matrix (integer
    deltas), the array and the KV table are bitwise the JAX world, sgd and
    AdaGrad within rtol 1e-6, atol 1e-6 (the JAX device path merges on XLA,
    the port on the host or the card); ``server.wire.device_bytes`` is the
    deferred values' bytes.
(2) The JAX package's mixed-run and device-burst children (mode
    ``dw_burst``) with the counters they assert, and a bad id inside a
    deferred Add failing its Wait on both ranks while the other Adds apply;
    the ranks bitwise equal.
(3) The CHECKs (mode ``dw_checks``): ``device`` under two engine shards
    fails the JAX package's collective-apply CHECK, and ``auto`` there
    defers nothing (the port's departure); ranks faked onto two
    hosts fail ``MV_Init``'s CHECK under ``device`` and defer nothing under
    ``auto``. Then an elastic drain and re-admit under ``device``: the boot
    world's Adds defer, the relay's ride the group transport, and the table
    is bitwise its oracle.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import free_port, run_world

torch.set_num_threads(1)

_FINALS = ("final_mat", "final_arr", "final_kv", "final_sgd", "final_ada")
_PORT_TURNS = {"host": ("-window_transport=host",),
               "device": ("-window_transport=device",),
               "auto": ("-window_transport=auto",
                        "-window_device_min_bytes=1024")}


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def test_transport_turns_match_host_and_jax(tmp_path):
    turns = {}
    for name, flags in _PORT_TURNS.items():
        sub = tmp_path / name
        sub.mkdir()
        turns[name], _ = run_world("torch", "transport", sub, *flags)
    jax_res, _ = run_world("jax", "transport", tmp_path,
                           *_PORT_TURNS["auto"])
    # the deferred bytes: the matrix's 32 x 16 and the array's 2048 floats,
    # then three rounds of 32 x 16 on each of the sgd and AdaGrad tables
    deferred = 4 * (32 * 16 + 2048 + 3 * 2 * 32 * 16)
    for r in range(2):
        host = turns["host"][r]
        assert int(jax_res[r]["dev_adds_first"]) == 2
        for name, both in turns.items():
            res = both[r]
            want = 0 if name == "host" else 2
            assert int(res["dev_adds_first"]) == want, (name, r)
            assert int(res["dev_adds"]) == (0 if name == "host" else 8)
            assert float(res["device_bytes"]) == \
                (0 if name == "host" else deferred)
            assert int(res["deferrals"]) == (0 if name == "host" else 8)
            assert str(res["wire"]) == "shm-plain"
            for key in _FINALS:
                assert _bits(res[key]) == _bits(host[key]), (name, r, key)
                assert _bits(res[key]) == _bits(turns[name][0][key])
        assert int(jax_res[r]["dev_adds"]) == int(turns["auto"][r]["dev_adds"])
        assert float(jax_res[r]["device_bytes"]) == deferred
        for key in ("final_mat", "final_arr", "final_kv"):
            np.testing.assert_array_equal(host[key], jax_res[r][key])
        for key in ("final_sgd", "final_ada"):
            np.testing.assert_allclose(host[key], jax_res[r][key],
                                       rtol=1e-6, atol=1e-6)


def test_device_bursts_merge_and_a_bad_id_fails_its_wait(tmp_path):
    res, _ = run_world("torch", "dw_burst", tmp_path)
    for r in range(2):
        used, merged, dev = (int(x) for x in res[r]["mixed"])
        assert dev >= 1 and merged >= 1 and used <= 6 * 7 // 2
        used, merged, dev = (int(x) for x in res[r]["burst"])
        assert dev == 16 and merged >= 1 and used <= 8
        assert "row id out of range" in str(res[r]["bad_error"])
        assert str(res[r]["wire"]) == "shm-plain"
    for key in ("final_mat", "final_arr"):
        assert _bits(res[0][key]) == _bits(res[1][key])


_ELASTIC_CHILD = r'''
import sys, time
rank, port, port2 = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
import multiverso_tpu_torch as mv
from multiverso_tpu_torch.failsafe.errors import MembershipChanged
from multiverso_tpu_torch.parallel import device_wire, multihost
from multiverso_tpu_torch.tables import MatrixTableOption
from multiverso_tpu_torch.telemetry import metrics

R, C = 24, 4
A_STEPS, B_STEPS, C_STEPS = 4, 3, 3
mv.MV_Init([f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2", "-mv_device=cpu", "-mv_deadline_s=30",
            "-mv_elastic=true", f"-mv_elastic_addr=127.0.0.1:{port2}",
            "-window_transport=device"])
assert device_wire.name() == "shm-plain", device_wire.name()
mat = mv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C))
defer = metrics.counter("server.add.device_deferrals")


def step_add(step, r):
    ids = np.array([r, 8 + (step % 5), 20], np.int32)
    return ids, np.full((3, C), float(step + 1 + r), np.float32)


for step in range(A_STEPS):              # the boot world: the device wire
    mat.AddRows(*step_add(step, rank))
assert defer.value == A_STEPS, defer.value
assert mv.MV_ElasticSync() == 0
if rank == 1:
    assert mv.MV_ElasticLeave() == 1
    try:
        mat.GetRows(np.arange(R, dtype=np.int32))
        raise AssertionError("departed member served a verb")
    except MembershipChanged:
        pass
    assert mv.MV_ElasticJoin() == 2
else:
    assert mv.MV_ElasticSync() == 1
    for step in range(A_STEPS, A_STEPS + B_STEPS):
        mat.AddRows(*step_add(step, 0))  # alone
    for _ in range(400):
        if mv.MV_ElasticSync() == 2:
            break
        time.sleep(0.025)
    assert mv.MV_ElasticEpoch() == 2
assert multihost.wire_name() == "relay", multihost.wire_name()
assert mv.MV_ElasticSync() == 2
before = defer.value
for step in range(A_STEPS + B_STEPS, A_STEPS + B_STEPS + C_STEPS):
    mat.AddRows(*step_add(step, rank))   # the group transport
mv.MV_Barrier()
assert defer.value == before, (defer.value, before)
assert device_wire.active() is None
got = mat.GetRows(np.arange(R, dtype=np.int32))
oracle = np.zeros((R, C), np.float32)
for step in range(A_STEPS + B_STEPS + C_STEPS):
    for r in ((0,) if A_STEPS <= step < A_STEPS + B_STEPS else (0, 1)):
        ids, d = step_add(step, r)
        np.add.at(oracle, ids, d)
np.testing.assert_array_equal(got, oracle)
mv.MV_Barrier()
mv.MV_ShutDown()
print(f"child {rank} DW-ELASTIC OK", flush=True)
'''


def _elastic_drill(tmp_path) -> None:
    child = tmp_path / "dw_elastic_child.py"
    child.write_text(_ELASTIC_CHILD)
    ports = [free_port(), free_port()]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(r), str(ports[0]), str(ports[1])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=90)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert f"child {r} DW-ELASTIC OK" in out, out[-800:]


def test_checks_and_the_group_transport(tmp_path):
    res, _ = run_world("torch", "dw_checks", tmp_path)
    for r in range(2):
        assert "collective applies need ONE ordered stream" in \
            str(res[r]["shards_error"])
        assert "window requires a collective apply (device_wire)" in \
            str(res[r]["shards_error"])
        assert int(res[r]["shards_auto_deferrals"]) == 0
        assert "ranks span hosts" in str(res[r]["hosts_error"])
        assert str(res[r]["auto_wire"]) == "none"
        assert "ranks span hosts" in str(res[r]["auto_why"])
        assert int(res[r]["auto_deferrals"]) == 0
        assert int(res[r]["auto_dev_adds"]) == 0
    sub = tmp_path / "elastic"
    sub.mkdir()
    _elastic_drill(sub)
