"""The device plane's collective writes across two processes on the CPU:
the device route (the device wire's ``shm-plain`` version) against the host
route (``route=host``: the route function patched in the children) and the
JAX package's two-process worlds.

(a) ``tests/_mh_child.py`` mode ``dw_apps``: LR's dense and sparse device
    planes on ragged shards and WE ``-device_plane 1 -use_adagrad 1`` (four
    tables a write): the weights and tables bitwise equal across the routes
    and the ranks; on the device route every rank copied exactly its
    peer's staged delta bytes, one copy a peer delta, and only the rides
    crossed to the host (the host route moves the same deltas and rides);
    the port within the JAX worlds' tolerances (LR rtol 1e-4, atol 1e-5 as
    tests/test_torch_mh_logreg.py; WE rtol 1e-3, atol 1e-4).
(b) mode ``kv_device``: the KV device verbs on both routes bitwise each
    other and equal to the JAX world, as tests/test_torch_mh_kv_device.py
    holds them; no delta to the host on the device route.
(c) mode ``dw_routes`` (the writes driven directly, a write outgrowing
    ``MIN_SLOT`` after small ones, so that the control group's handle swap
    frees a replaced slot, and an int32 KV table's deltas moving in their
    own dtype): the device route bitwise the patched host
    route, and the host route taken where the world has no device wire
    (ranks faked onto two hosts) and under an elastic group (after a drain
    and a re-admit), bitwise its oracle.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import free_port, run_world
from tests.test_torch_mh_logreg import _data as lr_data
from tests.test_torch_mh_wordembedding import _corpus, _vectors

torch.set_num_threads(1)

#: tests/_mh_child.py WRITE_STATS
STAT = {k: i for i, k in enumerate(
    ("stage_n", "stage_bytes", "copy_peer_n", "copy_peer_bytes",
     "d2h_bytes", "swap_n", "write_n"))}


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _stats(res, name):
    return [{k: float(r[f"{name}_stats"][i]) for k, i in STAT.items()}
            for r in res]


def _check_routes(dev, host, name, deltas_a_write, rides):
    """Device-route counts exact against the peer's staging, only the
    rides on the host, and the host route moving the same bytes."""
    ds, hs = _stats(dev, name), _stats(host, name)
    for r in range(2):
        assert str(dev[r][f"{name}_route"]) == "device"
        assert str(host[r][f"{name}_route"]) == "host"
        assert ds[r]["stage_n"] > 0 and ds[r]["stage_bytes"] > 0
        assert ds[r]["copy_peer_bytes"] == ds[1 - r]["stage_bytes"], name
        assert ds[r]["copy_peer_n"] == deltas_a_write * ds[1 - r]["stage_n"]
        assert ds[r]["d2h_bytes"] == (4 * ds[r]["stage_n"] if rides else 0)
        assert hs[r]["stage_n"] == hs[r]["copy_peer_n"] == 0
        assert hs[r]["d2h_bytes"] == ds[r]["stage_bytes"] + \
            ds[r]["d2h_bytes"], name


def _world(tmp_path, sub, pkg, mode, *extra, prepare=None):
    d = tmp_path / sub
    d.mkdir()
    if prepare is not None:
        prepare(d)
    res, _ = run_world(pkg, mode, d, *extra, timeout=240)
    return res, d


def test_app_device_planes_on_both_routes(tmp_path):
    def prepare(d):
        lr_data(d, (640, 256))
        _corpus(d, "corpus", [f"w{i}" for i in range(120)], (400, 400))

    dev, ddir = _world(tmp_path, "dev", "torch", "dw_apps", prepare=prepare)
    host, hdir = _world(tmp_path, "host", "torch", "dw_apps", "route=host",
                        prepare=prepare)
    jax, jdir = _world(tmp_path, "jax", "jax", "dw_apps", prepare=prepare)
    tables = ("input_table", "output_table", "ie_g2_table", "eo_g2_table")
    for r in range(2):
        assert str(dev[r]["wire"]) == "shm-plain"
        for key in [f"{k}_W" for k in ("dense", "sparse")] + \
                [f"we_ada_{t}" for t in tables]:
            assert _bits(dev[r][key]) == _bits(host[r][key]), (r, key)
            assert _bits(dev[r][key]) == _bits(dev[0][key]), (r, key)
        vecs = [(ddir / f"torch_we_ada_{r}.txt").read_text(),
                (hdir / f"torch_we_ada_{r}.txt").read_text()]
        assert vecs[0] == vecs[1] == (ddir / "torch_we_ada_0.txt").read_text()
    _check_routes(dev, host, "dense", 1, rides=True)
    _check_routes(dev, host, "sparse", 1, rides=True)
    _check_routes(dev, host, "we_ada", 4, rides=False)
    for kind in ("dense", "sparse"):
        np.testing.assert_allclose(dev[0][f"{kind}_W"], jax[0][f"{kind}_W"],
                                   rtol=1e-4, atol=1e-5, err_msg=kind)
        np.testing.assert_allclose(dev[0][f"{kind}_loss"],
                                   jax[0][f"{kind}_loss"], rtol=1e-4,
                                   atol=1e-5, err_msg=kind)
    jv = _vectors(jdir / "jax_we_ada_0.txt")
    tv = _vectors(ddir / "torch_we_ada_0.txt")
    assert jv.keys() == tv.keys()
    for w in jv:
        np.testing.assert_allclose(tv[w], jv[w], rtol=1e-3, atol=1e-4,
                                   err_msg=w)
    np.testing.assert_allclose(dev[0]["we_ada_loss"], jax[0]["we_ada_loss"],
                               rtol=1e-3)


def test_kv_device_verbs_on_both_routes(tmp_path):
    dev, _ = _world(tmp_path, "dev", "torch", "kv_device")
    host, _ = _world(tmp_path, "host", "torch", "kv_device", "route=host")
    jax, _ = _world(tmp_path, "jax", "jax", "kv_device")
    keys = ["values", "size"] + [f"mine{s}" for s in range(3)]
    for r in range(2):
        for key in keys:
            assert _bits(dev[r][key]) == _bits(host[r][key]), (r, key)
            np.testing.assert_array_equal(dev[r][key], jax[r][key],
                                          err_msg=f"rank {r} {key}")
    ds, hs = _stats(dev, "kv"), _stats(host, "kv")
    for r in range(2):
        assert str(dev[r]["kv_route"]) == "device"
        assert ds[r]["stage_n"] == 3 and ds[r]["d2h_bytes"] == 0
        assert ds[r]["copy_peer_bytes"] == ds[1 - r]["stage_bytes"] > 0
        assert hs[r]["stage_n"] == 0
    # rank 0 passes device deltas (they cross to the host on the host
    # route), rank 1 host numpy
    assert hs[0]["d2h_bytes"] == ds[0]["stage_bytes"]
    assert hs[1]["d2h_bytes"] == 0


_ELASTIC_CHILD = r'''
import sys, time
rank, port, port2 = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
import torch
import multiverso_tpu_torch as mv
from multiverso_tpu_torch.failsafe.errors import MembershipChanged
from multiverso_tpu_torch.parallel import device_wire, multihost
from multiverso_tpu_torch.tables import (ArrayTableOption, KVTableOption,
                                         MatrixTableOption)
from multiverso_tpu_torch.updaters.base import AddOption

R, C = 24, 4
mv.MV_Init([f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2", "-mv_device=cpu", "-mv_deadline_s=30",
            "-mv_elastic=true", f"-mv_elastic_addr=127.0.0.1:{port2}"])
assert device_wire.name() == "shm-plain", device_wire.name()
assert multihost.device_writes()
mat = mv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C))
arr = mv.MV_CreateTable(ArrayTableOption(size=16))
kv = mv.MV_CreateTable(KVTableOption())
for step in range(3):                   # the boot world's engine stream
    mat.AddRows(np.array([rank, 9], np.int32), np.ones((2, C), np.float32))
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
    for _ in range(400):
        if mv.MV_ElasticSync() == 2:
            break
        time.sleep(0.025)
    assert mv.MV_ElasticEpoch() == 2
assert mv.MV_ElasticSync() == 2
assert device_wire.active() is None and not multihost.device_writes()


def mine(r):
    ids = np.array([r, 5, 5, 20 - r], np.int32)
    return ids, np.arange(4 * C, dtype=np.float32).reshape(4, C) + r


multihost.reset_stats()
srv = mat.server()
ride = srv.device_apply_rows(mine(rank)[0], torch.from_numpy(mine(rank)[1]),
                             ride=torch.tensor(0.5 + rank))
assert ride == 2.0, ride
asrv = arr.server()
delta = torch.full((asrv.padded,), float(rank + 1))
new, aride = asrv.device_update(asrv.device_state(), delta,
                                AddOption().as_tensors(), ride=1.5)
asrv.device_set_state(new)
assert aride == 3.0, aride
ksrv = kv.server()
keys = np.array([7, 8 + rank], np.int64)
slots = ksrv.device_slots(keys, create=True)
pad = np.zeros(len(slots), np.float32)
pad[:2] = 1.0
gs, gd = ksrv.device_place_slots(slots, torch.from_numpy(pad))
ksrv.device_set_values(ksrv.device_scatter_add_slots(ksrv.device_values(),
                                                     gs, gd))
assert multihost.STATS["stage_n"] == 0 and multihost.STATS["copy_peer_n"] == 0
assert multihost.STATS["d2h_bytes"] > 0
oracle = np.zeros((R, C), np.float32)
oracle[[0, 1]] += 3.0
oracle[9] += 6.0
for r in range(2):
    np.add.at(oracle, *mine(r))
np.testing.assert_array_equal(mat.GetRows(np.arange(R, dtype=np.int32)),
                              oracle)
np.testing.assert_array_equal(arr.Get(), np.full(16, 3.0, np.float32))
np.testing.assert_array_equal(kv.Get(np.array([7, 8, 9], np.int64)),
                              np.array([2.0, 1.0, 1.0], np.float32))
mv.MV_Barrier()
mv.MV_ShutDown()
print(f"child {rank} DW-WRITES-ELASTIC OK", flush=True)
'''


def _elastic_drill(tmp_path) -> None:
    child = tmp_path / "dw_writes_elastic_child.py"
    child.write_text(_ELASTIC_CHILD)
    ports = [free_port(), free_port()]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
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
        assert f"child {r} DW-WRITES-ELASTIC OK" in out, out[-800:]


def test_routes_growth_no_wire_and_the_elastic_group(tmp_path):
    dev, _ = _world(tmp_path, "dev", "torch", "dw_routes")
    host, _ = _world(tmp_path, "host", "torch", "dw_routes", "route=host")
    split, _ = _world(tmp_path, "split", "torch", "dw_routes",
                      "hosts=split")
    finals = ("mat", "ada", "arr", "kv", "kv32", "gathered", "ride0",
              "ride1", "ride2", "ride_many", "arr_ride")
    for r in range(2):
        assert str(dev[r]["wire"]) == "shm-plain"
        assert str(split[r]["wire"]) == "none"
        assert str(dev[r]["routes_route"]) == "device"
        assert str(host[r]["routes_route"]) == "host"
        assert str(split[r]["routes_route"]) == "host"
        for key in finals:
            for other in (host, split):
                assert _bits(dev[r][key]) == _bits(other[r][key]), (r, key)
            if key != "gathered":
                assert _bits(dev[r][key]) == _bits(dev[0][key]), (r, key)
    ds = _stats(dev, "routes")
    for r in range(2):
        # eight writes: three row batches, the two-table write, the
        # Add+Get round, the array, the float32 and the int32 KV batches;
        # a swap at the first use of either slot, two when the third write
        # outgrew MIN_SLOT
        assert ds[r]["stage_n"] == 8 and ds[r]["swap_n"] == 4
        assert ds[r]["copy_peer_bytes"] == ds[1 - r]["stage_bytes"]
        # the rides that were device scalars: the second row batch's, the
        # two-table write's and the array's
        assert ds[r]["d2h_bytes"] == 3 * 4
        for st in (_stats(host, "routes")[r], _stats(split, "routes")[r]):
            assert st["stage_n"] == st["copy_peer_n"] == 0
    sub = tmp_path / "elastic"
    sub.mkdir()
    _elastic_drill(sub)
