"""The KV table's device verbs as collectives across processes, against the
JAX package's.

(a) ``tests/_mh_child.py`` mode ``kv_device``, two processes, in each
    package (the JAX package's own two-process script,
    tests/test_multihost.py's kv part, widened to 600 keys a rank, half
    shared, over three steps): ``device_slots(create=True)`` merges the
    ranks' keys in rank order with one shared bucket,
    ``device_place_slots`` builds the global batch, the scatter-add sums
    every rank's integer deltas, and each rank slices its own lanes out of
    the global gather. The port's ranks are bitwise equal, equal to a twin
    table that took the same deltas through the host Add (checked in the
    children), and equal to the JAX world's values and slices.
(b) In one process the verbs issue no collective and keep their
    in-place ``index_add_`` result; the deterministic segment sums the
    verbs take across processes give the same bits on the CPU.
"""

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)


def test_two_process_kv_device_verbs_match_jax(tmp_path):
    jres, _ = run_world("jax", "kv_device", tmp_path)
    tres, _ = run_world("torch", "kv_device", tmp_path)
    for key in ("values", "size"):
        for res in (tres, jres):
            np.testing.assert_array_equal(res[1][key], res[0][key],
                                          err_msg=key)
        np.testing.assert_array_equal(tres[0][key], jres[0][key],
                                      err_msg=key)
    for r in range(2):
        for step in range(3):
            key = f"mine{step}"
            np.testing.assert_array_equal(tres[r][key], jres[r][key],
                                          err_msg=f"rank {r} {key}")
    assert np.abs(tres[0]["values"]).max() > 0


def test_one_process_verbs_stay_local(monkeypatch):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.ops.rows import scatter_add_rows
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.tables import KVTableOption

    def no_collective(*a, **k):
        raise AssertionError("a one-process device verb issued a collective")

    monkeypatch.setattr(multihost, "host_allgather_objects_capped",
                        no_collective)
    g = np.random.default_rng(23)
    mv.MV_Init(["-mv_device=cpu"])
    try:
        kv = mv.MV_CreateTable(KVTableOption(init_capacity=16))
        srv = kv.server()
        keys = g.integers(0, 50, 40).astype(np.int64)
        slots = srv.device_slots(keys, create=True)
        assert len(slots) == 64 and srv.capacity > srv.size
        deltas = np.zeros(64, np.float32)
        deltas[:40] = g.standard_normal(40).astype(np.float32)
        gslots, gdeltas = srv.device_place_slots(slots, deltas)
        assert gslots.shape == (64,)
        vals = srv.device_values()
        want = vals.clone().index_add_(0, gslots, gdeltas)
        det = scatter_add_rows(vals.clone(), gslots, gdeltas,
                               deterministic=True)
        out = srv.device_scatter_add_slots(vals, gslots, gdeltas)
        assert out is vals                          # in place
        assert torch.equal(out, want) and torch.equal(det, want)
        srv.device_set_values(out)
        got = kv.Get(np.unique(keys))
        uniq, inv = np.unique(keys, return_inverse=True)
        host = np.zeros(len(uniq), np.float32)
        np.add.at(host, inv, deltas[:40])
        np.testing.assert_allclose(got, host, rtol=1e-6, atol=1e-6)
    finally:
        mv.MV_ShutDown()
