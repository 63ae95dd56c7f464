"""The integer route of the deterministic scatter-add, and an int32 KV
table's cross-process ``device_scatter_add_slots`` against the JAX
package's two-process world.

(a) ``ops.rows.scatter_add_rows(..., deterministic=True)`` and
    ``dedup_rows(..., deterministic=True)`` on integer rows: equal to the
    CPU's ``index_add_`` (integer sums are exact in any order; the float
    route's segment sums have no integer kernel), and the float route
    still bitwise the CPU's ``index_add_``.
(b) ``tests/_mh_child.py`` mode ``kv_int32`` on both write routes (the
    device wire's ``shm-plain`` version and ``route=host``) and in the
    JAX world: the values, the table size and each rank's gathered lanes
    equal across the routes and to the JAX package, the values equal to
    a twin table fed through the host Add inside each child; then
    ``multihost.broadcast_from_master`` over the port's process groups:
    rank 0's array on both ranks, as in the JAX world.
"""

import numpy as np
import torch

from multiverso_tpu_torch.ops import rows as ops_rows
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)


def test_deterministic_sums_take_every_dtype():
    for dtype in (torch.int32, torch.int64, torch.float32):
        _deterministic_sums(dtype)


def _deterministic_sums(dtype):
    g = np.random.default_rng(5)
    n, rows = 300, 41
    ids = torch.from_numpy(g.integers(0, rows - 1, n).astype(np.int32))
    if dtype.is_floating_point:
        vals = torch.from_numpy(g.standard_normal((n, 3)).astype(np.float32))
        table = torch.from_numpy(
            g.standard_normal((rows, 3)).astype(np.float32))
    else:
        vals = torch.from_numpy(g.integers(-2 ** 20, 2 ** 20, (n, 3))).to(
            dtype)
        table = torch.from_numpy(g.integers(-9, 9, (rows, 3))).to(dtype)
    want = table.clone().index_add_(0, ids.long(), vals)
    got = ops_rows.scatter_add_rows(table.clone(), ids, vals,
                                    deterministic=True)
    assert got.dtype == dtype
    # the last row is the trash row (the float route writes zeros there)
    assert got[:-1].numpy().tobytes() == want[:-1].numpy().tobytes()
    # the 1-D slot form the KV table passes
    got1 = ops_rows.scatter_add_rows(table[:, 0].clone(), ids, vals[:, 0],
                                     deterministic=True)
    want1 = table[:, 0].clone().index_add_(0, ids.long(), vals[:, 0])
    assert got1[:-1].numpy().tobytes() == want1[:-1].numpy().tobytes()
    out_ids, out = ops_rows.dedup_rows(ids, vals, deterministic=True)
    fast_ids, fast = ops_rows.dedup_rows(ids, vals)
    assert torch.equal(out_ids, fast_ids)
    assert out.numpy().tobytes() == fast.numpy().tobytes()


def test_int32_kv_scatter_add_across_ranks_matches_jax(tmp_path):
    worlds = {}
    for name, pkg, extra in (("dev", "torch", ()),
                             ("host", "torch", ("route=host",)),
                             ("jax", "jax", ())):
        d = tmp_path / name
        d.mkdir()
        worlds[name], _ = run_world(pkg, "kv_int32", d, *extra, timeout=240)
    dev, host, jax = worlds["dev"], worlds["host"], worlds["jax"]
    keys = ["values", "size", "bcast"] + [f"mine{s}" for s in range(3)]
    for r in range(2):
        assert str(dev[r]["kv32_route"]) == "device"
        assert str(host[r]["kv32_route"]) == "host"
        assert dev[r]["values"].dtype == np.int32
        for key in keys:
            assert dev[r][key].tobytes() == host[r][key].tobytes(), (r, key)
            if not key.startswith("mine"):     # the replicas agree
                assert dev[r][key].tobytes() == dev[0][key].tobytes(), key
            np.testing.assert_array_equal(dev[r][key], jax[r][key],
                                          err_msg=f"rank {r} {key}")
        np.testing.assert_array_equal(dev[r]["bcast"],
                                      np.array([5.0, 0.0], np.float32))
