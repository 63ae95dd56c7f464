"""LogisticRegression data-parallel across two processes: the port's
two-process worlds against the JAX package's.

Each rank of ``tests/_mh_child.py`` streams its own shard through
``LogReg(cfg).Train()`` / ``Test()`` in a two-process world of either
package (the JAX package's two-process LR tests' configuration,
tests/test_multihost.py:457-551 and :700-779, without pipelined pulls).
Here:

(a) the host plane, dense, on the JAX test's equal shards (640 / 640), and
    FTRL with ``device_plane`` asked for, which in a multi-process world
    rides the collective host KV verbs in both packages; then, in the port
    alone, the warm start: after one collective push from a model file
    (rank 0 carries W, the other rank zeros) both ranks read W exactly, on
    the dense and on the sparse table;
(b) the device plane, dense and sparse, on ragged shards (640 / 256): the
    rank whose shard runs out joins the collective windows with fillers.

In every case the two ranks of each package end bitwise equal, and the
port's final weights match the JAX package's to rtol 1e-4, atol 1e-5 (the
single-process LR parity tolerance, tests/test_torch_logreg.py): the
ranks' deltas merge in another order (a rank-order host sum against one
global scan), and every test accuracy is above 0.85 (FTRL with the
bench's alpha 2.0, lambdas 0.01).
"""

import struct

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _write(path, n, seed, w_true, sparse):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, 16)).astype(np.float32)
    y = (X @ w_true > 0).astype(int)
    with open(path, "w") as f:
        for row, lab in zip(X, y):
            if sparse:
                f.write(f"{lab} " + " ".join(
                    f"{k}:{row[k]:.5f}" for k in np.nonzero(row)[0]) + "\n")
            else:
                f.write(f"{lab} " + " ".join(f"{v:.5f}" for v in row) + "\n")


def _data(tmp_path, sizes):
    w_true = np.random.default_rng(0).normal(size=16)
    for kind in ("dense", "sparse"):
        sparse = kind == "sparse"
        for r, (n, seed) in enumerate(zip(sizes, (1, 2))):
            _write(tmp_path / f"{kind}_{r}.data", 640, seed, w_true, sparse)
            _write(tmp_path / f"{kind}_ragged_{r}.data", n, seed, w_true,
                   sparse)
        _write(tmp_path / f"{kind}_test.data", 400, 3, w_true, sparse)


def _compare(jax_res, port_res, names):
    for name in names:
        key = f"{name}_W"
        for res, pkg in ((jax_res, "jax"), (port_res, "port")):
            np.testing.assert_array_equal(res[0][key], res[1][key],
                                          err_msg=f"{pkg} ranks: {name}")
        np.testing.assert_allclose(port_res[0][key], jax_res[0][key],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(port_res[0][f"{name}_loss"],
                                   jax_res[0][f"{name}_loss"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} loss")


def test_host_plane_ftrl_and_warm_start(tmp_path):
    _data(tmp_path, (640, 640))
    W = np.random.default_rng(7).normal(size=(16, 1)).astype(np.float32)
    with open(tmp_path / "init.model", "wb") as f:
        f.write(struct.pack("<qq", 16, 1))
        f.write(np.ascontiguousarray(W.T).tobytes())
    jax_res, _ = run_world("jax", "lr", tmp_path)
    port_res, _ = run_world("torch", "lr", tmp_path)
    _compare(jax_res, port_res, ("host", "ftrl"))
    for r in range(2):
        for kind in ("dense", "sparse"):
            np.testing.assert_array_equal(port_res[r][f"warm_{kind}"], W,
                                          err_msg=f"rank {r} {kind}")


def test_device_plane_on_ragged_shards(tmp_path):
    _data(tmp_path, (640, 256))
    jax_res, _ = run_world("jax", "lr_dev", tmp_path)
    port_res, _ = run_world("torch", "lr_dev", tmp_path)
    _compare(jax_res, port_res, ("dense", "sparse"))
