"""Compressed row pushes across two processes: the port's compressed windows
against the JAX package's (``_mh_add_compressed_parts``).

(a) ``tests/_mh_child.py`` mode ``compress`` on the shm wire, in both
    packages (the JAX package's test of the same drill:
    tests/test_windowed_multihost.py ``_COMPRESS_CHILD``):
    ``compress="sparse"`` Adds from both ranks, compressed on even steps
    and dense fallbacks on odd ones, on an add table (the payloads rebuilt
    on the device into the union batch, one fused update) and a momentum
    table (decompressed on the host, one apply), each bitwise equal to
    its uncompressed twin, across the ranks and to the JAX world; then
    ``compress="1bit"`` pushes to each rank's own rows, within the JAX
    test's bound of the twin (checked in the children) and bitwise equal
    to the JAX world; the sparse table's wire ratio equals JAX's; then
    ``-mv_compress`` windows with one table in ``-mv_compress_lossy``: its
    Add values cross as int8 rows, the ranks bitwise equal to each other
    and to the JAX world's ranks (tolerance 0: both decode the same
    envelope bytes with the same numpy ops), within the int8 bound of a
    lossless twin and not equal to it (checked in the children).
(b) The same pushes on ``-mv_engine_shards=2`` (the compressed windows on
    two channels), bitwise equal to the one-engine world. The JAX
    package's sharded multi-process engine refuses compressed tables (their
    apply there is a device collective), so the port's one-engine world is
    the reference.
(c) LogisticRegression's host plane with ``compress=sparse`` and
    ``compress=1bit`` on two ranks' shards: the ranks bitwise equal, and
    equal to the JAX package's two-rank run within the two-process LR
    parity tolerance (tests/test_torch_mh_logreg.py).
"""

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world
from tests.test_torch_mh_logreg import ATOL, RTOL, _data

torch.set_num_threads(1)

_TABLES = ("sparse", "plain", "sparse_mom", "plain_mom", "onebit",
           "onebit_twin", "lossy", "lossy_twin")


def _port(tmp_path, name, *flags):
    sub = tmp_path / name
    sub.mkdir()
    res, _ = run_world("torch", "compress", sub, "want=shm", *flags)
    for key in ("sparse", "sparse_mom", "onebit", "lossy"):
        np.testing.assert_array_equal(res[0][key], res[1][key], err_msg=key)
    return res


def test_sparse_and_onebit_pushes_match_jax(tmp_path):
    jres, _ = run_world("jax", "compress", tmp_path, "want=shm")
    np.testing.assert_array_equal(jres[0]["lossy"], jres[1]["lossy"])
    tres = _port(tmp_path, "port")
    for r in range(2):
        np.testing.assert_array_equal(tres[r]["sparse"], tres[r]["plain"])
        np.testing.assert_array_equal(tres[r]["sparse_mom"],
                                      tres[r]["plain_mom"])
        for key in _TABLES + ("sparse_wire",):
            np.testing.assert_array_equal(tres[r][key], jres[r][key],
                                          err_msg=f"rank {r} {key}")


def test_compressed_windows_on_two_channels(tmp_path):
    one = _port(tmp_path, "one")
    two = _port(tmp_path, "two", "-mv_engine_shards=2")
    for r in range(2):
        assert len(two[r]["rounds"]) == 2 and min(two[r]["rounds"]) > 1
        for key in _TABLES:
            np.testing.assert_array_equal(two[r][key], one[r][key],
                                          err_msg=f"rank {r} {key}")


def test_lr_compress_matches_jax(tmp_path):
    _data(tmp_path, (640, 640))
    jres, _ = run_world("jax", "lr_compress", tmp_path, "want=shm")
    tres, _ = run_world("torch", "lr_compress", tmp_path, "want=shm")
    for mode in ("sparse", "1bit"):
        key = f"lr_{mode}_W"
        for res in (jres, tres):
            np.testing.assert_array_equal(res[0][key], res[1][key])
        np.testing.assert_allclose(tres[0][key], jres[0][key], rtol=RTOL,
                                   atol=ATOL, err_msg=mode)
        np.testing.assert_allclose(tres[0][f"lr_{mode}_loss"],
                                   jres[0][f"lr_{mode}_loss"], rtol=RTOL,
                                   atol=ATOL, err_msg=mode)
