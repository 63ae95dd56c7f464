"""The port's row kernels against the JAX package's Pallas kernels.

On the CPU every ``cuda_rows`` wrapper runs its kernel's plain PyTorch
version; the JAX side runs ``multiverso_tpu/ops/pallas_rows.py`` in
interpret mode, as ``tests/test_ops.py`` does. The same numpy inputs go to
both. Gather and scatter-set must agree bitwise; the fused update (+ and -)
bitwise outside the trash row, which duplicate trash lanes may race on.
The hand-written CUDA kernels themselves are held to these plain versions
on the card by ``chip_smoke.py``.

Every case uses one batch size (a ragged 100 ids: one full 64-id Pallas
chunk plus a padded tail), so each Pallas kernel compiles once per column
count and the cases differ only in their ids. The cases run as loops
inside a few tests (each failure names its case): pytest-xdist's
loadfile scheduler orders test files by test count, and a file with
many collected tests would reshuffle where every other file runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import pallas_rows as jpallas
from multiverso_tpu.ops import rows as jrows
from multiverso_tpu_torch import ops as tops
from multiverso_tpu_torch.ops import cuda_rows

torch.set_num_threads(1)

ROWS = 200          # >= one 64-id chunk: the Pallas _contig branch exists
TRASH = ROWS - 1    # the table's trash row (don't-care content)
N = 100             # ragged: not a multiple of the 64-id chunk
CASES = ("random", "consecutive", "pad_only", "trash_dups")
COLS = (128, 50)


def _ids(case: str, seed: int = 0) -> np.ndarray:
    """Lane ids for one case; live ids unique, duplicates only on TRASH."""
    rng = np.random.default_rng(seed)
    if case == "random":
        ids = rng.permutation(TRASH)[:N]
    elif case == "consecutive":
        # the first 64-id chunk is strictly consecutive (the Pallas
        # coalesced single-copy branch), the ragged tail random
        run = np.arange(17, 17 + 64)
        rest = rng.permutation(np.setdiff1d(np.arange(TRASH), run))[:N - 64]
        ids = np.concatenate([run, rest])
    elif case == "pad_only":
        ids = np.full(N, TRASH)          # pad lanes mapped to the trash row
    else:
        live = rng.permutation(TRASH)[:N - 20]
        ids = rng.permutation(np.concatenate([live, np.full(20, TRASH)]))
    return ids.astype(np.int32)


def _data(cols: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ROWS, cols)).astype(np.float32),
            rng.standard_normal((N, cols)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_gather(case, cols):
    data, _ = _data(cols)
    ids = _ids(case)
    want = np.asarray(jpallas.pallas_gather_rows(
        jnp.asarray(data), jnp.asarray(ids), interpret=True))
    got = cuda_rows.gather_rows(_t(data), _t(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data[ids])


def _check_scatter_set(case, cols):
    data, rows = _data(cols)
    ids = _ids(case)
    want = np.asarray(jpallas.pallas_scatter_set_rows(
        jnp.asarray(data), jnp.asarray(ids), jnp.asarray(rows),
        interpret=True))
    table = _t(data)
    out = cuda_rows.scatter_set_rows(table, _t(ids), _t(rows))
    assert out.data_ptr() == table.data_ptr()       # in place
    got = out.numpy()
    np.testing.assert_array_equal(got[:TRASH], want[:TRASH])
    if case in ("random", "consecutive"):            # no trash lanes
        np.testing.assert_array_equal(got, want)


def _check_update(case, cols, sign):
    data, deltas = _data(cols)
    ids = _ids(case)
    combine = jnp.add if sign > 0 else jnp.subtract
    want = np.asarray(jpallas.pallas_update_rows(
        jnp.asarray(data), jnp.asarray(ids), jnp.asarray(deltas),
        combine=combine, interpret=True))
    table = _t(data)
    got_table, new_rows = cuda_rows.update_rows(table, _t(ids), _t(deltas),
                                                sign, want_rows=True)
    got = got_table.numpy()
    np.testing.assert_array_equal(got[:TRASH], want[:TRASH])
    live = ids != TRASH
    np.testing.assert_array_equal(new_rows.numpy()[live], want[ids[live]])
    # untouched live rows intact
    untouched = np.setdiff1d(np.arange(TRASH), ids)
    np.testing.assert_array_equal(got[untouched], data[untouched])


def test_plain_kernels_match_pallas():
    """Every (kernel, case, cols[, sign]) combination; the failing one is
    named in the assertion."""
    for cols in COLS:
        for case in CASES:
            checks = [("gather", lambda: _check_gather(case, cols)),
                      ("scatter_set", lambda: _check_scatter_set(case, cols))]
            checks += [(f"update{sign:+d}",
                        lambda sign=sign: _check_update(case, cols, sign))
                       for sign in (1, -1)]
            for name, check in checks:
                try:
                    check()
                except AssertionError as exc:
                    raise AssertionError(
                        f"{name} case={case} cols={cols}: {exc}") from exc


def test_wrappers_reject_what_the_kernels_do_not_take():
    data = torch.zeros((8, 4))
    with pytest.raises(TypeError):
        cuda_rows.gather_rows(data, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        cuda_rows.gather_rows(data.double(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_rows.gather_rows(data.t(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_rows.scatter_set_rows(data, torch.zeros(2, dtype=torch.int32),
                                   torch.zeros((3, 4)))
    with pytest.raises(ValueError):
        cuda_rows.update_rows(data, torch.zeros(2, dtype=torch.int32),
                              torch.zeros((2, 4)), sign=2)


# -- the ops.rows dispatch against multiverso_tpu.ops.rows -------------------

def _jadd(r, d):
    return r + d


def _jsub(r, d):
    return r - d


def _check_dispatch(cols):
    data, deltas = _data(cols, seed=3)
    ids = _ids("trash_dups", seed=4)
    live = ids != TRASH
    np.testing.assert_array_equal(
        tops.gather_rows(_t(data), _t(ids)).numpy(),
        np.asarray(jrows.gather_rows(jnp.asarray(data), jnp.asarray(ids))))
    want = np.asarray(jrows.scatter_set_rows(
        jnp.asarray(data), jnp.asarray(ids), jnp.asarray(deltas)))
    got = tops.scatter_set_rows(_t(data), _t(ids), _t(deltas)).numpy()
    np.testing.assert_array_equal(got[:TRASH], want[:TRASH])
    for sign, combine in ((1, _jadd), (-1, _jsub)):
        want = np.asarray(jrows.update_rows(
            jnp.asarray(data), jnp.asarray(ids), jnp.asarray(deltas),
            combine))
        got = tops.update_rows(_t(data), _t(ids), _t(deltas), sign).numpy()
        np.testing.assert_array_equal(got[:TRASH], want[:TRASH])
        jd, jr = jrows.update_gather_rows(
            jnp.asarray(data), jnp.asarray(ids), jnp.asarray(deltas), combine)
        td, tr = tops.update_gather_rows(_t(data), _t(ids), _t(deltas), sign)
        np.testing.assert_array_equal(td.numpy()[:TRASH],
                                      np.asarray(jd)[:TRASH])
        np.testing.assert_array_equal(tr.numpy()[live], np.asarray(jr)[live])


def _check_dedup(integer_valued):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 12, 40).astype(np.int32)
    ids[::7] = -1                                   # pad lanes pass through
    if integer_valued:
        deltas = rng.integers(-5, 6, (40, 6)).astype(np.float32)
    else:
        deltas = rng.standard_normal((40, 6)).astype(np.float32)
    deltas[ids == -1] = 0.0
    jid, jd = jrows.dedup_rows(jnp.asarray(ids), jnp.asarray(deltas))
    tid, td = tops.dedup_rows(_t(ids), _t(deltas))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # duplicates summed into one surviving lane per id (the host oracle)
    oracle = np.zeros((12, 6), np.float64)
    np.add.at(oracle, ids[ids >= 0], deltas[ids >= 0])
    got = tid.numpy()
    assert len(np.unique(got[got >= 0])) == (got >= 0).sum()
    np.testing.assert_allclose(td.numpy()[got >= 0], oracle[got[got >= 0]],
                               rtol=1e-6, atol=1e-6)


def test_dispatch_and_dedup_match_jax_rows():
    """The ops.rows dispatch against multiverso_tpu.ops.rows (XLA path on
    the CPU), and dedup_rows' sums — bitwise, integer-valued and random
    deltas alike."""
    for cols in COLS:
        _check_dispatch(cols)
    for integer_valued in (True, False):
        _check_dedup(integer_valued)
