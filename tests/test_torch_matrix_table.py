"""The MatrixTable verb walk through both packages' worlds.

The same seeded verb script runs in a JAX-package world (``-use_pallas=on``,
so its device paths run the Pallas kernels in interpret mode;
``-mv_write_combine=0``, so every Add reaches its engine as its own message)
and then in a port world on the CPU at ``-mv_write_combine=0`` too (the
burst's momentum Adds combined would apply once as one Add) — one world
after the other, never both up at once. Every result the script observes is recorded
and the two records compared: integer-valued deltas must match exactly for
the linear updaters, momentum to rtol 1e-6. On the CPU the JAX table serves
add/sgd host verbs from its native mirror and keeps 8 server shards, so
only logical results are compared, never storage.
"""

import io

import numpy as np
import pytest
import torch
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

R, C = 40, 6
K = 10            # ids per row batch (fixed: one compile per JAX program)
UPDATERS = ("default", "sgd", "momentum")


def _opt(pkg, updater):
    if updater == "momentum":
        return pkg.AddOption(worker_id=0, momentum=0.5)
    return None


def _walk(mv, tables_mod, updaters_mod, stream_cls, to_numpy):
    """Run the verb script; returns {label: array} for every observation."""
    rng = np.random.default_rng(21)
    rec = {}
    tabs = {u: mv.MV_CreateTable(tables_mod.MatrixTableOption(
        num_rows=R, num_cols=C, updater_type=u)) for u in UPDATERS}
    for u, t in tabs.items():
        opt = _opt(updaters_mod, u)
        # AddRows with duplicate ids, then GetRows
        for step in range(3):
            ids = rng.integers(0, R, K).astype(np.int32)
            ids[1] = ids[0]                              # a duplicate
            d = rng.integers(-4, 5, (K, C)).astype(np.float32)
            t.AddRows(ids, d, opt)
            rec[f"{u}/rows{step}"] = t.GetRows(ids)
        # whole-table Add and Get
        t.Add(rng.integers(-2, 3, (R, C)).astype(np.float32), opt)
        rec[f"{u}/whole"] = t.Get()
        # fire-and-forget bursts: one batched envelope (drained into one
        # engine window, so linear tables coalesce it through
        # ProcessAddRun) and a loop of single pushes
        payloads = []
        for _ in range(4):
            ids = rng.permutation(R)[:K].astype(np.int32)
            payloads.append({"row_ids": ids, "values": rng.integers(
                -3, 4, (K, C)).astype(np.float32)})
        t.MultiAddAsync(payloads, option=opt, track=False)
        for p in payloads:
            t.AddFireForget(p["values"], row_ids=p["row_ids"], option=opt)
        rec[f"{u}/burst"] = t.GetRows(np.arange(R, dtype=np.int32))
        # device plane: fetch, apply (duplicates pre-combine on the host)
        srv = t.server()
        ids = rng.permutation(R)[:K].astype(np.int32)
        rec[f"{u}/dfetch"] = to_numpy(srv.device_fetch_rows(ids))
        ids_dup = ids.copy()
        ids_dup[3] = ids_dup[2]
        srv.device_apply_rows(ids_dup, rng.integers(-3, 4, (K, C)).astype(
            np.float32), opt)
        rec[f"{u}/dapply"] = t.GetRows(np.arange(R, dtype=np.int32))
        rec[f"{u}/raw"] = srv.raw()
        # Store/Load round trip through the byte-compatible stream
        buf = io.BytesIO()
        srv.Store(stream_cls(buf))
        rec[f"{u}/stored"] = np.frombuffer(buf.getvalue(), np.uint8)
        t.AddRows(np.arange(K, dtype=np.int32), np.ones((K, C), np.float32),
                  opt)
        buf.seek(0)
        srv.Load(stream_cls(buf))
        rec[f"{u}/loaded"] = t.Get()
    # an out-of-range id raises at the caller's Wait
    with pytest.raises(Exception, match="out of range"):
        tabs["default"].AddRows([R], np.ones((1, C), np.float32))
    with pytest.raises(Exception, match="out of range"):
        tabs["default"].GetRows([-1])
    rec["default/after_bad"] = tabs["default"].Get()
    return rec


def _records():
    """Both packages' records, worlds run one after the other."""
    import multiverso_tpu as jmv
    from multiverso_tpu import tables as jtables
    from multiverso_tpu.updaters import base as jupdaters
    from multiverso_tpu.utils.configure import SetCMDFlag
    from multiverso_tpu.utils.io import Stream as JStream

    jmv.MV_Init(["-mv_write_combine=0"])
    try:
        SetCMDFlag("use_pallas", "on")
        jrec = _walk(jmv, jtables, jupdaters, JStream, np.asarray)
    finally:
        jmv.MV_ShutDown()

    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch import tables as ttables
    from multiverso_tpu_torch.updaters import base as tupdaters
    from multiverso_tpu_torch.utils.io import Stream as TStream
    from multiverso_tpu_torch.zoo import Zoo

    tmv.MV_Init(["-mv_write_combine=0"], devices=[torch.device("cpu")])
    try:
        trec = _walk(tmv, ttables, tupdaters, TStream,
                     lambda t: t.cpu().numpy())
        merged = Zoo.Get().server_engine.add_runs_merged
    finally:
        tmv.MV_ShutDown()
    return jrec, trec, merged


PHASES = ("rows0", "rows1", "rows2", "whole", "burst", "dfetch", "dapply",
          "raw", "loaded")


def test_walk_matches_jax():
    jrec, trec, merged = _records()
    for updater in UPDATERS:
        for phase in PHASES:
            key = f"{updater}/{phase}"
            assert trec[key].shape == jrec[key].shape, key
            if updater == "momentum":
                np.testing.assert_allclose(trec[key], jrec[key], rtol=1e-6,
                                           atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(trec[key], jrec[key],
                                              err_msg=key)
    # both packages Store the same bytes (linear tables: exact values)
    for updater in ("default", "sgd"):
        np.testing.assert_array_equal(trec[f"{updater}/stored"],
                                      jrec[f"{updater}/stored"])
    # the rejected out-of-range Add left the table alone
    np.testing.assert_array_equal(trec["default/after_bad"],
                                  jrec["default/after_bad"])
    np.testing.assert_array_equal(trec["default/after_bad"],
                                  trec["default/loaded"])
    # the batched burst coalesced through ProcessAddRun at least once
    assert merged >= 1


def test_convert_load_matrix_state_reproduces_jax_table():
    """JAX table state (data + momentum aux) -> convert -> port table:
    raw() identical, and one more identical Add keeps them together."""
    import multiverso_tpu as jmv
    from multiverso_tpu.tables import MatrixTableOption as JOption
    from multiverso_tpu.updaters.base import AddOption as JAddOption

    rng = np.random.default_rng(8)
    init = rng.standard_normal((R, C)).astype(np.float32)
    ids = rng.permutation(R)[:K].astype(np.int32)
    steps = [rng.standard_normal((K, C)).astype(np.float32)
             for _ in range(3)]
    jmv.MV_Init([])
    try:
        t = jmv.MV_CreateTable(JOption(num_rows=R, num_cols=C,
                                       updater_type="momentum",
                                       initializer=lambda s: init))
        for d in steps[:2]:
            t.AddRows(ids, d, JAddOption(momentum=0.9))
        srv = t.server()
        data = srv.raw()
        aux = {"smooth": srv.aux_to_logical(srv.state["aux"]["smooth"])}
        t.AddRows(ids, steps[2], JAddOption(momentum=0.9))
        after = t.Get()
    finally:
        jmv.MV_ShutDown()

    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch.convert import load_matrix_state
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.updaters.base import AddOption

    tmv.MV_Init(["-mv_device=cpu"])
    try:
        pt = tmv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C,
                                                  updater_type="momentum"))
        load_matrix_state(pt, data, aux)
        np.testing.assert_array_equal(pt.server().raw(), data)
        np.testing.assert_array_equal(
            pt.server().aux_to_logical(pt.server().state["aux"]["smooth"]),
            aux["smooth"])
        pt.AddRows(ids, steps[2], AddOption(momentum=0.9))
        np.testing.assert_allclose(pt.Get(), after, rtol=1e-6, atol=1e-6)
    finally:
        tmv.MV_ShutDown()


def test_device_update_gather_rows_is_the_add_get_round():
    """Port only: the fused Add+Get round returns the post-update rows
    and leaves the table as AddRows + GetRows would."""
    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch.tables import MatrixTableOption

    rng = np.random.default_rng(9)
    tmv.MV_Init(["-mv_device=cpu"])
    try:
        for u in UPDATERS:
            t = tmv.MV_CreateTable(MatrixTableOption(num_rows=R, num_cols=C,
                                                     updater_type=u))
            ref = tmv.MV_CreateTable(MatrixTableOption(num_rows=R,
                                                       num_cols=C,
                                                       updater_type=u))
            for _ in range(3):
                ids = rng.permutation(R)[:K].astype(np.int32)
                d = rng.integers(-3, 4, (K, C)).astype(np.float32)
                rows = t.server().device_update_gather_rows(ids, d)
                ref.AddRows(ids, d)
                np.testing.assert_array_equal(rows.numpy(), ref.GetRows(ids))
            np.testing.assert_array_equal(t.Get(), ref.Get())
    finally:
        tmv.MV_ShutDown()
