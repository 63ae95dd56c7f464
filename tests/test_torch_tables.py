"""The Array, KV and SparseMatrix tables of the port against the JAX
package's.

Each test runs one seeded verb script in a JAX-package world
(``-mv_write_combine=0``, so every Add reaches its engine as its own
message, as in the port) and then in a port world on the CPU, one after
the other, and compares what the two observed:

* ArrayTable under all five updaters: Adds (blocking, async, fire-and-
  forget) from three workers, Gets, the device-plane verbs, Store bytes,
  logical aux and ``convert.load_array_state``. Integer-valued deltas keep
  the linear updaters exact; momentum, AdaGrad and DC-ASGD to rtol 1e-6,
  atol 1e-6 (float32 transcendentals in two libraries).
* KVTable: first-sight slot order, the grow rule (``init_capacity`` keys
  grow the table), the device-slot verbs, int64 host values, and Store/
  Load across the packages through ``convert.load_kv_state``: exact.
* SparseMatrixTable: a 3-worker Add/Get sequence (row sets, whole-table
  Gets, fetch-all, the row-0 fallback, a merged burst): the returned row
  sets and rows equal exactly.
"""

import io

import numpy as np
import pytest
import torch
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

WORKERS = 3


def _jax_world(run):
    import multiverso_tpu as jmv
    jmv.MV_Init([f"-num_workers={WORKERS}", "-mv_write_combine=0"])
    try:
        return run()
    finally:
        jmv.MV_ShutDown()


def _port_world(run):
    import multiverso_tpu_torch as tmv
    tmv.MV_Init([f"-num_workers={WORKERS}", "-mv_device=cpu"])
    try:
        return run()
    finally:
        tmv.MV_ShutDown()


def _jax_mods():
    import multiverso_tpu as mv
    from multiverso_tpu import tables
    from multiverso_tpu.updaters import base as updaters
    from multiverso_tpu.utils.io import Stream
    return mv, tables, updaters, Stream, np.asarray


def _port_mods():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import tables
    from multiverso_tpu_torch.updaters import base as updaters
    from multiverso_tpu_torch.utils.io import Stream
    return mv, tables, updaters, Stream, lambda t: t.detach().cpu().numpy()


# -- ArrayTable ------------------------------------------------------------------

SIZE = 37
ARRAY_UPDATERS = ("default", "sgd", "momentum", "adagrad", "dcasgd")


def _array_walk(mods):
    mv, tables, updaters, Stream, to_np = mods
    rng = np.random.default_rng(31)
    rec = {}
    for u in ARRAY_UPDATERS:
        t = mv.MV_CreateTable(tables.ArrayTableOption(size=SIZE,
                                                      updater_type=u))
        srv = t.server()

        def opt(w):
            return updaters.AddOption(worker_id=w, momentum=0.5,
                                      learning_rate=0.5, rho=0.25,
                                      lambda_=0.3)

        for step in range(4):
            w = step % WORKERS
            t.Add(rng.integers(-4, 5, SIZE).astype(np.float32), opt(w))
            rec[f"{u}/get{step}"] = t.Get()
        h = t.AddAsyncHandle(rng.integers(-3, 4, SIZE).astype(np.float32),
                             opt(1))
        t.Wait(h)
        for w in range(WORKERS):
            t.AddFireForget(rng.integers(-2, 3, SIZE).astype(np.float32),
                            opt(w))
        buf = np.zeros(SIZE, np.float32)
        rec[f"{u}/async"] = t.Wait(t.GetAsyncHandle()).copy()
        rec[f"{u}/buffer"] = t.Get(buf).copy()
        # device plane: one whole-table Add outside the engine
        state = srv.device_state()
        delta = np.zeros(srv.padded, np.float32)
        delta[:SIZE] = rng.integers(-3, 4, SIZE)
        jdelta = delta if to_np is np.asarray else torch.from_numpy(delta)
        opt_d = opt(2)
        opt_d = opt_d.as_jnp() if hasattr(opt_d, "as_jnp") else \
            opt_d.as_tensors()
        srv.device_set_state(srv.device_update(state, jdelta, opt_d))
        rec[f"{u}/device"] = to_np(srv.device_access(
            srv.device_state()))[:SIZE]
        rec[f"{u}/get_after_device"] = t.Get()
        for name, leaf in sorted(srv.state["aux"].items()):
            rec[f"{u}/aux_{name}"] = srv.aux_to_logical(leaf)
        stream = io.BytesIO()
        srv.Store(Stream(stream))
        rec[f"{u}/stored"] = np.frombuffer(stream.getvalue(), np.uint8)
        t.Add(np.ones(SIZE, np.float32), opt(0))
        stream.seek(0)
        srv.Load(Stream(stream))
        rec[f"{u}/loaded"] = t.Get()
    rec["partition"] = np.array(t.Partition(4))
    with pytest.raises(Exception, match="size mismatch"):
        t.Add(np.ones(SIZE + 1, np.float32))
    return rec


def test_array_table_matches_jax():
    jrec = _jax_world(lambda: _array_walk(_jax_mods()))
    trec = _port_world(lambda: _array_walk(_port_mods()))
    assert jrec.keys() == trec.keys()
    for key in jrec:
        t, j = trec[key], jrec[key]
        assert t.shape == j.shape, key
        if key.split("/")[0] in ("default", "sgd", "partition"):
            # the linear tables Store the very same bytes as the JAX
            # package
            np.testing.assert_array_equal(t, j, err_msg=key)
            continue
        if key.endswith("/stored"):
            np.testing.assert_array_equal(t[:8], j[:8], err_msg=key)
            t = np.frombuffer(t[8:].tobytes(), np.float32)
            j = np.frombuffer(j[8:].tobytes(), np.float32)
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6, err_msg=key)
    _check_load_array_state()


def _check_load_array_state():
    """JAX AdaGrad array state (data + per-worker history) -> convert ->
    port table: one more identical Add keeps them together."""
    import multiverso_tpu as jmv
    from multiverso_tpu.tables import ArrayTableOption as JOption
    from multiverso_tpu.updaters.base import AddOption as JAddOption
    rng = np.random.default_rng(5)
    deltas = [rng.standard_normal(SIZE).astype(np.float32) for _ in range(3)]

    def jax_run():
        t = jmv.MV_CreateTable(JOption(size=SIZE, updater_type="adagrad"))
        for i, d in enumerate(deltas[:2]):
            t.Add(d, JAddOption(worker_id=i))
        srv = t.server()
        data = t.Get()
        aux = {"hist": srv.aux_to_logical(srv.state["aux"]["hist"])}
        t.Add(deltas[2], JAddOption(worker_id=1))
        return data, aux, t.Get()

    data, aux, after = _jax_world(jax_run)

    def port_run():
        import multiverso_tpu_torch as tmv
        from multiverso_tpu_torch.convert import load_array_state
        from multiverso_tpu_torch.tables import ArrayTableOption
        from multiverso_tpu_torch.updaters.base import AddOption
        t = tmv.MV_CreateTable(ArrayTableOption(size=SIZE,
                                                updater_type="adagrad"))
        load_array_state(t, data, aux)
        np.testing.assert_array_equal(t.Get(), data)
        t.Add(deltas[2], AddOption(worker_id=1))
        np.testing.assert_allclose(t.Get(), after, rtol=1e-6, atol=1e-6)

    _port_world(port_run)


# -- KVTable ---------------------------------------------------------------------

CAP = 8


def _kv_walk(mods):
    mv, tables, _, Stream, to_np = mods
    rng = np.random.default_rng(41)
    rec = {}
    t = mv.MV_CreateTable(tables.KVTableOption(init_capacity=CAP))
    srv = t.server()
    # first-sight slot order, duplicates and a huge key; 6 keys < CAP
    keys = np.array([900, 5, 77, 5, 12345678901, 3, 900, 42], np.int64)
    t.Add(keys, np.arange(8, dtype=np.float32))
    rec["slots"] = np.asarray(srv.device_slots(keys))
    rec["cap6"] = np.array([srv.capacity, srv.size])
    rec["get6"] = t.Get(np.append(keys, 7))          # 7 is absent: reads 0
    # the grow rule: the key count reaching the capacity grows the table
    t.Add(np.array([11, 12], np.int64), np.ones(2, np.float32))
    rec["cap8"] = np.array([srv.capacity, srv.size,
                            srv.device_values().shape[0]])
    rec["slots8"] = np.asarray(srv.device_slots(
        np.array([5, 11, 12, 13], np.int64)))
    # the device-slot verbs: create, place, gather, scatter-add
    new = rng.integers(100, 200, 12).astype(np.int64)
    slots = srv.device_slots(np.concatenate([keys, new]), create=True)
    rec["slots_created"] = np.asarray(slots)
    rec["cap_created"] = np.array([srv.capacity, srv.size])
    n = len(keys) + len(new)
    deltas = np.zeros(len(slots), np.float32)
    deltas[:n] = rng.integers(-5, 6, n)
    gslots, gdeltas = srv.device_place_slots(slots, deltas)
    vals = srv.device_values()
    rec["gathered"] = to_np(srv.device_gather_slots(vals, gslots))[:n]
    srv.device_set_values(srv.device_scatter_add_slots(vals, gslots,
                                                       gdeltas))
    rec["after_scatter"] = t.Get(np.concatenate([keys, new]))
    with pytest.raises(Exception, match="capacity"):
        srv.device_set_values(srv.device_values()[:-1])
    # burst of Adds (merged in one engine window on both sides)
    for _ in range(4):
        k = rng.integers(0, 300, 20).astype(np.int64)
        t.Add(k, rng.integers(-3, 4, 20).astype(np.float32))
    rec["size_final"] = np.array([srv.size, srv.capacity])
    # int64 values stay on the host; the device plane refuses them
    c = mv.MV_CreateTable(tables.KVTableOption(dtype=np.int64))
    c.Add(np.array([3, 1, 3], np.int64), np.array([2, 5, 7], np.int64))
    rec["int64"] = c.Get(np.array([1, 3, 4], np.int64))
    with pytest.raises(Exception, match="host-resident"):
        c.server().device_slots(np.array([1], np.int64))
    stream = io.BytesIO()
    srv.Store(Stream(stream))
    rec["stored"] = stream.getvalue()
    return rec


def _parse_kv(blob):
    n = int(np.frombuffer(blob[:8], np.int64)[0])
    keys = np.frombuffer(blob[8: 8 + 8 * n], np.int64)
    vals = np.frombuffer(blob[8 + 8 * n:], np.float32)
    return keys, vals


def test_kv_table_matches_jax():
    jrec = _jax_world(lambda: _kv_walk(_jax_mods()))
    trec = _port_world(lambda: _kv_walk(_port_mods()))
    for key in jrec:
        if key == "stored":
            continue
        np.testing.assert_array_equal(trec[key], jrec[key], err_msg=key)
    # the grow rule: CAP keys in a CAP table grow it to 2 * CAP
    assert tuple(trec["cap8"]) == (2 * CAP, CAP, 2 * CAP)
    # both stores hold the same key -> value map; the port's in slot order
    jk, jv = _parse_kv(jrec["stored"])
    tk, tv = _parse_kv(trec["stored"])
    assert dict(zip(jk.tolist(), jv.tolist())) == dict(zip(tk.tolist(),
                                                           tv.tolist()))
    np.testing.assert_array_equal(np.sort(tk), np.sort(jk))
    _check_kv_round_trips(jrec["stored"], trec["stored"])


def _check_kv_round_trips(jblob, tblob):
    """JAX Store -> port Load and convert.load_kv_state; port Store -> JAX
    Load: every key reads the same, and the port keeps the file's order as
    its slot order."""
    keys, vals = _parse_kv(jblob)
    probe = np.append(keys, 999_999)

    def port_run():
        import multiverso_tpu_torch as tmv
        from multiverso_tpu_torch.convert import load_kv_state
        from multiverso_tpu_torch.tables import KVTableOption
        from multiverso_tpu_torch.utils.io import Stream
        a = tmv.MV_CreateTable(KVTableOption(init_capacity=CAP))
        a.server().Load(Stream(io.BytesIO(jblob)))
        b = tmv.MV_CreateTable(KVTableOption(init_capacity=CAP))
        load_kv_state(b, keys, vals)
        for t in (a, b):
            np.testing.assert_array_equal(t.Get(probe), np.append(vals, 0))
            np.testing.assert_array_equal(
                t.server().device_slots(keys)[: len(keys)],
                np.arange(len(keys)))
            # Load grows a table too small for the file to n + 1 slots
            assert t.server().capacity == max(len(keys) + 1, CAP)

    _port_world(port_run)

    def jax_run():
        from multiverso_tpu.tables import KVTableOption
        from multiverso_tpu.utils.io import Stream
        import multiverso_tpu as jmv
        t = jmv.MV_CreateTable(KVTableOption(init_capacity=CAP))
        t.server().Load(Stream(io.BytesIO(tblob)))
        tk, tv = _parse_kv(tblob)
        np.testing.assert_array_equal(t.Get(np.append(tk, 999_999)),
                                      np.append(tv, 0))

    _jax_world(jax_run)


# -- SparseMatrixTable -----------------------------------------------------------

R, C = 30, 5


def _sparse_walk(mods):
    mv, tables, updaters, _, _ = mods
    rng = np.random.default_rng(51)
    rec = []
    t = mv.MV_CreateTable(tables.SparseMatrixTableOption(num_rows=R,
                                                         num_cols=C))

    def add(w, ids):
        t.AddRows(np.asarray(ids, np.int32),
                  rng.integers(-4, 5, (len(ids), C)).astype(np.float32),
                  updaters.AddOption(worker_id=w))

    def get(w, ids=None):
        opt = updaters.GetOption(worker_id=w)
        out_ids, rows = (t.Get(opt) if ids is None
                         else t.GetRows(np.asarray(ids, np.int32), opt))
        rec.append((w, np.asarray(out_ids), np.asarray(rows)))

    for w in range(WORKERS):
        get(w)                                   # all fresh: row 0 only
    add(0, [1, 4, 7, 4])
    get(0)                                       # its own push: row 0
    get(1)
    get(1)
    get(2, [4, 7, 9, 1])
    get(-1)                                      # fetch everything
    for step in range(6):
        w = step % WORKERS
        add(w, rng.permutation(R)[:6])
        get((w + 1) % WORKERS, rng.permutation(R)[:8])
        get((w + 2) % WORKERS)
    # a whole-table Add marks every row stale for the others
    t.Add(rng.integers(-2, 3, (R, C)).astype(np.float32),
          updaters.AddOption(worker_id=1))
    get(1)
    get(0)
    # a fire-and-forget burst (merged in one engine window), then Gets
    for w in range(WORKERS):
        t.AddFireForget(rng.integers(-3, 4, (5, C)).astype(np.float32),
                        row_ids=rng.permutation(R)[:5].astype(np.int32),
                        option=updaters.AddOption(worker_id=w))
    for w in range(WORKERS):
        get(w)
    with pytest.raises(Exception, match="out of range"):
        t.GetRows(np.array([R], np.int32), updaters.GetOption(worker_id=0))
    get(0)
    rec.append(("bits", t.server().up_to_date.copy(), None))
    return rec


def test_sparse_matrix_table_matches_jax():
    jrec = _jax_world(lambda: _sparse_walk(_jax_mods()))
    trec = _port_world(lambda: _sparse_walk(_port_mods()))
    assert len(jrec) == len(trec)
    for i, (j, t) in enumerate(zip(jrec, trec)):
        assert j[0] == t[0], i
        np.testing.assert_array_equal(t[1], j[1], err_msg=f"ids {i} {j[0]}")
        if j[2] is not None:
            np.testing.assert_array_equal(t[2], j[2],
                                          err_msg=f"rows {i} {j[0]}")
    # the row-0 fallback happened, and the protocol shipped other sets too
    assert any(len(r[1]) == 1 and r[1][0] == 0 for r in trec[:-1])
    assert any(len(r[1]) > 1 for r in trec[:-1])
    _check_load_sparse_state()


def _check_load_sparse_state():
    from multiverso_tpu_torch.convert import load_sparse_matrix_state

    def port_run():
        import multiverso_tpu_torch as tmv
        from multiverso_tpu_torch.tables import SparseMatrixTableOption
        from multiverso_tpu_torch.updaters.base import GetOption
        t = tmv.MV_CreateTable(SparseMatrixTableOption(num_rows=R,
                                                       num_cols=C))
        data = np.arange(R * C, dtype=np.float32).reshape(R, C)
        bits = np.ones((WORKERS, R), bool)
        bits[1, [3, 8]] = False
        load_sparse_matrix_state(t, data, up_to_date=bits)
        ids, rows = t.Get(GetOption(worker_id=1))
        np.testing.assert_array_equal(ids, [3, 8])
        np.testing.assert_array_equal(rows, data[[3, 8]])

    _port_world(port_run)
