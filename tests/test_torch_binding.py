"""The port's reference-compatible binding (``multiverso_tpu_torch.binding``)
against the JAX package's (``multiverso_tpu.binding``), on the CPU.

Each script runs the same sequence, on the same numpy inputs, in a JAX
world and then in a port world (``-mv_device=cpu``), both at their default
``-mv_write_combine``, so the handlers' async pushes are combined in both.
Every result is bitwise JAX's (integer-valued deltas on the add updater).

(a) ``init``/``shutdown``/``barrier`` and the world's introspection
    (``workers_num``, ``worker_id``, ``server_id``, ``is_master_worker``,
    ``MV_WorkerIdToRank``/``MV_ServerIdToRank``, an out-of-range id
    failing); ``ArrayTableHandler`` and ``MatrixTableHandler`` with an
    init value, rounds of async and blocking adds, whole and by rows, and
    their gets; ``ASyncBuffer`` double-buffering the table's gets.
(b) ``TorchParamManager`` over an ``nn.Module``, ``SyncCallback`` syncing
    every 2 batches and at the end, the two-worker delta trick on one
    shared table (the server holds the base and both workers' deltas),
    ``mv_shared``/``sync_all_mv_shared_vars``, the master-initializes
    convention and attribute forwarding.
(c) The C ABI through each package's bridge on the same ctypes calls: an
    Array table (blocking and async adds), a Matrix table by rows (rounds
    of 8 async adds and a get) and whole, ``MV_StoreTable`` and
    ``MV_LoadTable``. The port's bridge is installed into the port's build
    of the library (the JAX bridge gets the same build through
    tests/_jax_native_from_port.py); the test skips when no C++ compiler
    can build it, as tests/test_torch_native.py does.
"""

import ctypes
import threading

import numpy as np
import pytest
import torch

from multiverso_tpu_torch import native as tnative
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

R, C = 30, 4


def _pkg(pkg):
    if pkg == "jax":
        import multiverso_tpu as core
        import multiverso_tpu.binding as b
        from multiverso_tpu.binding import param_manager, sharedvar
        from multiverso_tpu.utils import ASyncBuffer
        return core, b, param_manager, sharedvar, ASyncBuffer, []
    import multiverso_tpu_torch as core
    import multiverso_tpu_torch.binding as b
    from multiverso_tpu_torch.binding import param_manager, sharedvar
    from multiverso_tpu_torch.utils import ASyncBuffer
    return core, b, param_manager, sharedvar, ASyncBuffer, ["-mv_device=cpu"]


def _compare(script):
    jrec, trec = script("jax"), script("torch")
    assert jrec.keys() == trec.keys()
    for k in jrec:
        np.testing.assert_array_equal(np.asarray(trec[k]),
                                      np.asarray(jrec[k]), err_msg=k)
    return trec


# -- (a) the handlers --------------------------------------------------------------

def _handlers(pkg):
    core, b, _, _, ASyncBuffer, argv = _pkg(pkg)
    rng = np.random.default_rng(41)
    rec = {}
    b.init(args=argv)
    try:
        rec["world"] = [b.workers_num(), b.worker_id(), b.server_id(),
                        b.is_master_worker(), core.MV_WorkerIdToRank(0),
                        core.MV_ServerIdToRank(0)]
        try:
            core.MV_WorkerIdToRank(1)
        except Exception:
            rec["bad_id_raises"] = True
        arr = b.ArrayTableHandler(50, init_value=rng.integers(
            -5, 5, 50).astype(np.float32))
        mat = b.MatrixTableHandler(R, C, init_value=rng.integers(
            -5, 5, (R, C)).astype(np.float32))
        for r in range(5):
            ids = rng.integers(0, R, 6)
            for i in range(8):
                mat.add(rng.integers(-3, 4, (6, C)), row_ids=ids,
                        sync=i == 7)
                arr.add(rng.integers(-3, 4, 50), sync=i % 3 == 0)
            mat.add(rng.integers(-3, 4, (R, C)))
            rec[f"rows{r}"] = mat.get(ids)
            rec[f"arr{r}"] = arr.get()
        b.barrier()
        rec["mat"] = mat.get()
        bufs = ASyncBuffer(np.zeros(50, np.float32), np.zeros(50, np.float32),
                           lambda buf: np.copyto(buf, arr.get()))
        for i in range(3):
            got = bufs.Get()
            rec[f"async_buffer{i}"] = got.copy()
            arr.add(np.ones(50, np.float32), sync=True)
        bufs.Join()
    finally:
        b.shutdown()
    return rec


def test_handlers_and_world_match_jax():
    rec = _compare(_handlers)
    assert rec["world"] == [1, 0, 0, True, 0, 0] and rec["bad_id_raises"]


# -- (b) the managers and shared variables ----------------------------------------

def _managers(pkg):
    core, b, pm, sv, _, argv = _pkg(pkg)
    rng = np.random.default_rng(42)
    rec = {}
    weight = rng.integers(-4, 4, (3, 5)).astype(np.float32)
    bias = rng.integers(-4, 4, 3).astype(np.float32)

    def model():
        m = torch.nn.Linear(5, 3)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(weight))
            m.bias.copy_(torch.from_numpy(bias))
        return m

    b.init(args=argv)
    try:
        m = model()
        mgr = pm.TorchParamManager(m)
        syncs = []
        orig = mgr.sync_all_param
        mgr.sync_all_param = lambda: (syncs.append(1), orig())[1]
        cb = pm.SyncCallback(mgr, freq=2)
        for i in range(5):
            with torch.no_grad():
                m.weight += float(i + 1)
                m.bias -= 1.0
            cb.on_batch_end()
            rec[f"weight{i}"] = m.weight.detach().numpy().copy()
        cb.on_train_end()
        rec["syncs"] = len(syncs)
        rec["final"] = np.concatenate([m.weight.detach().numpy().ravel(),
                                       m.bias.detach().numpy()])
        rec["table"] = mgr.tbh.get()
        sv.mv_shared.shared_vars.clear()
        init = np.arange(6, dtype=np.float32).reshape(2, 3)
        a = sv.mv_shared(init, name="a")
        c = sv.mv_shared(np.full(4, 5.0, np.float32))
        rec["init"] = a.get_value()               # master-initializes
        a.set_value(a.get_value() + 1.0)
        c.set_value(c.get_value() * 2.0)
        sv.sync_all_mv_shared_vars()
        a.set_value(a.get_value() + 2.0)
        a.mv_sync()
        rec["a"], rec["c"], rec["name"] = a.get_value(), c.get_value(), \
            a.name == "a"
        sv.mv_shared.shared_vars.clear()
    finally:
        b.shutdown()
    # the delta trick from two worker threads on one shared table
    b.init(args=argv + ["-num_workers=2"])
    try:
        base = np.concatenate([weight.ravel(), bias])
        shared = b.ArrayTableHandler(base.size, init_value=base)
        merged, errors = {}, []

        def worker(w):
            try:
                with core.MV_WorkerContext(w):
                    mw = model()
                    mgr = pm.TorchParamManager(mw, table=shared)
                    with torch.no_grad():
                        mw.weight += float(w + 1)     # local training
                    mgr.sync_all_param()
                    b.barrier()                       # both pushes landed
                    mgr.sync_all_param()
                    merged[w] = mw.weight.detach().numpy().copy()
            except BaseException as exc:              # re-raised below
                errors.append(exc)

        ths = [threading.Thread(target=worker, args=(w,)) for w in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
        assert not any(th.is_alive() for th in ths) and not errors, errors
        rec["merged0"], rec["merged1"] = merged[0], merged[1]
        rec["server"] = shared.get()
    finally:
        b.shutdown()
    return rec


def test_param_managers_and_shared_vars_match_jax():
    rec = _compare(_managers)
    assert rec["syncs"] == 3
    np.testing.assert_array_equal(rec["merged0"], rec["merged1"])
    np.testing.assert_array_equal(rec["init"],
                                  np.arange(6).reshape(2, 3))


# -- (c) the C ABI through the bridges --------------------------------------------

def _c_abi(pkg, lib, tmp_path):
    _, _, _, _, _, argv = _pkg(pkg)
    if pkg == "jax":
        from multiverso_tpu.binding import native_bridge
    else:
        from multiverso_tpu_torch.binding import native_bridge
    fptr, iptr = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    rng = np.random.default_rng(43)
    rec = {}
    bridge = native_bridge.install(lib)
    args = [b"prog"] + [a.encode() for a in argv]
    argc = ctypes.c_int(len(args))
    lib.MV_Init(ctypes.byref(argc), (ctypes.c_char_p * len(args))(*args))
    try:
        arr, mat = ctypes.c_void_p(), ctypes.c_void_p()
        lib.MV_NewArrayTable(10, ctypes.byref(arr))
        lib.MV_NewMatrixTable(R, C, ctypes.byref(mat))
        if pkg == "torch":
            rec["port_tables"] = [type(e.worker).__name__
                                  for e in bridge._tables.values()]
        for r in range(3):
            ids = rng.integers(0, R, 5).astype(np.int32)
            for _ in range(8):
                d = rng.integers(-3, 4, (5, C)).astype(np.float32)
                lib.MV_AddAsyncMatrixTableByRows(
                    mat, d.ctypes.data_as(fptr), d.size,
                    ids.ctypes.data_as(iptr), len(ids))
                v = rng.integers(-3, 4, 10).astype(np.float32)
                lib.MV_AddAsyncArrayTable(arr, v.ctypes.data_as(fptr), 10)
            out = np.zeros((5, C), np.float32)
            lib.MV_GetMatrixTableByRows(mat, out.ctypes.data_as(fptr),
                                        out.size, ids.ctypes.data_as(iptr),
                                        len(ids))
            rec[f"rows{r}"] = out
            v = np.ones(10, np.float32)
            lib.MV_AddArrayTable(arr, v.ctypes.data_as(fptr), 10)
            out = np.zeros(10, np.float32)
            lib.MV_GetArrayTable(arr, out.ctypes.data_as(fptr), 10)
            rec[f"arr{r}"] = out
        whole = rng.integers(-3, 4, (R, C)).astype(np.float32)
        lib.MV_AddMatrixTableAll(mat, whole.ctypes.data_as(fptr), whole.size)
        lib.MV_AddAsyncMatrixTableAll(mat, whole.ctypes.data_as(fptr),
                                      whole.size)
        lib.MV_Barrier()
        out = np.zeros((R, C), np.float32)
        lib.MV_GetMatrixTableAll(mat, out.ctypes.data_as(fptr), out.size)
        rec["mat"] = out
        uri = str(tmp_path / f"{pkg}_mat.bin").encode()
        assert lib.MV_StoreTable(mat, uri) == 0
        rec["stored"] = np.frombuffer(open(uri, "rb").read(), np.uint8)
        lib.MV_AddMatrixTableAll(mat, whole.ctypes.data_as(fptr), whole.size)
        assert lib.MV_LoadTable(mat, uri) == 0
        lib.MV_GetMatrixTableAll(mat, out.ctypes.data_as(fptr), out.size)
        rec["loaded"] = out.copy()
    finally:
        lib.MV_ShutDown()
        bridge.uninstall()
    return rec


def test_c_abi_bridge_matches_jax(tmp_path):
    lib = tnative.lib()
    if lib is None:
        pytest.skip(f"the native library did not build: "
                    f"{tnative.last_build_error}")
    jrec = _c_abi("jax", lib, tmp_path)
    trec = _c_abi("torch", lib, tmp_path)
    assert trec.pop("port_tables") == ["ArrayWorker", "MatrixWorkerTable"]
    assert jrec.keys() == trec.keys()
    for k in jrec:
        np.testing.assert_array_equal(trec[k], jrec[k], err_msg=k)
    np.testing.assert_array_equal(trec["loaded"], trec["mat"])
