"""Serve the repo's native C ABI from the port's tables.

Counterpart of ``multiverso_tpu/binding/native_bridge.py``. The reference's
``src/c_api.cpp:1-93`` wraps its real runtime, so every foreign binding
(Lua FFI ``binding/lua/init.lua:16-27``, C# P/Invoke, raw C) reaches the
parameter server. This bridge installs an ``MV_BackendVTable``
(native/include/mvt/c_api.h:29-46) into the port's own build of
``libmultiverso_tpu.so`` (``multiverso_tpu_torch.native.lib()``, built
under ``build/native_torch/``): every ``MV_*`` table verb a native caller
in this process invokes then reaches the port's tables, on the card unless
the world was brought up on the CPU. Without an installed backend the
library serves its own native CPU store.

Usage (embedding host process)::

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.binding import native_bridge
    mv.MV_Init(["-num_workers=2"])
    bridge = native_bridge.install()     # native callers now reach the card
    ...  # native code calls MV_* as usual
    bridge.uninstall()
    mv.MV_ShutDown()

Installed before any world exists, the first native ``MV_Init`` brings up
the port's world (its argv forwarded as flags) and the matching native
``MV_ShutDown`` tears it down.

The verbs: ``MV_NewArrayTable``/``MV_NewMatrixTable`` create an Array or a
Matrix table; ``Get``/``Add``/``AddAsync`` run on whole tables and by rows,
the async form as ``AddFireForget`` (so consecutive async pushes combine on
the worker, ``-mv_write_combine``); the caller thread's
``MV_SetThreadAddOption`` values become the ``AddOption`` and its
``MV_SetThreadWorkerId`` the worker context; ``MV_StoreTable`` and
``MV_LoadTable`` serialize at an engine cut and move the bytes through
``utils/io.py`` on the caller's thread. A callback that raises logs the
traceback and returns a non-zero code to the C side, which fails its
check: an error, never a fallback. ``install`` also declares the C ABI's
ctypes signatures on the library (``declare_c_abi``) for callers in
Python.
"""

from __future__ import annotations

import ctypes
import io as _io
import threading
import traceback
from typing import Dict, Optional

import numpy as np

from multiverso_tpu_torch.utils.log import Log

# the callback types: the one source of the vtable layout (the field order
# below and the callbacks install() builds both use these)
INIT_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_char_p))
VOID_FN = ctypes.CFUNCTYPE(ctypes.c_int)
NEW_TABLE_FN = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int32)
GET_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int64,
                          ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                          ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                          ctypes.c_int32)
ADD_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int64,
                          ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                          ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                          ctypes.c_int32, ctypes.c_int32,
                          ctypes.POINTER(ctypes.c_float))
URI_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int64, ctypes.c_char_p)


class MV_BackendVTable(ctypes.Structure):
    """Mirror of the C struct (native/include/mvt/c_api.h)."""

    _fields_ = [
        ("init", INIT_FN),
        ("shutdown", VOID_FN),
        ("barrier", VOID_FN),
        ("num_workers", VOID_FN),
        ("new_table", NEW_TABLE_FN),
        ("get", GET_FN),
        ("add", ADD_FN),
        ("store", URI_FN),
        ("load", URI_FN),
    ]


def declare_c_abi(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of the C ABI's world and
    table verbs (native/include/mvt/c_api.h) on ``lib``, so a ctypes caller
    passes checked pointers and ints; returns ``lib``."""
    i, vp = ctypes.c_int, ctypes.c_void_p
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    sigs = {
        "MV_Init": ([ip, ctypes.POINTER(ctypes.c_char_p)], None),
        "MV_ShutDown": ([], None), "MV_Barrier": ([], None),
        "MV_NumWorkers": ([], i), "MV_WorkerId": ([], i),
        "MV_ServerId": ([], i), "MV_HasBackend": ([], i),
        "MV_NewArrayTable": ([i, ctypes.POINTER(vp)], None),
        "MV_GetArrayTable": ([vp, fp, i], None),
        "MV_AddArrayTable": ([vp, fp, i], None),
        "MV_AddAsyncArrayTable": ([vp, fp, i], None),
        "MV_NewMatrixTable": ([i, i, ctypes.POINTER(vp)], None),
        "MV_GetMatrixTableAll": ([vp, fp, i], None),
        "MV_AddMatrixTableAll": ([vp, fp, i], None),
        "MV_AddAsyncMatrixTableAll": ([vp, fp, i], None),
        "MV_GetMatrixTableByRows": ([vp, fp, i, ip, i], None),
        "MV_AddMatrixTableByRows": ([vp, fp, i, ip, i], None),
        "MV_AddAsyncMatrixTableByRows": ([vp, fp, i, ip, i], None),
        "MV_SetThreadWorkerId": ([i], None),
        "MV_SetThreadAddOption": ([ctypes.c_float] * 4, None),
        "MV_StoreTable": ([vp, ctypes.c_char_p], i),
        "MV_LoadTable": ([vp, ctypes.c_char_p], i),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


class _Entry:
    __slots__ = ("worker", "server", "rows", "cols", "is_array")

    def __init__(self, worker, server, rows: int, cols: int, is_array: bool):
        self.worker = worker
        self.server = server
        self.rows = rows
        self.cols = cols
        self.is_array = is_array


class NativeBridge:
    """Holds the installed vtable and keeps its callbacks alive."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._tables: Dict[int, _Entry] = {}
        self._tables_lock = threading.Lock()     # id allocation only
        self._owns_world = False
        self._vtable: Optional[MV_BackendVTable] = None

    # -- callback bodies (no exception crosses the FFI) -----------------------

    def _guard(self, fn, *args, err=-1):
        try:
            return fn(*args)
        except Exception:  # noqa: BLE001 - the FFI boundary
            Log.Error("native_bridge: %s", traceback.format_exc())
            return err

    def _init(self, argc, argv) -> int:
        import multiverso_tpu_torch as core
        from multiverso_tpu_torch.zoo import Zoo
        if Zoo.Get().started:
            return 0        # the embedding host already owns the world
        args = []
        if argc and argv:
            args = [argv[i].decode() for i in range(1, argc[0])
                    if argv[i] is not None]
        core.MV_Init(args)
        self._owns_world = True
        return 0

    def _shutdown(self) -> int:
        import multiverso_tpu_torch as core
        if self._owns_world:
            core.MV_ShutDown()
            self._owns_world = False
        self._tables.clear()
        return 0

    def _barrier(self) -> int:
        # the native ABI's MV_Barrier is a drain ping (happens-before for
        # the ops submitted, callable from any one thread), not the
        # worker-thread rendezvous of MV_Barrier, which would deadlock a
        # lone native caller in a world of several workers
        from multiverso_tpu_torch.zoo import Zoo
        Zoo.Get().DrainServer()
        return 0

    def _num_workers(self) -> int:
        import multiverso_tpu_torch as core
        return core.MV_NumWorkers()

    def _new_table(self, rows: int, cols: int, is_array: int) -> int:
        import multiverso_tpu_torch as core
        from multiverso_tpu_torch.tables import (ArrayTableOption,
                                                 MatrixTableOption)
        from multiverso_tpu_torch.zoo import Zoo
        if is_array:       # MV_NewArrayTable; a 1 x N MATRIX keeps row verbs
            worker = core.MV_CreateTable(ArrayTableOption(size=int(cols)))
        else:
            worker = core.MV_CreateTable(
                MatrixTableOption(num_rows=int(rows), num_cols=int(cols)))
        server = Zoo.Get().server_tables[worker.table_id]
        with self._tables_lock:
            bid = len(self._tables)
            self._tables[bid] = _Entry(worker, server, int(rows), int(cols),
                                       bool(is_array))
        return bid

    @staticmethod
    def _ids(row_ids, n_rows) -> Optional[np.ndarray]:
        if not row_ids or n_rows == 0:
            return None
        return np.ctypeslib.as_array(row_ids, shape=(n_rows,)).astype(
            np.int32)          # a copy: the caller owns its buffer

    def _get(self, table, row_ids, n_rows, out, n_floats, worker_id) -> int:
        from multiverso_tpu_torch.zoo import Zoo
        entry = self._tables[table]
        ids = self._ids(row_ids, n_rows)
        with Zoo.Get().worker_context(worker_id):
            if ids is None:
                result = entry.worker.Get()
            else:
                result = entry.worker.GetRows(ids)
        flat = np.ascontiguousarray(result, np.float32).reshape(-1)
        if flat.size != n_floats:
            raise ValueError(f"get size mismatch: the result has "
                             f"{flat.size} floats, the caller's buffer "
                             f"{n_floats}")
        ctypes.memmove(out, flat.ctypes.data, flat.size * 4)
        return 0

    def _add(self, table, row_ids, n_rows, data, n_floats, is_async,
             worker_id, add_opt) -> int:
        from multiverso_tpu_torch.updaters.base import AddOption
        from multiverso_tpu_torch.zoo import Zoo
        entry = self._tables[table]
        ids = self._ids(row_ids, n_rows)
        # a copy: an async caller may reuse its buffer once we return
        values = np.ctypeslib.as_array(data, shape=(int(n_floats),)).copy()
        # {momentum, lr, rho, lambda} of MV_SetThreadAddOption; never NULL
        # by the c_api contract
        if not add_opt:
            raise ValueError("add_opt must not be NULL (c_api.h contract)")
        opt = AddOption(worker_id=int(worker_id), momentum=add_opt[0],
                        learning_rate=add_opt[1], rho=add_opt[2],
                        lambda_=add_opt[3])
        with Zoo.Get().worker_context(worker_id):
            if ids is None:
                if values.size != entry.rows * entry.cols:
                    raise ValueError("add size mismatch")
                if not entry.is_array:
                    values = values.reshape(entry.rows, entry.cols)
                if is_async:
                    entry.worker.AddFireForget(values, option=opt)
                else:
                    entry.worker.Add(values, option=opt)
            else:
                values = values.reshape(len(ids), entry.cols)
                if is_async:
                    entry.worker.AddFireForget(values, row_ids=ids,
                                               option=opt)
                else:
                    entry.worker.AddRows(ids, values, option=opt)
        return 0

    def _store_load(self, table, uri: bytes, store: bool) -> int:
        from multiverso_tpu_torch.message import MsgType
        from multiverso_tpu_torch.utils.io import Stream, StreamFactory
        from multiverso_tpu_torch.zoo import Zoo
        entry = self._tables[table]
        name = uri.decode()

        # the (de)serialization runs at an engine cut (Zoo.CallOnEngine),
        # ordered against every Add admitted before it; the URI's IO
        # stays on this thread
        def submit(fn):
            Zoo.Get().CallOnEngine(MsgType.Request_StoreLoad, fn,
                                   f"native store/load of table {table}")

        if store:
            buf = _io.BytesIO()
            submit(lambda: entry.server.Store(Stream(buf, name)))
            with StreamFactory.GetStream(name, "wb") as s:
                s.Write(buf.getbuffer())
        else:
            with StreamFactory.GetStream(name, "rb") as s:
                raw = s.Read(-1)
            submit(lambda: entry.server.Load(Stream(_io.BytesIO(raw), name)))
        return 0

    # -- install / uninstall --------------------------------------------------

    def install(self) -> "NativeBridge":
        g = self._guard
        self._vtable = MV_BackendVTable(
            init=INIT_FN(lambda argc, argv: g(self._init, argc, argv)),
            shutdown=VOID_FN(lambda: g(self._shutdown)),
            barrier=VOID_FN(lambda: g(self._barrier)),
            # a NEGATIVE error: 1 would read as a one-worker world
            num_workers=VOID_FN(lambda: g(self._num_workers, err=-1)),
            new_table=NEW_TABLE_FN(
                lambda r, c, a: g(self._new_table, r, c, a)),
            get=GET_FN(lambda t, ids, n, out, nf, w:
                       g(self._get, t, ids, n, out, nf, w)),
            add=ADD_FN(lambda t, ids, n, d, nf, a, w, o:
                       g(self._add, t, ids, n, d, nf, a, w, o)),
            store=URI_FN(lambda t, uri: g(self._store_load, t, uri, True)),
            load=URI_FN(lambda t, uri: g(self._store_load, t, uri, False)),
        )
        self._lib.MV_RegisterBackend.restype = ctypes.c_int
        self._lib.MV_RegisterBackend.argtypes = [
            ctypes.POINTER(MV_BackendVTable)]
        declare_c_abi(self._lib)
        rc = self._lib.MV_RegisterBackend(ctypes.byref(self._vtable))
        if rc != 0:
            raise RuntimeError("MV_RegisterBackend failed (world live?)")
        return self

    def uninstall(self) -> None:
        if self._vtable is None:
            return
        rc = self._lib.MV_RegisterBackend(None)
        if rc != 0:
            raise RuntimeError("cannot uninstall: native world still live")
        self._vtable = None
        self._tables.clear()


def install(lib: Optional[ctypes.CDLL] = None) -> NativeBridge:
    """Install the port's backend into its build of the native library
    (built on demand). Returns the bridge; keep it alive while native code
    runs. Raises when the library cannot be built."""
    if lib is None:
        from multiverso_tpu_torch import native
        lib = native.lib()
        if lib is None:
            raise RuntimeError(f"the native library did not build: "
                               f"{native.last_build_error}")
    return NativeBridge(lib).install()
