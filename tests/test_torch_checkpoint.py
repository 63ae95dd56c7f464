"""The port's checkpoint (``multiverso_tpu_torch/checkpoint.py``,
``MV_SaveCheckpoint``/``MV_LoadCheckpoint``) against the JAX package's, on
the CPU.

(a) across packages: the same tables (Matrix with momentum, Matrix with
    AdaGrad, Array with sgd, SparseMatrix, KV) take the same seeded verbs
    in a JAX world (conftest's 8-device CPU mesh) and in a port world;
    a JAX-written checkpoint loads in the port and a port-written one in
    the JAX package with data and every aux leaf equal
    (``np.array_equal``; a KV table's pairs sorted by key, see
    ``_kv_items``), and its Matrix, Array and SparseMatrix frames save
    again as the same bytes; the Matrix (momentum), Array and SparseMatrix
    frames of the two packages' own runs (integer deltas, momentum 0.5:
    exact in both) are equal byte for byte and so are their KV pairs; the
    aux key strings, and their order, are ``jax.tree_util.keystr``'s;
(b) resume is exact: a save right after fire-and-forget Adds, more verbs,
    then a new world (on another engine) loads the file and takes the
    same verbs: every table bitwise equal to the uninterrupted run, the
    AdaGrad history kept;
(c) refusals, each raised as the JAX package raises it (type and
    message): wrong magic, table count, table type, aux leaf shape, dtype
    and name, payload drift; a registered scheme backend; a
    ``write_table_frame``/``read_table_frame`` round trip across packages.
"""

import io

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

WORKERS = 2


def _jax():
    import multiverso_tpu as mv
    from multiverso_tpu import checkpoint, tables
    from multiverso_tpu.updaters.base import AddOption, GetOption
    from multiverso_tpu.utils import io as sio
    return dict(mv=mv, ckpt=checkpoint, tables=tables, AddOption=AddOption,
                GetOption=GetOption, io=sio,
                argv=[f"-num_workers={WORKERS}", "-mv_write_combine=0"])


def _port(*argv):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import checkpoint, tables
    from multiverso_tpu_torch.updaters.base import AddOption, GetOption
    from multiverso_tpu_torch.utils import io as sio
    return dict(mv=mv, ckpt=checkpoint, tables=tables, AddOption=AddOption,
                GetOption=GetOption, io=sio,
                argv=[f"-num_workers={WORKERS}", "-mv_device=cpu", *argv])


def _world(pkg, run):
    pkg["mv"].MV_Init(list(pkg["argv"]))
    try:
        return run()
    finally:
        pkg["mv"].MV_ShutDown()


def _create(pkg):
    T = pkg["tables"]
    mv = pkg["mv"]
    return [mv.MV_CreateTable(T.MatrixTableOption(
                num_rows=13, num_cols=5, updater_type="momentum")),
            mv.MV_CreateTable(T.MatrixTableOption(
                num_rows=11, num_cols=3, updater_type="adagrad")),
            mv.MV_CreateTable(T.ArrayTableOption(size=21,
                                                 updater_type="sgd")),
            mv.MV_CreateTable(T.SparseMatrixTableOption(num_rows=9,
                                                        num_cols=4)),
            mv.MV_CreateTable(T.KVTableOption())]


def _verbs(pkg, tabs, seed, fire_and_forget=False):
    """Seeded Adds on every table; integer deltas (exact but for
    AdaGrad's square roots)."""
    rng = np.random.default_rng(seed)
    Opt = pkg["AddOption"]
    mom, ada, arr, sp, kv = tabs
    for step in range(3):
        w = step % WORKERS
        ids = rng.choice(13, 6, replace=False).astype(np.int32)
        mom.AddRows(ids, rng.integers(-3, 4, (6, 5)).astype(np.float32),
                    Opt(momentum=0.5))
        ids = rng.choice(11, 4, replace=False).astype(np.int32)
        ada.AddRows(ids, rng.integers(-3, 4, (4, 3)).astype(np.float32),
                    Opt(worker_id=w, learning_rate=0.5, rho=0.25))
        delta = rng.integers(-4, 5, 21).astype(np.float32)
        if fire_and_forget:
            arr.AddFireForget(delta)
        else:
            arr.Add(delta)
        ids = rng.choice(9, 3, replace=False).astype(np.int32)
        d = rng.integers(-2, 3, (3, 4)).astype(np.float32)
        if fire_and_forget:
            sp.AddFireForget(d, row_ids=ids)
        else:
            sp.AddRows(ids, d, Opt(worker_id=w))
        keys = rng.choice(40, 5, replace=False).astype(np.int64) - 20
        kv.Add(keys, rng.integers(-3, 4, 5).astype(np.float32))


def _kv_items(stored: bytes) -> bytes:
    """A KV table's Store payload with its (key, value) pairs sorted by
    key: the JAX table on the native index writes its keys in the index's
    iteration order, the port (and the JAX table on its dict index) in
    slot order; a load assigns slot i to the i-th key either way."""
    n = int(np.frombuffer(stored[:8], np.int64)[0])
    keys = np.frombuffer(stored[8: 8 + 8 * n], np.int64)
    vals = np.frombuffer(stored[8 + 8 * n:], np.float32)
    order = np.argsort(keys)
    return stored[:8] + keys[order].tobytes() + vals[order].tobytes()


def _snapshot(pkg, tabs):
    """Every table's data and aux in the logical layout, with the aux key
    strings the checkpoint writes."""
    ckpt = pkg["ckpt"]
    out = []
    for t in tabs:
        srv = t.server()
        buf = io.BytesIO()
        srv.Store(pkg["io"].Stream(buf))
        stored = buf.getvalue()
        if type(srv).__name__ == "KVServerTable":
            stored = _kv_items(stored)
        leaves = [(k, np.asarray(srv.aux_to_logical(leaf)))
                  for k, leaf in ckpt._aux_leaves(srv)]
        out.append((stored, leaves))
    return out


def _frames(pkg, tabs):
    return [pkg["ckpt"].write_table_frame(t.server(), i)
            for i, t in enumerate(tabs)]


def _assert_same_state(got, want, what):
    for i, ((gstore, gaux), (wstore, waux)) in enumerate(zip(got, want)):
        assert gstore == wstore, (what, i)
        assert [k for k, _ in gaux] == [k for k, _ in waux], (what, i)
        for (k, g), (_, w) in zip(gaux, waux):
            assert g.dtype == w.dtype and np.array_equal(g, w), (what, i, k)


def _save(pkg, path, seed):
    def run():
        tabs = _create(pkg)
        _verbs(pkg, tabs, seed)
        assert pkg["mv"].MV_SaveCheckpoint(path) == len(tabs)
        return _snapshot(pkg, tabs), _frames(pkg, tabs)
    return _world(pkg, run)


def _load(pkg, path):
    def run():
        tabs = _create(pkg)
        assert pkg["mv"].MV_LoadCheckpoint(path) == len(tabs)
        return _snapshot(pkg, tabs), _frames(pkg, tabs)
    return _world(pkg, run)


def test_checkpoint_crosses_packages(tmp_path):
    import jax
    jpath, tpath = str(tmp_path / "jax.mvt"), str(tmp_path / "port.mvt")
    jsnap, jframes = _save(_jax(), jpath, 21)
    tsnap, tframes = _save(_port(), tpath, 21)
    # a JAX-written file loads in the port, a port-written one in JAX, and
    # every Matrix, Array and SparseMatrix frame saves again as it came
    for pkg, path, snap, frames, what in (
            (_port(), jpath, jsnap, jframes, "JAX file in the port"),
            (_jax(), tpath, tsnap, tframes, "port file in JAX")):
        got, got_frames = _load(pkg, path)
        _assert_same_state(got, snap, what)
        assert got_frames[:4] == frames[:4], what
    # the two packages' own runs: the same frames but for AdaGrad's
    for i in (0, 2, 3):
        assert tframes[i] == jframes[i], i
    assert tsnap[4] == jsnap[4]
    _, jaux = jsnap[1]
    _, taux = tsnap[1]
    np.testing.assert_allclose(taux[0][1], jaux[0][1], rtol=1e-6)
    # aux key strings and order: jax.tree_util's over the same dicts
    names = [[k for k, _ in leaves] for _, leaves in tsnap]
    assert names == [["['smooth']"], ["['hist']"], [], [], []]
    from multiverso_tpu_torch import checkpoint as tckpt
    aux = {name: np.zeros(1) for name in ("zeta", "alpha", "m", "b_2")}
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(aux)]

    class _T:
        state = {"aux": aux}

    assert [k for k, _ in tckpt._aux_leaves(_T())] == want


def _resume_run(pkg_fn, path, interrupt):
    """Verbs, a save right after fire-and-forget Adds, more verbs; when
    ``interrupt``, a new world on another engine loads the file before
    the last verbs."""
    pkg = pkg_fn()
    pkg["mv"].MV_Init(list(pkg["argv"]))
    try:
        tabs = _create(pkg)
        _verbs(pkg, tabs, 1)
        _verbs(pkg, tabs, 2, fire_and_forget=True)
        if interrupt:
            pkg["mv"].MV_SaveCheckpoint(path)
            _verbs(pkg, tabs, 99)                    # lost at the restart
            pkg["mv"].MV_ShutDown()
            pkg = pkg_fn("-mv_engine_shards=1")
            pkg["mv"].MV_Init(list(pkg["argv"]))
            tabs = _create(pkg)
            pkg["mv"].MV_LoadCheckpoint(path)
        _verbs(pkg, tabs, 3)
        snap = _snapshot(pkg, tabs)
        gets = [tabs[2].Get(), tabs[4].Get(np.arange(-20, 20, dtype=np.int64)),
                tabs[3].Get(pkg["GetOption"](worker_id=-1))[1]]
        engine = type(pkg["mv"].api.Zoo.Get().server_engine).__name__
        return snap, gets, engine
    finally:
        pkg["mv"].MV_ShutDown()


def test_resume_is_exact(tmp_path):
    path = str(tmp_path / "resume.mvt")
    want, want_gets, _ = _resume_run(_port, path, False)
    got, got_gets, engine = _resume_run(_port, path, True)
    assert engine == "Server"
    _assert_same_state(got, want, "resumed")
    for g, w in zip(got_gets, want_gets):
        assert np.array_equal(g, w)
    # AdaGrad's history was kept: it is not what a fresh table would hold
    hist = got[1][1][0][1]
    assert hist.shape == (WORKERS, 11, 3) and (hist > 0).any()


def _refusal(pkg, tmp_path, case):
    """One refused load in ``pkg``; returns (type name, message)."""
    path = str(tmp_path / f"{case}.mvt")
    mv, T, ckpt = pkg["mv"], pkg["tables"], pkg["ckpt"]
    mv.MV_Init(list(pkg["argv"]))
    try:
        arr = mv.MV_CreateTable(T.ArrayTableOption(size=8))
        ada = mv.MV_CreateTable(T.MatrixTableOption(
            num_rows=4, num_cols=2, updater_type="adagrad"))
        mv.MV_SaveCheckpoint(path)
        if case == "magic":
            with open(path, "wb") as f:
                s = pkg["io"].Stream(f)
                s.WriteStr("MVTCKPT0")
                s.WriteInt(2)
        elif case == "count":
            mv.MV_CreateTable(T.ArrayTableOption(size=8))
        elif case == "type":
            mv.MV_ShutDown()
            mv.MV_Init(list(pkg["argv"]))
            mv.MV_CreateTable(T.MatrixTableOption(num_rows=2, num_cols=4))
            mv.MV_CreateTable(T.MatrixTableOption(num_rows=4, num_cols=2))
        elif case == "leaf_shape":
            mv.MV_ShutDown()
            mv.MV_Init([a.replace(f"={WORKERS}", "=3") for a in pkg["argv"]])
            mv.MV_CreateTable(T.ArrayTableOption(size=8))
            mv.MV_CreateTable(T.MatrixTableOption(
                num_rows=4, num_cols=2, updater_type="adagrad"))
        else:
            frame = _forged_frame(pkg, ckpt.write_table_frame(ada.server(), 1),
                                  case)
            return _raised(lambda: ckpt.read_table_frame(ada.server(), frame))
        return _raised(lambda: mv.MV_LoadCheckpoint(path))
    finally:
        mv.MV_ShutDown()


def _forged_frame(pkg, frame, case):
    """A frame with its payload padded (drift) or its one aux leaf's name
    or dtype changed."""
    s = pkg["io"].Stream(io.BytesIO(frame))
    table_id, type_name = s.ReadInt(), s.ReadStr()
    payload = s.Read(s.ReadInt())
    assert s.ReadInt() == 1
    key, dtype = s.ReadStr(), s.ReadStr()
    shape = [s.ReadInt() for _ in range(s.ReadInt())]
    raw = s._f.read()
    if case == "drift":
        payload += b"\0" * 8
    elif case == "leaf_name":
        key = "['history']"
    elif case == "leaf_dtype":
        dtype, raw = "int32", np.frombuffer(raw, np.float32).astype(
            np.int32).tobytes()
    out = pkg["io"].Stream(io.BytesIO())
    out.WriteInt(table_id)
    out.WriteStr(type_name)
    out.WriteInt(len(payload))
    out.Write(payload)
    out.WriteInt(1)
    out.WriteStr(key)
    out.WriteStr(dtype)
    out.WriteInt(len(shape))
    for d in shape:
        out.WriteInt(d)
    out.Write(raw)
    return out._f.getvalue()


def _raised(fn):
    try:
        fn()
    except Exception as exc:
        return type(exc).__name__, str(exc)
    return None


def test_refusals_schemes_and_frames_match_jax(tmp_path):
    cases = ("magic", "count", "type", "leaf_shape", "drift", "leaf_name",
             "leaf_dtype")
    for case in cases:
        want = _refusal(_jax(), tmp_path / "jax", case)
        got = _refusal(_port(), tmp_path / "port", case)
        assert want is not None and got == want, (case, got, want)
    # a registered scheme backend holds a checkpoint; an unknown one raises
    from multiverso_tpu_torch.utils.io import (URI, Stream, StreamFactory)
    store = {}

    class _Blob(io.BytesIO):
        def __init__(self, key, data=b""):
            super().__init__(data)
            self.key = key

        def close(self):
            store[self.key] = self.getvalue()
            super().close()

    def backend(uri, mode):
        key = uri.host + uri.path
        blob = _Blob(key, b"" if mode == "w" else store[key])
        return Stream(blob, uri.name())

    StreamFactory.RegisterSchemeBackend("memtest", backend)
    assert URI("memtest://bucket/a/b").path == "/a/b"
    pkg = _port()

    def run():
        tabs = _create(pkg)
        _verbs(pkg, tabs, 5)
        want = _snapshot(pkg, tabs)
        assert pkg["mv"].MV_SaveCheckpoint("memtest://bucket/ck") == 5
        _verbs(pkg, tabs, 6)
        assert pkg["mv"].MV_LoadCheckpoint("memtest://bucket/ck") == 5
        _assert_same_state(_snapshot(pkg, tabs), want, "scheme")
        with pytest.raises(NotImplementedError, match="no stream backend"):
            pkg["mv"].MV_SaveCheckpoint("nosuch://x/y")
        return _frames(pkg, tabs), want

    frames, want = _world(pkg, run)
    assert store["bucket/ck"][8:16] == b"MVTCKPT1"
    # a port frame restores a JAX table, whose frame is then the same bytes
    jpkg = _jax()

    def jrun():
        tabs = _create(jpkg)
        for t, frame in zip(tabs, frames):
            jpkg["ckpt"].read_table_frame(t.server(), frame)
        return _frames(jpkg, tabs), _snapshot(jpkg, tabs)

    jframes, jsnap = _world(jpkg, jrun)
    assert jframes[:4] == frames[:4]
    _assert_same_state(jsnap, want, "frames into JAX")
