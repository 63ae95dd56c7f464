"""The remote schemes of ``multiverso_tpu_torch/utils/io.py`` against the
JAX package's (``multiverso_tpu/utils/io.py``), on the CPU, through
fsspec's in-process ``memory://`` store (one store per process, so a file
one package writes the other reads).

(a) A checkpoint the port writes to ``memory://`` under ``-use_remote_io``
    loads in the JAX package, and one the JAX package writes loads in the
    port: a Matrix table with AdaGrad aux state, a Matrix table with
    momentum, an Array table and a KV table equal bitwise to the saving
    world (every Store payload and aux leaf; KV pairs by key), the file an
    ``MVTCKPT1`` file.
(b) With the gate shut (flag off, ``MULTIVERSO_USE_REMOTE_IO`` unset) every
    remote scheme raises ``NotImplementedError`` in both packages, with the
    same message, for a stream and for ``MV_SaveCheckpoint``, and nothing
    is written anywhere: no local fallback.
(c) ``MULTIVERSO_USE_REMOTE_IO=1`` opens the gate in both packages with the
    flag off; ``-use_remote_io=true`` given to ``MV_Init`` opens it in the
    port, and ``MV_ShutDown`` shuts it again.
"""

import io
import os

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)


def _pkg(name):
    if name == "jax":
        import multiverso_tpu as mv
        from multiverso_tpu import checkpoint, tables
        from multiverso_tpu.updaters.base import AddOption
        from multiverso_tpu.utils import configure
        from multiverso_tpu.utils import io as sio
        argv = ["-num_workers=2", "-mv_write_combine=0"]
    else:
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch import checkpoint, tables
        from multiverso_tpu_torch.updaters.base import AddOption
        from multiverso_tpu_torch.utils import configure
        from multiverso_tpu_torch.utils import io as sio
        argv = ["-num_workers=2", "-mv_device=cpu"]
    return dict(mv=mv, ckpt=checkpoint, tables=tables, AddOption=AddOption,
                configure=configure, io=sio, argv=argv)


@pytest.fixture
def memory_store(monkeypatch):
    """An empty memory:// store and the environment gate unset."""
    import fsspec
    monkeypatch.delenv("MULTIVERSO_USE_REMOTE_IO", raising=False)
    fs = fsspec.filesystem("memory")
    fs.store.clear()
    fs.pseudo_dirs[:] = [""]
    yield fs
    fs.store.clear()
    fs.pseudo_dirs[:] = [""]


def _tables(p):
    T, mv = p["tables"], p["mv"]
    return [mv.MV_CreateTable(T.MatrixTableOption(
                num_rows=17, num_cols=6, updater_type="adagrad")),
            mv.MV_CreateTable(T.MatrixTableOption(
                num_rows=9, num_cols=3, updater_type="momentum")),
            mv.MV_CreateTable(T.ArrayTableOption(size=23,
                                                 updater_type="sgd")),
            mv.MV_CreateTable(T.KVTableOption())]


def _verbs(p, tabs, seed):
    rng = np.random.default_rng(seed)
    Opt = p["AddOption"]
    ada, mom, arr, kv = tabs
    for step in range(3):
        ids = rng.choice(17, 7, replace=False).astype(np.int32)
        ada.AddRows(ids, rng.standard_normal((7, 6)).astype(np.float32),
                    Opt(worker_id=step % 2, learning_rate=0.5, rho=0.25))
        ids = rng.choice(9, 4, replace=False).astype(np.int32)
        mom.AddRows(ids, rng.integers(-3, 4, (4, 3)).astype(np.float32),
                    Opt(momentum=0.5))
        arr.Add(rng.integers(-4, 5, 23).astype(np.float32))
        keys = rng.choice(30, 5, replace=False).astype(np.int64) - 15
        kv.Add(keys, rng.integers(-3, 4, 5).astype(np.float32))


def _state(p, tabs):
    """Every table's Store payload (KV pairs sorted by key) and aux
    leaves in the logical layout."""
    out = []
    for t in tabs:
        srv = t.server()
        buf = io.BytesIO()
        srv.Store(p["io"].Stream(buf))
        stored = buf.getvalue()
        if type(srv).__name__ == "KVServerTable":
            n = int(np.frombuffer(stored[:8], np.int64)[0])
            keys = np.frombuffer(stored[8: 8 + 8 * n], np.int64)
            vals = np.frombuffer(stored[8 + 8 * n:], np.float32)
            order = np.argsort(keys)
            stored = stored[:8] + keys[order].tobytes() \
                + vals[order].tobytes()
        aux = [(k, np.asarray(srv.aux_to_logical(leaf)))
               for k, leaf in p["ckpt"]._aux_leaves(srv)]
        out.append((stored, aux))
    return out


def _world(p, extra, run):
    p["mv"].MV_Init(list(p["argv"]) + list(extra))
    try:
        return run()
    finally:
        p["mv"].MV_ShutDown()


def _same(got, want, what):
    assert len(got) == len(want)
    for i, ((gs, ga), (ws, wa)) in enumerate(zip(got, want)):
        assert gs == ws, (what, i)
        assert [k for k, _ in ga] == [k for k, _ in wa], (what, i)
        for (k, g), (_, w) in zip(ga, wa):
            assert g.dtype == w.dtype and np.array_equal(g, w), (what, i, k)


def test_memory_checkpoint_crosses_packages(memory_store):
    saved = {}
    for name in ("jax", "torch"):
        p = _pkg(name)
        uri = f"memory://ckpt/{name}.mvt"

        def save(p=p, uri=uri):
            tabs = _tables(p)
            _verbs(p, tabs, 7)
            assert p["mv"].MV_SaveCheckpoint(uri) == len(tabs)
            return _state(p, tabs)

        # the flag through the world's own argv parse
        saved[name] = _world(p, ["-use_remote_io=true"], save)
        raw = memory_store.cat(f"/ckpt/{name}.mvt")
        assert raw[8:16] == b"MVTCKPT1", name
    for name, other in (("torch", "jax"), ("jax", "torch")):
        p = _pkg(name)

        def load(p=p, other=other):
            tabs = _tables(p)
            assert p["mv"].MV_LoadCheckpoint(
                f"memory://ckpt/{other}.mvt") == len(tabs)
            return _state(p, tabs)

        _same(_world(p, ["-use_remote_io=true"], load), saved[other],
              f"{other} file in {name}")
    # the AdaGrad history travelled, not a fresh table's zeros
    assert (saved["torch"][0][1][0][1] > 0).any()


def _raised(fn):
    try:
        fn()
    except Exception as exc:
        return type(exc).__name__, str(exc)
    return None


def test_gate_shut_raises_in_both_packages(memory_store, tmp_path,
                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    jp, tp = _pkg("jax"), _pkg("torch")
    assert tp["io"].REMOTE_SCHEMES == jp["io"].REMOTE_SCHEMES
    for scheme in tp["io"].REMOTE_SCHEMES:
        for mode in ("w", "r"):
            uri = f"{scheme}://bucket/dir/x.mvt"
            got = [_raised(lambda p=p: p["io"].StreamFactory.GetStream(
                uri, mode)) for p in (jp, tp)]
            assert got[0] is not None and got[0][0] == "NotImplementedError"
            assert got[1] == got[0], uri

    def save(p):
        return lambda: _world(p, [], lambda: (
            _tables(p), p["mv"].MV_SaveCheckpoint("memory://ckpt/x.mvt")))

    got = [_raised(save(p)) for p in (jp, tp)]
    assert got[0][0] == "NotImplementedError" and got[1] == got[0], got
    assert not memory_store.store
    assert os.listdir(tmp_path) == []


def test_environment_and_flag_open_the_gate(memory_store, monkeypatch):
    jp, tp = _pkg("jax"), _pkg("torch")
    monkeypatch.setenv("MULTIVERSO_USE_REMOTE_IO", "1")
    for p, name in ((jp, "jax"), (tp, "torch")):
        assert not p["configure"].GetFlag("use_remote_io")
        with p["io"].StreamFactory.GetStream(f"memory://b/{name}",
                                             "w") as s:
            s.WriteInt(-5)
            s.WriteStr(name)
    for p in (jp, tp):
        for name in ("jax", "torch"):
            with p["io"].StreamFactory.GetStream(f"memory://b/{name}",
                                                 "r") as s:
                assert (s.ReadInt(), s.ReadStr()) == (-5, name)
    monkeypatch.delenv("MULTIVERSO_USE_REMOTE_IO")

    def check():
        assert tp["configure"].GetFlag("use_remote_io") is True
        with tp["io"].StreamFactory.GetStream("memory://b/flag", "w") as s:
            s.WriteStr("open")
        return True

    assert _world(tp, ["-use_remote_io=true"], check)
    assert tp["configure"].GetFlag("use_remote_io") is False
    with pytest.raises(NotImplementedError, match="gated off"):
        tp["io"].StreamFactory.GetStream("memory://b/flag", "r")
