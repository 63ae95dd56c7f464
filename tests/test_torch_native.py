"""The port's native bridge (``multiverso_tpu_torch/native.py``) against
the JAX package's native functions (``multiverso_tpu/native``), on the
CPU. Each test skips when the library cannot be built (no C++ compiler).

(a) ``parse_libsvm``: the same arrays as the JAX package's, weighted and
    unweighted, and the same samples as the Python line parser; malformed
    input raises; the library is built under ``build/native_torch/``;
(b) ``VocabTokenizer`` through ``sentences_from_file``: the same sentences
    as the port's Python path and as the JAX package's reader (OOV words
    dropped, empty lines skipped, sentences clipped at
    MAX_SENTENCE_LENGTH, chunk cuts mid-file, a last line without a
    newline);
(c) a KV table on the native index assigns the same slots, values and
    Store bytes as the JAX table and as the port's numpy index, across a
    grow and a Store/Load; sparse LR's first epoch through
    ``_iter_samples_native`` yields the same samples, and trains the same
    weights, as the Python parser.
"""

import io

import numpy as np
import pytest
import torch

from multiverso_tpu_torch import native as tnative
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)


def _require_libs():
    if tnative.lib() is None:
        pytest.skip(f"the native library did not build: "
                    f"{tnative.last_build_error}")
    from multiverso_tpu import native as jnative
    if jnative.lib() is None:
        pytest.skip("the JAX package's native library did not build")
    return jnative


# -- (a) the libsvm parser -----------------------------------------------------

def _libsvm_text(rng, n, weighted):
    lines = []
    for i in range(n):
        head = str(int(rng.integers(0, 3)))
        if weighted and i % 3:
            head += f":{rng.uniform(0.1, 2):.3f}"
        toks = []
        for k in np.sort(rng.choice(1000, int(rng.integers(0, 8)),
                                    replace=False)):
            toks.append(f"{k}" if rng.random() < 0.2
                        else f"{k}:{rng.standard_normal():.5g}")
        lines.append(" ".join([head] + toks))
        if i % 17 == 0:
            lines.append("   ")                       # blank line: skipped
    return ("\n".join(lines) + "\n").encode()


def test_parse_libsvm_matches_jax():
    jnative = _require_libs()
    from multiverso_tpu_torch.models.logreg.data import parse_line
    path = tnative.lib_path()
    assert path.parent.parent == tnative.BUILD_ROOT and path.exists()
    assert tnative.NATIVE_DIR not in path.parents
    # the recipe is native/Makefile's own; the build hash follows the
    # compiler too
    srcs, flags, extra = tnative.makefile_recipe()
    assert {"reader.cc", "kv_index.cc"} <= {s.name for s in srcs}
    assert all(s.exists() for s in srcs)
    assert "-std=c++17" in flags
    assert f"-I{tnative.NATIVE_DIR / 'include'}" in flags
    assert extra == {"host_store.cc": ["-O3", "-ftree-vectorize"]}
    assert tnative.lib_path("another-c++") != path
    rng = np.random.default_rng(3)
    for weighted in (False, True):
        text = _libsvm_text(rng, 200, weighted)
        before = tnative.USES["parse_libsvm"]
        got = tnative.parse_libsvm(text, weighted=weighted)
        assert tnative.USES["parse_libsvm"] == before + 1
        want = jnative.parse_libsvm(text, weighted=weighted)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        labels, weights, offsets, keys, values = got
        rows = [r for r in (parse_line(l, 1000, True, weighted)
                            for l in text.decode().splitlines()) if r]
        assert len(rows) == len(labels) == 200
        for i, (lab, w, k, v) in enumerate(rows):
            lo, hi = offsets[i], offsets[i + 1]
            assert (labels[i], weights[i]) == (lab, np.float32(w))
            np.testing.assert_array_equal(keys[lo:hi], k)
            np.testing.assert_array_equal(values[lo:hi], v)
    for bad in (b"1 abc:2\n", b"xyz 1:2\n", b"1 3:\n"):
        with pytest.raises(ValueError, match="malformed"):
            tnative.parse_libsvm(bad)
        with pytest.raises(ValueError):
            jnative.parse_libsvm(bad)


# -- (b) the vocabulary tokenizer ----------------------------------------------

def _corpus(path, rng):
    words = [f"w{i}" for i in range(40)] + ["café", "naïve"]
    with open(path, "w", encoding="utf-8") as f:
        for i in range(400):
            n = 2500 if i == 7 else int(rng.integers(0, 25))
            toks = list(rng.choice(words, n))
            if i % 50 == 0:                 # rare words: out of the vocab
                toks.insert(len(toks) // 2, f"rare{i}")
            f.write("\t " * (i % 2) + " ".join(toks) + "\n")
        f.write("w1 w2 rare0 w3")               # no newline at the end


def test_vocab_tokenizer_matches_python_and_jax(tmp_path, monkeypatch):
    _require_libs()
    from multiverso_tpu.models.wordembedding import data as jdata
    from multiverso_tpu.models.wordembedding.dictionary import \
        Dictionary as JDictionary
    from multiverso_tpu_torch.models.wordembedding import data as tdata
    from multiverso_tpu_torch.models.wordembedding.dictionary import \
        Dictionary as TDictionary
    path = str(tmp_path / "corpus.txt")
    _corpus(path, np.random.default_rng(4))
    dicts = []
    for cls in (JDictionary, TDictionary):
        d = cls()
        d.build_from_corpus(path)
        d.RemoveWordsLessThan(5)       # the rare words drop out
        dicts.append(d)
    assert dicts[0].words() == dicts[1].words()
    assert len(dicts[1].words()) == 42 and "rare0" not in dicts[1].words()

    def read(module, d):
        return [(s.tolist(), n) for s, n in module.sentences_from_file(
            path, d)]

    # chunk cuts mid-line and mid-file
    monkeypatch.setattr(tdata, "_TOKEN_CHUNK", 777)
    before = tnative.USES["tokenize"]
    native_path = read(tdata, dicts[1])
    assert tnative.USES["tokenize"] > before + 10
    jax_path = read(jdata, dicts[0])
    monkeypatch.setattr(tnative.VocabTokenizer, "create",
                        classmethod(lambda cls, words: None))
    python_path = read(tdata, dicts[1])
    assert native_path == python_path == jax_path
    assert max(n for _, n in native_path) == tdata.MAX_SENTENCE_LENGTH
    assert native_path[-1][0] == [dicts[1].GetWordIdx(w)
                                  for w in ("w1", "w2", "w3")]


# -- (c) the KV slot index and the LR reader -----------------------------------

CAP = 8


def _kv_script(mv, tables, Stream):
    """Adds that grow the table past its capacity, the device-slot verb,
    Store and a Load of the stored bytes into a second table."""
    rng = np.random.default_rng(9)
    rec = {}
    t = mv.MV_CreateTable(tables.KVTableOption(init_capacity=CAP))
    srv = t.server()
    for i in range(6):
        keys = rng.integers(-50, 10 ** 12, 7).astype(np.int64)
        keys[::3] = rng.integers(0, 20, len(keys[::3]))   # repeats
        t.Add(keys, rng.integers(-4, 5, len(keys)).astype(np.float32))
        rec[f"cap{i}"] = np.array([srv.capacity, srv.size])
        rec[f"slots{i}"] = np.asarray(srv.device_slots(keys))
        rec[f"get{i}"] = t.Get(np.append(keys, 10 ** 13))
    new = np.array([10 ** 14, 10 ** 14 + 1, 5], np.int64)
    rec["created"] = np.asarray(srv.device_slots(new, create=True))
    stream = io.BytesIO()
    srv.Store(Stream(stream))
    rec["stored"] = np.frombuffer(stream.getvalue(), np.uint8)
    u = mv.MV_CreateTable(tables.KVTableOption(init_capacity=CAP))
    u.server().Load(Stream(io.BytesIO(stream.getvalue())))
    keys = np.asarray(_stored(rec["stored"])[0], np.int64)
    rec["loaded_slots"] = np.asarray(u.server().device_slots(keys))[
        : len(keys)]
    rec["loaded_get"] = u.Get(keys)
    return rec, [s.server() for s in (t, u)]


def _stored(blob):
    """A KV Store's bytes -> (keys, values) in file order."""
    raw = blob.tobytes()
    n = int(np.frombuffer(raw[:8], np.int64)[0])
    return (np.frombuffer(raw[8: 8 + 8 * n], np.int64).tolist(),
            np.frombuffer(raw[8 + 8 * n:], np.float32).tolist())


def _jax_kv():
    import multiverso_tpu as jmv
    from multiverso_tpu import tables
    from multiverso_tpu.utils.io import Stream
    jmv.MV_Init(["-mv_write_combine=0"])
    try:
        return _kv_script(jmv, tables, Stream)
    finally:
        jmv.MV_ShutDown()


def _port_kv():
    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch import tables
    from multiverso_tpu_torch.utils.io import Stream
    tmv.MV_Init(["-mv_device=cpu"])
    try:
        return _kv_script(tmv, tables, Stream)
    finally:
        tmv.MV_ShutDown()


def test_kv_index_and_lr_reader_match(tmp_path, monkeypatch):
    _require_libs()
    jrec, jsrv = _jax_kv()
    assert all(s._nat_index is not None for s in jsrv)
    before = tnative.USES["kv_index"]
    nrec, nsrv = _port_kv()
    assert tnative.USES["kv_index"] > before
    assert all(s._nat_index is not None and not s._index for s in nsrv)
    with monkeypatch.context() as m:
        m.setattr(tnative.KvIndex, "create",
                  classmethod(lambda cls, cap_hint=1024: None))
        prec, psrv = _port_kv()
    assert all(s._nat_index is None for s in psrv)
    assert jrec["cap5"][0] > CAP                       # it grew
    for key in jrec:
        np.testing.assert_array_equal(nrec[key], prec[key], err_msg=key)
        # the JAX native Store writes its keys in hash order, so what a
        # Load of its bytes reads comes in that order: compared as maps
        if not key.startswith(("stored", "loaded")):
            np.testing.assert_array_equal(nrec[key], jrec[key],
                                          err_msg=key)
    maps = [dict(zip(*_stored(r["stored"]))) for r in (jrec, nrec)]
    assert maps[0] == maps[1]
    keys, vals = _stored(nrec["stored"])
    np.testing.assert_array_equal(nrec["loaded_slots"], np.arange(len(keys)))
    np.testing.assert_array_equal(nrec["loaded_get"], vals)
    _check_lr_reader(tmp_path, monkeypatch)


def _check_lr_reader(tmp_path, monkeypatch):
    from multiverso_tpu_torch.models.logreg import data as ldata
    from multiverso_tpu_torch.models.logreg.configure import Configure
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    rng = np.random.default_rng(6)
    path = tmp_path / "sparse.data"
    path.write_bytes(_libsvm_text(rng, 300, False))
    cfg = Configure(input_size=1000, output_size=1, sparse=True,
                    train_file=str(path), test_file="", output_file="",
                    output_model_file="", objective_type="sigmoid",
                    train_epoch=1, minibatch_size=20, platform="cpu",
                    show_time_per_sample=10 ** 9)
    runs = {}
    for name in ("native", "python"):
        with monkeypatch.context() as m:
            if name == "python":
                m.setattr(tnative, "lib", lambda: None)
            assert (ldata._iter_samples_native(str(path), cfg) is None) \
                == (name == "python")
            before = tnative.USES["parse_libsvm"]
            samples = list(ldata.iter_samples(str(path), cfg))
            app = LogReg(cfg)
            try:
                app.Train()
                weights = app.model.weights()
            finally:
                app.close()
            assert (tnative.USES["parse_libsvm"] > before) \
                == (name == "native")
        runs[name] = samples, weights
    (ns, nw), (ps, pw) = runs["native"], runs["python"]
    assert len(ns) == len(ps) == 300
    for a, b in zip(ns, ps):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_array_equal(nw, pw)
