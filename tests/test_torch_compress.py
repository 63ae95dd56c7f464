"""The port's compressed row wire (``compress="sparse"|"1bit"``) against
the JAX package's, on the CPU.

(a) the filters of ``utils/quantization.py`` against
    ``multiverso_tpu.utils.quantization`` on seeded inputs, bitwise:
    ``SparseFilter`` (sparse and dense outcomes, a clip), ``RowOneBitsFilter``
    over 12 pushes of overlapping row sets (the residual carries, its slot
    buffer grows past 64 rows) and ``OneBitsFilter`` over 5 pushes;
(b) one seeded verb script through both packages' Matrix and SparseMatrix
    tables (``tests/test_tables.py::TestWireCompression``'s cases): sparse
    payloads and the dense fallback on add, sgd and momentum tables beside
    uncompressed twins, duplicate ids, a batch whose pad lanes reach the
    trash row, fire-and-forget bursts (the engine's merged window declines
    them), async handles, 1-bit error feedback over 40 pushes, invalid ids
    (an error at the caller's Wait, the residual untouched), and a
    SparseMatrix table's freshness under compressed Adds of 3 workers. The
    sparse tables equal their uncompressed twins and the JAX tables
    bitwise (momentum: the port's own twin bitwise, JAX to rtol 1e-6 as in
    tests/test_torch_tables.py), the 1-bit tables the JAX ones to rtol
    1e-6, ``wire_stats`` exactly; Array and KV tables refuse ``compress``
    in both packages. Then the port alone: 3 worker threads pushing
    overlapping rows through one table's shared 1-bit residual lose no
    update (applied + residual == the pushed sum, rtol 1e-4: float32 sums
    in another order), and the server rebuilds the dense rows from the
    payload's tensors on the table's device and decodes nothing on the
    host;
(c) LogisticRegression sparse sigmoid on the PS host plane with
    ``compress=sparse`` and ``compress=1bit`` in both packages: final
    weights to rtol 1e-5, atol 1e-6, the loss of each epoch to the same
    tolerance, and ``sparse`` bitwise equal to the port's uncompressed
    run.
"""

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

WORKERS = 3


# -- (a) the filters ----------------------------------------------------------

def test_filters_match_jax():
    from multiverso_tpu.utils import quantization as jq
    from multiverso_tpu_torch.utils import quantization as tq
    rng = np.random.default_rng(5)
    for clip, zero_share in ((0.0, 0.8), (0.0, 0.3), (0.5, 0.2)):
        dense = rng.standard_normal((17, 9)).astype(np.float32)
        dense[rng.random(dense.shape) < zero_share] = 0.0
        want, got = (q.SparseFilter(clip).compress(dense) for q in (jq, tq))
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        size = dense.size
        np.testing.assert_array_equal(
            tq.SparseFilter().decompress(*got, size),
            jq.SparseFilter().decompress(*want, size))
    rows, cols = 300, 7
    jrow, trow = jq.RowOneBitsFilter(rows, cols), tq.RowOneBitsFilter(rows,
                                                                      cols)
    for push in range(12):
        ids = rng.choice(rows, int(rng.integers(5, 90)), replace=False)
        deltas = rng.standard_normal((len(ids), cols)).astype(np.float32)
        bucket = len(ids) + int(rng.integers(0, 9))
        want = jrow.compress(ids, deltas, bucket)
        got = trow.compress(ids, deltas, bucket)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), push
    assert trow._slot == jrow._slot and len(trow._slot) > 64
    np.testing.assert_array_equal(trow._buf, jrow._buf)
    jone, tone = jq.OneBitsFilter(), tq.OneBitsFilter()
    for _ in range(5):
        x = rng.standard_normal(131).astype(np.float32)
        want, got = jone.compress(x), tone.compress(x)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
        np.testing.assert_array_equal(tone.decompress(*got, x.size),
                                      jone.decompress(*want, x.size))
    np.testing.assert_array_equal(tone._residual, jone._residual)
    with pytest.raises(ValueError):
        tone.compress(np.ones(3, np.float32))


# -- (b) the tables -----------------------------------------------------------

def _jax_world(run):
    import multiverso_tpu as jmv
    jmv.MV_Init([f"-num_workers={WORKERS}", "-mv_write_combine=0"])
    try:
        import multiverso_tpu.tables as tables
        from multiverso_tpu.updaters.base import AddOption, GetOption
        return run(jmv, tables, AddOption, GetOption)
    finally:
        jmv.MV_ShutDown()


def _port_world(run):
    import multiverso_tpu_torch as tmv
    tmv.MV_Init([f"-num_workers={WORKERS}", "-mv_device=cpu"])
    try:
        import multiverso_tpu_torch.tables as tables
        from multiverso_tpu_torch.updaters.base import AddOption, GetOption
        return run(tmv, tables, AddOption, GetOption)
    finally:
        tmv.MV_ShutDown()


def _sparse_batch(rng, rows, n, cols, zero_share):
    ids = rng.choice(rows, n, replace=False).astype(np.int32)
    deltas = rng.standard_normal((n, cols)).astype(np.float32)
    deltas[rng.random((n, cols)) < zero_share] = 0.0
    return ids, deltas


def _raises(fn) -> str:
    try:
        fn()
    except Exception as exc:        # both packages' FatalError, by name
        return type(exc).__name__
    return "no error"


def _wire_script(mv, tables, AddOption, GetOption):
    rng = np.random.default_rng(9)
    M = tables.MatrixTableOption
    rec = {}
    tabs = {name: mv.MV_CreateTable(M(num_rows=200, num_cols=8,
                                      updater_type=u, compress=c))
            for name, u, c in (("add", None, None),
                               ("add_sparse", None, "sparse"),
                               ("sgd", "sgd", None),
                               ("sgd_sparse", "sgd", "sparse"),
                               ("mom", "momentum", None),
                               ("mom_sparse", "momentum", "sparse"))}
    mopt = AddOption(momentum=0.5)
    for step in range(5):
        sparse = _sparse_batch(rng, 200, 30, 8, 0.8)
        dense = _sparse_batch(rng, 200, 10, 8, 0.0)   # the dense fallback
        for ids, deltas in (sparse, dense):
            for name, t in tabs.items():
                t.AddRows(ids, deltas, mopt if "mom" in name else None)
        # an async handle and a batch of 3 ids (pad lanes of its bucket)
        ids, deltas = _sparse_batch(rng, 200, 3, 8, 0.9)
        for name, t in tabs.items():
            t.Wait(t.AddAsyncHandle(deltas, ids,
                                    mopt if "mom" in name else None))
    # duplicate ids combine before they are compressed
    dup = np.array([3, 7, 3], np.int32)
    d = np.zeros((3, 8), np.float32)
    d[0, 1], d[2, 1], d[1, 3] = 1.0, 2.0, 5.0
    for name in ("add", "add_sparse"):
        tabs[name].AddRows(dup, d)
    # fire-and-forget bursts: the merged window declines compressed Adds
    for _ in range(6):
        ids, deltas = _sparse_batch(rng, 200, 16, 8, 0.9)
        for name in ("add", "add_sparse", "sgd", "sgd_sparse"):
            tabs[name].AddFireForget(deltas, row_ids=ids)
    for name, t in tabs.items():
        rec[name] = t.Get()
        rec[f"{name}/rows"] = t.GetRows(np.array([3, 7, 199], np.int32))
        rec[f"{name}/wire"] = dict(t.server().wire_stats)
    rec["bad_ids"] = _raises(lambda: tabs["add_sparse"].AddRows(
        np.array([-1, 5], np.int32), d[:2]))
    # 1-bit error feedback: 40 pushes of one delta, then subsets
    onebit = mv.MV_CreateTable(M(num_rows=32, num_cols=64, compress="1bit"))
    ids = np.arange(32, dtype=np.int32)
    true_delta = rng.standard_normal((32, 64)).astype(np.float32)
    for _ in range(40):
        onebit.AddRows(ids, true_delta)
    rec["1bit/after40"] = onebit.Get()
    for _ in range(4):
        sub = np.sort(rng.choice(32, 11, replace=False)).astype(np.int32)
        onebit.AddFireForget(true_delta[sub] * 0.5, row_ids=sub)
    rec["1bit/bad_ids"] = _raises(lambda: onebit.AddRows(
        np.array([0, 32], np.int32), true_delta[:2]))
    onebit.AddRows(ids, true_delta)     # the residual was left alone
    rec["1bit"] = onebit.Get()
    rec["1bit/wire"] = dict(onebit.server().wire_stats)
    # SparseMatrix: freshness under compressed Adds of 3 workers
    sp = mv.MV_CreateTable(tables.SparseMatrixTableOption(
        num_rows=40, num_cols=8, compress="sparse"))
    for step in range(6):
        w = step % WORKERS
        ids, deltas = _sparse_batch(rng, 40, 6, 8, 0.8)
        sp.AddRows(ids, deltas, AddOption(worker_id=w))
        out_ids, rows = sp.Get(GetOption(worker_id=(w + 1) % WORKERS))
        rec[f"sparse_matrix/{step}"] = (np.asarray(out_ids), rows)
    rec["sparse_matrix/wire"] = dict(sp.server().wire_stats)
    rec["array_refused"] = _raises(lambda: mv.MV_CreateTable(
        tables.ArrayTableOption(size=8, compress="sparse")))
    rec["kv_refused"] = _raises(lambda: mv.MV_CreateTable(
        tables.KVTableOption(compress="1bit")))
    return rec


def test_compressed_adds_match_jax(monkeypatch):
    want = _jax_world(_wire_script)
    got = _port_world(_wire_script)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key.startswith("sparse_matrix/") and key != "sparse_matrix/wire":
            assert np.array_equal(g[0], w[0]), key
            assert np.array_equal(g[1], w[1]), key
        elif isinstance(w, np.ndarray) and key.startswith(("1bit", "mom")):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        elif isinstance(w, np.ndarray):
            assert np.array_equal(g, w), key
        else:
            assert g == w, (key, g, w)
    for name in ("add", "sgd", "mom"):
        assert np.array_equal(got[f"{name}_sparse"], got[name]), name
        wire = got[f"{name}_sparse/wire"]
        assert 0 < wire["payload_bytes"] < wire["dense_bytes"], name
    assert got["bad_ids"] == got["1bit/bad_ids"] == "FatalError"
    assert got["array_refused"] == got["kv_refused"] == "FatalError"
    w1 = got["1bit/wire"]
    assert 0 < w1["payload_bytes"] * 8 < w1["dense_bytes"]
    _check_threaded_onebit()
    _check_rebuilt_on_device(monkeypatch)


def _check_threaded_onebit():
    """Worker threads share one table's 1-bit residual: with pushes of
    overlapping rows interleaved at a short switch interval, what the
    table applied plus what the residual holds is still the sum of every
    pushed delta (a lost residual update would break it)."""
    import sys
    import threading
    from multiverso_tpu_torch.zoo import Zoo
    rows, cols, pushes = 40, 16, 30

    def run(mv, tables, AddOption, GetOption):
        t = mv.MV_CreateTable(tables.MatrixTableOption(
            num_rows=rows, num_cols=cols, compress="1bit"))
        sums = [np.zeros((rows, cols), np.float64) for _ in range(WORKERS)]

        def worker(w):
            rng = np.random.default_rng([7, w])
            with Zoo.Get().worker_context(w):
                for _ in range(pushes):
                    ids = rng.choice(rows, 12, replace=False).astype(np.int32)
                    d = rng.standard_normal((12, cols)).astype(np.float32)
                    t.AddFireForget(d, row_ids=ids)
                    sums[w][ids] += d

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(w,))
                       for w in range(WORKERS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
        finally:
            sys.setswitchinterval(old)
        assert not any(th.is_alive() for th in threads)
        residual = np.zeros((rows, cols), np.float32)
        f = t._onebit
        for r, slot in f._slot.items():
            residual[r] = f._buf[slot]
        return t.Get() + residual, sum(sums)

    applied, pushed = _port_world(run)
    np.testing.assert_allclose(applied, pushed, rtol=1e-4, atol=1e-4)


def _check_rebuilt_on_device(monkeypatch):
    """The server rebuilds a compressed payload's rows from tensors on the
    table's device: numpy's unpack and the filters' host decoders are
    never called, and the row update receives a device tensor."""
    from multiverso_tpu_torch.tables import matrix_table
    from multiverso_tpu_torch.utils import quantization as tq

    def host_decode(*a, **k):
        raise AssertionError("a compressed payload was decoded on the host")

    monkeypatch.setattr(np, "unpackbits", host_decode)
    monkeypatch.setattr(tq.SparseFilter, "decompress", host_decode)
    monkeypatch.setattr(tq.OneBitsFilter, "decompress", host_decode)
    seen = []
    orig = matrix_table.MatrixServerTable._update_rows

    def spy(self, ids, deltas, opt):
        seen.append(deltas)
        return orig(self, ids, deltas, opt)

    monkeypatch.setattr(matrix_table.MatrixServerTable, "_update_rows", spy)

    def run(mv, tables, AddOption, GetOption):
        rng = np.random.default_rng(3)
        out = {}
        for mode in ("sparse", "1bit"):
            t = mv.MV_CreateTable(tables.MatrixTableOption(
                num_rows=50, num_cols=6, compress=mode))
            ids, deltas = _sparse_batch(rng, 50, 9, 6, 0.8)
            t.AddRows(ids, deltas)
            out[mode] = (t.server().device, t.GetRows(ids), deltas)
        return out

    out = _port_world(run)
    assert len(seen) == 2
    for deltas, (mode, (device, rows, sent)) in zip(seen, out.items()):
        assert isinstance(deltas, torch.Tensor) and deltas.device == device
        if mode == "sparse":
            np.testing.assert_array_equal(rows, sent)


# -- (c) LogisticRegression ---------------------------------------------------

N_IN, N_SAMPLES = 50, 200


@pytest.fixture(scope="module")
def sparse_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("lr_compress")
    rng = np.random.default_rng(2)
    X = rng.normal(size=(N_SAMPLES, N_IN)).astype(np.float32)
    X[rng.random(X.shape) < 0.7] = 0
    y = (X @ rng.normal(size=N_IN) > 0).astype(int)
    path = d / "sparse.data"
    with open(path, "w") as f:
        for row, lab in zip(X, y):
            nz = np.nonzero(row)[0]
            f.write(f"{lab} " + " ".join(f"{k}:{row[k]:.5f}" for k in nz)
                    + "\n")
    return str(path)


def _lr_config(cls, path, compress, **kw):
    cfg = cls()
    cfg.train_file = path
    cfg.test_file = cfg.output_file = cfg.output_model_file = ""
    cfg.input_size, cfg.output_size = N_IN, 1
    cfg.sparse, cfg.use_ps, cfg.pipeline = True, True, False
    cfg.objective_type, cfg.updater_type = "sigmoid", "sgd"
    cfg.learning_rate, cfg.regular_type, cfg.regular_coef = 0.5, "L2", 0.001
    cfg.train_epoch, cfg.sync_frequency = 3, 5
    cfg.show_time_per_sample = 10 ** 9
    cfg.compress = compress
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


class _EpochLines:
    """Stands in for the JAX ``logreg`` module's ``Log``: keeps the epoch
    lines' average loss."""

    def __init__(self):
        self.losses = []

    def Info(self, fmt, *args):
        if fmt.startswith("[logreg] epoch %d done"):
            self.losses.append(float(args[2]))

    def Error(self, fmt, *args):
        pass

    Debug = Error


def _jax_lr(path, compress, monkeypatch):
    import multiverso_tpu as jmv
    from multiverso_tpu.models.logreg import logreg as jlogreg
    lines = _EpochLines()
    monkeypatch.setattr(jlogreg, "Log", lines)
    jmv.MV_Init(["-mv_write_combine=0"])
    try:
        app = jlogreg.LogReg(_lr_config(jlogreg.Configure, path, compress))
        try:
            app.Train()
            W = app.model.weights().copy()
        finally:
            app.close()
    finally:
        jmv.MV_ShutDown()
    return W, lines.losses


def _port_lr(path, compress):
    from multiverso_tpu_torch.models.logreg.configure import Configure
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    app = LogReg(_lr_config(Configure, path, compress, platform="cpu"))
    try:
        app.Train()
        W = app.model.weights().copy()
        wire = dict(app.model.table.server().wire_stats)
    finally:
        app.close()
    return W, [loss for _, loss, _ in app.epoch_log], wire


def test_lr_compressed_matches_jax(sparse_data, monkeypatch):
    plain_W, plain_losses, _ = _port_lr(sparse_data, "")
    for mode in ("sparse", "1bit"):
        jW, jlosses = _jax_lr(sparse_data, mode, monkeypatch)
        tW, tlosses, wire = _port_lr(sparse_data, mode)
        np.testing.assert_allclose(tW, jW, rtol=1e-5, atol=1e-6,
                                   err_msg=mode)
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-6,
                                   err_msg=mode)
        assert len(tlosses) == 3 and tlosses[-1] < tlosses[0], mode
        if mode == "sparse":
            # a row of one output is a single nonzero: the dense fallback
            assert np.array_equal(tW, plain_W)
            assert tlosses == plain_losses
        else:
            assert wire["payload_bytes"] > 0
