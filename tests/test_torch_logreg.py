"""The port's LogisticRegression against the JAX package's.

(a) the objective functions on one seeded minibatch, against
    ``multiverso_tpu.models.logreg.objective``: dense sigmoid and softmax
    in float32 and bfloat16 compute, sparse sigmoid and softmax, FTRL
    weights and deltas, and the device plane's whole-window sparse delta
    against the per-batch sum; rtol 1e-5, atol 1e-6 (the port sums in
    another order than XLA);
(b) the whole app in both packages on the same files (50 features, 200
    samples, 2 epochs) in the five modes local dense, PS dense on the host
    plane (not pipelined, and pipelined), PS dense softmax in bf16 on the
    device plane, PS sparse on the device plane and FTRL on the device
    plane, and local sparse and local FTRL besides: final weights to rtol 1e-4, atol 1e-5 and every epoch's loss to
    rtol 1e-4 (the JAX package's own device-vs-host tolerance is 1e-4,
    1e-6; the device plane here sums a window in one batched product);
(c) the port alone: its device plane against its host plane (sparse,
    FTRL), the CLI on a reference-style config file with ``-platform
    cpu``, Store/Load and the PS warm start, ``compress=1bit`` training an
    epoch, and the refused option.
"""

import numpy as np
import pytest
import torch
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

N_IN, N_SAMPLES = 50, 200


# -- (a) the objective functions ------------------------------------------------

class _Cfg:
    input_size = N_IN
    regular_type = "L2"
    regular_coef = 0.01
    alpha, beta, lambda1, lambda2 = 0.5, 1.0, 0.01, 0.02

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _close(t, j, what):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-6,
                               err_msg=what)


def test_objectives_match_jax():
    import jax.numpy as jnp
    from multiverso_tpu.models.logreg import objective as jobj
    from multiverso_tpu_torch.models.logreg import objective as tobj

    rng = np.random.default_rng(11)
    B, K, R = 16, 8, 12
    labels2 = rng.integers(0, 2, B).astype(np.int32)
    labels3 = rng.integers(0, 3, B).astype(np.int32)
    weights = np.ones(B, np.float32)
    weights[-3:] = 0                                  # pad samples
    X = rng.standard_normal((B, N_IN)).astype(np.float32)
    keys = rng.integers(0, R, (B, K)).astype(np.int64)
    values = rng.standard_normal((B, K)).astype(np.float32)
    mask = (rng.random((B, K)) > 0.2).astype(np.float32)
    T = torch.from_numpy
    for out, labels in ((1, labels2), (3, labels3)):
        objective = "sigmoid" if out == 1 else "softmax"
        W = (rng.standard_normal((N_IN, out)) * 0.3).astype(np.float32)
        for cdt in ("float32", "bfloat16"):
            cfg = _Cfg(output_size=out, objective_type=objective,
                       compute_type=cdt)
            jg, jl = jobj.make_dense_grad_fn(cfg)(
                jnp.asarray(W), jnp.asarray(X, cdt), jnp.asarray(labels),
                jnp.asarray(weights))
            tg, tl = tobj.make_dense_grad_fn(cfg)(
                T(W), T(X).to(tobj.compute_dtype(cfg)), T(labels),
                T(weights))
            _close(tg, jg, f"dense {objective} {cdt} grad")
            _close(tl, jl, f"dense {objective} {cdt} loss")
        _close(tobj.make_dense_predict_fn(cfg)(T(W), T(X)),
               jobj.make_dense_predict_fn(cfg)(W, X), f"dense {objective}")
        cfg = _Cfg(output_size=out, objective_type=objective)
        Wr = (rng.standard_normal((R, out)) * 0.3).astype(np.float32)
        jargs = (jnp.asarray(keys.astype(np.int32)), values, mask, labels,
                 weights)
        targs = (T(keys), T(values), T(mask), T(labels), T(weights))
        jg, jl = jobj.make_sparse_grad_fn(cfg)(Wr, *jargs)
        tg, tl = tobj.make_sparse_grad_fn(cfg)(T(Wr), *targs)
        _close(tg, jg, f"sparse {objective} grad")
        _close(tl, jl, f"sparse {objective} loss")
        _close(tobj.make_sparse_predict_fn(cfg)(T(Wr), *targs[:3]),
               jobj.make_sparse_predict_fn(cfg)(Wr, *jargs[:3]),
               f"sparse {objective} predict")
        _check_window_delta(tobj, cfg, rng, Wr, keys, values, mask, labels,
                            weights)
        z = rng.standard_normal((R, out)).astype(np.float32)
        n = np.abs(rng.standard_normal((R, out))).astype(np.float32)
        _close(tobj.make_ftrl_weights_fn(cfg)(T(z), T(n)),
               jobj.make_ftrl_weights_fn(cfg)(z, n), f"ftrl {out} weights")
        jz, jn, jl = jobj.make_ftrl_grad_fn(cfg)(z, n, *jargs)
        tz, tn, tl = tobj.make_ftrl_grad_fn(cfg)(T(z), T(n), *targs)
        for t, j, name in ((tz, jz, "dz"), (tn, jn, "dn"), (tl, jl, "loss")):
            _close(t, j, f"ftrl {out} {name}")
        # batched FTRL: a leading batch axis gives per-batch deltas
        bz, bn, bl = tobj.make_ftrl_grad_fn(cfg)(
            T(z), T(n), *(torch.stack([a, a]) for a in targs))
        _close(bz[1], jz, f"ftrl {out} batched dz")
        _close(bn[0], jn, f"ftrl {out} batched dn")
        _close(bl, 2 * np.asarray(jl), f"ftrl {out} batched loss")


def _check_window_delta(tobj, cfg, rng, Wr, keys, values, mask, labels,
                        weights):
    """The device plane's one-shot window delta equals the per-batch sum
    of lr_b * grad_b (the JAX window program's scan)."""
    T = torch.from_numpy
    nb = 3
    lrs = np.array([0.5, 0.25, 0.0], np.float32)      # the last: a pad batch
    perm = [rng.permutation(len(labels)) for _ in range(nb)]
    stack = [np.stack([a[p] for p in perm]) for a in
             (keys, values, mask, labels, weights)]
    stack[4][2] = 0
    grad = tobj.make_sparse_grad_fn(cfg)
    want = sum(float(lrs[b]) * grad(T(Wr), *(T(a[b]) for a in stack))[0]
               for b in range(nb))
    got, loss = tobj.make_sparse_window_delta_fn(cfg)(
        T(Wr), *(T(a) for a in stack), T(lrs))
    _close(got, want.numpy(), "window delta")


# -- (b) the whole app -----------------------------------------------------------

def _write_dense(path, X, y):
    with open(path, "w") as f:
        for row, lab in zip(X, y):
            f.write(f"{lab} " + " ".join(f"{v:.5f}" for v in row) + "\n")


def _write_sparse(path, X, y):
    with open(path, "w") as f:
        for row, lab in zip(X, y):
            nz = np.nonzero(row)[0]
            f.write(f"{lab} " + " ".join(f"{k}:{row[k]:.5f}" for k in nz)
                    + "\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("lr_data")
    rng = np.random.default_rng(2)
    X = rng.normal(size=(N_SAMPLES + 50, N_IN)).astype(np.float32)
    w = rng.normal(size=N_IN)
    _write_dense(d / "dense.data", X[:N_SAMPLES], (X[:N_SAMPLES] @ w > 0)
                 .astype(int))
    W3 = rng.normal(size=(N_IN, 3))
    _write_dense(d / "softmax.data", X[:N_SAMPLES],
                 np.argmax(X[:N_SAMPLES] @ W3, axis=1))
    Xs = X.copy()
    Xs[rng.random(Xs.shape) < 0.7] = 0
    y = (Xs @ w > 0).astype(int)
    _write_sparse(d / "sparse.data", Xs[:N_SAMPLES], y[:N_SAMPLES])
    _write_sparse(d / "sparse_test.data", Xs[N_SAMPLES:], y[N_SAMPLES:])
    return d


MODES = {
    "local dense": dict(file="dense.data", objective_type="sigmoid"),
    "local sparse": dict(file="sparse.data", sparse=True,
                         objective_type="sigmoid"),
    "local ftrl": dict(file="sparse.data", objective_type="ftrl",
                       alpha=1.0, beta=1.0, lambda1=0.01, lambda2=0.01),
    "ps dense host": dict(file="dense.data", objective_type="sigmoid",
                          use_ps=True, sync_frequency=5, pipeline=False),
    # the async window lets a Get observe Adds queued after it in the same
    # window (more progress, never less), so a pipelined pull depends on
    # timing; both engines run one message a window here
    "ps dense host pipelined": dict(file="dense.data",
                                    objective_type="sigmoid", use_ps=True,
                                    sync_frequency=2, pipeline=True,
                                    one_message_windows=True),
    "ps dense device": dict(file="softmax.data", output_size=3,
                            objective_type="softmax",
                            compute_type="bfloat16", use_ps=True,
                            sync_frequency=5, device_plane=True),
    "ps sparse device": dict(file="sparse.data", sparse=True,
                             objective_type="sigmoid", regular_type="L1",
                             use_ps=True, sync_frequency=5,
                             device_plane=True),
    "ftrl device": dict(file="sparse.data", objective_type="ftrl",
                        alpha=1.0, beta=1.0, lambda1=0.01, lambda2=0.01,
                        use_ps=True, sync_frequency=5, device_plane=True),
}


def _config(cls, d, file, **kw):
    cfg = cls()
    cfg.train_file = str(d / file)
    cfg.test_file = cfg.output_file = cfg.output_model_file = ""
    cfg.input_size, cfg.output_size = N_IN, 1
    cfg.updater_type, cfg.learning_rate = "sgd", 0.5
    cfg.regular_type, cfg.regular_coef = "L2", 0.001
    cfg.train_epoch = 2
    cfg.show_time_per_sample = 10 ** 9
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


class _EpochLines:
    """Stands in for the JAX ``logreg`` module's ``Log``: keeps the epoch lines'
    (samples, average loss)."""

    def __init__(self):
        self.epochs = []

    def Info(self, fmt, *args):
        if fmt.startswith("[logreg] epoch %d done"):
            self.epochs.append((args[1], float(args[2])))

    def Error(self, fmt, *args):
        pass

    Debug = Error


def _mode(mode, monkeypatch, server_cls, **kw):
    kw = dict(MODES[mode], **kw)
    if kw.pop("one_message_windows", False):
        monkeypatch.setattr(server_cls, "GET_PIPELINE_WINDOW", 1)
    return kw


def _run_jax(d, mode, monkeypatch):
    import multiverso_tpu as jmv
    from multiverso_tpu.models.logreg import logreg as jlogreg
    from multiverso_tpu.sync.server import Server
    lines = _EpochLines()
    monkeypatch.setattr(jlogreg, "Log", lines)
    cfg = _config(jlogreg.Configure, d, **_mode(mode, monkeypatch, Server))
    if cfg.use_ps:
        # every Add reaches the engine as its own message, as in the port
        jmv.MV_Init(["-mv_write_combine=0"])
    try:
        app = jlogreg.LogReg(cfg)
        try:
            app.Train()
            W = app.model.weights().copy()
        finally:
            app.close()
    finally:
        if cfg.use_ps:
            jmv.MV_ShutDown()
    return W, lines.epochs


def _run_port(d, mode, monkeypatch, **kw):
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    from multiverso_tpu_torch.models.logreg.configure import Configure
    from multiverso_tpu_torch.sync.server import Server
    from multiverso_tpu_torch.zoo import Zoo
    cfg = _config(Configure, d, platform="cpu",
                  **_mode(mode, monkeypatch, Server, **kw))
    app = LogReg(cfg)
    try:
        app.Train()
        W = app.model.weights().copy()
        acc = app.Test() if cfg.test_file else None
    finally:
        app.close()
    assert not Zoo.Get().started
    return W, [(n, loss) for n, loss, _ in app.epoch_log], acc


def test_app_matches_jax(data, monkeypatch):
    for mode in MODES:
        jW, jep = _run_jax(data, mode, monkeypatch)
        tW, tep, _ = _run_port(data, mode, monkeypatch)
        assert tW.shape == jW.shape, mode
        np.testing.assert_allclose(tW, jW, rtol=1e-4, atol=1e-5,
                                   err_msg=mode)
        assert [n for n, _ in tep] == [n for n, _ in jep] == \
            [N_SAMPLES, N_SAMPLES], mode
        np.testing.assert_allclose([lo for _, lo in tep],
                                   [lo for _, lo in jep], rtol=1e-4,
                                   err_msg=mode)
        assert tep[-1][1] < tep[0][1], mode


# -- (c) the port alone ----------------------------------------------------------

def test_port_app_alone(data, tmp_path, monkeypatch):
    # the device plane against the host plane (windows on sync boundaries)
    for mode in ("ps sparse device", "ftrl device"):
        hW, hep, _ = _run_port(data, mode, monkeypatch, device_plane=False)
        dW, dep, acc = _run_port(data, mode, monkeypatch,
                                 test_file=str(data / "sparse_test.data"))
        np.testing.assert_allclose(dW, hW, rtol=1e-4, atol=1e-5,
                                   err_msg=mode)
        np.testing.assert_allclose([lo for _, lo in dep],
                                   [lo for _, lo in hep], rtol=1e-4)
        assert acc > 0.75, (mode, acc)
    _check_cli(data, tmp_path)
    _check_refusals(data)


def _check_cli(data, tmp_path):
    """A reference-style config through the CLI with -platform cpu, then
    the saved model as a PS warm start: the pushed weights are the
    table's."""
    from multiverso_tpu_torch.models.logreg import main as lr_main
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    from multiverso_tpu_torch.models.logreg.configure import Configure
    model = tmp_path / "model.bin"
    conf = tmp_path / "run.config"
    conf.write_text(f"""# mnist-style config (reference example/mnist.config keys)
input_size={N_IN}
output_size=1
objective_type=sigmoid
regular_type=L2
updater_type=sgd
train_epoch=3
sparse=false
use_ps=false
minibatch_size=20
train_file={data}/dense.data
test_file={data}/dense.data
output_file={tmp_path}/test.out
output_model_file={model}
learning_rate_coef=7e6
regular_coef=0.0007
""")
    assert lr_main.main([str(conf), "-platform", "cpu"]) == 0
    assert lr_main.main([str(conf), "-bogus"]) == 1
    lines = (tmp_path / "test.out").read_text().splitlines()
    assert len(lines) == N_SAMPLES and "->" in lines[0]
    raw = model.read_bytes()
    n_in, n_out = np.frombuffer(raw[:16], np.int64)
    assert (n_in, n_out) == (N_IN, 1)
    W = np.frombuffer(raw[16:], np.float32).reshape(n_out, n_in).T
    for sparse in (False, True):
        cfg = Configure.from_file(str(conf))
        cfg.platform, cfg.use_ps, cfg.init_model_file = "cpu", True, str(model)
        cfg.sparse = sparse
        cfg.output_model_file = ""
        app = LogReg(cfg)
        try:
            np.testing.assert_allclose(app.model.weights(), W, rtol=1e-6,
                                       atol=1e-7)
        finally:
            app.close()


def _check_refusals(data):
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    from multiverso_tpu_torch.models.logreg.configure import Configure
    from multiverso_tpu_torch.zoo import Zoo
    # compress= builds the compressed table and trains (it was refused
    # before the compressed wire was ported)
    cfg = _config(Configure, data, "sparse.data", sparse=True, use_ps=True,
                  platform="cpu", compress="1bit", train_epoch=1)
    app = LogReg(cfg)
    try:
        assert app.model.table.server().compress == "1bit"
        app.Train()
        assert app.model.table.server().wire_stats["payload_bytes"] > 0
    finally:
        app.close()
    assert len(app.epoch_log) == 1 and np.isfinite(app.epoch_log[0][1])
    assert not Zoo.Get().started
    cfg = _config(Configure, data, "dense.data", compute_type="float16")
    with pytest.raises(ValueError, match="compute_type"):
        LogReg(cfg)
    assert not Zoo.Get().started        # the failed init closed its world
