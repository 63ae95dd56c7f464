"""The port's WordEmbedding against the JAX package's.

(a) the train step, plain and AdaGrad, against
    ``multiverso_tpu.models.wordembedding.model.make_train_step`` on the
    same stacked batches: rtol 1e-5, atol 1e-6, because ``index_add_`` and
    einsum sum in another order than XLA;
(b) the whole app in both packages on the topic corpus of
    ``tests/test_wordembedding.py`` with ``-is_pipeline 0``, skip-gram NEG,
    plain SGD, on ``-device_plane 1`` and on the host plane with
    ``-mv_engine_shards=4`` (its three tables on three engine shards): the
    pair pipeline is numpy-seeded and identical in both, so the saved
    embeddings must match to rtol 1e-3, atol 1e-4 (the tolerance of the
    JAX package's own device-vs-host plane test);
(c) the port alone separates the corpus topics, on both planes.
"""

import numpy as np
import torch

from multiverso_tpu_torch.models.wordembedding.distributed import \
    DistributedWordEmbedding
from multiverso_tpu_torch.models.wordembedding.option import Option
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)


# -- (a) the train step -------------------------------------------------------

def _batches(rng, B, P, R_in, R_out, K):
    inputs = rng.integers(0, R_in, (B, P, 1)).astype(np.int32)
    imask = np.ones((B, P, 1), np.float32)
    outputs = rng.integers(0, R_out, (B, P, 1 + K)).astype(np.int32)
    labels = np.zeros((B, P, 1 + K), np.float32)
    labels[:, :, 0] = 1.0
    omask = (rng.random((B, P, 1 + K)) > 0.1).astype(np.float32)
    imask[:, -3:] = 0.0                     # padded pairs
    omask[:, -3:] = 0.0
    return inputs, imask, outputs, labels, omask


def test_train_step_matches_jax():
    for use_adagrad in (False, True):
        try:
            _check_train_step(use_adagrad)
        except AssertionError as exc:
            raise AssertionError(f"use_adagrad={use_adagrad}: {exc}") \
                from exc


def _check_train_step(use_adagrad):
    import jax.numpy as jnp
    from multiverso_tpu.models.wordembedding import model as jmodel
    from multiverso_tpu_torch.models.wordembedding import model as tmodel

    rng = np.random.default_rng(3)
    R_in, R_out, D, K, P, B = 30, 40, 16, 5, 64, 3
    ie = jmodel.init_embedding(R_in, D, seed=2)
    eo = rng.standard_normal((R_out, D)).astype(np.float32) * 0.1
    g2 = [np.abs(rng.standard_normal((n, D))).astype(np.float32) * 0.01
          for n in (R_in, R_out)] if use_adagrad else [None, None]
    batch = _batches(rng, B, P, R_in, R_out, K)
    lr = 0.05

    jstep = jmodel.make_train_step(use_adagrad)
    jstate = jmodel.TrainState(
        jnp.asarray(ie), jnp.asarray(eo),
        *(jnp.asarray(g) if g is not None else None for g in g2))
    tstep = tmodel.make_train_step(use_adagrad)
    tstate = tmodel.TrainState(
        torch.from_numpy(ie.copy()), torch.from_numpy(eo.copy()),
        *(torch.from_numpy(g.copy()) if g is not None else None for g in g2))
    tlr = torch.tensor(lr, dtype=torch.float32)
    for b in range(B):
        jx = [jnp.asarray(a[b]) for a in batch]
        tx = [torch.from_numpy(a[b].copy()) for a in batch]
        tx[0], tx[2] = tx[0].long(), tx[2].long()
        jstate, jloss = jstep(jstate, *jx, jnp.float32(lr))
        tstate, tloss = tstep(tstate, *tx, tlr)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                                   atol=1e-6)
        for name in ("ie", "eo", "ie_g2", "eo_g2"):
            j = getattr(jstate, name)
            if j is None:
                assert getattr(tstate, name) is None
                continue
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       np.asarray(j), rtol=1e-5, atol=1e-6)


# -- (b), (c) the whole app ---------------------------------------------------

def _make_corpus(path, n_sentences=300, seed=0):
    """tests/test_wordembedding.py's corpus: each sentence draws its words
    from ONE topic of 5 words (4 topics, 20-word vocab)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_sentences):
            topic = rng.integers(4)
            words = [f"w{topic * 5 + rng.integers(5)}" for _ in range(12)]
            f.write(" ".join(words) + "\n")


def _options(option_cls, tmp_path, **kw):
    corpus = tmp_path / "corpus.txt"
    if not corpus.exists():
        _make_corpus(str(corpus))
    opt = option_cls(train_file=str(corpus),
                     output_file=str(tmp_path / "vec.txt"),
                     embedding_size=16, window_size=2, negative_num=3,
                     min_count=1, epoch=2, data_block_size=4000,
                     pair_batch_size=256, init_learning_rate=0.05)
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


def _vectors(path):
    lines = open(path).read().splitlines()[1:]
    return {l.split()[0]: np.array(l.split()[1:], np.float64) for l in lines}


def _run_port(tmp_path, **kw):
    opt = _options(Option, tmp_path, platform="cpu", **kw)
    we = DistributedWordEmbedding(opt)
    try:
        loss = we.run()
    finally:
        we.close()
    return opt, loss


def _in_world(mv, zoo_cls, argv, run):
    """``run()`` in a world started with ``argv`` (the app joins a started
    world and leaves it up), whose engine must be sharded over the app's
    three tables; none started when ``argv`` is empty."""
    if not argv:
        return run()
    mv.MV_Init(argv)
    try:
        out = run()
        eng = zoo_cls.Get().server_engine
        assert type(eng).__name__ == "ShardedServer"
        assert len(eng.shard_states()) == 3
        return out
    finally:
        mv.MV_ShutDown()


def test_device_plane_app_matches_jax(tmp_path):
    cases = {"device plane": ([], [], dict(device_plane=True)),
             "host plane, 4 engine shards": (
                 ["-mv_engine_shards=4", "-mv_write_combine=0"],
                 ["-mv_engine_shards=4", "-mv_device=cpu"],
                 dict(device_plane=False))}
    for name, (jargv, targv, kw) in cases.items():
        path = tmp_path / name.replace(" ", "_").replace(",", "")
        try:
            _check_app_matches_jax(path, jargv, targv, kw)
        except AssertionError as exc:
            raise AssertionError(f"{name}: {exc}") from exc


def _check_app_matches_jax(tmp_path, jargv, targv, kw):
    import multiverso_tpu as jmv
    import multiverso_tpu_torch as tmv
    from multiverso_tpu.models.wordembedding.distributed import \
        DistributedWordEmbedding as JWordEmbedding
    from multiverso_tpu.models.wordembedding.option import Option as JOption
    from multiverso_tpu.zoo import Zoo as JZoo
    from multiverso_tpu_torch.zoo import Zoo as TZoo

    (tmp_path / "jax").mkdir(parents=True)
    (tmp_path / "port").mkdir()
    jopt = _options(JOption, tmp_path / "jax", is_pipeline=False, **kw)

    def run_jax():
        jwe = JWordEmbedding(jopt)
        try:
            return jwe.run()
        finally:
            jwe.close()

    jloss = _in_world(jmv, JZoo, jargv, run_jax)
    topt, tloss = _in_world(tmv, TZoo, targv, lambda: _run_port(
        tmp_path / "port", is_pipeline=False, **kw))
    jv, tv = _vectors(jopt.output_file), _vectors(topt.output_file)
    assert jv.keys() == tv.keys()
    for w in jv:
        np.testing.assert_allclose(tv[w], jv[w], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-3)


def test_port_app_alone(tmp_path):
    """(c) topic separation on both planes; -device_pairs 1 is not
    rerouted to the host pair path: its blocks carry only the token
    stream and the DevicePairsTrainer trains them;
    convert.load_wordembedding_state loads a Communicator."""
    for plane in ("device", "host"):
        (tmp_path / plane).mkdir()
        _check_topics(tmp_path / plane, plane)
    _check_device_pairs_route(tmp_path)
    _check_load_state(tmp_path)


def _check_device_pairs_route(tmp_path):
    from multiverso_tpu_torch.models.wordembedding.data import PairGenerator
    we = DistributedWordEmbedding(_options(Option, tmp_path, platform="cpu",
                                           device_pairs=True, epoch=1))
    try:
        we.prepare()
        gen = PairGenerator(we.opt, we.dictionary, we.sampler, we.huffman)
        block = gen.make_block([np.arange(10, dtype=np.int32)], 10)
        assert block.stacked is None and block.pair_count == 0
        np.testing.assert_array_equal(block.tokens, np.arange(10))
        we.train()
        assert we.dp_trainer.batches > 0 and we.total_pairs > 0
    finally:
        we.close()


def _check_topics(tmp_path, plane):
    opt, loss = _run_port(tmp_path, device_plane=plane == "device",
                          is_pipeline=plane == "host")
    # a random sigmoid loss per pair is ~(1+K)*0.69; training must beat it
    assert loss < 0.69 * (1 + opt.negative_num) * 0.9
    header = open(opt.output_file).readline().split()
    assert int(header[0]) == 20 and int(header[1]) == 16
    vecs = _vectors(opt.output_file)

    def cos(a, b):
        return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)

    same = np.mean([cos(vecs[f"w{5*t}"], vecs[f"w{5*t + k}"])
                    for t in range(4) for k in range(1, 5)])
    cross = np.mean([cos(vecs[f"w{5*t}"], vecs[f"w{(5*t + 7) % 20}"])
                     for t in range(4)])
    assert same > cross, plane


def _check_load_state(tmp_path):
    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch.convert import load_wordembedding_state
    from multiverso_tpu_torch.models.wordembedding.communicator import \
        Communicator

    opt = _options(Option, tmp_path, use_adagrad=True)
    rng = np.random.default_rng(4)
    state = [rng.standard_normal((20, 16)).astype(np.float32)
             for _ in range(4)]
    tmv.MV_Init(["-mv_device=cpu"])
    try:
        comm = Communicator(opt, 20)
        load_wordembedding_state(comm, *state)
        for table, want in zip((comm.input_table, comm.output_table,
                                comm.ie_g2_table, comm.eo_g2_table), state):
            np.testing.assert_array_equal(table.Get(), want)
    finally:
        tmv.MV_ShutDown()
