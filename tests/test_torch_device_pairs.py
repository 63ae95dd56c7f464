"""The port's WordEmbedding ``-device_pairs`` against the JAX package's.

(a) the block program, ``DevicePairsTrainer.train_block``, in all four
    modes (skip-gram/CBOW x NEG/HS; plain SGD and dense AdaGrad; one mode
    with subsampling and a pair batch that leaves a padded last batch)
    and on the touched-rows AdaGrad step
    (``_SPARSE_BYTES`` at 0 in both packages): both packages' tables start
    from the same state (the port's loaded through
    ``convert.load_wordembedding_state``), take the same token block
    (subsampled on the host by both packages' ``make_token_block``, which
    must agree), and the port gets the JAX program's draws, recomputed
    here from its key (``fold_in(PRNGKey(seed), block)``, split,
    ``randint``). Logical tables, loss sum: rtol 1e-5, atol 1e-6; the pair
    count exactly;
(b) the port alone: the touched-rows step and the dense AdaGrad step give
    the same tables (rtol 2e-5, atol 2e-6, the JAX package's own test's
    tolerance), and the trained rows are what the tables' verbs read
    (``GetRows`` through the worker table, ``pull_embeddings``);
(c) the port's app with ``-device_pairs 1`` on the CPU learns the topic
    corpus of ``tests/test_wordembedding.py`` in all four modes.
"""

import numpy as np
import pytest
import torch
from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

V, D, N_TOKENS, SEED = 50, 16, 2000, 5
LR = 0.05


def _counts():
    ranks = np.arange(1, V + 1, dtype=np.float64)
    return (4000.0 / ranks).astype(np.int64) + 1


def _sentences(rng):
    p = _counts() / _counts().sum()
    tokens = rng.choice(V, N_TOKENS, p=p).astype(np.int32)
    cuts = np.cumsum(rng.integers(3, 30, 200))
    return [s for s in np.split(tokens, cuts[cuts < N_TOKENS]) if len(s)]


def _options(option_cls, **kw):
    opt = option_cls(embedding_size=D, window_size=2, negative_num=3,
                     min_count=1, pair_batch_size=256, seed=SEED,
                     init_learning_rate=LR)
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


def _token_block(pkg, opt, counts, sentences, huffman):
    """The package's own Sampler and PairGenerator.make_token_block."""
    import importlib
    sampler = importlib.import_module(
        f"{pkg}.models.wordembedding.sampler").Sampler(counts, seed=opt.seed)
    data = importlib.import_module(f"{pkg}.models.wordembedding.data")
    gen = data.PairGenerator(opt, None, sampler, huffman)
    block = gen.make_token_block(sentences, sum(map(len, sentences)),
                                 rng_stream=sampler.spawn_stream())
    return block.tokens, block.token_sent


def _huffman(pkg, opt, counts):
    if not opt.hs:
        return None
    import importlib
    enc = importlib.import_module(
        f"{pkg}.models.wordembedding.huffman").HuffmanEncoder()
    enc.BuildFromTermFrequency(counts)
    return enc


def _tables(comm):
    tabs = [comm.input_table, comm.output_table]
    if comm.ie_g2_table is not None:
        tabs += [comm.ie_g2_table, comm.eo_g2_table]
    return [t.Get() for t in tabs]


# -- (a) the block program against the JAX package ---------------------------

MODES = {
    # a pair batch that does not divide the lanes: the last batch pads
    "skip-gram NEG, plain SGD, sample 1e-3, batches of 300":
        dict(sample=1e-3, pair_batch_size=300),
    "CBOW NEG, dense AdaGrad": dict(cbow=True, use_adagrad=True),
    "skip-gram HS, dense AdaGrad": dict(hs=True, negative_num=0,
                                        use_adagrad=True),
    "CBOW HS, plain SGD": dict(cbow=True, hs=True, negative_num=0),
    "skip-gram NEG, touched-rows AdaGrad": dict(use_adagrad=True,
                                                sparse=True),
}


def test_block_program_matches_jax(monkeypatch):
    from multiverso_tpu.models.wordembedding import device_pairs as jdp
    from multiverso_tpu_torch.models.wordembedding import device_pairs as tdp
    for name, kw in MODES.items():
        kw = dict(kw)
        threshold = 0 if kw.pop("sparse", False) else 1 << 60
        monkeypatch.setattr(jdp, "_SPARSE_BYTES", threshold)
        monkeypatch.setattr(tdp, "_SPARSE_BYTES", threshold)
        try:
            _check_mode(kw, threshold == 0)
        except AssertionError as exc:
            raise AssertionError(f"{name}: {exc}") from exc


def _check_mode(kw, sparse):
    import jax
    import multiverso_tpu as jmv
    import multiverso_tpu_torch as tmv
    from multiverso_tpu.models.wordembedding.communicator import \
        Communicator as JComm
    from multiverso_tpu.models.wordembedding.device_pairs import \
        DevicePairsTrainer as JTrainer
    from multiverso_tpu.models.wordembedding.option import Option as JOption
    from multiverso_tpu.parallel.mesh import next_bucket
    from multiverso_tpu_torch.convert import load_wordembedding_state
    from multiverso_tpu_torch.models.wordembedding.communicator import \
        Communicator as TComm
    from multiverso_tpu_torch.models.wordembedding.device_pairs import \
        DevicePairsTrainer as TTrainer
    from multiverso_tpu_torch.models.wordembedding.option import Option

    counts = _counts()
    rng = np.random.default_rng(11)
    sentences = _sentences(rng)
    jopt, topt = _options(JOption, **kw), _options(Option, **kw)
    jhuff = _huffman("multiverso_tpu", jopt, counts)
    thuff = _huffman("multiverso_tpu_torch", topt, counts)
    tokens, sent = _token_block("multiverso_tpu", jopt, counts, sentences,
                                jhuff)
    t_tokens, t_sent = _token_block("multiverso_tpu_torch", topt, counts,
                                    sentences, thuff)
    np.testing.assert_array_equal(t_tokens, tokens)
    np.testing.assert_array_equal(t_sent, sent)
    if kw.get("sample"):
        assert len(tokens) < N_TOKENS          # subsampling removed words
    # the JAX tables: the input table keeps its seeded init (the same
    # numpy init in both packages), the others add a random state to
    # their zeros (exact)
    extra = [rng.standard_normal((V, D)).astype(np.float32) * 0.1]
    if jopt.use_adagrad:
        extra += [np.abs(rng.standard_normal((V, D))).astype(np.float32)
                  * 0.01 for _ in range(2)]

    jmv.MV_Init(["-mv_write_combine=0"])
    try:
        comm = JComm(jopt, V)
        for table, state in zip(
                [comm.output_table, comm.ie_g2_table, comm.eo_g2_table],
                extra):
            table.Add(state)
        start = _tables(comm)
        trainer = JTrainer(jopt, comm, counts.tolist(), huffman=jhuff)
        jloss, jpairs = trainer.train_block(tokens, sent, LR)
        jloss, jpairs = float(jloss), int(jpairs)
        want = _tables(comm)
        slots = None if jopt.hs else np.asarray(trainer._slots)
    finally:
        jmv.MV_ShutDown()

    # the JAX program's draws for block 1 (device_pairs.py:273-274, :319,
    # :445)
    t_pad = next_bucket(len(tokens), min_bucket=1024)
    P = t_pad if jopt.cbow else 2 * jopt.window_size * t_pad
    key = jax.random.fold_in(jax.random.PRNGKey(jopt.seed), 1)
    kb, kneg = jax.random.split(key)
    b = np.asarray(jax.random.randint(kb, (t_pad,), 1,
                                      jopt.window_size + 1))
    draws = (None if jopt.hs else np.asarray(jax.random.randint(
        kneg, (P, jopt.negative_num), 0, slots.shape[0])))

    tmv.MV_Init(["-mv_device=cpu"])
    try:
        comm = TComm(topt, V)
        load_wordembedding_state(comm, *start)
        trainer = TTrainer(topt, comm, counts.tolist(), huffman=thuff)
        if slots is not None:
            np.testing.assert_array_equal(trainer.slots.numpy(), slots)
        assert trainer.sparse() == sparse
        tloss, tpairs = trainer.train_block(t_tokens, t_sent, LR, b=b,
                                            draws=draws)
        tloss, tpairs = float(tloss), int(tpairs)
        got = _tables(comm)
        assert trainer.sparse_batches == (trainer.batches if sparse else 0)
    finally:
        tmv.MV_ShutDown()
    assert tpairs == jpairs and tpairs > 0
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=1e-6)
    for name, g, w, s in zip(("ie", "eo", "ie_g2", "eo_g2"), got, want,
                             start):
        assert not np.array_equal(w, s), f"{name} did not train"
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


# -- (b) the touched-rows step against the dense step, in the port -----------

def test_sparse_step_matches_dense_and_writes_back(monkeypatch):
    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch.models.wordembedding import device_pairs as tdp
    from multiverso_tpu_torch.models.wordembedding.communicator import \
        Communicator
    from multiverso_tpu_torch.models.wordembedding.option import Option

    counts = _counts()
    sentences = _sentences(np.random.default_rng(12))
    opt = _options(Option, use_adagrad=True, init_learning_rate=0.1)
    tokens, sent = _token_block("multiverso_tpu_torch", opt, counts,
                                sentences, None)
    ids = np.arange(V, dtype=np.int32)
    results = {}
    for name, threshold in (("dense", 1 << 60), ("sparse", 0)):
        monkeypatch.setattr(tdp, "_SPARSE_BYTES", threshold)
        tmv.MV_Init(["-mv_device=cpu"])
        try:
            comm = Communicator(opt, V)
            before = comm.input_table.GetRows(ids)
            trainer = tdp.DevicePairsTrainer(opt, comm, counts.tolist())
            assert trainer.sparse() == (name == "sparse")
            # two blocks: the second reads what the first wrote back
            for _ in range(2):
                loss, pairs = trainer.train_block(tokens, sent, 0.1)
                assert np.isfinite(float(loss)) and int(pairs) > 0
            tables = [t.server().raw() for t in (
                comm.input_table, comm.output_table, comm.ie_g2_table,
                comm.eo_g2_table)]
            # the trained rows are what the tables' own verbs read
            rows = comm.input_table.GetRows(ids)
            np.testing.assert_array_equal(rows, tables[0])
            np.testing.assert_array_equal(comm.pull_embeddings(), tables[0])
            np.testing.assert_array_equal(comm.eo_g2_table.GetRows(ids),
                                          tables[3])
            assert not np.allclose(rows, before)
            results[name] = tables
        finally:
            tmv.MV_ShutDown()
    for i, (s, d) in enumerate(zip(results["sparse"], results["dense"])):
        np.testing.assert_allclose(s, d, rtol=2e-5, atol=2e-6,
                                   err_msg=f"table {i}")


# -- (c) the app learns the topic corpus --------------------------------------

def _make_corpus(path, n_sentences=300, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_sentences):
            topic = rng.integers(4)
            f.write(" ".join(f"w{topic * 5 + rng.integers(5)}"
                             for _ in range(12)) + "\n")


APP_MODES = {
    "skip-gram NEG": (dict(), 0.69 * 4 * 0.9),
    "skip-gram NEG AdaGrad": (dict(use_adagrad=True,
                                   init_learning_rate=0.1), 0.69 * 4 * 0.9),
    "CBOW NEG AdaGrad": (dict(cbow=True, use_adagrad=True,
                              init_learning_rate=0.1), 0.69 * 4 * 0.9),
    "skip-gram HS AdaGrad": (dict(hs=True, negative_num=0, use_adagrad=True,
                                  init_learning_rate=0.1, epoch=3),
                             0.69 * 6),
    "CBOW HS AdaGrad": (dict(cbow=True, hs=True, negative_num=0,
                             use_adagrad=True, init_learning_rate=0.1,
                             epoch=3), 0.69 * 6),
}


def test_app_learns_topics(tmp_path):
    from multiverso_tpu_torch.models.wordembedding.distributed import \
        DistributedWordEmbedding
    from multiverso_tpu_torch.models.wordembedding.option import Option
    corpus = tmp_path / "corpus.txt"
    _make_corpus(str(corpus))
    for name, (kw, bound) in APP_MODES.items():
        opt = Option(train_file=str(corpus),
                     output_file=str(tmp_path / "vec.txt"),
                     embedding_size=16, window_size=2, negative_num=3,
                     min_count=1, epoch=2, data_block_size=4000,
                     pair_batch_size=256, init_learning_rate=0.05,
                     device_pairs=True, platform="cpu")
        for k, v in kw.items():
            setattr(opt, k, v)
        we = DistributedWordEmbedding(opt)
        try:
            loss = we.run()
        finally:
            we.close()
        assert 0 < loss < bound, name
        assert we.dp_trainer.batches > 0, name
        assert all(isinstance(p, int) and isinstance(lo, float)
                   for _, p, lo in we.block_log), name
        lines = open(opt.output_file).read().splitlines()[1:]
        vecs = {l.split()[0]: np.array(l.split()[1:], float) for l in lines}
        assert all(np.isfinite(v).all() for v in vecs.values()), name

        def cos(a, b):
            return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)

        same = np.mean([cos(vecs[f"w{5*t}"], vecs[f"w{5*t + k}"])
                        for t in range(4) for k in range(1, 5)])
        cross = np.mean([cos(vecs[f"w{5*t}"], vecs[f"w{(5*t + 7) % 20}"])
                         for t in range(4)])
        assert same > cross, name
