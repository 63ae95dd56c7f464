"""WordEmbedding data-parallel across two processes: the port's two-process
worlds against the JAX package's.

Each rank of ``tests/_mh_child.py`` streams its own corpus shard through
``DistributedWordEmbedding(opt).run()`` (the JAX package's two-process WE
tests' options, tests/test_multihost.py:508-602 and :664-743). Here:

(a) the host plane and ``-device_plane 1`` on equal shards, in both
    packages: each package's ranks save the same vectors, and the port's
    match the JAX package's two-process vectors to rtol 1e-3, atol 1e-4
    (the single-process WE app tolerance, tests/test_torch_wordembedding.py);
(b) ``-device_pairs 1`` on ragged shards (400 / 150 sentences; topics 0-1
    only in shard 0, 2-3 only in shard 1): the port's two ranks end with
    bitwise-equal tables and vectors, every topic is learned, and the
    tables match the JAX package's block program run in ONE process on
    the same global blocks (every rank's padded tokens in rank order, the
    sentence ids offset by rank; recorded by the port's rank 0 with the
    lr it used) with the JAX program's draws, which the children inject
    into the port (recomputed from ``fold_in(PRNGKey(seed), block)`` as
    tests/test_torch_device_pairs.py does): rtol 1e-5, atol 1e-6;
(c) the host plane on unequal block streams fails on both ranks with the
    message that says why, well within the children's 60 s collective
    timeout.
"""

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)


def _corpus(tmp_path, name, words, sizes, topics=None):
    for r, sents in enumerate(sizes):
        g = np.random.default_rng([5, r])
        with open(tmp_path / f"{name}_{r}.txt", "w") as f:
            for _ in range(sents):
                if topics is None:
                    f.write(" ".join(g.choice(words, 10)) + "\n")
                else:
                    t = topics[r][g.integers(len(topics[r]))]
                    f.write(" ".join(f"w{t * 5 + g.integers(5)}"
                                     for _ in range(10)) + "\n")
    with open(tmp_path / f"{name}_vocab.txt", "w") as f:
        for w in words:
            f.write(f"{w} 100\n")


def _vectors(path):
    lines = open(path).read().splitlines()[1:]
    return {ln.split()[0]: np.array(ln.split()[1:], np.float64)
            for ln in lines}


def test_host_and_device_planes_match_jax(tmp_path):
    _corpus(tmp_path, "corpus", [f"w{i}" for i in range(120)], (400, 400))
    jax_res, _ = run_world("jax", "we", tmp_path)
    port_res, _ = run_world("torch", "we", tmp_path)
    for plane in ("host", "device"):
        for pkg in ("jax", "torch"):
            v0 = (tmp_path / f"{pkg}_{plane}_0.txt").read_text()
            v1 = (tmp_path / f"{pkg}_{plane}_1.txt").read_text()
            assert v0 == v1, f"{pkg} {plane}: the ranks saved different " \
                             f"embeddings"
        jv = _vectors(tmp_path / f"jax_{plane}_0.txt")
        tv = _vectors(tmp_path / f"torch_{plane}_0.txt")
        assert jv.keys() == tv.keys()
        for w in jv:
            np.testing.assert_allclose(tv[w], jv[w], rtol=1e-3, atol=1e-4,
                                       err_msg=f"{plane} {w}")
        np.testing.assert_allclose(port_res[0][f"{plane}_loss"],
                                   jax_res[0][f"{plane}_loss"], rtol=1e-3)


def test_device_pairs_on_ragged_shards(tmp_path):
    words = [f"w{i}" for i in range(20)]
    _corpus(tmp_path, "topics", words, (400, 150), topics=[[0, 1], [2, 3]])
    res, _ = run_world("torch", "we_pairs", tmp_path)
    for key in ("input_table", "output_table"):
        np.testing.assert_array_equal(res[0][key], res[1][key], err_msg=key)
    assert (tmp_path / "torch_pairs_0.txt").read_text() == \
        (tmp_path / "torch_pairs_1.txt").read_text()
    vecs = _vectors(tmp_path / "torch_pairs_0.txt")

    def cos(a, b):
        return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)

    for t in range(4):          # incl. the topics only one shard has
        same = np.mean([cos(vecs[f"w{5 * t}"], vecs[f"w{5 * t + k}"])
                        for k in range(1, 5)])
        cross = cos(vecs[f"w{5 * t}"], vecs[f"w{(5 * t + 7) % 20}"])
        assert same > cross, f"topic {t} not learned: {same} {cross}"
    # rank 1's shard ran out first: later blocks hold rank 0's tokens only
    nblocks = sum(1 for k in res[0] if k.endswith("_ids"))
    half = len(res[0]["block0_ids"]) // 2
    assert nblocks >= 3
    assert (res[0][f"block{nblocks - 1}_ids"][half:] == -1).all()
    _check_against_jax_program(tmp_path, res[0], nblocks)


def _check_against_jax_program(tmp_path, res, nblocks):
    import jax
    import jax.numpy as jnp
    import multiverso_tpu as jmv
    from multiverso_tpu.models.wordembedding.communicator import \
        Communicator
    from multiverso_tpu.models.wordembedding.device_pairs import \
        DevicePairsTrainer
    from multiverso_tpu.models.wordembedding.dictionary import Dictionary
    from multiverso_tpu.models.wordembedding.option import Option
    from multiverso_tpu.parallel.mesh import next_bucket

    opt = Option.parse_args([
        "-size", "16", "-epoch", "2", "-negative", "3", "-min_count", "1",
        "-device_pairs", "1"])
    vocab = Dictionary.load_vocab(str(tmp_path / "topics_vocab.txt"), set())
    counts = vocab.counts()
    jmv.MV_Init(["-mv_write_combine=0"])
    try:
        comm = Communicator(opt, vocab.Size())
        trainer = DevicePairsTrainer(opt, comm, counts)
        np.testing.assert_array_equal(np.asarray(trainer._slots),
                                      res["slots"])
        for i in range(nblocks):
            ids = res[f"block{i}_ids"]
            n = len(ids)
            P = 2 * opt.window_size * n
            nb = next_bucket(-(-P // opt.pair_batch_size), min_bucket=4)
            program = trainer._program(n, nb)
            key = jax.random.fold_in(jax.random.PRNGKey(opt.seed), i + 1)
            states, _ = program(trainer._take_states(), (trainer._slots,),
                                jnp.asarray(ids),
                                jnp.asarray(res[f"block{i}_sent"]), key,
                                jnp.float32(res[f"block{i}_lr"]))
            trainer._put_states(states)
        want = [comm.input_table.Get(), comm.output_table.Get()]
    finally:
        jmv.MV_ShutDown()
    for key, w in zip(("input_table", "output_table"), want):
        np.testing.assert_allclose(res[key], w, rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_ragged_host_plane_fails_on_both_ranks(tmp_path):
    _corpus(tmp_path, "ragged", [f"w{i}" for i in range(50)], (400, 150))
    res, _ = run_world("torch", "we_ragged", tmp_path)
    for r in range(2):
        assert float(res[r]["fail_s"]) < 30.0
