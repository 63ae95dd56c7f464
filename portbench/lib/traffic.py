"""The one traffic generator: every input of a run made from ``--seed``
and the cell's parameters (``portbench/workloads/<cell>.json``).

Frozen copies of ``chip_smoke.py``'s Zipf corpus writer
(``write_zipf_corpus``, ``zipf_cdf``) and its PS batch makers
(``ps_threads_phase``: unique ids, integer-valued float deltas), so later
changes to that script cannot move the yardstick.
"""

from __future__ import annotations

import os

import numpy as np

#: the word2vec loader's bytes per word (``data.start_loader``): a block
#: closes once 8 * words >= data_block_size
LOADER_BYTES_PER_WORD = 8


def zipf_counts(vocab_size: int, total_words: float, s: float) -> np.ndarray:
    """Word counts under Zipf(s) for a corpus of ``total_words``, rank 0
    the most frequent word; every count at least 1. Non-increasing, so the
    vocabulary's ids (count-sorted, stable) are the ranks."""
    w = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64) ** s
    return np.maximum(np.round(w / w.sum() * total_words), 1).astype(np.int64)


def zipf_tokens(rng, vocab_size: int, s: float, n: int) -> np.ndarray:
    """``n`` token ids drawn under Zipf(s) (inverse CDF)."""
    w = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(n), side="right"),
                      vocab_size - 1).astype(np.int32)


def we_blocks(seed: int, cfg: dict, blocks: int) -> list:
    """``blocks`` loader blocks of Zipf tokens in sentences of
    ``cfg["sentence_words"]``: a list of (n_sentences, sentence_words)
    int32 arrays, each exactly one loader block (the loader closes a block
    at the first sentence that brings it to ``data_block_size`` bytes)."""
    L = int(cfg["sentence_words"])
    per_block = -(-cfg["data_block_size"] // (LOADER_BYTES_PER_WORD * L))
    rng = np.random.default_rng([seed, 24])
    toks = zipf_tokens(rng, cfg["vocab_size"], cfg["zipf_s"],
                       blocks * per_block * L)
    return list(toks.reshape(blocks, per_block, L))


def write_vocab(path: str, counts: np.ndarray) -> None:
    with open(path, "w") as f:
        f.writelines(f"w{i} {int(c)}\n" for i, c in enumerate(counts))


def write_corpus(path: str, blocks: list, vocab_size: int) -> None:
    """Sentences of ``blocks`` as text lines of the words ``w<id>``."""
    words = np.array([f"w{i}" for i in range(vocab_size)], dtype=object)
    with open(path, "w") as f:
        for blk in blocks:
            f.writelines(" ".join(row) + "\n" for row in words[blk])


def we_inputs(seed: int, cfg: dict, blocks: int, workdir: str) -> dict:
    """The WordEmbedding cell's inputs: the vocabulary file (Zipf counts of
    the published corpus size), one corpus file per block (the checked
    steps) and the window's corpus of all blocks."""
    counts = zipf_counts(cfg["vocab_size"], cfg["corpus_words"], cfg["zipf_s"])
    blks = we_blocks(seed, cfg, blocks)
    vocab = os.path.join(workdir, "vocab.txt")
    write_vocab(vocab, counts)
    step_files = []
    for i, b in enumerate(blks):
        p = os.path.join(workdir, f"block{i}.txt")
        write_corpus(p, [b], cfg["vocab_size"])
        step_files.append(p)
    corpus = os.path.join(workdir, "corpus.txt")
    with open(corpus, "w") as out:
        for p in step_files:
            with open(p) as f:
                out.write(f.read())
    return {"counts": counts, "blocks": blks, "vocab": vocab,
            "step_files": step_files, "corpus": corpus}


def ps_pool(seed: int, worker: int, cfg: dict, params: dict) -> list:
    """Worker ``worker``'s pool of rounds: ``params["pool_rounds"]`` batches
    of (ids, deltas), ``params["ids_per_round"]`` unique ids of the
    worker's own quarter of the rows (so every Get has one right answer
    under any interleaving) and integer-valued float32 deltas in
    [-delta_max, delta_max] (exact in float32 at every sum a run reaches)."""
    rows, cols = cfg["num_rows"], cfg["num_cols"]
    lo, hi = own_rows(rows, params["workers"], worker)
    rng = np.random.default_rng([seed, 4, worker])
    n, dmax = params["ids_per_round"], params["delta_max"]
    return [((lo + rng.choice(hi - lo, n, replace=False)).astype(np.int32),
             rng.integers(-dmax, dmax + 1, (n, cols)).astype(np.float32))
            for _ in range(params["pool_rounds"])]


def own_rows(rows: int, workers: int, worker: int) -> tuple:
    """[lo, hi): worker ``worker``'s quarter (share) of the rows."""
    share = -(-rows // workers)
    return worker * share, min(rows, (worker + 1) * share)


def ps_sample(seed: int, worker: int, every: int, n: int = 1 << 20
              ) -> np.ndarray:
    """Which of a worker's rounds keep their Gets for the comparison: a
    random 1 in ``every``, drawn from the seed, round 0 always."""
    keep = np.random.default_rng([seed, 5, worker]).random(n) < 1.0 / every
    keep[0] = True
    return keep
