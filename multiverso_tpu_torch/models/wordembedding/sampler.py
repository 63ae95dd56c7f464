"""Subsampling + negative-sampling distributions (the port's copy of
``multiverso_tpu/models/wordembedding/sampler.py``).

Behavioral equivalent of reference
Applications/WordEmbedding/src/util.h Sampler (+ util.cpp): the
``unigram^(3/4)`` negative table and the word2vec subsampling keep-rule
``(sqrt(cnt/(sample*total)) + 1) * (sample*total)/cnt``.

The port keeps the JAX package's numpy streams unchanged, so both
packages draw identical pairs from one seed. Sampling is vectorized numpy
on the host (it feeds batch
construction, not device compute). Negatives draw from a quantized slot
table like the reference's 1e8-slot int table (slots per word proportional
to unigram^0.75) — one random gather per draw, ~5x faster than a
``searchsorted`` over the cumulative distribution, at the same (table-
quantized) distribution the reference uses.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np


class Sampler:
    def __init__(self, counts: Sequence[int], power: float = 0.75,
                 seed: int = 1):
        counts = np.asarray(counts, np.float64)
        # thread-local generators spawned from one SeedSequence: block
        # preparation runs in a pool (data.start_loader) and numpy
        # Generators are not thread-safe
        self._seed_seq = np.random.SeedSequence(seed)
        # lazy per-thread streams (threads that never get
        # set_thread_stream) come from a DEDICATED root so they cannot
        # perturb spawn_stream's sequential counter — loader-managed
        # streams stay reproducible no matter how many stray threads
        # touch the sampler or in what order the OS schedules them
        self._lazy_seq = np.random.SeedSequence(
            entropy=seed, spawn_key=(0x6C617A79,))  # 'lazy'
        self._spawn_lock = threading.Lock()
        self._local = threading.local()
        probs = counts ** power
        probs = probs / probs.sum()
        self._cum = np.cumsum(probs)
        # slot table (reference SetNegativeSamplingDistribution): word i
        # owns round(probs[i] * T) consecutive slots. Sized so even a
        # 1-in-a-million word keeps a slot, capped for memory.
        T = int(min(max(1 << 20, 64 * len(counts)), 1 << 24))
        bounds = np.round(self._cum * T).astype(np.int64)
        self._neg_table = np.repeat(
            np.arange(len(counts), dtype=np.int32),
            np.diff(bounds, prepend=0))
        self._counts = counts
        self._total = counts.sum()

    @property
    def _rng(self) -> np.random.Generator:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            with self._spawn_lock:
                child = self._lazy_seq.spawn(1)[0]
            rng = np.random.default_rng(child)
            self._local.rng = rng
        return rng

    def spawn_stream(self) -> np.random.Generator:
        """A fresh deterministic child generator. The block loader spawns
        one per block IN BLOCK ORDER from its single producer thread and
        installs it in whichever pool thread builds that block
        (set_thread_stream) — so seeded runs are reproducible regardless
        of -threads and of OS scheduling."""
        with self._spawn_lock:
            child = self._seed_seq.spawn(1)[0]
        return np.random.default_rng(child)

    def set_thread_stream(self, rng: np.random.Generator) -> None:
        self._local.rng = rng

    def SampleNegatives(self, shape) -> np.ndarray:
        """Vocabulary ids ~ unigram^0.75 (reference SetNegativeSamplingDistribution)."""
        idx = self._rng.integers(0, len(self._neg_table), size=shape)
        return self._neg_table[idx]

    def KeepMask(self, word_ids: np.ndarray, sample: float) -> np.ndarray:
        """Subsampling keep decisions for a sentence
        (reference WordSampling, util.h:55)."""
        if sample <= 0:
            return np.ones(len(word_ids), bool)
        cnt = self._counts[word_ids]
        ratio = (sample * self._total) / np.maximum(cnt, 1)
        keep_prob = np.minimum((np.sqrt(1.0 / ratio) + 1.0) * ratio, 1.0)
        return self._rng.random(len(word_ids)) < keep_prob

    def rand_windows(self, n: int, window: int) -> np.ndarray:
        """Per-position random effective window in [1, window] (word2vec's
        ``b = rand % window`` shrink)."""
        return self._rng.integers(1, window + 1, size=n)
