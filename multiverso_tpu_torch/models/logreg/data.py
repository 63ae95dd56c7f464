"""Sample containers and async readers for LogisticRegression.

The port's copy of ``multiverso_tpu/models/logreg/data.py`` (reference
Applications/LogisticRegression/src/data_type.h and reader.h/.cpp): samples
are batched into fixed-size minibatches — dense (B, input) matrices, or
padded (B, K) key/value/mask triples with K a power-of-two bucket — so a
training step is one batched product, not a per-sample loop. The reader
thread groups ``sync_frequency`` minibatches into a *window* and attaches
the window's unique key set, which is what the PS pulls fetch.

Sparse text is parsed in newline-aligned chunks by the repo's C++ reader
(``native.parse_libsvm``, through the port's own loader) when the library
builds, else line by line with ``parse_line``, as in the JAX package.

Text formats (reference configure.h:56-70):
  default: ``label v1 v2 ...`` (dense) or ``label k:v k:v ...`` (sparse)
  weight:  first column is ``label:weight``; rest like default
  bsparse: binary records: count(u64) label(i32) weight(f64) keys(u64 × count)
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from multiverso_tpu_torch import native
from multiverso_tpu_torch.parallel.mesh import next_bucket
from multiverso_tpu_torch.utils.log import CHECK, Log
from multiverso_tpu_torch.utils.mt_queue import MtQueue


_EMPTY_KEYS = np.empty(0, np.int64)


@dataclass
class SampleBatch:
    """One minibatch, padded to static shapes."""

    labels: np.ndarray                 # (B,) int32
    weights: np.ndarray                # (B,) float32 per-sample weight
    dense: Optional[np.ndarray] = None  # (B, input_size) float32
    keys: Optional[np.ndarray] = None   # (B, K) int32, padded with 0
    values: Optional[np.ndarray] = None  # (B, K) float32, padded with 0
    mask: Optional[np.ndarray] = None    # (B, K) float32 1=valid
    count: int = 0                       # true number of samples (<= B)

    @property
    def sparse(self) -> bool:
        return self.dense is None


def parse_line(line: str, input_size: int, sparse: bool,
               weighted: bool) -> Optional[Tuple[int, float, np.ndarray, np.ndarray]]:
    """-> (label, weight, keys, values); dense lines produce keys=arange."""
    parts = line.split()
    if not parts:
        return None
    head = parts[0]
    if weighted and ":" in head:
        lab, _, w = head.partition(":")
        label, weight = int(float(lab)), float(w)
    else:
        label, weight = int(float(head)), 1.0
    if sparse:
        keys, vals = [], []
        for tok in parts[1:]:
            k, _, v = tok.partition(":")
            keys.append(int(k))
            vals.append(float(v) if v else 1.0)
        key_arr = np.asarray(keys, np.int64)
        if key_arr.size:
            CHECK(0 <= key_arr.min() and key_arr.max() < input_size,
                  f"sparse feature id out of range [0, {input_size})")
        return label, weight, key_arr, np.asarray(vals, np.float32)
    vals = np.asarray([float(x) for x in parts[1:]], np.float32)
    CHECK(vals.size == input_size, f"dense sample width {vals.size} != input_size")
    return label, weight, _EMPTY_KEYS, vals  # dense batching never reads keys


def read_bsparse(path: str) -> Iterator[Tuple[int, float, np.ndarray, np.ndarray]]:
    """Binary-sparse records (reference configure.h:64-69); values are 1."""
    rec = struct.Struct("<qid")
    with open(path, "rb") as f:
        while True:
            head = f.read(rec.size)
            if len(head) < rec.size:
                return
            count, label, weight = rec.unpack(head)
            keys = np.frombuffer(f.read(8 * count), np.int64).copy()
            yield label, weight, keys, np.ones(count, np.float32)


_CHUNK = 8 << 20  # parse ~8MB of text at a time (bounded memory)


def _newline_chunks(path: str) -> Iterator[bytes]:
    """~8MB newline-aligned text chunks (bounded memory on multi-GB
    files); the final partial line flushes at EOF."""
    with open(path, "rb") as f:
        tail = b""
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                if tail:
                    yield tail
                return
            block = tail + chunk
            cut = block.rfind(b"\n")
            if cut < 0:
                tail = block
                continue
            yield block[: cut + 1]
            tail = block[cut + 1:]


def _iter_samples_native(path: str, config) -> Optional[Iterator]:
    """Fast path: newline-aligned chunks through the C++ libsvm reader
    (native/src/reader.cc); sparse text only. None when the library is
    unavailable."""
    if native.lib() is None:
        return None
    weighted = config.reader_type == "weight"

    def gen():
        for text in _newline_chunks(path):
            parsed = native.parse_libsvm(text, weighted=weighted)
            if parsed is None:
                raise RuntimeError("native parser unavailable mid-file")
            labels, weights, offsets, keys, values = parsed
            if keys.size:
                CHECK(0 <= keys.min() and keys.max() < config.input_size,
                      f"sparse feature id out of range "
                      f"[0, {config.input_size})")
            for i in range(len(labels)):
                lo, hi = offsets[i], offsets[i + 1]
                yield (int(labels[i]), float(weights[i]),
                       keys[lo:hi], values[lo:hi])

    return gen()


def _iter_samples_dense_fast(path: str, config) -> Iterator:
    """Vectorized dense-text parse: whole newline-aligned chunks through
    np.loadtxt's C tokenizer instead of a Python loop per line — ~3x the
    line parser on uniform dense files. loadtxt validates per-line column
    counts, so ragged/malformed chunks (including totals that would
    coincidentally reshape) fall back to parse_line for the precise
    per-line CHECK errors."""
    import io

    width = config.input_size + 1
    for text in _newline_chunks(path):
        if not text.strip():
            continue
        rows = None
        try:
            # comments=None: '#' must not act as a comment delimiter — a
            # truncated-at-'#' line whose prefix still has width columns
            # would silently parse differently from parse_line; with
            # comments off such lines raise and take the fallback
            rows = np.loadtxt(io.BytesIO(text), dtype=np.float32, ndmin=2,
                              comments=None)
        except ValueError:
            pass                       # ragged chunk: precise path below
        if rows is not None and rows.shape[1] == width:
            labels = rows[:, 0].astype(np.int32)
            for i in range(rows.shape[0]):
                yield (int(labels[i]), 1.0, _EMPTY_KEYS, rows[i, 1:])
        else:
            for line in text.decode().splitlines():
                if line.lstrip().startswith("#"):
                    continue   # full-line comments skip (loadtxt's old
                               # behavior); a mid-line '#' still errors
                               # precisely in parse_line
                parsed = parse_line(line, config.input_size, False, False)
                if parsed is not None:
                    yield parsed


def iter_samples(files: str, config) -> Iterator[Tuple[int, float, np.ndarray, np.ndarray]]:
    """Stream samples from ';'-separated files (reference configure.h:55)."""
    for path in [p for p in files.split(";") if p]:
        if config.reader_type == "bsparse":
            yield from read_bsparse(path)
            continue
        if not config.sparse and config.reader_type == "default":
            yield from _iter_samples_dense_fast(path, config)
            continue
        if config.sparse:
            fast = _iter_samples_native(path, config)
            if fast is not None:
                yield from fast
                continue
        weighted = config.reader_type == "weight"
        with open(path) as f:
            for line in f:
                parsed = parse_line(line, config.input_size, config.sparse,
                                    weighted)
                if parsed is not None:
                    yield parsed


def batch_samples(samples: Sequence[Tuple[int, float, np.ndarray, np.ndarray]],
                  config, minibatch_size: int) -> SampleBatch:
    """Pad a list of parsed samples into one static-shape SampleBatch."""
    n = len(samples)
    B = minibatch_size
    labels = np.zeros(B, np.int32)
    weights = np.zeros(B, np.float32)   # padding weight 0 => no gradient
    for i, (lab, w, _, _) in enumerate(samples):
        labels[i], weights[i] = lab, w
    if not config.sparse:
        dense = np.zeros((B, config.input_size), np.float32)
        for i, (_, _, _, vals) in enumerate(samples):
            dense[i] = vals
        return SampleBatch(labels, weights, dense=dense, count=n)
    K = next_bucket(max((len(s[2]) for s in samples), default=1))
    keys = np.zeros((B, K), np.int64)
    vals = np.zeros((B, K), np.float32)
    mask = np.zeros((B, K), np.float32)
    for i, (_, _, k, v) in enumerate(samples):
        keys[i, : len(k)] = k
        vals[i, : len(k)] = v
        mask[i, : len(k)] = 1.0
    return SampleBatch(labels, weights, keys=keys, values=vals, mask=mask,
                       count=n)


@dataclass
class Window:
    """``sync_frequency`` minibatches + the unique keys they touch
    (reference reader emits key sets per sync window, reader.h:45)."""

    batches: List[SampleBatch]
    keys: np.ndarray  # unique int64 keys (empty for dense)


class WindowReader:
    """Background thread parsing samples into Windows ahead of training
    (reference SampleReader's parse thread, reader.cpp)."""

    def __init__(self, files: str, config, sync_frequency: int = 1):
        self._config = config
        self._files = files
        self._sync = max(1, sync_frequency)
        cap = max(2, config.read_buffer_size //
                  max(1, config.minibatch_size * self._sync))
        self._queue: MtQueue[Window] = MtQueue()
        self._cap = cap
        self._space = threading.Semaphore(cap)
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        cfg = self._config
        batches: List[SampleBatch] = []
        key_sets: List[np.ndarray] = []
        pending: List = []
        try:
            for sample in iter_samples(self._files, cfg):
                pending.append(sample)
                if len(pending) == cfg.minibatch_size:
                    batches.append(batch_samples(pending, cfg,
                                                 cfg.minibatch_size))
                    if cfg.sparse:
                        key_sets.append(np.concatenate([s[2] for s in pending]))
                    pending = []
                    if len(batches) == self._sync:
                        self._emit(batches, key_sets)
                        batches, key_sets = [], []
            if pending:
                batches.append(batch_samples(pending, cfg, cfg.minibatch_size))
                if cfg.sparse:
                    key_sets.append(np.concatenate([s[2] for s in pending]))
            if batches:
                self._emit(batches, key_sets)
        except Exception as exc:
            Log.Error("[logreg reader] %r", exc)
            self._error = exc  # re-raised at the consumer: a parse error
            # must fail the run, not truncate the dataset silently
        finally:
            self._queue.Exit()

    def _emit(self, batches, key_sets) -> None:
        keys = (np.unique(np.concatenate(key_sets)) if key_sets
                else np.empty(0, np.int64))
        self._space.acquire()
        self._queue.Push(Window(batches=list(batches), keys=keys))

    def next_window(self) -> Optional[Window]:
        ok, window = self._queue.Pop()
        if not ok:
            if self._error is not None:
                raise self._error
            return None
        self._space.release()
        return window


class WindowCache:
    """Parse-once epoch cache (``config.cache_data``): the first epoch
    streams through the normal WindowReader while teeing its windows;
    later epochs replay the IDENTICAL window sequence from memory,
    skipping the text re-parse that otherwise dominates dense epochs
    (the reference re-reads the file every epoch, logreg.cpp:40-45 —
    re-parsing is its cost structure, not a semantic). Budget-capped:
    datasets larger than ``cache_data_mb`` stream every epoch."""

    def __init__(self, budget_mb: int):
        self._budget = budget_mb << 20
        self._windows: Optional[List[Window]] = None
        self._key: Optional[tuple] = None
        self._overflowed = False

    def reader(self, files: str, config, sync: int):
        key = (files, sync, config.minibatch_size)
        if self._key != key:
            self._key, self._windows = key, None
            self._overflowed = False
        if self._windows is not None:
            return _ReplayReader(self._windows)
        if self._overflowed:
            # the dataset already blew the budget once: stream plainly
            # instead of re-buffering up to the budget every epoch
            return WindowReader(files, config, sync)
        return _TeeReader(WindowReader(files, config, sync), self)

    @staticmethod
    def _window_bytes(w: Window) -> int:
        total = w.keys.nbytes
        for b in w.batches:
            for arr in (b.labels, b.weights, b.dense, b.keys, b.values,
                        b.mask):
                if arr is not None:
                    total += arr.nbytes
        return total


class _TeeReader:
    def __init__(self, inner: WindowReader, cache: WindowCache):
        self._inner = inner
        self._cache = cache
        self._acc: Optional[List[Window]] = []
        self._bytes = 0

    def next_window(self) -> Optional[Window]:
        w = self._inner.next_window()
        if w is None:
            if self._acc is not None:
                self._cache._windows = self._acc   # complete epoch captured
            return None
        if self._acc is not None:
            self._bytes += WindowCache._window_bytes(w)
            if self._bytes > self._cache._budget:
                self._acc = None                   # too big: stream epochs
                self._cache._overflowed = True
            else:
                self._acc.append(w)
        return w


class _ReplayReader:
    def __init__(self, windows: List[Window]):
        self._it = iter(windows)

    def next_window(self) -> Optional[Window]:
        return next(self._it, None)
