#!/usr/bin/env python3
"""Smoke run of multiverso_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--json-out PATH] [--baseline DIR]

(``--rank-child R --port P`` runs one rank of ``[ps_2proc]``; the script
starts both ranks itself.)

Drives the port's main path through the entry points a user calls and
holds every kernel of that path against its plain PyTorch version:

0. card     — name and power limit as nvidia-smi gives them; TF32 off;
1. build    — nvcc builds ``multiverso_tpu_torch/csrc/rows.cu`` (sm_90a)
              while g++ builds the repo's C++ library from ``native/src``
              into ``build/native_torch/`` (``native.py``); the run fails
              if either does not build;
2. kernels  — each row kernel against its plain version on the card, at
              the slice's shapes and edge cases (tests/test_torch_rows.py's
              id patterns; the row groups' geometry: n = 1, n below the SM
              count, n not a multiple of a block's rows, 1,000,000 ids of a
              1,000,001 x 52 table, cols 4/52/128/300/1024 and rows of
              16,384 and 16,388 floats, all lanes on the trash row,
              out-of-range ids mid-batch, subnormal values, a misaligned
              table view moving floats): bitwise outside the trash row;
              the error word 0, and set by out-of-range ids, whose lanes
              read zero or leave the table as the valid lanes alone do;
              device times of launches queued back to back behind a spin
              kernel, after warm-up, ids rotating through more rows than
              the 50 MB L2 holds, by two methods: ``ms`` (per-pair: the
              median of 30 launches, each between its own pair of CUDA
              events) and ``stream_ms`` (one event pair around a run of
              30 launches, divided by 30; the median of 5 runs); beside
              the byte bound, the plain version, one PyTorch library call
              and an empty launch timed both ways, plus the
              host-inclusive time of one call; with ``--baseline DIR``
              (another checkout of the repository, e.g. an earlier commit
              unpacked with ``git archive``) also that checkout's gather,
              scatter-set and update, built from its own sources, checked
              bitwise against this one's and timed both ways in turns
              with this one's on the same inputs (baseline, this, this,
              baseline); and at [ps_2proc]'s merged Add (both ranks' ids
              of a round, ~19,900 on the 1,000,001 x 52 storage);
3. PS       — the reference's test_matrix_perf shape: MV_Init on the card,
              a 1,000,000 x 50 MatrixTable with the add updater and one
              with momentum, 5 rounds of AddRows + GetRows of 10,000
              random rows (1%) with integer-valued deltas, every GetRows
              held to a host numpy oracle (add exact, momentum rtol 1e-6),
              on the default engine (the ShardedServer on a host of 8 or
              more cores) and again on ``-mv_engine_shards=1``: the final
              tables bitwise equal; then 4 worker threads on an add and an
              sgd table, each worker on rows of its own, every GetRows and
              both final tables equal to the oracle; BSP (``-sync=true``,
              4 workers): every worker's i-th GetRows equal to the oracle
              after all workers' i-th Adds, and a bounded shutdown;
              model-average (``-ma=true``, 4 workers): no engine,
              MV_CreateTable raises, each worker's MV_Aggregate of a
              1,000,000 x 50 float32 array returns the exact sum;
              checkpoint (``[ckpt]``): the momentum table at that shape
              and a 47,236 x 1 sgd table (the sparse sigmoid LR table)
              take 5 rounds, ``MV_SaveCheckpoint``, 3 more rounds; a new
              world on the card loads the file and takes the same 3
              rounds: data and aux bitwise equal on the card, and the file
              loaded in a world on the CPU equal to the card's load; save
              and load seconds and MB/s; compressed pushes
              (``[ps_compress]``): the add table at that shape with
              ``compress="sparse"`` beside an uncompressed twin, deltas
              80% zeros, rounds in turns: bitwise equal, with the round
              times and the wire ratio; two processes (``[ps_2proc]``):
              after the build, two ranks of this script on ``cuda:0``
              over ``torch.distributed`` (gloo), each keeping a replica
              of the tables, the add and momentum tables at the PS shape,
              5 rounds of AddRows + GetRows of each rank's 10,000 ids
              (overlapping across the ranks) through the windowed
              engine: every GetRows equal to the oracle of both ranks'
              Adds, the final tables bitwise equal across the ranks;
              then BSP (each rank's i-th GetRows against the oracle after
              both ranks' i-th Adds) and, with 2 worker threads a rank,
              MV_Aggregate of a 1,000,000 x 50 float32 array from each of
              the four workers (the exact sum); per rank the round
              medians, the exchange's seconds and share of the rounds,
              and the launches, each rank launching all three kernels;
              a rank that fails or hangs fails the run; and
              ``[ps_2proc burst]``: 200 fire-and-forget AddRows of 2,000
              ids a rank on the add table at the PS shape, on the
              default pipelined engine and on ``-mv_pipeline=0``
              ("serial") in turns (pipelined, serial, serial,
              pipelined): the final table equal to the oracle of both
              ranks' Adds and bitwise equal across the ranks, with the
              burst's seconds, windows, and the engine's exchange and
              apply seconds;
4. WE       — WordEmbedding at the repo's width: 100,000 words x 128,
              skip-gram NEG, 3 blocks of a Zipf corpus made from --seed,
              on ``-device_plane 1 -is_pipeline 0`` and on the host plane
              with the JAX package's defaults (``-device_plane 0
              -is_pipeline 1``, the default engine), and with
              ``-device_pairs 1`` (pairs made on the card, plain SGD: no
              row kernel); loss finite and under 0.69*(1+K) on every
              block. ``-device_pairs 1 -use_adagrad 1`` at the word2vec
              scale, 1,000,000 words x 128 (four 512 MB tables) on 3
              blocks of a Zipf corpus over that vocabulary: the
              touched-rows AdaGrad step on every batch, six row gathers
              and four row scatter-sets a batch; then the gather and the
              scatter-set at that step's shape (the output-lane ids of
              the run's first batches and their dedup'd sets) against
              their plain versions, bitwise, and timed as in phase 2. CBOW
              NEG, skip-gram HS and CBOW HS with ``-device_pairs 1``, one
              block each at 100,000 x 128, each under its untrained loss
              (0.69*(1+K); HS: 0.69 times the corpus's mean Huffman path).
              Every WE run tokenizes through the native tokenizer. On the
              card against the CPU: the device plane on a small topic
              corpus (embeddings rtol 1e-3, atol 1e-4), and that corpus's
              token blocks through ``DevicePairsTrainer.train_block`` on
              the touched-rows step with the same injected draws (all four
              tables rtol 1e-3, atol 1e-4);
5. LR       — the LogisticRegression app through ``LogReg`` on the card, on
              data made from --seed: bench.py's dense softmax (784 x 10,
              6,000 samples, bf16 compute, 9 epochs on the device plane
              and 3 on the host plane: final loss under 0.1); sparse
              sigmoid on the MatrixTable at the RCV1 width (47,236 x 1,
              rows of 4 stored floats, 30 nonzeros a sample, 6,000
              samples, 6 epochs on the device plane: the loss falls every
              epoch); sparse softmax at 10 outputs (rows of 12 floats, 2
              epochs); bench.py's FTRL (1,000 features, 6 epochs on the
              device plane: final loss under 0.1); and a short sparse
              sigmoid run on the card against the same run on the CPU
              (final weights rtol 1e-4, atol 1e-5). On the host plane,
              where the worker pushes its row deltas over the table's
              wire: the sparse sigmoid run uncompressed and with
              ``compress="sparse"`` (weights and every epoch's loss
              bitwise equal), and the sparse softmax run with
              ``compress="1bit"`` (the loss falls every epoch; its
              wire_stats). The sparse and FTRL
              runs must parse their text through the native libsvm
              reader, and FTRL's KV tables must use the native slot
              index. Phase 2 holds the row
              kernels to their plain versions, and times them, at both
              sparse geometries with the first window's row set;
6. summary  — a ``{"kernels": [...]}`` line, the card line, and last
              ``{"ok": true, "device": {...}}``.

Each main path of phases 3 to 5 runs with the launch counters (and the
native library's call counters) zeroed just before it and read just
after: each kernel that path runs must have launched there, and the
``kernels`` line sums the paths. Any failure
raises and the script exits non-zero without the ``ok`` line. Without a
CUDA device, or away from the repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PS_ROWS, PS_COLS, PS_IDS, PS_ROUNDS = 1_000_000, 50, 10_000, 5
WE_VOCAB, WE_DIM, WE_NEG, WE_WINDOW = 100_000, 128, 5, 5
WE_BLOCK_BYTES, WE_BLOCKS, WE_SENT_LEN = 2_000_000, 3, 20
# [we_pairs_adagrad]: the word2vec scale the touched-rows AdaGrad step is
# for (multiverso_tpu/models/wordembedding/device_pairs.py:99-104), at the
# AdaGrad rate of tests/test_wordembedding.py's runs
WE_BIG_VOCAB, WE_ADAGRAD_LR = 1_000_000, 0.1
TIMED_RUNS, WARMUP_RUNS, ID_SETS, STREAM_RUNS = 30, 5, 40, 5
SPIN_CYCLES = 100_000_000       # ~50 ms at H100 clocks: holds the stream
PS_WORKERS = 4                  # worker threads of the threaded PS, BSP, MA
JOIN_S = 300                    # a worker thread or shutdown past this hung
RANK_CHILD_S = 600              # a [ps_2proc] rank past this hung
# [ps_2proc burst]: fire-and-forget AddRows a rank (after BURST_WARM
# untimed ones) of BURST_IDS ids each, ~20 windows of the engine's 4 MB
# budget; the default pipelined engine and -mv_pipeline=0 in turns
BURST_VERBS, BURST_WARM, BURST_IDS = 200, 10, 2_000
BURST_TURNS = ("pipeline", "serial", "serial", "pipeline")
# LogisticRegression: bench.py's app configurations (bench.py:446-553) and
# the RCV1 width (bench.py:44)
LR_DENSE_IN, LR_DENSE_OUT, LR_SAMPLES = 784, 10, 6_000
LR_SPARSE_IN, LR_SOFTMAX_OUT, LR_FTRL_IN, LR_NNZ = 47_236, 10, 1_000, 30
LR_MINIBATCH, LR_SPARSE_SYNC = 20, 50    # the app's default minibatch
LR_EPOCHS = {"lr_dense": 9, "lr_dense_host": 3, "lr_sparse": 6,
             "lr_softmax": 2, "lr_ftrl": 6, "lr_sparse_host": 6,
             "lr_sparse_compress": 6, "lr_softmax_1bit": 2}
# [ckpt]: rounds run after the save, and again after the load; the LR
# table's keys a round (about a window's distinct keys at the RCV1 width)
CKPT_ROUNDS, CKPT_LR_KEYS = 3, 20_000
# [ps_compress]: the share of each delta's entries that are zero
# (tests/test_tables.py:853-872, where the sparse filter's rule engages)
COMPRESS_ZEROS = 0.8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# -- phase 2: kernels against their plain versions --------------------------

def _event(torch):
    return torch.cuda.Event(enable_timing=True)


def _spin(torch):
    """Queue a spin kernel that holds the stream while the host enqueues
    the runs behind it; returns the events before and after it."""
    spin_start, held = _event(torch), _event(torch)
    spin_start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    held.record()
    return spin_start, held


def _check_spin(spin_start, held, enqueue_ms: float) -> None:
    """After a synchronise: raise if the spin ended before the host
    finished enqueuing (the timed runs would then include idle time)."""
    if enqueue_ms >= spin_start.elapsed_time(held):
        raise AssertionError(f"spin of {spin_start.elapsed_time(held):.2f} "
                             f"ms ended before the {enqueue_ms:.2f} ms "
                             f"enqueue: raise SPIN_CYCLES")


def _warm_up(torch, fn, n_sets: int) -> None:
    for i in range(WARMUP_RUNS):
        fn(i % n_sets)
    torch.cuda.synchronize()


def median_ms(torch, fn, n_sets: int) -> float:
    """Per-pair DEVICE time of ``fn(i)``: the median over TIMED_RUNS runs
    after WARMUP_RUNS, ``i`` rotating through ``n_sets`` input sets. A spin
    kernel holds the stream while the host enqueues every run between its
    own pair of CUDA events, so the runs execute back to back and each
    pair times the device work, not the host's Python between launches;
    each pair also holds the two event records around its launch."""
    _warm_up(torch, fn, n_sets)
    events = [(_event(torch), _event(torch)) for _ in range(TIMED_RUNS)]
    spin_start, held = _spin(torch)
    t0 = time.perf_counter()
    for i, (start, end) in enumerate(events):
        start.record()
        fn((i + WARMUP_RUNS) % n_sets)
        end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    _check_spin(spin_start, held, enqueue_ms)
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def stream_ms(torch, fn, n_sets: int) -> float:
    """Stream DEVICE time of ``fn(i)``: one pair of CUDA events around
    TIMED_RUNS runs queued back to back behind a spin kernel, divided by
    TIMED_RUNS, with no event between the launches; the median of
    STREAM_RUNS such runs, ``i`` rotating through ``n_sets`` input sets
    across all of them."""
    _warm_up(torch, fn, n_sets)
    per_launch, k = [], WARMUP_RUNS
    for _ in range(STREAM_RUNS):
        spin_start, start = _spin(torch)
        end = _event(torch)
        t0 = time.perf_counter()
        for _ in range(TIMED_RUNS):
            fn(k % n_sets)
            k += 1
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        _check_spin(spin_start, start, enqueue_ms)
        per_launch.append(start.elapsed_time(end) / TIMED_RUNS)
    return float(np.median(per_launch))


def call_ms(torch, fn, n_sets: int) -> float:
    """Median host-inclusive time of one call (event before the Python
    call, event after it, stream idle in between): what a caller that
    waits on each launch pays, wrapper overhead included."""
    times = []
    for i in range(TIMED_RUNS):
        start, end = _event(torch), _event(torch)
        torch.cuda.synchronize()
        start.record()
        fn(i % n_sets)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _clone_in_place(torch, t):
    """A copy of ``t`` as far off 16-byte alignment as ``t`` is."""
    off = (t.data_ptr() % 16) // t.element_size()
    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    return flat[off:].view(t.shape).copy_(t)


def _check_rows(torch, cr, dev, data, ids_np, src, name):
    """One case: the gather, the scatter-set and the update (both signs,
    with and without the post-update rows) against their plain versions on
    the card, bitwise outside the trash row (the last row). Ids outside
    the table must set the error word, read zero in every gathered or
    out_rows lane, and leave the table as the plain scatter-set or update
    of the valid lanes leaves it."""
    rows = data.shape[0]
    trash = rows - 1
    bad_np = (ids_np < 0) | (ids_np >= rows)
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
    good = torch.from_numpy(~bad_np).to(dev)
    live = torch.from_numpy(~bad_np & (ids_np != trash)).to(dev)
    ids_ok = ids[good]
    torch.cuda.synchronize()
    cr.reset_error(dev)
    got = cr.gather_rows(data, ids)
    want = torch.zeros_like(got)
    want[good] = cr.gather_rows_plain(data, ids_ok)
    if not torch.equal(got, want):
        raise AssertionError(f"gather {name}")
    a, b = _clone_in_place(torch, data), data.clone()
    cr.scatter_set_rows(a, ids, src)
    cr.scatter_set_rows_plain(b, ids_ok, src[good])
    if not torch.equal(a[:trash], b[:trash]):
        raise AssertionError(f"scatter-set {name}")
    for sign in (1, -1):
        for want_rows in (False, True):
            a, b = _clone_in_place(torch, data), data.clone()
            res = cr.update_rows(a, ids, src, sign, want_rows=want_rows)
            _, rb = cr.update_rows_plain(b, ids_ok, src[good], sign)
            if not torch.equal(a[:trash], b[:trash]):
                raise AssertionError(f"update{sign:+d} want_rows={want_rows}"
                                     f" {name}: table")
            if want_rows:
                ra = res[1]
                full = torch.zeros_like(ra)
                full[good] = rb
                if not (torch.equal(ra[live], full[live])
                        and torch.equal(ra[~good], full[~good])):
                    raise AssertionError(f"update{sign:+d} {name}: rows")
    torch.cuda.synchronize()
    err = cr.read_error(dev)
    if err != int(bad_np.any()):
        raise AssertionError(f"{name}: error word {err}, bad ids "
                             f"{int(bad_np.sum())}")
    cr.reset_error(dev)


def edge_cases(torch, cr, dev) -> None:
    """tests/test_torch_rows.py's cases and the row groups' geometry on
    the card: kernel == plain bitwise outside the trash row."""
    rng = np.random.default_rng(7)

    def table(rows, cols, scale=1.0):
        return torch.from_numpy((rng.standard_normal((rows, cols))
                                 * scale).astype(np.float32)).to(dev)

    def unique(rows, n):
        return rng.permutation(rows - 1)[:n]

    # the first slice's cases: id patterns at cols 128 / 50 / 52
    rows, n = 200, 100
    trash = rows - 1
    patterns = {
        "random": rng.permutation(trash)[:n],
        "consecutive": np.concatenate([np.arange(17, 81), rng.permutation(
            np.setdiff1d(np.arange(trash), np.arange(17, 81)))[:n - 64]]),
        "pad_only": np.full(n, trash),
        "trash_dups": rng.permutation(np.concatenate(
            [rng.permutation(trash)[:n - 20], np.full(20, trash)])),
    }
    for cols in (128, 50, 52):
        data, src = table(rows, cols), table(n, cols)
        for name, ids_np in patterns.items():
            _check_rows(torch, cr, dev, data, ids_np, src,
                        f"{name} cols={cols}")
    # the row groups' geometry: (name, table rows, cols, ids)
    cases = [("n=1", 200, 52, unique(200, 1)),
             ("n=7 (below the SM count)", 200, 52, unique(200, 7)),
             ("n=1001 (not a multiple of a block's rows)", 5000, 52,
              unique(5000, 1001))]
    for cols in (4, 52, 128, 300):
        cases.append((f"cols={cols}, n=5000", 20_001, cols,
                      unique(20_001, 5000)))
    cases.append(("cols=1024 (a warp looping over a row)", 5_001, 1_024,
                  unique(5_001, 1_000)))
    cases += [("cols=128, n=20000 (several grid strides)", 100_001, 128,
               unique(100_001, 20_000)),
              ("cols=16384", 301, 16_384, unique(301, 100)),
              ("cols=16388, n=300", 301, 16_388, unique(301, 300)),
              ("all lanes on the trash row", 2001, 52, np.full(1001, 2000))]
    mid = unique(5000, 1001)
    mid[500], mid[700] = 5000, -1
    cases.append(("out-of-range ids mid-batch", 5000, 52, mid))
    for name, rows, cols, ids_np in cases:
        _check_rows(torch, cr, dev, table(rows, cols), ids_np,
                    table(len(ids_np), cols), name)
    # subnormal rows and deltas: no flush to zero on either side
    _check_rows(torch, cr, dev, table(2001, 52, 1e-39), unique(2001, 1000),
                table(1000, 52, 1e-39), "subnormal values")
    # many more tiles than the grid holds: 1,000,000 ids of 1,000,001 x 52
    big = table(1_000_001, 52)
    _check_rows(torch, cr, dev, big, rng.permutation(1_000_000),
                table(1_000_000, 52), "n=1,000,000 of 1,000,001 x 52")
    del big
    # a table view 4 bytes off 16-byte alignment: rows move as floats
    flat = table(1, 200 * 52 + 1).reshape(-1)
    _check_rows(torch, cr, dev, flat[1:].view(200, 52), unique(200, 100),
                table(100, 52), "misaligned view")
    log(f"[kernels] edge cases: kernel == plain (bitwise outside the trash "
        f"row) for gather, scatter-set and update +/-1 with and without "
        f"post-update rows; first-slice id patterns at cols 128/50/52; "
        f"{'; '.join(c[0] for c in cases)}; subnormal values; n=1,000,000 "
        f"of 1,000,001 x 52; a misaligned view moving floats. "
        f"Error word 0 on valid ids, set by out-of-range ids, whose lanes "
        f"read zero and write nothing")


def time_kernels(torch, cr, dev, rows: int, cols: int, n: int,
                 seed: int) -> dict:
    """Kernel vs plain vs library at one shape, ids cycling through
    ID_SETS random unique sets (more rows than L2 holds)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    data = torch.randn(rows + 1, cols, generator=g).to(dev)   # + trash row
    ids = [torch.randperm(rows, generator=g)[:n].to(torch.int32).to(dev)
           for _ in range(ID_SETS)]
    ids64 = [i.long() for i in ids]
    src = [torch.randn(n, cols, generator=g).to(dev) for _ in range(ID_SETS)]
    res = {}

    def entry(name, kernel, plain, library, err, nbytes):
        res[name] = {
            "ms": median_ms(torch, kernel, ID_SETS),
            "stream_ms": stream_ms(torch, kernel, ID_SETS),
            "call_ms": call_ms(torch, kernel, ID_SETS),
            "plain_ms": median_ms(torch, plain, ID_SETS),
            "library_ms": median_ms(torch, library, ID_SETS),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err, "shape": [rows + 1, cols, n]}

    # gather
    err = max(float((cr.gather_rows(data, ids[i])
                     - cr.gather_rows_plain(data, ids[i])).abs().max())
              for i in range(3))
    entry("gather_rows", lambda i: cr.gather_rows(data, ids[i]),
          lambda i: cr.gather_rows_plain(data, ids[i]),
          lambda i: torch.index_select(data, 0, ids64[i]), err,
          2 * n * cols * 4 + 4 * n)
    # scatter-set
    a, b = data.clone(), data.clone()
    cr.scatter_set_rows(a, ids[0], src[0])
    cr.scatter_set_rows_plain(b, ids[0], src[0])
    err = float((a - b).abs().max())
    entry("scatter_set_rows", lambda i: cr.scatter_set_rows(a, ids[i], src[i]),
          lambda i: cr.scatter_set_rows_plain(b, ids[i], src[i]),
          lambda i: b.index_copy_(0, ids64[i], src[i]), err,
          2 * n * cols * 4 + 4 * n)
    # fused update, add (+1), the engine's Add path
    a, b = data.clone(), data.clone()
    cr.update_rows(a, ids[0], src[0], 1)
    cr.update_rows_plain(b, ids[0], src[0], 1)
    err = float((a - b).abs().max())
    entry("update_rows", lambda i: cr.update_rows(a, ids[i], src[i], 1),
          lambda i: cr.update_rows_plain(b, ids[i], src[i], 1),
          lambda i: b.index_add_(0, ids64[i], src[i]), err,
          3 * n * cols * 4 + 4 * n)
    # the other update variants, reported beside: sgd (-1) and Add+Get
    a, b = data.clone(), data.clone()
    cr.update_rows(a, ids[0], src[0], -1)
    cr.update_rows_plain(b, ids[0], src[0], -1)
    res["update_rows_sgd_max_abs_err"] = float((a - b).abs().max())
    res["update_rows_sgd_plain_ms"] = median_ms(
        torch, lambda i: cr.update_rows_plain(b, ids[i], src[i], -1), ID_SETS)
    variants = {
        "update_rows_sgd": lambda i: cr.update_rows(a, ids[i], src[i], -1),
        "update_gather_rows": lambda i: cr.update_rows(
            a, ids[i], src[i], 1, want_rows=True),
        # an empty launch timed both ways: the floor of either method
        "empty_launch": lambda i: torch.cuda._sleep(0)}
    for name, fn in variants.items():
        res[f"{name}_ms"] = median_ms(torch, fn, ID_SETS)
        res[f"{name}_stream_ms"] = stream_ms(torch, fn, ID_SETS)
    res["update_rows_sgd_library_ms"] = median_ms(
        torch, lambda i: b.index_add_(0, ids64[i], src[i], alpha=-1),
        ID_SETS)
    res["update_gather_rows_bound_ms"] = (
        (4 * n * cols * 4 + 4 * n) / HBM_BYTES_PER_S * 1e3)
    torch.cuda.synchronize()
    if cr.read_error(dev) != 0:
        raise AssertionError("error word set during timing")
    return res


class FirstBatches:
    """While installed, records the output-lane storage ids of the first
    ``n`` batches the touched-rows AdaGrad step trains (the ids its first
    row gather reads; their dedup'd set is what its output-table
    scatter-set writes)."""

    def __init__(self, dp, n: int):
        self.dp, self.n, self.outputs = dp, n, []

    def __enter__(self):
        self.step = self.dp.sparse_adagrad_step

        def recording(state, inputs, imask, outputs, *rest):
            if len(self.outputs) < self.n:
                self.outputs.append(outputs.reshape(-1).clone())
            return self.step(state, inputs, imask, outputs, *rest)

        self.dp.sparse_adagrad_step = recording
        return self

    def __exit__(self, *exc):
        self.dp.sparse_adagrad_step = self.step


def time_touched_rows(torch, cr, dev, table_rows: int, cols: int,
                      outputs: list, seed: int) -> dict:
    """The row gather and scatter-set at the touched-rows AdaGrad step's
    shape: a (table_rows, cols) storage table (the last row the trash
    row), the gather on each recorded batch's output-lane ids (duplicates
    included), the scatter-set on their dedup'd set (pad lanes on the
    trash row). Bitwise against the plain versions (the scatter-set
    outside the trash row), timed both ways beside the plain version,
    ``index_select`` / ``index_copy_`` and the byte bound of this data:
    the gather reads each distinct row once and writes every lane's row;
    the scatter-set reads one source row and writes one table row for
    each distinct id (the trash row once: its content is free, so its
    lanes need one source row between them); both read every lane's id."""
    from multiverso_tpu_torch import ops
    g = torch.Generator(device="cpu").manual_seed(seed)
    data = torch.randn(table_rows, cols, generator=g).to(dev)
    trash = table_rows - 1
    gather_ids = [o.to(dev).contiguous() for o in outputs]
    set_ids = []
    for ids in gather_ids:
        u, _ = ops.dedup_rows(ids, torch.zeros((ids.shape[0], 1),
                                               device=dev))
        set_ids.append(torch.where(u < 0, trash, u).contiguous())
    n = gather_ids[0].shape[0]
    src = [torch.randn(n, cols, generator=g).to(dev) for _ in set_ids]
    g64 = [i.long() for i in gather_ids]
    s64 = [i.long() for i in set_ids]
    sets = len(gather_ids)
    err_g = 0.0
    for i, ids in enumerate(gather_ids):
        got, want = cr.gather_rows(data, ids), cr.gather_rows_plain(data, ids)
        if not torch.equal(got, want):
            raise AssertionError(f"touched-rows gather, batch {i}")
        err_g = max(err_g, float((got - want).abs().max()))
    a, b = data.clone(), data.clone()
    err_s = 0.0
    for i, sid in enumerate(set_ids):
        cr.scatter_set_rows(a, sid, src[i])
        cr.scatter_set_rows_plain(b, sid, src[i])
        if not torch.equal(a[:trash], b[:trash]):
            raise AssertionError(f"touched-rows scatter-set, batch {i}")
        err_s = max(err_s, float((a[:trash] - b[:trash]).abs().max()))
    uniq_g = [int(torch.unique(i).numel()) for i in gather_ids]
    uniq_s = [int(torch.unique(i).numel()) for i in set_ids]
    res = {"gather_rows": {
        "ms": median_ms(torch, lambda i: cr.gather_rows(
            data, gather_ids[i]), sets),
        "stream_ms": stream_ms(torch, lambda i: cr.gather_rows(
            data, gather_ids[i]), sets),
        "plain_ms": median_ms(torch, lambda i: cr.gather_rows_plain(
            data, gather_ids[i]), sets),
        "library_ms": median_ms(torch, lambda i: torch.index_select(
            data, 0, g64[i]), sets),
        "bound_ms": float(np.mean([(u * cols * 4 + n * cols * 4 + 4 * n)
                                   for u in uniq_g])) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": err_g, "shape": [table_rows, cols, n],
        "distinct_rows": float(np.mean(uniq_g))}}
    res["scatter_set_rows"] = {
        "ms": median_ms(torch, lambda i: cr.scatter_set_rows(
            a, set_ids[i], src[i]), sets),
        "stream_ms": stream_ms(torch, lambda i: cr.scatter_set_rows(
            a, set_ids[i], src[i]), sets),
        "plain_ms": median_ms(torch, lambda i: cr.scatter_set_rows_plain(
            b, set_ids[i], src[i]), sets),
        "library_ms": median_ms(torch, lambda i: b.index_copy_(
            0, s64[i], src[i]), sets),
        "bound_ms": float(np.mean([(2 * u * cols * 4 + 4 * n)
                                   for u in uniq_s])) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": err_s, "shape": [table_rows, cols, n],
        "distinct_rows": float(np.mean(uniq_s))}
    # beside it, the same scatter-set without the pad lanes (dedup_rows
    # leaves them at the tail, all on the one trash row): what the lanes
    # that all write one row cost
    live = [sid[: int((sid != trash).sum())] for sid in set_ids]
    res["scatter_set_rows"].update(
        live_lanes=float(np.mean([x.shape[0] for x in live])),
        live_ms=median_ms(torch, lambda i: cr.scatter_set_rows(
            a, live[i], src[i][: live[i].shape[0]]), sets),
        live_stream_ms=stream_ms(torch, lambda i: cr.scatter_set_rows(
            a, live[i], src[i][: live[i].shape[0]]), sets))
    torch.cuda.synchronize()
    if cr.read_error(dev) != 0:
        raise AssertionError("error word set at the touched-rows shape")
    return res


def import_rows_module(root: str):
    """``multiverso_tpu_torch/ops/cuda_rows.py`` of another checkout, as a
    module of its own (its own launch counts, error words and library)."""
    import importlib.util
    path = os.path.join(os.path.abspath(root), "multiverso_tpu_torch", "ops",
                        "cuda_rows.py")
    spec = importlib.util.spec_from_file_location("baseline_cuda_rows", path)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs: its dataclasses look their module up
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def compare_baseline(torch, cr, base, dev, rows: int, cols: int, n: int,
                     seed: int) -> dict:
    """The baseline checkout's gather, scatter-set, update (+1, -1) and
    Add+Get against this checkout's, through the public wrappers on the
    same inputs, each timed per pair (``median_ms``) and by stream
    (``stream_ms``) in turns: baseline, this, this, baseline. Results must
    agree bitwise."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    data = torch.randn(rows + 1, cols, generator=g).to(dev)
    ids = [torch.randperm(rows, generator=g)[:n].to(torch.int32).to(dev)
           for _ in range(ID_SETS)]
    src = [torch.randn(n, cols, generator=g).to(dev) for _ in range(ID_SETS)]
    if not torch.equal(base.gather_rows(data, ids[0]),
                       cr.gather_rows(data, ids[0])):
        raise AssertionError("baseline and this gather disagree")
    a, b = data.clone(), data.clone()
    base.scatter_set_rows(a, ids[0], src[0])
    cr.scatter_set_rows(b, ids[0], src[0])
    if not torch.equal(a, b):
        raise AssertionError("baseline and this scatter-set disagree")
    for sign in (1, -1):
        a, b = data.clone(), data.clone()
        _, ra = base.update_rows(a, ids[0], src[0], sign, want_rows=True)
        _, rb = cr.update_rows(b, ids[0], src[0], sign, want_rows=True)
        if not (torch.equal(a, b) and torch.equal(ra, rb)):
            raise AssertionError(f"baseline and this update{sign:+d} "
                                 f"disagree")
    tables = {"baseline": data.clone(), "this": data.clone()}
    mods = {"baseline": base, "this": cr}

    def calls(who):
        m, t = mods[who], tables[who]
        return {
            "gather_rows": lambda i: m.gather_rows(data, ids[i]),
            "scatter_set_rows": lambda i: m.scatter_set_rows(t, ids[i],
                                                             src[i]),
            "update_rows": lambda i: m.update_rows(t, ids[i], src[i], 1),
            "update_rows_sgd": lambda i: m.update_rows(t, ids[i], src[i], -1),
            "update_gather_rows": lambda i: m.update_rows(
                t, ids[i], src[i], 1, want_rows=True)}

    fns = {who: calls(who) for who in mods}
    res = {k: {m: {"baseline": [], "this": []} for m in ("ms", "stream_ms")}
           for k in fns["this"]}
    for k in res:
        for who in ("baseline", "this", "this", "baseline"):
            res[k]["ms"][who].append(median_ms(torch, fns[who][k], ID_SETS))
            res[k]["stream_ms"][who].append(
                stream_ms(torch, fns[who][k], ID_SETS))
    torch.cuda.synchronize()
    if base.read_error(dev) != 0 or cr.read_error(dev) != 0:
        raise AssertionError("error word set during the baseline turns")
    return res


# -- phase 3: the PS row protocol on each engine mode -------------------------

def run_threads(fn, n: int) -> None:
    """``fn(w)`` on ``n`` threads; re-raises the first failure here."""
    errors = []

    def guarded(w):
        try:
            fn(w)
        except BaseException as exc:        # re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=guarded, args=(w,)) for w in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a worker thread hung past {JOIN_S} s")
    if errors:
        raise errors[0]


def shut_down(mv, what: str) -> float:
    """MV_ShutDown, bounded: a world that does not come down (a BSP drain
    that never completes) fails the phase. Returns the seconds it took."""
    t0 = time.perf_counter()
    done = threading.Thread(target=mv.MV_ShutDown, daemon=True)
    done.start()
    done.join(JOIN_S)
    if done.is_alive():
        raise AssertionError(f"{what}: MV_ShutDown hung past {JOIN_S} s")
    return time.perf_counter() - t0


def engine_info() -> dict:
    """The running world's engine: class, resolved shard cap, live slots."""
    from multiverso_tpu_torch.sync.server import engine_shard_cap
    from multiverso_tpu_torch.zoo import Zoo
    eng = Zoo.Get().server_engine
    return {"engine": type(eng).__name__, "shard_cap": engine_shard_cap(),
            "live_slots": [s["slot"] for s in eng.shard_states()],
            "cores": os.cpu_count()}


def ps_phase(torch, mv, cr, dev, seed: int, argv=()) -> tuple:
    """The PS script on the engine ``argv`` selects (default: the JAX
    package's default engine). Returns (stats, final tables)."""
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.updaters.base import AddOption
    rng = np.random.default_rng(seed)
    mv.MV_Init(list(argv))
    try:
        add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                  num_cols=PS_COLS))
        mom = mv.MV_CreateTable(MatrixTableOption(
            num_rows=PS_ROWS, num_cols=PS_COLS, updater_type="momentum"))
        if add.server().state["data"].device != dev:
            raise AssertionError("the PS tables are not on the card")
        info = engine_info()
        m = np.float32(0.5)
        mopt = AddOption(momentum=float(m))
        oracle_add = np.zeros((PS_ROWS, PS_COLS), np.float32)
        oracle_mom = np.zeros((PS_ROWS, PS_COLS), np.float32)
        smooth = np.zeros((PS_ROWS, PS_COLS), np.float32)
        add_ms, mom_ms = [], []
        for r in range(PS_ROUNDS):
            ids = rng.choice(PS_ROWS, PS_IDS, replace=False).astype(np.int32)
            deltas = rng.integers(-3, 4, (PS_IDS, PS_COLS)).astype(
                np.float32)
            t0 = time.perf_counter()
            add.AddRows(ids, deltas)
            got_add = add.GetRows(ids)
            add_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            mom.AddRows(ids, deltas, mopt)
            got_mom = mom.GetRows(ids)
            mom_ms.append((time.perf_counter() - t0) * 1e3)
            oracle_add[ids] += deltas
            smooth[ids] = m * smooth[ids] + (np.float32(1) - m) * deltas
            oracle_mom[ids] -= smooth[ids]
            np.testing.assert_array_equal(got_add, oracle_add[ids])
            np.testing.assert_allclose(got_mom, oracle_mom[ids], rtol=1e-6,
                                       atol=1e-6)
        final = {"add": add.Get(), "momentum": mom.Get()}
        np.testing.assert_array_equal(final["add"], oracle_add)
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError("error word set on the PS path")
    finally:
        mv.MV_ShutDown()
    return dict(info, add_round_ms=add_ms, momentum_round_ms=mom_ms,
                add_round_median_ms=float(np.median(add_ms)),
                momentum_round_median_ms=float(np.median(mom_ms))), final


def ps_threads_phase(torch, mv, cr, dev, seed: int) -> dict:
    """PS_WORKERS worker threads on the default engine, an add table and
    an sgd table (two shards): worker w owns rows w, w + PS_WORKERS, ...,
    so each tracked GetRows must equal that worker's own oracle exactly,
    and after the join each whole table the combined oracle."""
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.zoo import Zoo
    mv.MV_Init([f"-num_workers={PS_WORKERS}"])
    try:
        add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                  num_cols=PS_COLS))
        sgd = mv.MV_CreateTable(MatrixTableOption(
            num_rows=PS_ROWS, num_cols=PS_COLS, updater_type="sgd"))
        info = engine_info()
        own = [np.zeros((-(-PS_ROWS // PS_WORKERS), PS_COLS), np.float32)
               for _ in range(PS_WORKERS)]
        round_ms = [[] for _ in range(PS_WORKERS)]

        def worker(w):
            rng = np.random.default_rng([seed, w])
            rows = np.arange(w, PS_ROWS, PS_WORKERS)
            with Zoo.Get().worker_context(w):
                for _ in range(PS_ROUNDS):
                    ids = rng.choice(rows, PS_IDS, replace=False).astype(
                        np.int32)
                    deltas = rng.integers(-3, 4, (PS_IDS, PS_COLS)).astype(
                        np.float32)
                    t0 = time.perf_counter()
                    add.AddRows(ids, deltas)
                    got_add = add.GetRows(ids)
                    sgd.AddRows(ids, deltas)
                    got_sgd = sgd.GetRows(ids)
                    round_ms[w].append((time.perf_counter() - t0) * 1e3)
                    own[w][ids // PS_WORKERS] += deltas
                    np.testing.assert_array_equal(got_add,
                                                  own[w][ids // PS_WORKERS])
                    np.testing.assert_array_equal(got_sgd,
                                                  -own[w][ids // PS_WORKERS])

        run_threads(worker, PS_WORKERS)
        oracle = np.zeros((PS_ROWS, PS_COLS), np.float32)
        for w in range(PS_WORKERS):
            oracle[w::PS_WORKERS] = own[w][:len(range(w, PS_ROWS,
                                                      PS_WORKERS))]
        np.testing.assert_array_equal(add.Get(), oracle)
        np.testing.assert_array_equal(sgd.Get(), -oracle)
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError("error word set on the threaded PS path")
    finally:
        mv.MV_ShutDown()
    flat = [x for ms in round_ms for x in ms]
    return dict(info, round_ms=round_ms,
                round_median_ms=float(np.median(flat)))


def bsp_phase(torch, mv, cr, dev, seed: int) -> dict:
    """-sync=true: PS_WORKERS threads, PS_ROUNDS rounds of AddRows then
    GetRows of PS_IDS random ids each; every worker's i-th GetRows must
    equal the oracle after ALL workers' i-th Adds, at that worker's ids."""
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.zoo import Zoo
    scripts = []
    for w in range(PS_WORKERS):
        rng = np.random.default_rng([seed, 100 + w])
        scripts.append([(rng.choice(PS_ROWS, PS_IDS, replace=False).astype(
            np.int32), rng.integers(-3, 4, (PS_IDS, PS_COLS)).astype(
                np.float32)) for _ in range(PS_ROUNDS)])
    got = [[] for _ in range(PS_WORKERS)]
    round_ms = [[] for _ in range(PS_WORKERS)]
    mv.MV_Init(["-sync=true", f"-num_workers={PS_WORKERS}"])
    try:
        info = engine_info()
        if info["engine"] != "SyncServer":
            raise AssertionError(f"-sync=true built {info['engine']}")
        table = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                    num_cols=PS_COLS))

        def worker(w):
            with Zoo.Get().worker_context(w):
                for ids, deltas in scripts[w]:
                    t0 = time.perf_counter()
                    table.AddRows(ids, deltas)
                    got[w].append(table.GetRows(ids))
                    round_ms[w].append((time.perf_counter() - t0) * 1e3)

        run_threads(worker, PS_WORKERS)
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError("error word set on the BSP path")
    finally:
        shutdown_s = shut_down(mv, "BSP world")
    oracle = np.zeros((PS_ROWS, PS_COLS), np.float32)
    for i in range(PS_ROUNDS):
        for w in range(PS_WORKERS):
            ids, deltas = scripts[w][i]
            oracle[ids] += deltas
        for w in range(PS_WORKERS):
            np.testing.assert_array_equal(got[w][i], oracle[scripts[w][i][0]],
                                          err_msg=f"worker {w} GetRows {i}")
    flat = [x for ms in round_ms for x in ms]
    return dict(info, round_ms=round_ms, shutdown_s=shutdown_s,
                round_median_ms=float(np.median(flat)))


def ma_phase(mv, seed: int) -> dict:
    """-ma=true: no engine, MV_CreateTable raises, and PS_WORKERS threads
    each MV_Aggregate a PS_ROWS x PS_COLS float32 array and receive the
    exact sum (float64 accumulation, cast back)."""
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.utils.log import FatalError
    from multiverso_tpu_torch.zoo import Zoo
    arrays = [np.random.default_rng([seed, 200 + w]).standard_normal(
        (PS_ROWS, PS_COLS), dtype=np.float32) for w in range(PS_WORKERS)]
    acc = arrays[0].astype(np.float64)
    for a in arrays[1:]:
        acc += a
    want = acc.astype(np.float32)
    del acc
    secs = [0.0] * PS_WORKERS
    mv.MV_Init(["-ma=true", f"-num_workers={PS_WORKERS}"])
    try:
        if Zoo.Get().server_engine is not None:
            raise AssertionError("-ma=true started an engine")
        try:
            mv.MV_CreateTable(MatrixTableOption(num_rows=8, num_cols=2))
        except FatalError:
            pass
        else:
            raise AssertionError("MV_CreateTable did not raise in -ma mode")

        def worker(w):
            with Zoo.Get().worker_context(w):
                t0 = time.perf_counter()
                mv.MV_Aggregate(arrays[w])
                secs[w] = time.perf_counter() - t0

        t0 = time.perf_counter()
        run_threads(worker, PS_WORKERS)
        wall = time.perf_counter() - t0
    finally:
        mv.MV_ShutDown()
    for w in range(PS_WORKERS):
        np.testing.assert_array_equal(arrays[w], want,
                                      err_msg=f"worker {w}'s aggregate")
    return {"aggregate_s": secs, "wall_s": wall,
            "bytes_per_worker": int(arrays[0].nbytes)}


def ps2_batch(seed: int, r: int, rank: int, n: int = PS_IDS) -> tuple:
    """[ps_2proc] round r's (ids, integer deltas) of ``rank``: ``n`` ids
    unique within a rank, overlapping across the ranks; every rank can
    make its peer's batch too, for the oracle."""
    g = np.random.default_rng([seed, 600 + r, rank])
    return (g.choice(PS_ROWS, n, replace=False).astype(np.int32),
            g.integers(-3, 4, (n, PS_COLS)).astype(np.float32))


def ps2_burst_turn(torch, mv, base: list, turn: str, batches: list,
                   oracle: np.ndarray, rank: int) -> dict:
    """One turn of [ps_2proc burst] on ``turn``'s engine: BURST_WARM
    untimed fire-and-forget AddRows and a blocking GetRows, a barrier,
    then the timed rest of this rank's burst, ended by a blocking GetRows
    (it waits for every Add queued before it); the final table must equal
    ``oracle`` (both ranks' Adds)."""
    import hashlib

    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.zoo import Zoo
    mv.MV_Init(base + [f"-mv_pipeline={int(turn == 'pipeline')}"])
    try:
        table = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                    num_cols=PS_COLS))
        eng = Zoo.Get().server_engine
        mine = batches[rank]
        for ids, deltas in mine[:BURST_WARM]:
            table.AddFireForget(deltas, row_ids=ids)
        table.GetRows(mine[0][0][:1])
        mv.MV_Barrier()
        x0, a0 = eng.xw_busy_s, eng.apply_busy_s
        e0, v0 = eng.mh_window_exchanges, eng.mh_window_verbs
        t0 = time.perf_counter()
        for ids, deltas in mine[BURST_WARM:]:
            table.AddFireForget(deltas, row_ids=ids)
        table.GetRows(mine[-1][0][:1])
        wall = time.perf_counter() - t0
        res = {"turn": turn, "wall_s": wall,
               "exchange_s": eng.xw_busy_s - x0,
               "apply_s": eng.apply_busy_s - a0,
               "exchanges": eng.mh_window_exchanges - e0,
               "verbs": eng.mh_window_verbs - v0}
        final = table.Get()
        torch.cuda.synchronize()
    finally:
        mv.MV_ShutDown(finalize_net=False)
    np.testing.assert_array_equal(final, oracle,
                                  err_msg=f"[ps_2proc burst] {turn}")
    res["digest"] = hashlib.sha256(final.tobytes()).hexdigest()
    return res


def ps_2proc_rank(rank: int, port: int, seed: int, out: str) -> int:
    """One rank of [ps_2proc] (``--rank-child``), on ``cuda:0`` beside its
    peer, over gloo. The PS shape on an add and a momentum table, 5 rounds
    of AddRows + GetRows of each rank's 10,000 ids, every GetRows held to
    the oracle of BOTH ranks' Adds; the final tables' digest; then, on the
    same process group, [ps_2proc burst] on both engines in turns, BSP (each rank's i-th GetRows against the oracle
    after both ranks' i-th Adds) and, in a model-average world of 2
    worker threads a rank, MV_Aggregate of a 1,000,000 x 50 float32 array
    from each of the four workers (the exact sum). Writes its measurements and its launch counts
    to ``out``."""
    import hashlib

    import torch
    try:
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch.ops import cuda_rows as cr
        from multiverso_tpu_torch.tables import MatrixTableOption
        from multiverso_tpu_torch.updaters.base import AddOption
        from multiverso_tpu_torch.zoo import Zoo
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    base = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2"]
    res = {"rank": rank}
    cr.reset_launches()
    t0 = time.perf_counter()
    mv.MV_Init(base)
    res["init_s"] = time.perf_counter() - t0
    add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                              num_cols=PS_COLS))
    mom = mv.MV_CreateTable(MatrixTableOption(
        num_rows=PS_ROWS, num_cols=PS_COLS, updater_type="momentum"))
    if add.server().state["data"].device != dev:
        raise AssertionError("the PS tables are not on cuda:0")
    eng = Zoo.Get().server_engine
    res["engine"] = type(eng).__name__
    m = np.float32(0.5)
    mopt = AddOption(momentum=float(m))
    oracle_add = np.zeros((PS_ROWS, PS_COLS), np.float32)
    oracle_mom = np.zeros((PS_ROWS, PS_COLS), np.float32)
    smooth = np.zeros((PS_ROWS, PS_COLS), np.float32)
    add_ms, mom_ms = [], []
    for r in range(PS_ROUNDS):
        batches = [ps2_batch(seed, r, k) for k in range(2)]
        ids, deltas = batches[rank]
        t0 = time.perf_counter()
        add.AddRows(ids, deltas)
        got_add = add.GetRows(ids)
        add_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        mom.AddRows(ids, deltas, mopt)
        got_mom = mom.GetRows(ids)
        mom_ms.append((time.perf_counter() - t0) * 1e3)
        delta = np.zeros((PS_ROWS, PS_COLS), np.float32)
        for k_ids, k_deltas in batches:
            delta[k_ids] += k_deltas
        touched = np.union1d(batches[0][0], batches[1][0])
        oracle_add[touched] += delta[touched]
        smooth[touched] = (m * smooth[touched]
                           + (np.float32(1) - m) * delta[touched])
        oracle_mom[touched] -= smooth[touched]
        np.testing.assert_array_equal(got_add, oracle_add[ids])
        np.testing.assert_allclose(got_mom, oracle_mom[ids], rtol=1e-6,
                                   atol=1e-6)
    res.update(add_round_ms=add_ms, momentum_round_ms=mom_ms,
               round_s=(sum(add_ms) + sum(mom_ms)) / 1e3,
               window_exchanges=eng.mh_window_exchanges,
               window_verbs=eng.mh_window_verbs,
               exchange_s=eng.xw_busy_s, engine_apply_s=eng.apply_busy_s)
    final_add, final_mom = add.Get(), mom.Get()
    np.testing.assert_array_equal(final_add, oracle_add)
    np.testing.assert_allclose(final_mom, oracle_mom, rtol=1e-6, atol=1e-6)
    res["digest"] = hashlib.sha256(final_add.tobytes()
                                   + final_mom.tobytes()).hexdigest()
    torch.cuda.synchronize()
    if cr.read_error(dev) != 0:
        raise AssertionError("error word set on the 2-process PS path")
    res["ps_launches"] = dict(cr.LAUNCHES)
    del oracle_mom, smooth, final_add, final_mom
    mv.MV_ShutDown(finalize_net=False)      # the process group stays up

    # [ps_2proc burst]: both ranks' bursts (each rank knows its peer's
    # for the oracle), then the engines in turns on the same bursts
    batches = [[ps2_batch(seed, 1000 + v, k, BURST_IDS)
                for v in range(BURST_VERBS)] for k in range(2)]
    oracle_add[:] = 0
    for k in range(2):
        for ids, deltas in batches[k]:
            oracle_add[ids] += deltas
    res["burst"] = [ps2_burst_turn(torch, mv, base, turn, batches,
                                   oracle_add, rank)
                    for turn in BURST_TURNS]
    del batches, oracle_add

    # BSP across the two processes, one worker a rank: a process's
    # verb sequence must not depend on how its threads interleave (the
    # SPMD collective contract), and the BSP engine applies in arrival
    # order
    mv.MV_Init(base + ["-sync=true"])
    table = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                num_cols=PS_COLS))
    oracle = np.zeros((PS_ROWS, PS_COLS), np.float32)
    bsp_ms = []
    for i in range(PS_ROUNDS):
        ids, deltas = ps2_batch(seed, 100 + i, rank)
        t0 = time.perf_counter()
        table.AddRows(ids, deltas)
        got = table.GetRows(ids)
        bsp_ms.append((time.perf_counter() - t0) * 1e3)
        for k in range(2):
            k_ids, k_deltas = ps2_batch(seed, 100 + i, k)
            oracle[k_ids] += k_deltas
        np.testing.assert_array_equal(got, oracle[ids],
                                      err_msg=f"BSP GetRows {i}")
    res["bsp_round_ms"] = bsp_ms
    del oracle
    mv.MV_ShutDown(finalize_net=False)

    # MV_Aggregate of the four workers' arrays across the processes
    arrays = [np.random.default_rng([seed, 700 + g]).standard_normal(
        (PS_ROWS, PS_COLS), dtype=np.float32) for g in range(4)]
    acc = arrays[0].astype(np.float64)
    for a in arrays[1:]:
        acc += a
    want = acc.astype(np.float32)
    del acc
    mine = [arrays[2 * rank + w] for w in range(2)]
    agg_s = [0.0, 0.0]

    def agg_worker(w):
        with Zoo.Get().worker_context(w):
            t0 = time.perf_counter()
            mv.MV_Aggregate(mine[w])
            agg_s[w] = time.perf_counter() - t0

    mv.MV_Init(base + ["-ma=true", "-num_workers=2"])
    run_threads(agg_worker, 2)
    for w in range(2):
        np.testing.assert_array_equal(mine[w], want,
                                      err_msg=f"worker {w}'s aggregate")
    res["aggregate_s"] = agg_s
    torch.cuda.synchronize()
    res["launches"] = dict(cr.LAUNCHES)
    mv.MV_ShutDown()
    with open(out, "w") as f:
        json.dump(res, f)
    print(f"[ps_2proc rank {rank}] ok", flush=True)
    return 0


def ps_2proc_phase(seed: int, workdir: str) -> dict:
    """[ps_2proc]: two ranks of this script (``--rank-child``) on the one
    card over gloo, started after the build so they load the built
    kernels; a rank that fails or hangs past RANK_CHILD_S fails the run
    (both are killed). Returns each rank's measurements and the launches
    summed over the ranks; each rank must launch all three kernels, and
    the ranks' final tables must be bitwise equal."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    outs = [os.path.join(workdir, f"ps_2proc_rank{r}.json") for r in range(2)]
    logs = [open(os.path.join(workdir, f"ps_2proc_rank{r}.log"), "w+")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-child", str(r),
         "--port", str(port), "--seed", str(seed), "--json-out", outs[r]],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + RANK_CHILD_S
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[ps_2proc] rank {r} hung past "
                                     f"{RANK_CHILD_S} s") from None
        for r, p in enumerate(procs):
            if p.returncode != 0:
                logs[r].seek(0)
                raise AssertionError(f"[ps_2proc] rank {r} failed "
                                     f"(exit {p.returncode}):\n"
                                     f"{logs[r].read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f))
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("[ps_2proc] the ranks' final tables differ")
    for t0, t1 in zip(ranks[0]["burst"], ranks[1]["burst"]):
        if t0["digest"] != t1["digest"]:
            raise AssertionError(f"[ps_2proc burst] the ranks' final tables "
                                 f"differ on the {t0['turn']} turn")
    for r in ranks:
        for k in ("gather_rows", "scatter_set_rows", "update_rows"):
            if r["ps_launches"][k] == 0:
                raise AssertionError(f"[ps_2proc] rank {r['rank']} never "
                                     f"launched {k}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    return {"ranks": ranks, "launches": launches}


def ckpt_tables(mv):
    """[ckpt]'s tables: the PS shape with the momentum updater (storage
    1,000,001 x 52 and a ['smooth'] aux leaf of the same size) and a
    sparse sigmoid LR table at the RCV1 width, as the app creates it."""
    from multiverso_tpu_torch.tables import MatrixTableOption
    return (mv.MV_CreateTable(MatrixTableOption(
                num_rows=PS_ROWS, num_cols=PS_COLS, updater_type="momentum")),
            mv.MV_CreateTable(MatrixTableOption(
                num_rows=LR_SPARSE_IN, num_cols=1, updater_type="sgd")))


def ckpt_batches(seed: int, n: int) -> list:
    """[ckpt]'s first ``n`` rounds: the momentum table's ids and integer
    deltas, the LR table's sorted keys and small float deltas."""
    rng = np.random.default_rng([seed, 300])
    return [(rng.choice(PS_ROWS, PS_IDS, replace=False).astype(np.int32),
             rng.integers(-3, 4, (PS_IDS, PS_COLS)).astype(np.float32),
             np.sort(rng.choice(LR_SPARSE_IN, CKPT_LR_KEYS,
                                replace=False)).astype(np.int32),
             (rng.standard_normal((CKPT_LR_KEYS, 1)) * 0.01).astype(
                 np.float32))
            for _ in range(n)]


def compress_batch(rng) -> tuple:
    """[ps_compress]'s round: PS_IDS random rows, deltas COMPRESS_ZEROS
    zeros."""
    ids = rng.choice(PS_ROWS, PS_IDS, replace=False).astype(np.int32)
    deltas = rng.standard_normal((PS_IDS, PS_COLS)).astype(np.float32)
    deltas[rng.random(deltas.shape) < COMPRESS_ZEROS] = 0.0
    return ids, deltas


def ckpt_rounds(tables, batches) -> None:
    """Blocking AddRows + GetRows on both tables, a round a batch: no
    engine window merges Adds (its ``index_add_`` sums in an undefined
    order on the card)."""
    from multiverso_tpu_torch.updaters.base import AddOption
    mopt = AddOption(momentum=0.5)
    mom, lr = tables
    for ids, deltas, lr_ids, lr_deltas in batches:
        mom.AddRows(ids, deltas, mopt)
        mom.GetRows(ids)
        lr.AddRows(lr_ids, lr_deltas)
        lr.GetRows(lr_ids)


def table_states(tables, host: bool) -> list:
    """Each table's data and aux leaves: clones of the device storage, or
    (``host``) the logical host arrays a checkpoint holds."""
    out = []
    for t in tables:
        srv = t.server()
        aux = [leaf for _, leaf in sorted(srv.state["aux"].items())]
        if host:
            out.append([srv.raw()] + [srv.aux_to_logical(a) for a in aux])
        else:
            out.append([srv.state["data"].clone()] + [a.clone() for a in aux])
    return out


def ckpt_phase(torch, mv, cr, dev, seed: int, workdir: str) -> dict:
    """PS_ROUNDS rounds, MV_SaveCheckpoint, CKPT_ROUNDS more rounds: state
    A. A new world on the card creates the same tables, loads the file and
    runs the same CKPT_ROUNDS rounds: state B, which must equal A bitwise,
    data and aux, on the card. A world on the CPU loads the same file: its
    values must equal the card's right after its load."""
    batches = ckpt_batches(seed, PS_ROUNDS + CKPT_ROUNDS)
    path = os.path.join(workdir, "ckpt.mvt")
    mv.MV_Init([])
    try:
        tables = ckpt_tables(mv)
        if tables[0].server().state["data"].device != dev:
            raise AssertionError("the checkpoint's tables are not on the card")
        ckpt_rounds(tables, batches[:PS_ROUNDS])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = mv.MV_SaveCheckpoint(path)
        save_s = time.perf_counter() - t0
        ckpt_rounds(tables, batches[PS_ROUNDS:])
        state_a = table_states(tables, host=False)
    finally:
        mv.MV_ShutDown()
    mv.MV_Init([])
    try:
        tables = ckpt_tables(mv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mv.MV_LoadCheckpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loaded = table_states(tables, host=True)
        ckpt_rounds(tables, batches[PS_ROUNDS:])
        state_b = table_states(tables, host=False)
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError("error word set on the checkpoint path")
    finally:
        mv.MV_ShutDown()
    for name, a, b in zip(("momentum", "lr"), state_a, state_b):
        if len(a) != len(b) or not all(torch.equal(x, y)
                                       for x, y in zip(a, b)):
            raise AssertionError(f"[ckpt] {name} table: the resumed run "
                                 f"differs from the uninterrupted one")
    del state_a, state_b
    mv.MV_Init(["-mv_device=cpu"])
    try:
        tables = ckpt_tables(mv)
        mv.MV_LoadCheckpoint(path)
        on_cpu = table_states(tables, host=True)
    finally:
        mv.MV_ShutDown()
    for name, a, b in zip(("momentum", "lr"), loaded, on_cpu):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"[ckpt] {name} table: loaded on the CPU "
                                 f"it differs from the card's")
    nbytes = os.path.getsize(path)
    return {"tables": n, "file_bytes": nbytes, "save_s": save_s,
            "load_s": load_s, "save_mb_s": nbytes / save_s / 1e6,
            "load_mb_s": nbytes / load_s / 1e6,
            "leaves": [len(x) for x in loaded]}


def ps_compress_phase(torch, mv, cr, dev, seed: int) -> dict:
    """The PS shape with the add updater, compress="sparse" beside an
    uncompressed twin: PS_ROUNDS rounds of AddRows + GetRows of PS_IDS
    random rows whose deltas are COMPRESS_ZEROS zeros, the twins in turns;
    every GetRows and the final tables equal bitwise."""
    from multiverso_tpu_torch.tables import MatrixTableOption
    rng = np.random.default_rng([seed, 400])
    mv.MV_Init([])
    try:
        twins = {c: mv.MV_CreateTable(MatrixTableOption(
            num_rows=PS_ROWS, num_cols=PS_COLS, compress=c))
            for c in (None, "sparse")}
        round_ms = {None: [], "sparse": []}
        for r in range(PS_ROUNDS):
            ids, deltas = compress_batch(rng)
            got = {}
            for c in ((None, "sparse") if r % 2 == 0 else ("sparse", None)):
                t0 = time.perf_counter()
                twins[c].AddRows(ids, deltas)
                got[c] = twins[c].GetRows(ids)
                round_ms[c].append((time.perf_counter() - t0) * 1e3)
            np.testing.assert_array_equal(got["sparse"], got[None])
        np.testing.assert_array_equal(twins["sparse"].Get(),
                                      twins[None].Get())
        wire = dict(twins["sparse"].server().wire_stats)
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError("error word set on the compressed PS path")
    finally:
        mv.MV_ShutDown()
    if not 0 < wire["payload_bytes"] < wire["dense_bytes"]:
        raise AssertionError(f"[ps_compress] the sparse filter did not "
                             f"engage: {wire}")
    return {"round_ms": round_ms["sparse"],
            "plain_round_ms": round_ms[None],
            "round_median_ms": float(np.median(round_ms["sparse"])),
            "plain_round_median_ms": float(np.median(round_ms[None])),
            "wire_stats": wire,
            "wire_ratio": wire["payload_bytes"] / wire["dense_bytes"]}


# -- phase 4: WordEmbedding ----------------------------------------------------

def write_zipf_corpus(workdir: str, seed: int, vocab_size: int = WE_VOCAB,
                      blocks: int = WE_BLOCKS, tag: str = "") -> tuple:
    """A vocabulary of ``vocab_size`` words with Zipf counts and a corpus
    of Zipf-drawn tokens, exactly ``blocks`` blocks long; ``tag`` names
    the files of a corpus other than the ``we`` runs' one (and draws it
    from its own stream)."""
    rng = np.random.default_rng([seed, vocab_size, blocks] if tag else seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    n_words = blocks * WE_BLOCK_BYTES // 8      # the loader's 8 B/word
    tokens = rng.choice(vocab_size, n_words, p=p)
    counts = np.bincount(tokens, minlength=vocab_size) + 1
    vocab = os.path.join(workdir, f"vocab{tag}.txt")
    with open(vocab, "w") as f:
        f.writelines(f"w{i} {c}\n" for i, c in enumerate(counts))
    corpus = os.path.join(workdir, f"corpus{tag}.txt")
    with open(corpus, "w") as f:
        for s in range(0, n_words, WE_SENT_LEN):
            f.write(" ".join(f"w{t}" for t in tokens[s: s + WE_SENT_LEN])
                    + "\n")
    return vocab, corpus, n_words


def we_options(workdir: str, seed: int, vocab: str, corpus: str,
               device_plane: bool = True, extra=()):
    """The WE runs' CLI options: bench.py's WordEmbedding width, on the
    device plane (``-is_pipeline 0``) or on the host plane with the JAX
    package's defaults (``-device_plane 0 -is_pipeline 1``); ``extra``
    flags come last (``-device_pairs 1`` and the mode)."""
    from multiverso_tpu_torch.models.wordembedding.option import Option
    return Option.parse_args([
        "-train_file", corpus, "-read_vocab", vocab,
        "-output", os.path.join(workdir, "vec.txt"),
        "-size", str(WE_DIM), "-window", str(WE_WINDOW),
        "-negative", str(WE_NEG), "-pair_batch", "4096", "-min_count", "1",
        "-use_adagrad", "0", "-device_plane", str(int(device_plane)),
        "-is_pipeline", str(int(not device_plane)),
        "-data_block_size", str(WE_BLOCK_BYTES), "-epoch", "1",
        "-seed", str(seed), "-platform", "cuda", *extra])


def hs_chance_loss(vocab: str, corpus: str) -> float:
    """0.69 times the mean Huffman path length over a corpus's tokens: the
    loss per pair of an untrained hierarchical softmax (its output rows
    start at zero), as 0.69 * (1 + K) is negative sampling's."""
    from multiverso_tpu_torch.models.wordembedding.dictionary import \
        Dictionary
    from multiverso_tpu_torch.models.wordembedding.huffman import \
        HuffmanEncoder
    d = Dictionary.load_vocab(vocab)
    d.RemoveWordsLessThan(1)
    enc = HuffmanEncoder()
    enc.BuildFromTermFrequency(d.counts())
    lengths = np.array([len(enc.GetLabelInfo(w).codes)
                        for w in range(d.Size())], np.float64)
    with open(corpus) as f:
        ids = np.array([d.GetWordIdx(t) for t in f.read().split()])
    return 0.69 * float(lengths[ids].mean())


def we_phase(torch, seed: int, workdir: str, corpus_files: tuple,
             device_plane: bool = True, extra=(), vocab_size: int = WE_VOCAB,
             blocks: int = WE_BLOCKS, limit: float = 0.69 * (1 + WE_NEG)
             ) -> dict:
    """One WE run through ``DistributedWordEmbedding``: prepare, then a
    timed ``train()``; every block's loss per pair finite and below
    ``limit``, the input embeddings finite."""
    from multiverso_tpu_torch.models.wordembedding.distributed import \
        DistributedWordEmbedding
    vocab, corpus, n_words = corpus_files
    opt = we_options(workdir, seed, vocab, corpus, device_plane, extra)
    we = DistributedWordEmbedding(opt)
    try:
        we.prepare()
        info = engine_info()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = we.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        emb = we.comm.input_table.server().raw()
    finally:
        we.close()          # MV_ShutDown of the world prepare() started
    blocks_log = [{"words": w, "pairs": p, "loss_per_pair": lo / max(p, 1)}
                  for w, p, lo in we.block_log]
    if len(blocks_log) != blocks:
        raise AssertionError(f"expected {blocks} blocks, got {blocks_log}")
    for b in blocks_log:
        if not (math.isfinite(b["loss_per_pair"])
                and b["loss_per_pair"] < limit):
            raise AssertionError(f"block loss out of bounds (< {limit}): "
                                 f"{b}")
    if not (math.isfinite(loss) and loss < limit):
        raise AssertionError(f"average loss {loss} not below {limit}")
    if emb.shape != (vocab_size, WE_DIM) or not np.isfinite(emb).all():
        raise AssertionError("input embeddings not finite / misshapen")
    out = dict(info, words=n_words, train_s=secs,
               words_per_s=n_words / secs, avg_loss_per_pair=loss,
               loader_wait_s=we.loader_wait_s, blocks=blocks_log,
               limit=limit)
    if we.dp_trainer is not None:
        out.update(batches=we.dp_trainer.batches,
                   sparse_batches=we.dp_trainer.sparse_batches)
    return out


def we_run_table(workdir: str, seed: int, corpus: tuple) -> dict:
    """The WE runs, name -> (description, the row kernels its path must
    launch, ``we_phase`` arguments); writes the corpora they read besides
    ``corpus``. The ``-device_pairs 1`` runs keep the ``we`` run's
    loader (``-is_pipeline 0``: a queue of one block), so the two differ
    in where the pairs are made only."""
    pairs = ("-device_pairs", "1")
    big = write_zipf_corpus(workdir, seed, WE_BIG_VOCAB, WE_BLOCKS, "_big")
    one = write_zipf_corpus(workdir, seed, WE_VOCAB, 1, "_one")
    adagrad = ("-use_adagrad", "1", "-lr", str(WE_ADAGRAD_LR))
    rows_and_update = ("gather_rows", "update_rows")
    runs = {
        "we": (f"{WE_VOCAB} x {WE_DIM}, -device_plane 1 -is_pipeline 0",
               rows_and_update, dict(corpus_files=corpus)),
        "we_host": (f"{WE_VOCAB} x {WE_DIM}, -device_plane 0 -is_pipeline 1",
                    rows_and_update,
                    dict(corpus_files=corpus, device_plane=False)),
        "we_pairs": (f"{WE_VOCAB} x {WE_DIM}, skip-gram NEG, plain SGD, "
                     f"-device_pairs 1", (),
                     dict(corpus_files=corpus, extra=pairs)),
        "we_pairs_adagrad": (
            f"{WE_BIG_VOCAB} x {WE_DIM} (four tables), skip-gram NEG, "
            f"-use_adagrad 1 -lr {WE_ADAGRAD_LR}, -device_pairs 1",
            ("gather_rows", "scatter_set_rows"),
            dict(corpus_files=big, vocab_size=WE_BIG_VOCAB,
                 extra=pairs + adagrad)),
    }
    # the modes as tests/test_wordembedding.py runs them: AdaGrad at its
    # rate (a 4,096-pair batch sums a frequent word's gradients, which
    # plain SGD does not survive in CBOW); a 100,000 x 128 table is below
    # _SPARSE_BYTES, so the dense AdaGrad step: no row kernel
    hs_limit = hs_chance_loss(one[0], one[1])
    for name, what, flags, limit in (
            ("we_pairs_cbow", "CBOW NEG", ("-cbow", "1"),
             0.69 * (1 + WE_NEG)),
            ("we_pairs_hs", "skip-gram HS", ("-hs", "1", "-negative", "0"),
             hs_limit),
            ("we_pairs_cbow_hs", "CBOW HS",
             ("-cbow", "1", "-hs", "1", "-negative", "0"), hs_limit)):
        runs[name] = (f"{WE_VOCAB} x {WE_DIM}, {what}, -use_adagrad 1 -lr "
                      f"{WE_ADAGRAD_LR} (the dense step), -device_pairs 1, "
                      f"one block", (),
                      dict(corpus_files=one, blocks=1, limit=limit,
                           extra=pairs + adagrad + flags))
    return runs


def check_we_pairs(name: str, we: dict, launches: dict) -> None:
    """The ``-device_pairs 1`` runs' own checks: the dense steps launch no
    row kernel (they are tensor code, as in the JAX package); the
    touched-rows step ran on every batch of ``[we_pairs_adagrad]``, with
    six row gathers and four row scatter-sets a batch."""
    if "batches" not in we:
        return
    if name == "we_pairs_adagrad":
        n = we["batches"]
        want = {"gather_rows": 6 * n, "scatter_set_rows": 4 * n,
                "update_rows": 0}
        if not (n > 0 and we["sparse_batches"] == n and launches == want):
            raise AssertionError(f"{name}: {n} batches, "
                                 f"{we['sparse_batches']} touched-rows, "
                                 f"launches {launches}, want {want}")
    elif we["sparse_batches"] or any(launches.values()):
        raise AssertionError(f"{name}: the dense step launched row kernels "
                             f"{launches}")


def we_small_reference(torch, workdir: str) -> float:
    """The topic corpus of tests/test_wordembedding.py through the port's
    device plane on the card and on the CPU: the saved embeddings must
    agree (the CPU run uses the kernels' plain versions)."""
    from multiverso_tpu_torch.models.wordembedding.distributed import \
        DistributedWordEmbedding
    from multiverso_tpu_torch.models.wordembedding.option import Option
    rng = np.random.default_rng(0)
    corpus = os.path.join(workdir, "topics.txt")
    with open(corpus, "w") as f:
        for _ in range(300):
            topic = rng.integers(4)
            f.write(" ".join(f"w{topic * 5 + rng.integers(5)}"
                             for _ in range(12)) + "\n")
    vecs = {}
    for platform in ("cuda", "cpu"):
        out = os.path.join(workdir, f"topics_{platform}.txt")
        opt = Option(train_file=corpus, output_file=out, embedding_size=16,
                     window_size=2, negative_num=3, min_count=1, epoch=2,
                     data_block_size=4000, pair_batch_size=256,
                     init_learning_rate=0.05, device_plane=True,
                     is_pipeline=False, platform=platform)
        we = DistributedWordEmbedding(opt)
        try:
            we.run()
        finally:
            we.close()
        lines = open(out).read().splitlines()[1:]
        vecs[platform] = np.array([[float(x) for x in l.split()[1:]]
                                   for l in lines])
    np.testing.assert_allclose(vecs["cuda"], vecs["cpu"], rtol=1e-3,
                               atol=1e-4)
    return float(np.abs(vecs["cuda"] - vecs["cpu"]).max())


def we_pairs_card_vs_cpu(torch, cr, workdir: str) -> float:
    """The topic corpus (written by ``we_small_reference``) through
    ``DevicePairsTrainer.train_block`` with ``-use_adagrad 1`` and the
    touched-rows step forced (``_SPARSE_BYTES`` at 0), on the card and on
    the CPU, from the same initial tables, with the same window and
    negative draws (numpy, a fixed seed): all four tables must agree
    (rtol 1e-3, atol 1e-4), and the card run must launch the row gather
    and scatter-set."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.wordembedding import device_pairs as dp
    from multiverso_tpu_torch.models.wordembedding.communicator import \
        Communicator
    from multiverso_tpu_torch.models.wordembedding.data import (
        PairGenerator, sentences_from_file)
    from multiverso_tpu_torch.models.wordembedding.dictionary import \
        Dictionary
    from multiverso_tpu_torch.models.wordembedding.option import Option
    from multiverso_tpu_torch.models.wordembedding.sampler import Sampler
    from multiverso_tpu_torch.parallel.mesh import next_bucket
    corpus = os.path.join(workdir, "topics.txt")
    opt = Option(train_file=corpus, embedding_size=16, window_size=2,
                 negative_num=3, min_count=1, pair_batch_size=256,
                 use_adagrad=True, device_pairs=True, init_learning_rate=0.1)
    d = Dictionary()
    d.build_from_corpus(corpus)
    d.RemoveWordsLessThan(1)
    counts = d.counts()
    gen = PairGenerator(opt, d, Sampler(counts, seed=opt.seed), None)
    sents = [s for s, _ in sentences_from_file(corpus, d)]
    blocks = [gen.make_token_block(sents[i: i + 100], 0)
              for i in range(0, len(sents), 100)]
    rng = np.random.default_rng(17)
    W, K = opt.window_size, opt.negative_num
    draws = []
    tables = []
    old = dp._SPARSE_BYTES
    dp._SPARSE_BYTES = 0
    try:
        for platform in ("cuda", "cpu"):
            mv.MV_Init([f"-mv_device={platform}"])
            try:
                comm = Communicator(opt, d.Size())
                trainer = dp.DevicePairsTrainer(opt, comm, counts)
                if not trainer.sparse():
                    raise AssertionError("the touched-rows step is not on")
                if not draws:
                    for blk in blocks:
                        t_pad = next_bucket(len(blk.tokens), 1024)
                        draws.append((rng.integers(1, W + 1, t_pad),
                                      rng.integers(0, trainer.slots.shape[0],
                                                   (2 * W * t_pad, K))))
                before = dict(cr.LAUNCHES)
                for blk, (b, neg) in zip(blocks, draws):
                    loss, pairs = trainer.train_block(
                        blk.tokens, blk.token_sent, opt.init_learning_rate,
                        b=b, draws=neg)
                    if not (math.isfinite(float(loss)) and int(pairs) > 0):
                        raise AssertionError(f"{platform}: block loss "
                                             f"{float(loss)}, pairs "
                                             f"{int(pairs)}")
                tables.append([t.server().raw() for t in (
                    comm.input_table, comm.output_table, comm.ie_g2_table,
                    comm.eo_g2_table)])
                if platform == "cuda" and any(
                        cr.LAUNCHES[k] == before[k]
                        for k in ("gather_rows", "scatter_set_rows")):
                    raise AssertionError("the card run launched no row "
                                         "gather or scatter-set")
            finally:
                mv.MV_ShutDown()
    finally:
        dp._SPARSE_BYTES = old
    for name, a, b in zip(("ie", "eo", "ie_g2", "eo_g2"), *tables):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    return max(float(np.abs(a - b).max())
               for a, b in zip(*tables))


# -- phase 5: LogisticRegression -----------------------------------------------

def lr_dense_file(path: str, seed: int) -> str:
    """bench.py's LR app data (bench.py:462-470): 10 Gaussian class centres
    in 784 features, 6,000 samples at noise 0.35, 4 decimals."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((LR_DENSE_OUT, LR_DENSE_IN)).astype(
        np.float32)
    y = rng.integers(0, LR_DENSE_OUT, LR_SAMPLES)
    X = (centers[y] + rng.standard_normal((LR_SAMPLES, LR_DENSE_IN)) * 0.35
         ).astype(np.float32)
    np.savetxt(path, np.column_stack([y, X]),
               fmt=["%d"] + ["%.4f"] * LR_DENSE_IN)
    return path


def lr_sparse_samples(seed: int, features: int, outputs: int,
                      samples: int = LR_SAMPLES) -> tuple:
    """bench.py:517-524's generator at any width: LR_NNZ distinct features
    a sample with N(0, 1) values, labelled by a random true model (its
    sign for one output, its argmax for several). Returns (keys, values,
    labels)."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((features, outputs))
    keys = np.stack([rng.choice(features, LR_NNZ, replace=False)
                     for _ in range(samples)])
    values = rng.standard_normal((samples, LR_NNZ)).astype(np.float32)
    scores = np.einsum("sk,sko->so", values, w_true[keys])
    labels = (scores[:, 0] > 0 if outputs == 1
              else np.argmax(scores, axis=1)).astype(np.int64)
    return keys, values, labels


def write_lr_sparse(path: str, samples: tuple) -> str:
    keys, values, labels = samples
    with open(path, "w") as f:
        for k, v, lab in zip(keys, values, labels):
            f.write(f"{lab} " + " ".join(f"{a}:{b:.4f}" for a, b in zip(k, v))
                    + "\n")
    return path


def first_window_rows(samples: tuple) -> np.ndarray:
    """The row set of a sparse run's first window (LR_SPARSE_SYNC
    minibatches): the ids its row gather and update get."""
    keys = samples[0][: LR_SPARSE_SYNC * LR_MINIBATCH]
    return np.unique(keys).astype(np.int32)


def lr_config(train_file: str, input_size: int, output_size: int,
              epochs: int, **kw):
    """An app configuration as bench.py builds one: PS, device plane, no
    pipeline, no output files, on the card."""
    from multiverso_tpu_torch.models.logreg.configure import Configure
    cfg = Configure()
    cfg.train_file = train_file
    cfg.test_file = cfg.output_file = cfg.output_model_file = ""
    cfg.input_size, cfg.output_size = input_size, output_size
    cfg.train_epoch = epochs
    cfg.minibatch_size = LR_MINIBATCH
    cfg.use_ps, cfg.device_plane, cfg.pipeline = True, True, False
    cfg.show_time_per_sample = 10 ** 9
    cfg.platform = "cuda"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def lr_run(torch, cfg, dev=None) -> tuple:
    """One ``LogReg`` training run; returns (stats, final weights). With
    ``dev`` the PS tables must live on it."""
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    t0 = time.perf_counter()
    app = LogReg(cfg)
    try:
        if dev is not None:
            tables = ([app.model.z_table, app.model.n_table]
                      if app.model.ftrl else [app.model.table])
            for t in tables:
                srv = t.server()
                held = (srv.device_values() if app.model.ftrl
                        else srv.state["data"])
                if held.device != dev:
                    raise AssertionError("the LR tables are not on the card")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        app.Train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        W = app.model.weights()
        wire = (dict(app.model.table.server().wire_stats)
                if cfg.sparse and not app.model.ftrl else {})
    finally:
        app.close()
    wall_s = time.perf_counter() - t0
    losses = [loss for _, loss, _ in app.epoch_log]
    samples = sum(n for n, _, _ in app.epoch_log)
    if (W.shape != (cfg.input_size, cfg.output_size)
            or not np.isfinite(W).all()
            or not all(math.isfinite(x) for x in losses)
            or len(losses) != cfg.train_epoch):
        raise AssertionError(f"LR weights {W.shape} / epoch losses {losses} "
                             f"not finite or misshapen")
    return {"samples": samples, "train_s": train_s, "wall_s": wall_s,
            "samples_per_s": samples / train_s, "epoch_loss": losses,
            "epoch_s": [s for _, _, s in app.epoch_log],
            "wire_stats": wire}, W


def check_lr(name: str, r: dict) -> None:
    """The run's check: final loss under 0.1 (bench.py:496, :552) for the
    dense and FTRL runs, the loss falling every epoch for the sparse
    ones."""
    losses = r["epoch_loss"]
    if name in ("lr_dense", "lr_dense_host", "lr_ftrl"):
        if not losses[-1] < 0.1:
            raise AssertionError(f"{name}: final loss {losses[-1]} not < 0.1")
    elif not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{name}: the loss did not fall every epoch "
                             f"{losses}")


def lr_card_vs_cpu(torch, workdir: str, seed: int) -> float:
    """A short sparse sigmoid run (1,000 features, 400 samples, 1 epoch,
    windows of 5 minibatches) on the card and on the CPU, where the row
    kernels' plain versions run: the final weights must agree."""
    path = write_lr_sparse(os.path.join(workdir, "lr_small.data"),
                           lr_sparse_samples(seed + 7, 1_000, 1, 400))
    W = {}
    for platform in ("cuda", "cpu"):
        cfg = lr_config(path, 1_000, 1, 1, sparse=True,
                        objective_type="sigmoid", updater_type="sgd",
                        regular_type="L2", sync_frequency=5,
                        platform=platform)
        W[platform] = lr_run(torch, cfg)[1]
    np.testing.assert_allclose(W["cuda"], W["cpu"], rtol=1e-4, atol=1e-5)
    return float(np.abs(W["cuda"] - W["cpu"]).max())


def lr_samples(seed: int) -> dict:
    """The sparse LR runs' samples (phase 2 times the kernels on their
    first windows' row sets)."""
    return {"lr_sparse": lr_sparse_samples(seed + 2, LR_SPARSE_IN, 1),
            "lr_softmax": lr_sparse_samples(seed + 3, LR_SPARSE_IN,
                                            LR_SOFTMAX_OUT),
            "lr_ftrl": lr_sparse_samples(seed + 6, LR_FTRL_IN, 1)}


def lr_runs(workdir: str, seed: int, lr_data: dict) -> dict:
    """The LR runs, name -> (description, the row kernels its path must
    launch, configuration, the native pieces its path must call); writes
    their data files into ``workdir``. Sparse text is parsed by the native
    reader; dense text by numpy, as in the JAX package."""
    path = lambda name: os.path.join(workdir, f"{name}.data")  # noqa: E731
    dense = lr_dense_file(path("lr_dense"), seed)
    dense_kw = dict(objective_type="softmax", regular_type="L2",
                    updater_type="sgd", learning_rate_coef=7e6,
                    regular_coef=0.0007, sync_frequency=100,
                    compute_type="bfloat16")
    sparse_kw = dict(sparse=True, regular_type="L2", updater_type="sgd",
                     sync_frequency=LR_SPARSE_SYNC)
    rows_and_update = ("gather_rows", "update_rows")
    sparse_file = write_lr_sparse(path("lr_sparse"), lr_data["lr_sparse"])
    softmax_file = write_lr_sparse(path("lr_softmax"), lr_data["lr_softmax"])

    def host(name, what, file, outputs, objective, **kw):
        """A sparse run on the host plane, where the worker pushes its
        row deltas through the table's (compressed) wire."""
        return (what, rows_and_update,
                lr_config(file, LR_SPARSE_IN, outputs, LR_EPOCHS[name],
                          objective_type=objective, device_plane=False,
                          **sparse_kw, **kw), ("parse_libsvm",))

    return {
        "lr_dense": ("dense softmax 784 x 10, bf16, device plane", (),
                     lr_config(dense, LR_DENSE_IN, LR_DENSE_OUT,
                               LR_EPOCHS["lr_dense"], **dense_kw), ()),
        "lr_dense_host": ("dense softmax 784 x 10, bf16, host plane", (),
                          lr_config(dense, LR_DENSE_IN, LR_DENSE_OUT,
                                    LR_EPOCHS["lr_dense_host"],
                                    device_plane=False, **dense_kw), ()),
        "lr_sparse": (f"sparse sigmoid {LR_SPARSE_IN} x 1 (rows of 4), "
                      f"device plane", rows_and_update,
                      lr_config(sparse_file,
                                LR_SPARSE_IN, 1, LR_EPOCHS["lr_sparse"],
                                objective_type="sigmoid", **sparse_kw),
                      ("parse_libsvm",)),
        "lr_softmax": (f"sparse softmax {LR_SPARSE_IN} x {LR_SOFTMAX_OUT} "
                       f"(rows of 12), device plane", rows_and_update,
                       lr_config(softmax_file,
                                 LR_SPARSE_IN, LR_SOFTMAX_OUT,
                                 LR_EPOCHS["lr_softmax"],
                                 objective_type="softmax", **sparse_kw),
                       ("parse_libsvm",)),
        "lr_ftrl": (f"FTRL {LR_FTRL_IN} x 1, device plane", (),
                    lr_config(write_lr_sparse(path("lr_ftrl"),
                                              lr_data["lr_ftrl"]),
                              LR_FTRL_IN, 1, LR_EPOCHS["lr_ftrl"],
                              objective_type="ftrl", alpha=2.0, beta=1.0,
                              lambda1=0.01, lambda2=0.01,
                              sync_frequency=LR_SPARSE_SYNC),
                    ("parse_libsvm", "kv_index")),
        # [lr_sparse]'s run on the host plane, uncompressed and with
        # compress="sparse" (equal bitwise), and [lr_softmax]'s with
        # compress="1bit"; the device plane pushes nothing over the wire
        "lr_sparse_host": host(
            "lr_sparse_host", f"sparse sigmoid {LR_SPARSE_IN} x 1, host "
            f"plane", sparse_file, 1, "sigmoid"),
        "lr_sparse_compress": host(
            "lr_sparse_compress", f"sparse sigmoid {LR_SPARSE_IN} x 1, host "
            f"plane, compress=sparse", sparse_file, 1, "sigmoid",
            compress="sparse"),
        "lr_softmax_1bit": host(
            "lr_softmax_1bit", f"sparse softmax {LR_SPARSE_IN} x "
            f"{LR_SOFTMAX_OUT}, host plane, compress=1bit", softmax_file,
            LR_SOFTMAX_OUT, "softmax", compress="1bit"),
    }


def lr_phase(torch, dev, seed: int, workdir: str, lr_data: dict, drive,
             results: dict) -> None:
    """Each LR run as a main path of its own (``drive``), then the card
    against the CPU."""
    runs = lr_runs(workdir, seed, lr_data)
    weights = {}
    for name, (what, needs, cfg, native_needs) in runs.items():
        r, weights[name] = drive(name, lambda: lr_run(torch, cfg, dev),
                                 needs, native_needs)
        check_lr(name, r)
        results[name] = r
        log(f"[lr] {what}: {r['samples']} samples ({cfg.train_epoch} epochs "
            f"of {LR_SAMPLES}) in {r['train_s']:.3f} s = "
            f"{r['samples_per_s']:.0f} samples/s (the first epoch, which "
            f"parses the text, {r['epoch_s'][0]:.4f} s), wall "
            f"{r['wall_s']:.3f} s; loss per epoch "
            f"{[round(x, 5) for x in r['epoch_loss']]}"
            + (f"; wire_stats {r['wire_stats']}" if cfg.compress else ""))
    # compress="sparse" is exact: the run equals the uncompressed one
    a, b = results["lr_sparse_compress"], results["lr_sparse_host"]
    if not (np.array_equal(weights["lr_sparse_compress"],
                           weights["lr_sparse_host"])
            and a["epoch_loss"] == b["epoch_loss"]):
        raise AssertionError("lr_sparse_compress: weights or epoch losses "
                             "differ from the uncompressed run")
    log("[lr_sparse_compress] final weights and every epoch's loss bitwise "
        "equal to lr_sparse_host's (uncompressed)")
    if not results["lr_softmax_1bit"]["wire_stats"].get("payload_bytes"):
        raise AssertionError("lr_softmax_1bit pushed no compressed payload")
    results["lr_card_vs_cpu_max_abs_diff"] = lr_card_vs_cpu(torch, workdir,
                                                            seed)
    log(f"[lr] sparse sigmoid 1,000 x 1, 400 samples, card vs CPU weights: "
        f"max abs diff {results['lr_card_vs_cpu_max_abs_diff']:.3g} "
        f"(rtol 1e-4, atol 1e-5)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default="",
                    help="also write every measurement to this JSON file")
    ap.add_argument("--baseline", default="",
                    help="another checkout of the repository whose gather, "
                         "scatter-set and update to check against this "
                         "one's and time in turns with them")
    ap.add_argument("--rank-child", type=int, default=-1,
                    help="run one rank of [ps_2proc] (the script starts "
                         "both itself)")
    ap.add_argument("--port", type=int, default=0,
                    help="[ps_2proc] rank 0's rendezvous port")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if args.rank_child >= 0:
        return ps_2proc_rank(args.rank_child, args.port, args.seed,
                             args.json_out)
    try:
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch import native
        from multiverso_tpu_torch.models.wordembedding import \
            device_pairs as dp
        from multiverso_tpu_torch.ops import cuda_rows as cr
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2

    # phase 0: the card
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; TF32 off for matmul and cuDNN")
    dev = torch.device("cuda", 0)
    results = {"card": card, "seed": args.seed}

    # phase 1: build the row kernels (nvcc) and, meanwhile, the native
    # library (g++, one process per source); the run needs both
    t0 = time.perf_counter()
    native_built = {}
    native_thread = threading.Thread(target=lambda: native_built.update(
        path=native.build(), s=time.perf_counter() - t0))
    native_thread.start()
    lib = cr.build()
    results["build_s"] = time.perf_counter() - t0
    native_thread.join()
    log(f"[build] {lib} in {results['build_s']:.2f} s")
    if cr.last_build_log:
        log(cr.last_build_log.strip())
    if native_built["path"] is None or native.lib() is None:
        raise AssertionError(f"the native library did not build: "
                             f"{native.last_build_error}")
    results["native_build_s"] = native_built["s"]
    log(f"[build] native library {native_built['path']} in "
        f"{native_built['s']:.2f} s (from native/src, outside native/)")

    # phase 2: kernels against their plain versions
    edge_cases(torch, cr, dev)
    ps_k = time_kernels(torch, cr, dev, PS_ROWS, PS_COLS + 2, PS_IDS,
                        args.seed)
    we_k = time_kernels(torch, cr, dev, WE_VOCAB, WE_DIM, 40_000,
                        args.seed + 1)
    results["kernels_ps_shape"] = ps_k
    # [ps_2proc]'s merged Add: both ranks' ids of a round on each replica
    n2 = len(np.union1d(ps2_batch(args.seed, 0, 0)[0],
                        ps2_batch(args.seed, 0, 1)[0]))
    ps2_k = time_kernels(torch, cr, dev, PS_ROWS, PS_COLS + 2, n2,
                         args.seed + 9)
    results["kernels_ps_2proc_shape"] = ps2_k
    results["kernels_we_shape"] = we_k
    # the LR sparse paths' geometries: the 47,236-row MatrixTable stored
    # as rows of 4 floats (one output) and of 12 (10 outputs), the first
    # window's row set as the ids
    lr_data = lr_samples(args.seed)
    lr_k = {}
    rng = np.random.default_rng(args.seed + 4)
    for name, cols in (("lr_sparse", 4), ("lr_softmax", 12)):
        ids_np = first_window_rows(lr_data[name])
        table, src = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev) for shape in ((LR_SPARSE_IN + 1, cols),
                                               (len(ids_np), cols)))
        _check_rows(torch, cr, dev, table, ids_np, src,
                    f"{name} {LR_SPARSE_IN + 1} x {cols}, n={len(ids_np)}")
        lr_k[name] = time_kernels(torch, cr, dev, LR_SPARSE_IN, cols,
                                  len(ids_np), args.seed + 5)
    log(f"[kernels] LR sparse geometries: kernel == plain (bitwise outside "
        f"the trash row) at {LR_SPARSE_IN + 1} x 4 and x 12 on the first "
        f"windows' row sets ({lr_k['lr_sparse']['gather_rows']['shape'][2]} "
        f"and {lr_k['lr_softmax']['gather_rows']['shape'][2]} ids)")
    results["kernels_lr_shapes"] = lr_k
    for label, res in (("PS 1000001x52, 10000 ids", ps_k),
                       (f"PS 2-process merge 1000001x52, {n2} ids", ps2_k),
                       ("WE 100001x128, 40000 ids", we_k),
                       *((f"LR {name} {r['gather_rows']['shape'][0]}x"
                          f"{r['gather_rows']['shape'][1]}, "
                          f"{r['gather_rows']['shape'][2]} ids", r)
                         for name, r in lr_k.items())):
        for k in ("gather_rows", "scatter_set_rows", "update_rows"):
            r = res[k]
            log(f"[kernels] {label} {k}: per-pair {r['ms']:.7f} ms, stream "
                f"{r['stream_ms']:.7f} ms (bound {r['bound_ms']:.7f}, plain "
                f"{r['plain_ms']:.7f}, library {r['library_ms']:.7f}, all "
                f"per-pair; one call with its host overhead "
                f"{r['call_ms']:.4f}), max_abs_err {r['max_abs_err']}")
        log(f"[kernels] {label} update sgd per-pair "
            f"{res['update_rows_sgd_ms']:.7f} ms, stream "
            f"{res['update_rows_sgd_stream_ms']:.7f} ms (plain per-pair "
            f"{res['update_rows_sgd_plain_ms']:.7f}, library per-pair "
            f"{res['update_rows_sgd_library_ms']:.7f}), max_abs_err "
            f"{res['update_rows_sgd_max_abs_err']}; Add+Get per-pair "
            f"{res['update_gather_rows_ms']:.7f} ms, stream "
            f"{res['update_gather_rows_stream_ms']:.7f} ms (bound "
            f"{res['update_gather_rows_bound_ms']:.7f})")
        log(f"[kernels] {label} an empty launch: per-pair "
            f"{res['empty_launch_ms']:.7f} ms, stream "
            f"{res['empty_launch_stream_ms']:.7f} ms")
    if args.baseline:
        base = import_rows_module(args.baseline)
        base.build()        # from that checkout's sources, into its build/
        log(f"[baseline] {args.baseline}: kernels built from its sources")
        results["baseline"] = {}
        for label, key, shape, seed in (
                ("PS 1000001x52, 10000 ids", "ps",
                 (PS_ROWS, PS_COLS + 2, PS_IDS), args.seed),
                ("WE 100001x128, 40000 ids", "we",
                 (WE_VOCAB, WE_DIM, 40_000), args.seed + 1)):
            turns = compare_baseline(torch, cr, base, dev, *shape, seed)
            results["baseline"][key] = turns
            for k, by in turns.items():
                for method, t in by.items():
                    log(f"[baseline] {label} {k} {method} in turns: "
                        f"baseline {t['baseline'][0]:.7f} / "
                        f"{t['baseline'][1]:.7f} ms, this "
                        f"{t['this'][0]:.7f} / {t['this'][1]:.7f} ms")

    # phases 3 + 4: the main paths, each counted from zero
    paths, native_uses = {}, {}

    def drive(name, fn, needs, native_needs=()):
        """Run one main path with the launch counts and the native call
        counts zeroed just before it and read just after; each kernel in
        ``needs`` must have launched, each native piece in
        ``native_needs`` must have been called."""
        cr.reset_launches()
        native.reset_uses()
        out = fn()
        paths[name] = dict(cr.LAUNCHES)
        native_uses[name] = dict(native.USES)
        for k in needs:
            if paths[name][k] == 0:
                raise AssertionError(f"{name} never launched {k}")
        for k in native_needs:
            if native_uses[name][k] == 0:
                raise AssertionError(f"{name} never called the native {k}")
        log(f"[main path] {name}: launches {paths[name]} (kernels this path "
            f"must launch: {', '.join(needs) or 'none'}), native calls "
            f"{native_uses[name]}")
        return out

    every = tuple(cr.LAUNCHES)
    rows_and_update = ("gather_rows", "update_rows")
    ps, ps_final = drive("ps", lambda: ps_phase(torch, mv, cr, dev,
                                                args.seed), every)
    if (os.cpu_count() or 0) >= 8 and ps["engine"] != "ShardedServer":
        raise AssertionError(f"{os.cpu_count()} cores: the default engine "
                             f"must be the ShardedServer, got {ps['engine']}")
    one, one_final = drive("ps_one_engine", lambda: ps_phase(
        torch, mv, cr, dev, args.seed, ["-mv_engine_shards=1"]), every)
    if one["engine"] != "Server":
        raise AssertionError(f"-mv_engine_shards=1 built {one['engine']}")
    for k in ("add", "momentum"):
        if not np.array_equal(ps_final[k], one_final[k]):
            raise AssertionError(f"{k} table: the {ps['engine']} and the "
                                 f"single engine disagree")
    del ps_final, one_final
    results["ps"], results["ps_one_engine"] = ps, one
    for label, r in (("default engine", ps), ("one engine", one)):
        log(f"[ps] {label}: {r['engine']}, shard cap {r['shard_cap']} "
            f"({r['cores']} cores), live slots {r['live_slots']}; "
            f"1,000,000 x 50, {PS_ROUNDS} rounds of {PS_IDS} ids: add "
            f"round median {r['add_round_median_ms']:.3f} ms "
            f"{[round(x, 3) for x in r['add_round_ms']]}, momentum round "
            f"median {r['momentum_round_median_ms']:.3f} ms; GetRows == "
            f"oracle (add exact, momentum rtol 1e-6), whole Get == oracle")
    log("[ps] final add and momentum tables bitwise equal on both engines")
    thr = drive("ps_threads", lambda: ps_threads_phase(
        torch, mv, cr, dev, args.seed), rows_and_update)
    results["ps_threads"] = thr
    log(f"[ps] {PS_WORKERS} worker threads, add + sgd tables on "
        f"{thr['engine']} live slots {thr['live_slots']}: round (AddRows + "
        f"GetRows on both) median {thr['round_median_ms']:.3f} ms; every "
        f"GetRows == the worker's oracle, both tables == oracle after join")
    bsp = drive("bsp", lambda: bsp_phase(torch, mv, cr, dev, args.seed),
                rows_and_update)
    results["bsp"] = bsp
    log(f"[bsp] -sync=true, {PS_WORKERS} workers, 1,000,000 x 50, "
        f"{PS_ROUNDS} rounds of AddRows + GetRows of {PS_IDS} ids: round "
        f"median {bsp['round_median_ms']:.3f} ms; every worker's i-th "
        f"GetRows == the oracle after all i-th Adds; shutdown "
        f"{bsp['shutdown_s']:.3f} s")
    ma = drive("ma", lambda: ma_phase(mv, args.seed), ())
    results["ma"] = ma
    log(f"[ma] -ma=true, {PS_WORKERS} workers each MV_Aggregate "
        f"{ma['bytes_per_worker']} bytes of float32: per-worker "
        f"{[round(x, 4) for x in ma['aggregate_s']]} s, wall "
        f"{ma['wall_s']:.4f} s; every worker holds the exact sum; "
        f"MV_CreateTable raised")
    with tempfile.TemporaryDirectory(prefix="mvt_smoke_") as workdir:
        # [ps_2proc]: the two ranks count their own launches from zero
        two = ps_2proc_phase(args.seed, workdir)
        paths["ps_2proc"] = two["launches"]
        results["ps_2proc"] = two
        log(f"[main path] ps_2proc: launches {two['launches']} (both ranks; "
            f"each rank must launch gather_rows, scatter_set_rows, "
            f"update_rows)")
        for r in two["ranks"]:
            share = r["exchange_s"] / r["round_s"]
            log(f"[ps_2proc] rank {r['rank']} of 2 on cuda:0 over gloo, "
                f"{r['engine']}: 1,000,000 x 50, {PS_ROUNDS} rounds of "
                f"{PS_IDS} ids of its own: add round median "
                f"{np.median(r['add_round_ms']):.3f} ms "
                f"{[round(x, 3) for x in r['add_round_ms']]}, momentum "
                f"round median {np.median(r['momentum_round_ms']):.3f} ms "
                f"{[round(x, 3) for x in r['momentum_round_ms']]}; in the "
                f"window exchanges' all-gathers {r['exchange_s']:.4f} s of "
                f"the rounds' {r['round_s']:.4f} s (share {share:.3f}), "
                f"{r['window_exchanges']} window "
                f"exchanges for {r['window_verbs']} verbs, apply "
                f"{r['engine_apply_s']:.4f} s; BSP round median "
                f"{np.median(r['bsp_round_ms']):.3f} ms; MV_Aggregate "
                f"{[round(x, 4) for x in r['aggregate_s']]} s; launches on "
                f"the PS rounds {r['ps_launches']}, on the whole rank "
                f"{r['launches']}")
        for r in two["ranks"]:
            turns = r["burst"]
            for t in turns:
                log(f"[ps_2proc burst] rank {r['rank']} {t['turn']}: "
                    f"{t['verbs']} fire-and-forget AddRows of {BURST_IDS} "
                    f"ids (both ranks) in {t['exchanges']} windows, "
                    f"{t['wall_s']:.4f} s; the engine's exchange "
                    f"{t['exchange_s']:.4f} s + apply {t['apply_s']:.4f} s "
                    f"= {(t['exchange_s'] + t['apply_s']) / t['wall_s']:.3f}"
                    f" of the burst")
            med = {k: float(np.median([t["wall_s"] for t in turns
                                       if t["turn"] == k]))
                   for k in ("pipeline", "serial")}
            r["burst_median_s"] = med
            log(f"[ps_2proc burst] rank {r['rank']} median: pipelined "
                f"{med['pipeline']:.4f} s, serial {med['serial']:.4f} s "
                f"(pipelined / serial {med['pipeline'] / med['serial']:.3f})")
        log("[ps_2proc burst] final tables == the oracle of both ranks' "
            "Adds on every turn, bitwise equal across the ranks")
        log("[ps_2proc] every GetRows == the oracle of both ranks' Adds "
            "(add exact, momentum rtol 1e-6); final tables bitwise equal "
            "across the ranks; BSP i-th GetRows == the oracle after both "
            "ranks' i-th Adds; MV_Aggregate (2 ranks x 2 threads) == the "
            "exact sum")
        ck = drive("ckpt", lambda: ckpt_phase(torch, mv, cr, dev, args.seed,
                                              workdir), every)
        results["ckpt"] = ck
        log(f"[ckpt] 1,000,000 x 50 momentum + {LR_SPARSE_IN} x 1 sgd, "
            f"{PS_ROUNDS} rounds, save, {CKPT_ROUNDS} rounds: the resumed "
            f"run in a new world bitwise equal to the uninterrupted one "
            f"(data and aux, on the card), the file loaded on the CPU equal "
            f"to the card's; {ck['tables']} tables, aux leaves "
            f"{ck['leaves']}, {ck['file_bytes']} bytes: save "
            f"{ck['save_s']:.3f} s ({ck['save_mb_s']:.1f} MB/s), load "
            f"{ck['load_s']:.3f} s ({ck['load_mb_s']:.1f} MB/s)")
        pc = drive("ps_compress", lambda: ps_compress_phase(
            torch, mv, cr, dev, args.seed), rows_and_update)
        results["ps_compress"] = pc
        log(f"[ps_compress] 1,000,000 x 50 add, {PS_ROUNDS} rounds of "
            f"{PS_IDS} ids, deltas {COMPRESS_ZEROS:.0%} zeros, in turns: "
            f"compress=sparse round median {pc['round_median_ms']:.3f} ms "
            f"{[round(x, 3) for x in pc['round_ms']]}, uncompressed "
            f"{pc['plain_round_median_ms']:.3f} ms "
            f"{[round(x, 3) for x in pc['plain_round_ms']]}; every GetRows "
            f"and the final tables bitwise equal; wire_stats "
            f"{pc['wire_stats']} (payload / dense {pc['wire_ratio']:.4f})")
        corpus = write_zipf_corpus(workdir, args.seed)
        we_runs = we_run_table(workdir, args.seed, corpus)
        for name, (what, needs, kw) in we_runs.items():
            if name == "we_pairs_adagrad":
                with FirstBatches(dp, ID_SETS) as first:
                    we = drive(name, lambda: we_phase(torch, args.seed,
                                                      workdir, **kw),
                               needs, ("tokenize",))
            else:
                we = drive(name, lambda: we_phase(torch, args.seed, workdir,
                                                  **kw),
                           needs, ("tokenize",))
            check_we_pairs(name, we, paths[name])
            results[name] = we
            log(f"[{name}] {what}, {we['engine']} live slots "
                f"{we['live_slots']}: {we['words']} words in "
                f"{we['train_s']:.3f} s = {we['words_per_s']:.0f} words/s "
                f"({we['loader_wait_s']:.3f} s of it waiting on the block "
                f"loader); pairs by block "
                f"{[b['pairs'] for b in we['blocks']]}, loss per pair by "
                f"block {[round(b['loss_per_pair'], 4) for b in we['blocks']]}"
                f" (bound {we['limit']:.4f})"
                + (f"; {we['batches']} batch steps, {we['sparse_batches']} "
                   f"on the touched-rows step" if "batches" in we else ""))
        touched = time_touched_rows(torch, cr, dev, WE_BIG_VOCAB + 1, WE_DIM,
                                    first.outputs, args.seed + 8)
        results["kernels_touched_rows"] = touched
        for k, r in touched.items():
            log(f"[kernels] WE touched-rows AdaGrad {WE_BIG_VOCAB + 1}x"
                f"{WE_DIM}, {r['shape'][2]} ids ({r['distinct_rows']:.1f} "
                f"distinct rows, mean of the first {len(first.outputs)} "
                f"batches of [we_pairs_adagrad]) {k}: kernel == plain "
                f"bitwise; per-pair {r['ms']:.7f} ms, stream "
                f"{r['stream_ms']:.7f} ms (bound {r['bound_ms']:.7f}, plain "
                f"{r['plain_ms']:.7f}, library {r['library_ms']:.7f}, all "
                f"per-pair), max_abs_err {r['max_abs_err']}"
                + (f"; its {r['live_lanes']:.1f} lanes off the trash row "
                   f"alone: per-pair {r['live_ms']:.7f} ms, stream "
                   f"{r['live_stream_ms']:.7f} ms" if "live_ms" in r else ""))
        del first
        results["we_small_max_abs_diff"] = we_small_reference(torch, workdir)
        log(f"[we] topic corpus, card vs CPU embeddings: max abs diff "
            f"{results['we_small_max_abs_diff']:.3g} (rtol 1e-3, atol 1e-4)")
        results["we_pairs_max_abs_diff"] = we_pairs_card_vs_cpu(torch, cr,
                                                                workdir)
        log(f"[we_pairs] topic corpus, -device_pairs 1 -use_adagrad 1 on the "
            f"touched-rows step, the same draws, card vs CPU tables: max abs "
            f"diff {results['we_pairs_max_abs_diff']:.3g} (rtol 1e-3, atol "
            f"1e-4)")
        lr_phase(torch, dev, args.seed, workdir, lr_data, drive, results)
    launches = {k: sum(p[k] for p in paths.values()) for k in cr.LAUNCHES}
    results["main_path_launches"] = {"paths": paths, "total": launches,
                                     "native_calls": native_uses}
    log(f"[main path] launches, all paths {launches}")

    # phase 5: summary
    sources = {"gather_rows": "_make_gather_kernel / pallas_gather_rows",
               "scatter_set_rows": "pallas_scatter_set_rows",
               "update_rows": "pallas_update_rows"}
    replaces = {"gather_rows": "multiverso_tpu/ops/pallas_rows.py:170",
                "scatter_set_rows": "multiverso_tpu/ops/pallas_rows.py:244",
                "update_rows": "multiverso_tpu/ops/pallas_rows.py:362"}
    kernels = []
    for k in ("gather_rows", "scatter_set_rows", "update_rows"):
        r = ps_k[k]
        entry = {
            "name": k, "route": "cuda",
            "source": "multiverso_tpu_torch/csrc/rows.cu",
            "replaces": replaces[k], "pallas": sources[k],
            "launches": launches[k],
            "max_abs_err": max(
                [err for s in (ps_k, ps2_k, we_k, *lr_k.values())
                 for err in (s[k]["max_abs_err"],
                             s["update_rows_sgd_max_abs_err"]
                             if k == "update_rows" else 0.0)]
                + ([touched[k]["max_abs_err"]] if k in touched else [])),
            "ms": r["ms"], "stream_ms": r["stream_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": r["library_ms"], "shape": r["shape"],
            "we_ms": we_k[k]["ms"], "we_stream_ms": we_k[k]["stream_ms"],
            "we_bound_ms": we_k[k]["bound_ms"],
            "we_shape": we_k[k]["shape"]}
        for name, s in lr_k.items():
            # the LR paths' update is the sgd sign
            sgd = k == "update_rows"
            entry[name] = {
                "ms": s["update_rows_sgd_ms"] if sgd else s[k]["ms"],
                "stream_ms": (s["update_rows_sgd_stream_ms"] if sgd
                              else s[k]["stream_ms"]),
                "plain_ms": (s["update_rows_sgd_plain_ms"] if sgd
                             else s[k]["plain_ms"]),
                "library_ms": (s["update_rows_sgd_library_ms"] if sgd
                               else s[k]["library_ms"]),
                "max_abs_err": (s["update_rows_sgd_max_abs_err"] if sgd
                                else s[k]["max_abs_err"]),
                "bound_ms": s[k]["bound_ms"], "shape": s[k]["shape"]}
        entry["ps_2proc"] = {key: ps2_k[k][key] for key in (
            "ms", "stream_ms", "plain_ms", "library_ms", "max_abs_err",
            "bound_ms", "shape")}
        if k in touched:
            # the touched-rows AdaGrad step of [we_pairs_adagrad]
            entry["we_pairs_adagrad"] = {
                key: touched[k][key] for key in (
                    "ms", "stream_ms", "plain_ms", "library_ms",
                    "max_abs_err", "bound_ms", "shape", "distinct_rows")}
        kernels.append(entry)
    results["kernels"] = kernels
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
