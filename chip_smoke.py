#!/usr/bin/env python3
"""Smoke run of multiverso_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--json-out PATH] [--baseline DIR]

(``--rank-child R --child-phase ps|mh|fs|lr|we --port P`` runs one rank of
``[ps_2proc]``, of ``[ps_2proc apply]``, ``[ps_2proc compress]`` and
``[kv_2proc device]``, of ``[ps_2proc chaos]``, of ``[lr_2proc]`` or of
``[we_2proc]``; the script starts both ranks itself.)

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
              times and the wire ratio; the worker-side fast paths
              (``[ps_combine]``, run after the apps' phases, before
              ``[serve]``, as are ``[ps_get_cache]``, ``[binding]`` and
              ``[binding_c_abi]``): one worker pushes 200 fire-and-forget
              AddRows of 2,000 ids (integer deltas) to the add and the
              momentum table at the PS shape, then ``DrainServer`` and
              one GetRows of 10,000 ids a table, at the default
              ``-mv_write_combine=8`` and at 0 in turns (combined, plain,
              plain, combined): the add table equal to the oracle in
              every turn, 25 Add messages a table reaching the engine in
              a combined turn against 200, the momentum table bitwise
              equal across the combined turns and within rtol 1e-5, atol
              1e-6 of the same burst in a world on the CPU, the burst's
              seconds; ``<kAdd>`` at the combined Add's shape (8 x 2,000
              ids, duplicates pre-combined) bitwise its plain version,
              timed as in phase 2; the Get cache (``[ps_get_cache]``,
              ``-mv_get_staleness=2``): 10 identical GetRows of 10,000
              ids, the first a miss, the rest hits bitwise the miss
              launching no row gather, a miss equal to the oracle after
              the worker's own Add, each Get's seconds; the reference
              binding (``[binding]``): ``binding.init()`` on the card, a
              1,000,000 x 50 MatrixTableHandler and a 1,000,000
              ArrayTableHandler with init values, 5 rounds of 8 async
              adds and one get, each get equal to the oracle; a
              TorchParamManager over a model on the card in each of 2
              worker threads sharing one table (the server and both
              models end at the base plus both deltas); then the C ABI
              (``[binding_c_abi]``) through ctypes on the port's build of
              the native library with the port's bridge installed:
              ``MV_Init``, ``MV_NewMatrixTable(1000000, 50)``, 5 rounds of
              8 ``MV_AddAsyncMatrixTableByRows`` and one
              ``MV_GetMatrixTableByRows``, each equal to the oracle, the
              row gather and the update launched from the C path, the
              per-round seconds of both paths; two processes (``[ps_2proc]``):
              after the build, two ranks of this script on ``cuda:0``
              over ``torch.distributed`` (gloo) and, for the engine's
              window exchanges, the default host wire of a same-host
              world, the shared-memory wire (asserted; the size of
              ``/dev/shm`` is printed first), each keeping a replica
              of the tables, the add and momentum tables at the PS shape,
              5 rounds of AddRows + GetRows of each rank's 10,000 ids
              (overlapping across the ranks) through the windowed
              engine: every GetRows equal to the oracle of both ranks'
              Adds, the final tables bitwise equal across the ranks;
              ``[ps_2proc wires]``: the same rounds in a new world a turn
              (WIRE_TURNS: ``-mv_wire=gloo``; ``-mv_engine_shards=2`` on
              shm, a channel a shard; tcp, selected by ``auto`` in a
              loopback cross-host world of ``-mv_wire_hostname`` labels
              with two shards; compressed, ``compress="sparse"`` tables
              beside uncompressed twins on 80%-zero deltas; each twice,
              in mirrored order, then shm again), each turn asserting
              its wire by name, every GetRows equal to the oracle, the
              final tables bitwise equal across the ranks and across the
              wires (the compressed tables bitwise their twins), each
              rank launching all three kernels in each turn; per turn
              and wire the round medians, the exchange's seconds and
              share of the rounds, and the compressed wire ratio; then
              BSP (each rank's i-th GetRows against the oracle after
              both ranks' i-th Adds) and, with 2 worker threads a rank,
              MV_Aggregate of a 1,000,000 x 50 float32 array from each of
              the four workers (the exact sum); per rank the round
              medians, the exchange's seconds and share of the rounds,
              and the launches, each rank launching all three kernels;
              a rank that fails or hangs fails the run; and
              ``[ps_2proc burst]``: 200 fire-and-forget AddRows of 2,000
              ids a rank on the add table at the PS shape, at the
              default ``-mv_write_combine`` (8 pushes a message), on the
              default pipelined engine and on ``-mv_pipeline=0``
              ("serial") in turns (pipelined, serial, serial,
              pipelined), then pipelined at ``-mv_write_combine=0``: the
              final table equal to the oracle of both ranks' Adds and
              bitwise equal across the ranks, with the burst's seconds,
              Add messages, windows, and the engine's exchange and
              apply seconds; ``[ps_2proc serve]``: after the PS rounds
              both ranks ``MV_PublishSnapshot`` at one stream position
              (host residence), the versions agree, 4 threads a rank look
              up 256 random ids 50 times on each table, bitwise the rank's
              Get at the cut, with no host collective round on the lookup
              path; the rest of the two-process table surface (two more
              ranks, ``--child-phase mh``, each path's launch counts
              zeroed before it): ``[ps_2proc apply]``, an add, sgd,
              momentum and AdaGrad table at the PS shape, 50 rounds of
              fire-and-forget AddRows of 2,000 ids a rank to each table
              in turn (the first 5 untimed; ``-mv_write_combine=0``, so a
              window carries the four tables) and a GetRows of 10,000 ids
              a table, in a world a turn at ``-mv_apply_workers`` 4, 1, 1,
              4: every table bitwise equal across the ranks and the turns,
              add and sgd equal to the oracle, pool jobs at 4 workers and
              none at 1, with the burst's seconds, the engine's apply
              seconds, the pool and inline jobs and the share of windows
              that took the pool; ``[ps_2proc compress]``, [ps_2proc]'s add
              rounds with the window codecs off, with ``-mv_compress``
              alone (bitwise the first) and with ``-mv_compress_lossy=all``
              (the ranks bitwise equal, within the int8 bound of the first
              turn and not equal to it), with the window bytes before and
              after the codec; ``[kv_2proc device]``, 1,000,000 keys a rank
              (half shared) through ``device_slots(create=True)``,
              ``device_place_slots``, the scatter-add and the gather on the
              card, the values bitwise equal across the ranks and to a twin
              KV table that took the same deltas through the host Add, and
              each rank's lanes of the gather its keys' values;
              serving (``[serve]``, run after every other phase):
              the WordEmbedding flagship's width, an sgd and an AdaGrad MatrixTable of 1,000,000 x
              128 in one process on the card: the sgd table's snapshots
              device-resident (one clone, read by the row gather), the
              AdaGrad table's host-resident (aux state), on every
              published version; the card's allocated memory before
              publishing, after 3 publishes with a pin (3 copies) and
              after the unpin (2); the publish times; a trainer pushing
              AddRows of 10,000 random ids to both tables and publishing
              every 8 batches while 8 client threads look up 256
              Zipf(1.0) ids each, tables alternating, for 20 s (lookups/s,
              p50 / p99, mean coalesced batch, dispatches), then 5 s of
              it under torch.profiler (device idle); quiesced, served
              rows equal to the training GetRows at one cut (sgd
              bitwise, AdaGrad rtol / atol 1e-6), one row-gather launch
              per device-resident read, and a pinned version bitwise
              unchanged after 16 more Add batches and 2 publishes; then
              the gather at the serve union shape (unions of the
              measured mean batch of Zipf lookups) against its plain
              version, bitwise, timed as in phase 2;
              telemetry (``[telemetry]``): the PS round (add and
              momentum) with the JAX package's default-on telemetry and
              with ``-telemetry=false -mv_flight_events=0``, a world a
              turn, ABBA twice, every GetRows equal to the oracle, the
              medians and their ratio; in a ``-trace=true
              -mv_ops_port=0`` world the collective metrics snapshot's
              per-table counts equal to the verbs issued,
              ``MV_StartProfiler``/``MV_StopProfiler`` around 2 rounds
              (the trace's ``rows_group_kernel`` events exactly the
              wrappers' launches there, the ``mv`` spans on the host),
              the byte ledger (each table's device bytes its storage's,
              208,000,208 B and twice that with momentum, at most
              ``memory_allocated``; the probe, under a profiler of its
              own, launches nothing) and ``/metrics``, ``/healthz``,
              ``/memory``, ``/perf`` over HTTP; the same on/off turns of
              ``[ps_combine]``'s combined burst and of ``[ps_2proc]``'s
              rounds (tables bitwise equal on and off); and the port's
              ``telemetry/critpath.py`` over both ranks' flight rings of
              ``[ps_2proc]`` and of each ``[ps_2proc apply]`` turn (the
              binding rank and phase, seconds blocked in the collective
              against the codec's, ``align_err_s``, apply seconds a
              table); failsafe (``[failsafe]``, after ``[ma]``): the PS
              rounds in a world a turn, clean, chaos, chaos, clean, on
              the default engine and on ``-mv_engine_shards=1``, the chaos
              turns under the JAX soak's verb and mailbox sites
              (``mailbox.drop:0.06,mailbox.dup:0.08,mailbox.delay:0.08@
              0.002,verb.transient:0.06,verb.failack:0.06``,
              ``-chaos_seed=1234 -mv_max_retries=12``): every GetRows equal
              to the oracle, the final tables bitwise the clean turn's,
              ``failsafe.dedup_hits``, ``failsafe.retries`` and each armed
              ``chaos.*`` counter moved, the round medians of each turn;
              the deadline drill (``-mv_deadline_s=0.5``,
              ``apply.delay:1.0@2.0``): a GetRows raises
              ``DeadlineExceeded`` within 0.5-2.0 s with the bundle's five
              sections and the waiting msg_id,
              ``failsafe.deadline_exceeded`` moves by 1 and
              ``MV_ShutDown`` returns within 5 s; the PS rounds at
              ``-mv_deadline_s`` 0 and 30 in turns (off, on, on, off);
              ``[ps_2proc chaos]`` (two more ranks, ``--child-phase fs``,
              after ``[kv_2proc device]``): [ps_2proc]'s rounds in a world a
              turn (clean, chaos, chaos, clean; ``-mv_deadline_s=60``, so
              the window exchanges run through the bounded runner), the
              chaos turns under the same spec plus ``wire.bitflip:0.05`` on
              the default (shm) wire: every GetRows equal to the oracle of
              both ranks' Adds, the final tables bitwise equal across the
              ranks and the turns, every flipped frame caught by the CRC
              and re-exchanged, the counters moved, each rank's round
              medians against its clean turn; then the rounds at
              ``-mv_deadline_s`` 0 and 30 in turns;
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
   apps over two processes — two ranks of this script (``--rank-child
              R --child-phase lr|we``) on ``cuda:0`` over gloo, each on
              its own shard through the apps' entry points: ``[lr_2proc]``
              the dense softmax (784 x 10, float32) and sparse sigmoid
              (47,236 x 1) on the device plane, 6,000 samples cut 70 : 30
              (filler windows on the smaller rank), and FTRL (1,000
              features, halves) on the collective host KV verbs: final
              weights bitwise equal across the ranks, within rtol 1e-4,
              atol 1e-5 of the same runs in a two-rank world on the CPU,
              and phase 5's loss bounds; ``[we_2proc]`` ``-device_pairs 1
              -use_adagrad 1`` on the topic corpus (touched-rows step
              forced) and at 1,000,000 x 128 on the big Zipf corpus, both
              cut 2/3 : 1/3 (filler blocks), every rank running the
              global blocks, and ``-device_plane 1`` at 100,000 x 128 on
              halves: every table bitwise equal across the ranks, every
              block under its untrained loss, the topic run's first
              global block within rtol 1e-3, atol 1e-4 of the same block
              on the CPU (same draws); the 1,000,000 x 128 run's first
              global block with every batch step retaken on the card
              from the CPU's state within that tolerance, bitwise the
              same block in one process on the card, and no further
              from the CPU's block than 3x a one-ulp nudge moves it;
              per rank samples or words/s, the lockstep rounds' seconds
              and share, launches; the deterministic segment sums
              repeated on the card; the kernels timed at the LR merged
              window and the global touched-rows batch;
6. summary  — a ``{"kernels": [...]}`` line, the card line, and last
              ``{"ok": true, "device": {...}}``.

Each main path of phases 3 to 5 runs with the launch counters (and the
native library's call counters) zeroed just before it and read just
after: each kernel that path runs must have launched there, and the
``kernels`` line sums the paths (``[failsafe]``'s and ``[ps_2proc
chaos]``'s ranks' included). Any failure
raises and the script exits non-zero without the ``ok`` line. Without a
CUDA device, or away from the repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
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
BURST_TURNS = ("pipeline", "serial", "serial", "pipeline", "pipeline_wc0")
# [ps_2proc wires]: after the default world's PS rounds (the shm wire),
# each turn a new world on the same process group running the same rounds:
# gloo and shm with one engine, shm and tcp (a loopback cross-host world
# through -mv_wire_hostname) with -mv_engine_shards=2, and compressed
# (compress="sparse" tables beside uncompressed twins, COMPRESS_ZEROS of
# the deltas zero) on shm; every configuration twice, in mirrored order
WIRE_TURNS = ("gloo", "shm_sharded", "tcp", "compress", "compress", "tcp",
              "shm_sharded", "gloo", "shm")
# [ps_combine]: BURST_VERBS fire-and-forget AddRows of BURST_IDS ids on the
# add and the momentum table in one process, at the default
# -mv_write_combine (COMBINE_CAP) and at 0 in turns; then CACHE_GETS
# repeated GetRows under -mv_get_staleness=CACHE_STALENESS
COMBINE_CAP = 8
COMBINE_TURNS = ("combined", "plain", "plain", "combined")
CACHE_GETS, CACHE_STALENESS = 10, 2
# [binding]: rounds of BINDING_ADDS async row adds and one get through the
# Python handlers and through the C ABI; the param manager's model width
BINDING_ROUNDS, BINDING_ADDS, BINDING_WIDTH = 5, 8, 1024
# LogisticRegression: bench.py's app configurations (bench.py:446-553) and
# the RCV1 width (bench.py:44)
LR_DENSE_IN, LR_DENSE_OUT, LR_SAMPLES = 784, 10, 6_000
LR_SPARSE_IN, LR_SOFTMAX_OUT, LR_FTRL_IN, LR_NNZ = 47_236, 10, 1_000, 30
LR_MINIBATCH, LR_SPARSE_SYNC = 20, 50    # the app's default minibatch
LR_EPOCHS = {"lr_dense": 9, "lr_dense_host": 3, "lr_sparse": 6,
             "lr_softmax": 2, "lr_ftrl": 6, "lr_sparse_host": 6,
             "lr_sparse_compress": 6, "lr_softmax_1bit": 2}
# [lr_2proc]: rank 0's share of the device-plane runs' samples (the other
# rank runs out of windows first) and each run's epochs; [we_2proc]: a
# rank's -device_pairs block and rank 0's share of the big corpus
LR2_SHARE = 0.7
LR2_EPOCHS = {"lr2_dense": 3, "lr2_sparse": 3, "lr2_ftrl": 6}
WE2_BLOCK_BYTES, WE2_SHARE = 500_000, 2 / 3
WE2_RUNS = ("we2_topics", "we2_pairs", "we2_device")
# [ckpt]: rounds run after the save, and again after the load; the LR
# table's keys a round (about a window's distinct keys at the RCV1 width)
CKPT_ROUNDS, CKPT_LR_KEYS = 3, 20_000
# [ps_compress]: the share of each delta's entries that are zero
# (tests/test_tables.py:853-872, where the sparse filter's rule engages)
COMPRESS_ZEROS = 0.8
# [serve]: the WordEmbedding flagship's table width ([we_pairs_adagrad]'s
# 1,000,000 x 128 storage); a trainer pushes the PS shape's AddRows batches
# and publishes every SERVE_PUBLISH_EVERY of them while SERVE_CLIENTS
# client threads look up SERVE_LOOKUP_IDS Zipf(1.0) ids each for
# SERVE_WALL_S (and SERVE_IDLE_S under the profiler); a pinned version
# must outlive SERVE_PIN_ADDS more Add batches; [ps_2proc]'s serving check
# runs SERVE_2PROC_LOOKUPS lookups from each of 4 threads a rank
SERVE_ROWS, SERVE_COLS, SERVE_IDS = WE_BIG_VOCAB, WE_DIM, PS_IDS
SERVE_PUBLISH_EVERY, SERVE_CLIENTS, SERVE_LOOKUP_IDS = 8, 8, 256
SERVE_WALL_S, SERVE_IDLE_S, SERVE_PIN_ADDS = 20.0, 5.0, 16
SERVE_2PROC_LOOKUPS = 50
# [ps_2proc apply]: four tables at the PS shape; APPLY_ROUNDS rounds of
# fire-and-forget AddRows of BURST_IDS ids a rank to each in turn (the
# first APPLY_WARM untimed), in a world a turn at -mv_apply_workers of
# APPLY_TURNS (mirrored)
APPLY_KINDS = (("add", "default"), ("sgd", "sgd"), ("momentum", "momentum"),
               ("adagrad", "adagrad"))
APPLY_ROUNDS, APPLY_WARM, APPLY_TURNS = 50, 5, (4, 1, 1, 4)
# [ps_2proc compress]: [ps_2proc]'s add rounds with the window codecs off,
# -mv_compress alone, and -mv_compress with every table lossy-opted
CODEC_TURNS = ("off", "lossless", "lossy")
# [kv_2proc device]: the keys each rank resolves on the KV device plane
KV_DEVICE_KEYS = 1_000_000
# [telemetry]: the flags that turn the JAX package's default-on telemetry
# off; the PS round (AddRows + GetRows on the add and on the momentum table,
# PS_IDS ids) with telemetry at its defaults ("on"), with the metrics but
# no flight ring ("metrics": no flight events and no phase stamps) and off,
# a world a turn of TELE_TURNS, TELE_ROUNDS rounds a world of which the
# first TELE_WARM are untimed; the same on and off turns of [ps_combine]'s
# burst (COMBINE_TELE_TURNS) and of [ps_2proc]'s rounds (TELE2_TURNS);
# TELE_PROBE_ROUNDS rounds counted in the metrics snapshot and traced under
# MV_StartProfiler
TELE_OFF = ("-telemetry=false", "-mv_flight_events=0")
TELE_METRICS_ONLY = ("-mv_flight_events=0",)
TELE_TURNS = ("on", "metrics", "off", "off", "metrics", "on") * 3
TELE_ROUNDS, TELE_WARM, TELE_PROBE_ROUNDS = 43, 3, 2
COMBINE_TELE_TURNS = ("on", "off", "off", "on") * 2
TELE2_TURNS = ("on", "off", "off", "on")
TELE2_ROUNDS = 13
# [failsafe]: the JAX package's chaos soak's verb and mailbox sites
# (tests/test_failsafe_multiproc.py) under one seed, a world a turn of
# FS_TURNS on the PS path; the deadline drill stalls the engine's window
# apply FS_DELAY_S under a deadline of FS_DEADLINE_S; the PS rounds at
# -mv_deadline_s 0 and 30 in FS_DEADLINE_TURNS
FS_SPEC = ("mailbox.drop:0.06,mailbox.dup:0.08,mailbox.delay:0.08@0.002,"
           "verb.transient:0.06,verb.failack:0.06")
FS_CHAOS = (f"-chaos_spec={FS_SPEC}", "-chaos_seed=1234",
            "-mv_max_retries=12")
FS_SITES = ("mailbox.drop", "mailbox.dup", "mailbox.delay",
            "verb.transient", "verb.failack")
FS_COUNTERS = ("failsafe.dedup_hits", "failsafe.retries",
               "failsafe.deadline_exceeded", "wire.crc_failures",
               *(f"chaos.{s}" for s in FS_SITES + ("wire.bitflip",)))
FS_TURNS = ("clean", "chaos", "chaos", "clean")
FS_DEADLINE_TURNS = ("off", "on", "on", "off")
FS_DEADLINE_S, FS_DELAY_S, FS_SHUTDOWN_S = 0.5, 2.0, 5.0


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
    # the Add+Get's plain version: the plain update, which returns the
    # post-update rows too (no single library call does both)
    res["update_gather_rows_plain_ms"] = median_ms(
        torch, lambda i: cr.update_rows_plain(b, ids[i], src[i], 1), ID_SETS)
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

        def recording(state, inputs, imask, outputs, *rest, **kw):
            if len(self.outputs) < self.n:
                self.outputs.append(outputs.reshape(-1).clone())
            return self.step(state, inputs, imask, outputs, *rest, **kw)

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


def counter(name: str) -> float:
    """A metrics counter's process total (``telemetry/metrics.py``); a
    phase reads the difference across its world."""
    from multiverso_tpu_torch.telemetry import metrics
    return metrics.counter(name).value


def serving_stats(s0: dict, s1: dict) -> dict:
    """The serving front-end's work between two local metrics snapshots:
    the ``serving.*`` counters' differences, the batches and the mean
    coalesced batch (``serving.batch_size``), and the latency p50 / p99
    (admission to fill) from ``serving.latency_s``'s bucket differences
    (the log-bucket estimate: within a bucket's octave)."""
    from multiverso_tpu_torch.telemetry.metrics import N_BUCKETS, Histogram

    def diff(name, key="value"):
        return (s1.get(name, {}).get(key, 0.0)
                - s0.get(name, {}).get(key, 0.0))

    def buckets(name):
        a = s0.get(name, {}).get("buckets", {})
        b = s1.get(name, {}).get("buckets", {})
        return [b.get(str(i), 0) - a.get(str(i), 0) for i in range(N_BUCKETS)]

    n_batch = diff("serving.batch_size", "count")
    n_lat = diff("serving.latency_s", "count")
    lat = buckets("serving.latency_s")
    return {"lookups": int(diff("serving.lookups")),
            "shed": int(diff("serving.shed")),
            "dispatches": int(diff("serving.dispatches")),
            "batches": int(n_batch),
            "mean_batch": (diff("serving.batch_size", "sum") / n_batch
                           if n_batch else 0.0),
            "latency_p50_s": Histogram.percentile(lat, n_lat, 0.50),
            "latency_p99_s": Histogram.percentile(lat, n_lat, 0.99)}


def tele_argv(turn: str) -> list:
    """A [telemetry] turn's flags: the defaults ("on"), the metrics without
    the flight ring ("metrics"), or telemetry off."""
    return {"on": [], "metrics": list(TELE_METRICS_ONLY),
            "off": list(TELE_OFF)}[turn]


def spread(values) -> float:
    """max / min of a configuration's turn medians (1.0 = no spread)."""
    return float(max(values) / min(values))


def flight_slice(path: str, since: float) -> str:
    """Keep the header and the events recorded at or after ``since`` (wall
    seconds) of the flight dump at ``path``: the ring is process-wide and
    outlives worlds, and a turn's stream positions restart at SEQ 0, so
    the offline tools must see one world's events only."""
    with open(path) as f:
        lines = f.readlines()
    keep = [lines[0]] + [ln for ln in lines[1:]
                         if json.loads(ln)["t"] >= since]
    with open(path, "w") as f:
        f.writelines(keep)
    return path


def critpath_summary(paths: list) -> dict:
    """The port's ``telemetry/critpath.py`` over both ranks' dumps of one
    turn: the windows, the binding rank and phase histograms, per rank the
    seconds blocked in the exchange's collective against the codec's
    (encode + decode) and the whole exchange, the alignment error, and the
    apply seconds per (table, verb). Fails when the report degrades (the
    dumps hold no common stamped window)."""
    from multiverso_tpu_torch.telemetry import critpath
    rep = critpath.correlate(paths)
    if rep["degraded"] is not None or rep["n_windows"] == 0:
        raise AssertionError(f"critpath degraded on {paths}: "
                             f"{rep['degraded']}")
    tot = rep["phase_totals_s"]
    return {
        "n_windows": rep["n_windows"],
        "binding_rank_hist": {str(k): v for k, v in
                              rep["binding_rank_hist"].items()},
        "binding_phase_hist": rep["binding_phase_hist"],
        "exchange_wait_s": {str(r): tot[r]["exchange_wait"] for r in tot},
        "exchange_s": {str(r): tot[r]["exchange"] for r in tot},
        "codec_s": {str(r): tot[r]["encode"] + tot[r]["decode"]
                    for r in tot},
        "apply_s": {str(r): tot[r]["apply"] for r in tot},
        "wait_excess_s": {str(k): v for k, v in
                          rep["exchange_wait_excess_s"].items()},
        "align_err_s": rep["align_err_s"],
        "accounted_pct": rep["accounted_pct"],
        "tables": rep["tables_top"], "note": rep["note"]}


def critpath_line(tag: str, c: dict, card: str) -> str:
    """One turn's critpath verdict as a log line."""
    tables = ", ".join(f"{t['table']} {t['verb']} {t['seconds']:.4f} s"
                       for t in c["tables"][:6])
    ranks = "; ".join(
        f"rank {r}: blocked in the collective {c['exchange_wait_s'][r]:.4f} "
        f"s of the exchange's {c['exchange_s'][r]:.4f} s, codec "
        f"{c['codec_s'][r]:.4f} s, apply {c['apply_s'][r]:.4f} s"
        for r in sorted(c["exchange_s"]))
    return (f"{tag} critpath: {c['n_windows']} windows, binding ranks "
            f"{c['binding_rank_hist']}, binding phases "
            f"{c['binding_phase_hist']}; {ranks}; wait on a slower peer "
            f"{c['wait_excess_s']}; align_err_s {c['align_err_s']}; "
            f"accounted {c['accounted_pct']}%; apply by table: {tables} "
            f"({card})")


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


def ps_tables(mv):
    """The PS shape's add and momentum tables."""
    from multiverso_tpu_torch.tables import MatrixTableOption
    add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                              num_cols=PS_COLS))
    mom = mv.MV_CreateTable(MatrixTableOption(
        num_rows=PS_ROWS, num_cols=PS_COLS, updater_type="momentum"))
    return add, mom


def tele_rounds(seed: int, n: int) -> list:
    """[telemetry]'s rounds: n (ids, integer deltas) of PS_IDS unique
    rows."""
    g = np.random.default_rng([seed, 1300])
    return [(g.choice(PS_ROWS, PS_IDS, replace=False).astype(np.int32),
             g.integers(-3, 4, (PS_IDS, PS_COLS)).astype(np.float32))
            for _ in range(n)]


def tele_round(add, mom, mopt, ids, deltas) -> tuple:
    """One PS round, host clock: AddRows + GetRows on the add table, then
    on the momentum table. Returns (ms, the add table's rows)."""
    t0 = time.perf_counter()
    add.AddRows(ids, deltas)
    got = add.GetRows(ids)
    mom.AddRows(ids, deltas, mopt)
    mom.GetRows(ids)
    return (time.perf_counter() - t0) * 1e3, got


def http_get(port: int, path: str) -> tuple:
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def telemetry_phase(torch, mv, cr, dev, seed: int, workdir: str) -> dict:
    """[telemetry] at the PS shape on the default engine: (1) the PS round
    with telemetry at the JAX package's defaults, with the metrics alone
    (TELE_METRICS_ONLY) and off (TELE_OFF), a world a turn of TELE_TURNS
    (each order of the three, balanced), every GetRows held to the
    oracle; (2) one world at ``-trace=true -mv_ops_port=0``: the metrics
    snapshot's per-table counts against the verbs issued;
    ``MV_StartProfiler``/``MV_StopProfiler`` around TELE_PROBE_ROUNDS
    rounds: the trace file's CUDA kernel events named rows_group_kernel as
    many as the wrappers counted in that window, and the ``mv`` spans on
    the host; the byte ledger: each table's device bytes its storage's
    (208,000,208 B for the add table, twice that with momentum's aux
    state), the sum in ``mem.tables.device_bytes``, at most
    ``torch.cuda.memory_allocated()``, and the probe (under a CUDA
    profiler of its own) launches no kernel; the ops endpoint's
    ``/metrics``, ``/healthz``, ``/memory`` and ``/perf`` over HTTP."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multiverso_tpu_torch.telemetry import accounting, metrics, ops
    from multiverso_tpu_torch.updaters.base import AddOption
    from multiverso_tpu_torch.zoo import Zoo
    mopt = AddOption(momentum=0.5)
    rounds = tele_rounds(seed, TELE_ROUNDS)
    oracle = np.zeros((PS_ROWS, PS_COLS), np.float32)
    turns = []
    for turn in TELE_TURNS:
        oracle[:] = 0
        mv.MV_Init(tele_argv(turn))
        try:
            add, mom = ps_tables(mv)
            ms = []
            for ids, deltas in rounds:
                t, got = tele_round(add, mom, mopt, ids, deltas)
                oracle[ids] += deltas
                np.testing.assert_array_equal(got, oracle[ids],
                                              err_msg=f"[telemetry] {turn}")
                ms.append(t)
            names = len(metrics.snapshot())
        finally:
            mv.MV_ShutDown()
        turns.append({"turn": turn, "round_ms": ms[TELE_WARM:],
                      "median_ms": float(np.median(ms[TELE_WARM:])),
                      "instruments": names})
    res = {"turns": turns}
    for k in ("on", "metrics", "off"):
        med = [t["median_ms"] for t in turns if t["turn"] == k]
        res[f"{k}_median_ms"] = float(np.median(med))
        res[f"{k}_spread"] = spread(med)
        # every timed round of the configuration's turns
        res[f"{k}_pooled_ms"] = float(np.median(np.concatenate(
            [t["round_ms"] for t in turns if t["turn"] == k])))
    res["on_over_off"] = res["on_median_ms"] / res["off_median_ms"]
    res["metrics_over_off"] = res["metrics_median_ms"] / res["off_median_ms"]

    mv.MV_Init(["-trace=true", "-mv_ops_port=0"])
    try:
        add, mom = ps_tables(mv)
        probe = tele_rounds(seed + 1, 2 + 2 * TELE_PROBE_ROUNDS)
        for ids, deltas in probe[:2]:                     # warm up
            tele_round(add, mom, mopt, ids, deltas)
        Zoo.Get().DrainServer()
        c0 = mv.MV_MetricsSnapshot()
        for ids, deltas in probe[2:2 + TELE_PROBE_ROUNDS]:
            tele_round(add, mom, mopt, ids, deltas)
        Zoo.Get().DrainServer()
        c1 = mv.MV_MetricsSnapshot()
        want = {f"table.matrix{t}.{v}.count": TELE_PROBE_ROUNDS
                for t in (0, 1) for v in ("add", "get")}
        want["server.window.verbs"] = 4 * TELE_PROBE_ROUNDS
        got = {k: c1[k]["value"] - c0.get(k, {"value": 0})["value"]
               for k in want}
        if got != want:
            raise AssertionError(f"[telemetry] MV_MetricsSnapshot counts "
                                 f"{got}, verbs issued {want}")
        res["snapshot_counts"] = got
        # the profiler around TELE_PROBE_ROUNDS rounds
        tdir = os.path.join(workdir, "mv_profile")
        l0 = dict(cr.LAUNCHES)
        mv.MV_StartProfiler(tdir)
        try:
            for ids, deltas in probe[2 + TELE_PROBE_ROUNDS:]:
                tele_round(add, mom, mopt, ids, deltas)
            torch.cuda.synchronize()
        finally:
            path = mv.MV_StopProfiler()
        launched = {k: cr.LAUNCHES[k] - l0[k] for k in l0}
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"
                and "rows_group_kernel" in e.get("name", "")]
        spans = sorted({e["name"] for e in events
                        if e.get("cat") == "user_annotation"})
        if len(kern) != sum(launched.values()) or not kern:
            raise AssertionError(f"[telemetry] the profiler trace holds "
                                 f"{len(kern)} rows_group_kernel events; "
                                 f"the wrappers launched {launched}")
        if not {"worker.add", "worker.get"} <= set(spans):
            raise AssertionError(f"[telemetry] no mv spans in the trace: "
                                 f"{spans}")
        res["profiler"] = {"kernel_events": len(kern), "launched": launched,
                           "kernel_names": sorted({e["name"] for e in kern}),
                           "spans": spans,
                           "trace_mb": os.path.getsize(path) / 1e6}
        # the byte ledger, its probe under a CUDA profiler of its own
        torch.cuda.synchronize()
        l0 = dict(cr.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rep = accounting.memory_report()
            torch.cuda.synchronize()
        probe_kernels = sum(1 for e in prof.events()
                            if e.device_type == DeviceType.CUDA)
        if probe_kernels or cr.LAUNCHES != l0:
            raise AssertionError(f"[telemetry] the ledger probe launched "
                                 f"{probe_kernels} device events")
        per = {r["table_id"]: r["device_bytes"]
               for r in rep["components"]["tables"]["per_table"]}
        storage = (PS_ROWS + 1) * (PS_COLS + 2) * 4
        if per != {0: storage, 1: 2 * storage}:
            raise AssertionError(f"[telemetry] ledger device bytes {per}, "
                                 f"storage {storage} and {2 * storage}")
        gauge = metrics.snapshot()["mem.tables.device_bytes"]["value"]
        allocated = torch.cuda.memory_allocated()
        if gauge != 3 * storage or gauge > allocated:
            raise AssertionError(f"[telemetry] mem.tables.device_bytes "
                                 f"{gauge}, allocated {allocated}")
        res["ledger"] = {"per_table": per, "device_bytes": gauge,
                         "allocated": allocated,
                         "total_bytes": rep["total_bytes"]}
        # the ops endpoint over HTTP
        port = ops.port()
        scrape = {}
        for p in ("/metrics", "/healthz", "/memory", "/perf"):
            code, body = http_get(port, p)
            if code != 200:
                raise AssertionError(f"[telemetry] {p}: HTTP {code}")
            scrape[p] = body
        samples = dict(ln.rsplit(" ", 1) for ln in
                       scrape["/metrics"].splitlines()
                       if not ln.startswith("#"))
        if float(samples["mv_mem_tables_device_bytes"]) != 3 * storage:
            raise AssertionError("[telemetry] /metrics ledger gauge")
        health = json.loads(scrape["/healthz"])
        perf = json.loads(scrape["/perf"])
        if health["status"] != "ok" or "apply" not in perf["phases"]:
            raise AssertionError(f"[telemetry] /healthz {health['status']}"
                                 f", /perf phases {sorted(perf['phases'])}")
        res["ops"] = {"metrics_lines": len(scrape["/metrics"].splitlines()),
                      "health": health["status"],
                      "memory_total_bytes": json.loads(
                          scrape["/memory"])["total_bytes"],
                      "perf_phases": {k: v["count"] for k, v in
                                      perf["phases"].items()},
                      "binding_phase": perf["binding_phase"]}
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError("error word set on the telemetry path")
    finally:
        mv.MV_ShutDown()
    return res


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


def ps2_wire_flags(turn: str, rank: int) -> tuple:
    """A [ps_2proc wires] turn's extra MV_Init flags and the wire its
    engine must ride."""
    return {"shm": ((), "shm"),
            "gloo": (("-mv_wire=gloo",), "gloo"),
            "shm_sharded": (("-mv_engine_shards=2",), "shm"),
            "tcp": (("-mv_engine_shards=2", f"-mv_wire_hostname=node{rank}"),
                    "tcp"),
            "compress": ((), "shm")}[turn]


def engine_sum(eng, attr: str) -> float:
    """``attr`` summed over the engine's shards (the router and its
    sub-shards on the sharded engine)."""
    shards = [eng] + list(getattr(eng, "_subs", {}).values())
    return sum(getattr(e, attr) for e in shards)


def ps2_compress_batch(seed: int, r: int, rank: int) -> tuple:
    """The compressed turn's round r of ``rank``: ps2_batch's ids, integer
    deltas with COMPRESS_ZEROS of the entries zero (the sparse filter
    compresses every batch)."""
    ids, deltas = ps2_batch(seed, 300 + r, rank)
    g = np.random.default_rng([seed, 610 + r, rank])
    deltas[g.random(deltas.shape) < COMPRESS_ZEROS] = 0.0
    return ids, deltas


def ps2_oracle(batches, momentum: float) -> list:
    """The oracle of PS_ROUNDS rounds of both ranks' (ids, deltas)
    ``batches[k][r]`` on an add and a momentum table: per round, each
    rank's expected GetRows after it, ``{rank: (add rows, momentum
    rows)}``; and the final add and momentum tables."""
    m = np.float32(momentum)
    oracle_add = np.zeros((PS_ROWS, PS_COLS), np.float32)
    oracle_mom = np.zeros((PS_ROWS, PS_COLS), np.float32)
    smooth = np.zeros((PS_ROWS, PS_COLS), np.float32)
    delta = np.zeros((PS_ROWS, PS_COLS), np.float32)
    out = []
    for r in range(PS_ROUNDS):
        touched = np.union1d(batches[0][r][0], batches[1][r][0])
        delta[touched] = 0.0
        for k_ids, k_deltas in (batches[0][r], batches[1][r]):
            delta[k_ids] += k_deltas
        oracle_add[touched] += delta[touched]
        smooth[touched] = (m * smooth[touched]
                           + (np.float32(1) - m) * delta[touched])
        oracle_mom[touched] -= smooth[touched]
        out.append({k: (oracle_add[batches[k][r][0]].copy(),
                        oracle_mom[batches[k][r][0]].copy())
                    for k in range(2)})
    return out, oracle_add, oracle_mom


def ps2_wire_turn(torch, mv, cr, base: list, turn: str, rank: int,
                  seed: int) -> dict:
    """One [ps_2proc wires] turn on ``rank``: a world of ``turn``'s flags
    (``ps2_wire_flags``) whose engine must ride the turn's wire, the add
    and momentum tables at the PS shape, PS_ROUNDS rounds of AddRows +
    GetRows of the rank's 10,000 ids, every GetRows held to the oracle of
    both ranks' Adds; the compressed turn runs ``compress="sparse"``
    tables beside uncompressed twins on 80%-zero deltas, every GetRows of
    a compressed table bitwise its twin's. Returns the round times, the
    engine's exchange seconds (all shards), the wire's channels' rounds,
    the final tables' digest and the launches of each kernel in the
    turn."""
    import hashlib

    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.updaters.base import AddOption
    from multiverso_tpu_torch.zoo import Zoo
    flags, want = ps2_wire_flags(turn, rank)
    compress = turn == "compress"
    make = ps2_compress_batch if compress else ps2_batch
    batches = [[make(seed, r, k) for r in range(PS_ROUNDS)]
               for k in range(2)]
    expect, final_add, final_mom = ps2_oracle(batches, 0.5)
    l0 = dict(cr.LAUNCHES)
    mv.MV_Init(base + list(flags))
    try:
        if multihost.wire_name() != want:
            raise AssertionError(f"[ps_2proc wires] {turn}: the engine "
                                 f"rides {multihost.wire_name()}, not "
                                 f"{want}")

        def pair(**kw):
            return [mv.MV_CreateTable(MatrixTableOption(
                num_rows=PS_ROWS, num_cols=PS_COLS, compress=c, **kw))
                for c in (("sparse", None) if compress else (None,))]

        adds, moms = pair(), pair(updater_type="momentum")
        mopt = AddOption(momentum=0.5)
        eng = Zoo.Get().server_engine
        x0 = engine_sum(eng, "xw_busy_s")
        add_ms, mom_ms = [], []
        for r, (ids, deltas) in enumerate(batches[rank]):
            want_add, want_mom = expect[r][rank]
            t0 = time.perf_counter()
            got = []
            for t in adds:
                t.AddRows(ids, deltas)
                got.append(t.GetRows(ids))
            add_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            for t in moms:
                t.AddRows(ids, deltas, mopt)
                got.append(t.GetRows(ids))
            mom_ms.append((time.perf_counter() - t0) * 1e3)
            n = len(adds)
            for g in got[:n]:
                np.testing.assert_array_equal(g, want_add)
            for g in got[n:]:
                np.testing.assert_allclose(g, want_mom, rtol=1e-6, atol=1e-6)
            if compress:
                # a compressed table's rows bitwise its twin's
                np.testing.assert_array_equal(got[0], got[1])
                np.testing.assert_array_equal(got[2], got[3])
        exchange_s = engine_sum(eng, "xw_busy_s") - x0
        finals = [t.Get() for t in adds + moms]
        np.testing.assert_array_equal(finals[0], final_add)
        np.testing.assert_allclose(finals[len(adds)], final_mom, rtol=1e-6,
                                   atol=1e-6)
        if compress:
            np.testing.assert_array_equal(finals[0], finals[1])
            np.testing.assert_array_equal(finals[2], finals[3])
        res = {"turn": turn, "wire": multihost.wire_name(),
               "engine": type(eng).__name__,
               "channel_rounds": multihost.active_wire().stats()["rounds"]
               if multihost.active_wire() is not None else None,
               "add_round_ms": add_ms, "momentum_round_ms": mom_ms,
               "round_s": (sum(add_ms) + sum(mom_ms)) / 1e3,
               "exchange_s": exchange_s,
               "digest": hashlib.sha256(finals[0].tobytes()
                                        + finals[len(adds)].tobytes()
                                        ).hexdigest()}
        if compress:
            ws = adds[0].server().wire_stats
            res["wire_ratio"] = ws["payload_bytes"] / ws["dense_bytes"]
        torch.cuda.synchronize()
    finally:
        mv.MV_ShutDown(finalize_net=False)
    res["launches"] = {k: cr.LAUNCHES[k] - l0[k] for k in l0}
    return res


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
    mv.MV_Init(base + [f"-mv_pipeline={int(turn != 'serial')}"]
               + (["-mv_write_combine=0"] if turn == "pipeline_wc0" else []))
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
        m0 = eng.add_messages
        t0 = time.perf_counter()
        for ids, deltas in mine[BURST_WARM:]:
            table.AddFireForget(deltas, row_ids=ids)
        table.GetRows(mine[-1][0][:1])
        wall = time.perf_counter() - t0
        res = {"turn": turn, "wall_s": wall,
               "exchange_s": eng.xw_busy_s - x0,
               "apply_s": eng.apply_busy_s - a0,
               "exchanges": eng.mh_window_exchanges - e0,
               "verbs": eng.mh_window_verbs - v0,
               "add_messages": eng.add_messages - m0}
        final = table.Get()
        torch.cuda.synchronize()
    finally:
        mv.MV_ShutDown(finalize_net=False)
    np.testing.assert_array_equal(final, oracle,
                                  err_msg=f"[ps_2proc burst] {turn}")
    res["digest"] = hashlib.sha256(final.tobytes()).hexdigest()
    return res


def ps2_serve(mv, tables, gets, seed: int, rank: int) -> dict:
    """[ps_2proc]'s serving cut: both ranks publish right after the
    tables' whole Gets ``gets`` (the same stream position on both: the
    versions must agree, and a multi-process world serves from host
    copies); 4 threads a rank then look up SERVE_2PROC_LOOKUPS sets of
    SERVE_LOOKUP_IDS random ids on each table, every one bitwise the
    rank's training Get at the cut, while the process's host collective
    rounds stay where they were."""
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.serving import get_plane
    t0 = time.perf_counter()
    v = mv.MV_PublishSnapshot()
    publish_s = time.perf_counter() - t0
    snap = get_plane().store.get(v)
    residence = sorted({snap.tables[t.table_id].residence for t in tables})
    del snap
    if residence != ["host"]:
        raise AssertionError(f"[ps_2proc] serving residence {residence}")
    versions = multihost.host_allgather_objects(v)
    rounds0 = multihost.collective_rounds()

    def looker(c):
        g = np.random.default_rng([seed, 650, rank, c])
        for _ in range(SERVE_2PROC_LOOKUPS):
            ids = g.choice(PS_ROWS, SERVE_LOOKUP_IDS, replace=False)
            for t, want in zip(tables, gets):
                if not np.array_equal(
                        mv.MV_ServingLookup(t, ids, version=v), want[ids]):
                    raise AssertionError(f"[ps_2proc] rank {rank}: a "
                                         f"served row != the Get at the cut")

    t0 = time.perf_counter()
    run_threads(looker, 4)
    lookup_s = time.perf_counter() - t0
    return {"version": v, "versions": versions, "publish_s": publish_s,
            "lookups": 4 * SERVE_2PROC_LOOKUPS * len(tables),
            "lookup_s": lookup_s,
            "lookup_rounds": multihost.collective_rounds() - rounds0,
            "residence": residence}


def ps_2proc_rank(rank: int, port: int, seed: int, out: str) -> int:
    """One rank of [ps_2proc] (``--rank-child``), on ``cuda:0`` beside its
    peer. The default world, which must ride the shm wire: the PS shape on
    an add and a momentum table, 5 rounds of AddRows + GetRows of each
    rank's 10,000 ids, every GetRows held to the oracle of BOTH ranks'
    Adds; the final tables' digest; the serving cut; then, on the same
    process group, [ps_2proc wires] (WIRE_TURNS: the same rounds on gloo,
    shm and tcp, one engine or two shards, and compressed), [ps_2proc
    burst] on both engines in turns, BSP (each rank's i-th GetRows against
    the oracle after both ranks' i-th Adds) and, in a model-average world
    of 2 worker threads a rank, MV_Aggregate of a 1,000,000 x 50 float32
    array from each of the four workers (the exact sum). Writes its
    measurements and its launch counts to ``out``."""
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
    from multiverso_tpu_torch.parallel import multihost
    dev = torch.device("cuda", 0)
    base = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2"]
    res = {"rank": rank}
    batches = [[ps2_batch(seed, r, k) for r in range(PS_ROUNDS)]
               for k in range(2)]
    expect, oracle_add, oracle_mom = ps2_oracle(batches, 0.5)
    cr.reset_launches()
    since = time.time()
    t0 = time.perf_counter()
    mv.MV_Init(base)
    res["init_s"] = time.perf_counter() - t0
    # the default wire of a same-host world
    res["wire"] = multihost.wire_name()
    if res["wire"] != "shm":
        raise AssertionError(f"[ps_2proc] the default world rides "
                             f"{res['wire']}, not shm")
    add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                              num_cols=PS_COLS))
    mom = mv.MV_CreateTable(MatrixTableOption(
        num_rows=PS_ROWS, num_cols=PS_COLS, updater_type="momentum"))
    if add.server().state["data"].device != dev:
        raise AssertionError("the PS tables are not on cuda:0")
    eng = Zoo.Get().server_engine
    res["engine"] = type(eng).__name__
    mopt = AddOption(momentum=0.5)
    add_ms, mom_ms = [], []
    for r, (ids, deltas) in enumerate(batches[rank]):
        t0 = time.perf_counter()
        add.AddRows(ids, deltas)
        got_add = add.GetRows(ids)
        add_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        mom.AddRows(ids, deltas, mopt)
        got_mom = mom.GetRows(ids)
        mom_ms.append((time.perf_counter() - t0) * 1e3)
        np.testing.assert_array_equal(got_add, expect[r][rank][0])
        np.testing.assert_allclose(got_mom, expect[r][rank][1], rtol=1e-6,
                                   atol=1e-6)
    res.update(add_round_ms=add_ms, momentum_round_ms=mom_ms,
               round_s=(sum(add_ms) + sum(mom_ms)) / 1e3,
               window_exchanges=eng.mh_window_exchanges,
               window_verbs=eng.mh_window_verbs,
               exchange_s=eng.xw_busy_s, engine_apply_s=eng.apply_busy_s)
    # this world's flight ring, for the port's critpath in the parent
    res["flight_ps"] = flight_slice(mv.MV_DumpFlightRecorder(os.path.join(
        os.path.dirname(out), f"flight_ps_rank{rank}.jsonl")), since)
    final_add, final_mom = add.Get(), mom.Get()
    np.testing.assert_array_equal(final_add, oracle_add)
    np.testing.assert_allclose(final_mom, oracle_mom, rtol=1e-6, atol=1e-6)
    res["digest"] = hashlib.sha256(final_add.tobytes()
                                   + final_mom.tobytes()).hexdigest()
    res["serve"] = ps2_serve(mv, (add, mom), (final_add, final_mom), seed,
                             rank)
    torch.cuda.synchronize()
    if cr.read_error(dev) != 0:
        raise AssertionError("error word set on the 2-process PS path")
    res["ps_launches"] = dict(cr.LAUNCHES)
    del oracle_mom, final_add, final_mom, expect
    mv.MV_ShutDown(finalize_net=False)      # the process group stays up

    # [ps_2proc telemetry]: TELE2_ROUNDS rounds with telemetry at its
    # defaults and off, in turns (the parent checks the tables bitwise
    # equal across the turns and the ranks)
    mine = [ps2_batch(seed, 5000 + r, rank) for r in range(TELE2_ROUNDS)]
    res["tele"] = [ps2_tele_turn(mv, base, turn, mine)
                   for turn in TELE2_TURNS]
    del mine

    # [ps_2proc wires]: the same rounds on the other wires and engines, and
    # compressed, in turns
    res["wires"] = [ps2_wire_turn(torch, mv, cr, base, turn, rank, seed)
                    for turn in WIRE_TURNS]

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


def ps2_tele_turn(mv, base: list, turn: str, mine: list) -> dict:
    """One [ps_2proc telemetry] turn: a round of AddRows + GetRows on fresh
    add and momentum tables for each of this rank's batches ``mine``,
    telemetry at its defaults ("on") or off. Returns the round times after
    the first TELE_WARM and the final tables' digest."""
    import hashlib

    from multiverso_tpu_torch.updaters.base import AddOption
    mopt = AddOption(momentum=0.5)
    mv.MV_Init(base + tele_argv(turn))
    try:
        add, mom = ps_tables(mv)
        ms = [tele_round(add, mom, mopt, ids, deltas)[0]
              for ids, deltas in mine]
        got = hashlib.sha256(add.Get().tobytes()
                             + mom.Get().tobytes()).hexdigest()
    finally:
        mv.MV_ShutDown(finalize_net=False)
    return {"turn": turn, "round_ms": ms[TELE_WARM:],
            "median_ms": float(np.median(ms[TELE_WARM:])), "digest": got}


def rank_children(phase: str, seed: int, workdir: str) -> list:
    """Both ranks of a two-process phase: two processes of this script
    (``--rank-child R --child-phase PHASE``) on the one card over gloo,
    started after the build so they load the built kernels; a rank that
    fails or hangs past RANK_CHILD_S fails the run (both are killed).
    Returns each rank's JSON results."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    tag = f"{phase}_2proc"
    outs = [os.path.join(workdir, f"{tag}_rank{r}.json") for r in range(2)]
    logs = [open(os.path.join(workdir, f"{tag}_rank{r}.log"), "w+")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-child", str(r),
         "--child-phase", phase, "--port", str(port), "--seed", str(seed),
         "--workdir", workdir, "--json-out", outs[r]],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + RANK_CHILD_S
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[{tag}] rank {r} hung past "
                                     f"{RANK_CHILD_S} s") from None
        for r, p in enumerate(procs):
            if p.returncode != 0:
                logs[r].seek(0)
                raise AssertionError(f"[{tag}] rank {r} failed "
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
    return ranks


def check_wire_turns(ranks: list) -> None:
    """[ps_2proc wires]' checks across the ranks: every turn's final
    tables bitwise equal across the ranks, and, but for the compressed
    turns' other deltas, to the default world's on every wire; each rank
    launching all three kernels in every turn."""
    main = ranks[0]["digest"]
    for t0, t1 in zip(ranks[0]["wires"], ranks[1]["wires"]):
        turn = t0["turn"]
        if t0["digest"] != t1["digest"]:
            raise AssertionError(f"[ps_2proc wires] the ranks' final tables "
                                 f"differ on the {turn} turn")
        if turn != "compress" and t0["digest"] != main:
            raise AssertionError(f"[ps_2proc wires] the {turn} turn's "
                                 f"tables differ from the default world's")
        for t in (t0, t1):
            for k in ("gather_rows", "scatter_set_rows", "update_rows"):
                if t["launches"][k] == 0:
                    raise AssertionError(f"[ps_2proc wires] a rank never "
                                         f"launched {k} on the {turn} turn")
    digests = {t["digest"] for t in ranks[0]["wires"]
               if t["turn"] == "compress"}
    if len(digests) != 1:
        raise AssertionError("[ps_2proc wires] the compressed turns differ")


def shm_mount_line() -> str:
    """The size and free bytes of the shared-memory mount the shm wire's
    segments live in."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError as exc:
        return f"/dev/shm: not available ({exc})"
    return (f"/dev/shm: {st.f_blocks * st.f_frsize} bytes, "
            f"{st.f_bavail * st.f_frsize} free")


def report_wire_turns(ranks: list) -> None:
    """[ps_2proc wires]' lines: each turn's rounds, exchange seconds and
    share per rank; the medians per wire over its turns; the compressed
    wire ratio."""
    for r in ranks:
        for t in r["wires"]:
            share = t["exchange_s"] / t["round_s"]
            t["exchange_share"] = share
            extra = (f", wire ratio {t['wire_ratio']:.4f}"
                     if "wire_ratio" in t else "")
            log(f"[ps_2proc wires] rank {r['rank']} {t['turn']}: "
                f"{t['wire']}, {t['engine']}, channel rounds "
                f"{t['channel_rounds']}: add round median "
                f"{np.median(t['add_round_ms']):.3f} ms "
                f"{[round(x, 3) for x in t['add_round_ms']]}, momentum "
                f"round median {np.median(t['momentum_round_ms']):.3f} ms "
                f"{[round(x, 3) for x in t['momentum_round_ms']]}; exchange "
                f"{t['exchange_s']:.4f} s of the rounds' {t['round_s']:.4f}"
                f" s (share {share:.3f}){extra}; launches {t['launches']}")
        med = {}
        for turn in dict.fromkeys(WIRE_TURNS):
            ts = [t for t in r["wires"] if t["turn"] == turn]
            med[turn] = {
                "add_round_ms": float(np.median(
                    [x for t in ts for x in t["add_round_ms"]])),
                "momentum_round_ms": float(np.median(
                    [x for t in ts for x in t["momentum_round_ms"]])),
                "exchange_share": float(np.median(
                    [t["exchange_share"] for t in ts]))}
        r["wire_medians"] = med
        log(f"[ps_2proc wires] rank {r['rank']} medians per turn kind "
            f"(add round ms, momentum round ms, exchange share): "
            + "; ".join(f"{k} {v['add_round_ms']:.3f}, "
                        f"{v['momentum_round_ms']:.3f}, "
                        f"{v['exchange_share']:.3f}" for k, v in med.items()))
    log("[ps_2proc wires] every GetRows == the oracle of both ranks' Adds on "
        "every turn; the final tables bitwise equal across the ranks and "
        "across shm, gloo, sharded shm and tcp; the compressed tables "
        "bitwise their uncompressed twins; each rank launched all three "
        "kernels on every turn")


def ps_2proc_phase(seed: int, workdir: str) -> dict:
    """[ps_2proc]: both ranks (``rank_children``). Returns each rank's
    measurements and the launches summed over the ranks; each rank must
    launch all three kernels (in the default world and in every wire
    turn), and the ranks' final tables must be bitwise equal, on every
    wire."""
    ranks = rank_children("ps", seed, workdir)
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("[ps_2proc] the ranks' final tables differ")
    check_wire_turns(ranks)
    for t0, t1 in zip(ranks[0]["burst"], ranks[1]["burst"]):
        if t0["digest"] != t1["digest"]:
            raise AssertionError(f"[ps_2proc burst] the ranks' final tables "
                                 f"differ on the {t0['turn']} turn")
    for r in ranks:
        sv = r["serve"]
        if sv["versions"] != [sv["version"]] * 2 or sv["lookup_rounds"]:
            raise AssertionError(f"[ps_2proc] rank {r['rank']} serving: "
                                 f"versions {sv['versions']}, "
                                 f"{sv['lookup_rounds']} host collective "
                                 f"rounds on the lookup path")
        for k in ("gather_rows", "scatter_set_rows", "update_rows"):
            if r["ps_launches"][k] == 0:
                raise AssertionError(f"[ps_2proc] rank {r['rank']} never "
                                     f"launched {k}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    if len({t["digest"] for r in ranks for t in r["tele"]}) != 1:
        raise AssertionError("[ps_2proc telemetry] the tables differ across "
                             "the turns or the ranks")
    tele = {}
    for k in ("on", "off"):
        meds = [t["median_ms"] for r in ranks for t in r["tele"]
                if t["turn"] == k]
        tele[k] = {"median_ms": float(np.median(meds)),
                   "spread": spread(meds)}
    tele["on_over_off"] = tele["on"]["median_ms"] / tele["off"]["median_ms"]
    return {"ranks": ranks, "launches": launches, "tele": tele,
            "critpath": critpath_summary([r["flight_ps"] for r in ranks])}


def apply_batches(seed: int, rank: int) -> list:
    """[ps_2proc apply]'s traffic of ``rank``: per round, a (ids, integer
    deltas) batch of BURST_IDS ids for each of the four tables."""
    return [[ps2_batch(seed, 3000 + len(APPLY_KINDS) * r + j, rank,
                       BURST_IDS) for j in range(len(APPLY_KINDS))]
            for r in range(APPLY_ROUNDS)]


def apply_oracles(seed: int) -> dict:
    """The add and sgd tables after both ranks' [ps_2proc apply] traffic
    (the sgd table takes the deltas with the minus sign)."""
    out = {}
    for j, (name, _) in enumerate(APPLY_KINDS[:2]):
        table = np.zeros((PS_ROWS, PS_COLS), np.float32)
        for k in range(2):
            for batch in apply_batches(seed, k):
                ids, deltas = batch[j]
                table[ids] += deltas
        out[name] = table if name == "add" else -table
    return out


def ps2_apply_turn(torch, mv, cr, base: list, workers: int, rank: int,
                   seed: int, mine: list, oracle: dict,
                   flight_path: str) -> dict:
    """One [ps_2proc apply] turn: a world at ``-mv_apply_workers=workers``
    (``-mv_write_combine=0``: every push its own Add, so a window carries
    one round of the four tables), the add, sgd, momentum and AdaGrad
    tables at the PS shape; this rank's first APPLY_WARM rounds of
    fire-and-forget AddRows to each table in turn and a GetRows of one id
    a table, untimed; after a barrier, the other rounds, then a blocking
    GetRows of PS_IDS ids on every table (it waits for every Add before
    it). Returns the timed burst's seconds, the engine's apply seconds,
    pool and inline jobs, windows, the tables' digests and the turn's
    launches; the add and sgd tables must equal ``oracle``. The world's
    flight ring goes to ``flight_path`` (the parent runs critpath on
    it)."""
    import hashlib

    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.updaters.base import AddOption
    from multiverso_tpu_torch.zoo import Zoo
    opts = {"add": None, "sgd": None, "momentum": AddOption(momentum=0.5),
            "adagrad": AddOption(learning_rate=2.0, rho=0.25)}
    get_ids = ps2_batch(seed, 3999, rank)[0]
    l0 = dict(cr.LAUNCHES)
    since = time.time()
    mv.MV_Init(base + [f"-mv_apply_workers={workers}",
                       "-mv_write_combine=0"])
    try:
        tables = [mv.MV_CreateTable(MatrixTableOption(
            num_rows=PS_ROWS, num_cols=PS_COLS, updater_type=u))
            for _, u in APPLY_KINDS]
        eng = Zoo.Get().server_engine
        names = [n for n, _ in APPLY_KINDS]
        counters = ("apply_busy_s", "xw_busy_s", "mh_window_exchanges")
        pool = {"apply_pool_jobs": "engine.apply_pool.jobs",
                "apply_pool_inline": "engine.apply_pool.inline_jobs"}

        def push(batches):
            for batch in batches:
                for name, t, (ids, deltas) in zip(names, tables, batch):
                    t.AddFireForget(deltas, row_ids=ids, option=opts[name])

        push(mine[:APPLY_WARM])
        for t in tables:
            t.GetRows(get_ids[:1])
        mv.MV_Barrier()
        c0 = {c: getattr(eng, c) for c in counters}
        p0 = {k: counter(name) for k, name in pool.items()}
        t0 = time.perf_counter()
        push(mine[APPLY_WARM:])
        gets = [t.GetRows(get_ids) for t in tables]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = {"workers": workers, "wall_s": wall}
        res.update({c: getattr(eng, c) - c0[c] for c in counters})
        res.update({k: int(counter(name) - p0[k])
                    for k, name in pool.items()})
        res["pool_share"] = (res["apply_pool_inline"]
                             / max(1, res["mh_window_exchanges"]))
        res["digests"] = {}
        for name, t, got in zip(names, tables, gets):
            final = t.Get()
            if name in oracle:
                np.testing.assert_array_equal(
                    final, oracle[name], err_msg=f"[ps_2proc apply] {name}")
                np.testing.assert_array_equal(got, oracle[name][get_ids])
            elif not np.isfinite(final).all():
                raise AssertionError(f"[ps_2proc apply] {name}: not finite")
            res["digests"][name] = hashlib.sha256(final.tobytes()).hexdigest()
        torch.cuda.synchronize()
        res["flight"] = flight_slice(mv.MV_DumpFlightRecorder(flight_path),
                                     since)
    finally:
        mv.MV_ShutDown(finalize_net=False)
    res["launches"] = {k: cr.LAUNCHES[k] - l0[k] for k in l0}
    return res


def ps2_codec_turns(torch, mv, base: list, rank: int, seed: int) -> list:
    """[ps_2proc compress]: the add table at the PS shape, [ps_2proc]'s
    PS_ROUNDS rounds of AddRows + GetRows of the rank's PS_IDS ids, in a
    world a turn of CODEC_TURNS: the window codecs off, ``-mv_compress``
    alone (bitwise the first turn), and with every table lossy-opted
    (int8 window values: within the int8 bound of the first turn, summed
    over both ranks' Adds, max|row| / 254 an element of each row, and not
    equal to it). Returns each turn's round times, exchange seconds, the
    window bytes before and after the codecs (``compress.stats()``) and
    its table's digest; the first turn's table must equal the oracle."""
    import hashlib

    from multiverso_tpu_torch.parallel import compress
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.zoo import Zoo
    batches = [[ps2_batch(seed, r, k) for r in range(PS_ROUNDS)]
               for k in range(2)]
    _, oracle, _ = ps2_oracle(batches, 0.5)
    bound = np.zeros((PS_ROWS, PS_COLS), np.float32)
    for k in range(2):
        for ids, deltas in batches[k]:
            bound[ids] += np.abs(deltas).max(axis=1, keepdims=True) / 254
    turns = []
    for turn in CODEC_TURNS:
        flags = {"off": [], "lossless": ["-mv_compress=true"],
                 "lossy": ["-mv_compress=true",
                           "-mv_compress_lossy=all"]}[turn]
        mv.MV_Init(base + flags)
        try:
            table = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                        num_cols=PS_COLS))
            eng = Zoo.Get().server_engine
            compress.reset_stats()
            x0 = eng.xw_busy_s
            round_ms = []
            for ids, deltas in batches[rank]:
                t0 = time.perf_counter()
                table.AddRows(ids, deltas)
                table.GetRows(ids)
                round_ms.append((time.perf_counter() - t0) * 1e3)
            st = compress.stats()
            final = table.Get()
            res = {"turn": turn, "round_ms": round_ms,
                   "exchange_s": eng.xw_busy_s - x0,
                   "pre_bytes": st["compress.pre_bytes.window"],
                   "post_bytes": st["compress.post_bytes.window"],
                   "digest": hashlib.sha256(final.tobytes()).hexdigest()}
            torch.cuda.synchronize()
        finally:
            mv.MV_ShutDown(finalize_net=False)
        if turn == "off":
            np.testing.assert_array_equal(final, oracle)
        elif turn == "lossy":
            err = np.abs(final - oracle)
            res["max_err"] = float(err.max())
            res["max_err_over_bound"] = float(
                (err / np.maximum(bound, 1e-30)).max())
            if not (err <= bound * 1.0001).all() or err.max() == 0:
                raise AssertionError(f"[ps_2proc compress] lossy turn: "
                                     f"error {err.max()} against the int8 "
                                     f"bound")
        turns.append(res)
    return turns


def kv_keys(seed: int, rank: int) -> tuple:
    """[kv_2proc device]'s (keys, integer deltas) of ``rank``: half the
    KV_DEVICE_KEYS keys shared with the peer, half its own."""
    half = KV_DEVICE_KEYS // 2
    shared = np.random.default_rng([seed, 800]).integers(0, 1 << 40, half)
    own = np.random.default_rng([seed, 801, rank]).integers(0, 1 << 40, half)
    keys = np.concatenate([shared, own + ((rank + 1) << 41)]).astype(np.int64)
    deltas = np.random.default_rng([seed, 802, rank]).integers(
        -3, 4, KV_DEVICE_KEYS).astype(np.float32)
    return keys, deltas


def kv2_device(torch, mv, base: list, rank: int, seed: int) -> dict:
    """[kv_2proc device]: a KV table on the card; this rank resolves its
    KV_DEVICE_KEYS keys with ``device_slots(create=True)`` (collective:
    the union in rank order, one shared bucket), places the global batch
    with device deltas, scatter-adds it (the deterministic segment sums)
    and gathers it; a twin KV table takes the same deltas through the
    host Add. Both tables' values at both ranks' keys must be bitwise
    equal, and this rank's lanes of the gather its keys' values."""
    import hashlib

    from multiverso_tpu_torch.tables import KVTableOption
    dev = torch.device("cuda", 0)
    keys, deltas = kv_keys(seed, rank)
    n = len(keys)
    mv.MV_Init(base)
    try:
        kv = mv.MV_CreateTable(KVTableOption())
        twin = mv.MV_CreateTable(KVTableOption())
        srv = kv.server()
        if srv.device_values().device != dev:
            raise AssertionError("[kv_2proc device] the KV table is not on "
                                 "cuda:0")
        mv.MV_Barrier()
        res = {}
        t0 = time.perf_counter()
        slots = srv.device_slots(keys, create=True)
        res["slots_s"] = time.perf_counter() - t0
        b = len(slots)
        pad = torch.zeros(b, dtype=torch.float32, device=dev)
        pad[:n] = torch.from_numpy(deltas).to(dev)
        t0 = time.perf_counter()
        gslots, gdeltas = srv.device_place_slots(slots, pad)
        torch.cuda.synchronize()
        res["place_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.device_set_values(srv.device_scatter_add_slots(
            srv.device_values(), gslots, gdeltas))
        torch.cuda.synchronize()
        res["scatter_add_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gathered = srv.device_gather_slots(srv.device_values(), gslots)
        torch.cuda.synchronize()
        res["gather_s"] = time.perf_counter() - t0
        mine = gathered[rank * b: rank * b + n].cpu().numpy()
        t0 = time.perf_counter()
        twin.Add(keys, deltas)
        res["twin_add_s"] = time.perf_counter() - t0
        np.testing.assert_array_equal(mine, kv.Get(keys),
                                      err_msg="[kv_2proc device] own lanes")
        every = np.concatenate([kv_keys(seed, k)[0] for k in range(2)])
        values = kv.Get(every)
        np.testing.assert_array_equal(values, twin.Get(every),
                                      err_msg="[kv_2proc device] twin")
        res.update(bucket=b, keys=n, table_keys=srv.size,
                   capacity=srv.capacity,
                   digest=hashlib.sha256(values.tobytes()).hexdigest())
        torch.cuda.synchronize()
    finally:
        mv.MV_ShutDown(finalize_net=False)
    return res


def mh_2proc_rank(rank: int, port: int, seed: int, out: str) -> int:
    """One rank of [ps_2proc apply], [ps_2proc compress] and [kv_2proc
    device] (``--rank-child R --child-phase mh``), on ``cuda:0`` beside
    its peer, one world a turn on one process group; the launch counts
    zeroed before each phase and read after it."""
    import torch
    try:
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch.ops import cuda_rows as cr
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    base = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2"]
    res = {"rank": rank}
    mine = apply_batches(seed, rank)
    oracle = apply_oracles(seed)
    cr.reset_launches()
    res["apply"] = [ps2_apply_turn(
        torch, mv, cr, base, w, rank, seed, mine, oracle,
        os.path.join(os.path.dirname(out), f"flight_apply{i}_rank{rank}.jsonl"))
        for i, w in enumerate(APPLY_TURNS)]
    res["apply_launches"] = dict(cr.LAUNCHES)
    del mine, oracle
    cr.reset_launches()
    res["compress"] = ps2_codec_turns(torch, mv, base, rank, seed)
    res["compress_launches"] = dict(cr.LAUNCHES)
    cr.reset_launches()
    res["kv"] = kv2_device(torch, mv, base, rank, seed)
    res["kv_launches"] = dict(cr.LAUNCHES)
    torch.cuda.synchronize()
    if cr.read_error(dev) != 0:
        raise AssertionError("error word set on the two-process table paths")
    mv.MV_ShutDown()
    with open(out, "w") as f:
        json.dump(res, f)
    print(f"[mh_2proc rank {rank}] ok", flush=True)
    return 0


def mh_2proc_phase(seed: int, workdir: str) -> dict:
    """[ps_2proc apply], [ps_2proc compress] and [kv_2proc device]: both
    ranks (``rank_children``), then the checks across them: every table
    bitwise equal across the ranks and the apply turns, pool jobs only at
    more than one worker, the lossless codec turn bitwise the plain one,
    the KV values equal on both ranks; each rank launching the row gather,
    the scatter-set and the update on the apply turns, the gather and the
    update on the codec turns. Returns the ranks and each path's launches
    summed over them."""
    ranks = rank_children("mh", seed, workdir)
    first = ranks[0]["apply"][0]["digests"]
    for r in ranks:
        for t in r["apply"]:
            if t["digests"] != first:
                raise AssertionError(f"[ps_2proc apply] rank {r['rank']} at "
                                     f"{t['workers']} workers: tables differ "
                                     f"from rank 0's first turn")
            pooled = t["apply_pool_jobs"] > 0
            if pooled != (t["workers"] > 1):
                raise AssertionError(f"[ps_2proc apply] rank {r['rank']} at "
                                     f"{t['workers']} workers: "
                                     f"{t['apply_pool_jobs']} pool jobs")
        codec = {t["turn"]: t for t in r["compress"]}
        if codec["lossless"]["digest"] != codec["off"]["digest"]:
            raise AssertionError("[ps_2proc compress] -mv_compress alone "
                                 "changed the table")
        if codec["lossless"]["pre_bytes"] or not codec["lossy"]["pre_bytes"]:
            raise AssertionError("[ps_2proc compress] the lossy codec ran "
                                 "on the wrong turn")
        for k, needs in (("apply_launches", ("gather_rows",
                                             "scatter_set_rows",
                                             "update_rows")),
                         ("compress_launches", ("gather_rows",
                                                "update_rows"))):
            for kern in needs:
                if r[k][kern] == 0:
                    raise AssertionError(f"{k}: rank {r['rank']} never "
                                         f"launched {kern}")
    for turn in range(len(CODEC_TURNS)):
        if len({r["compress"][turn]["digest"] for r in ranks}) != 1:
            raise AssertionError(f"[ps_2proc compress] the ranks differ on "
                                 f"the {CODEC_TURNS[turn]} turn")
    if ranks[0]["kv"]["digest"] != ranks[1]["kv"]["digest"]:
        raise AssertionError("[kv_2proc device] the ranks' values differ")
    launches = {path: {k: sum(r[f"{key}_launches"][k] for r in ranks)
                       for k in ranks[0][f"{key}_launches"]}
                for path, key in (("ps_2proc_apply", "apply"),
                                  ("ps_2proc_compress", "compress"),
                                  ("kv_2proc_device", "kv"))}
    critpaths = [dict(critpath_summary([r["apply"][i]["flight"]
                                        for r in ranks]), workers=w)
                 for i, w in enumerate(APPLY_TURNS)]
    return {"ranks": ranks, "launches": launches,
            "apply_critpath": critpaths}


def report_mh_2proc(mh: dict, card: str) -> None:
    """The lines of [ps_2proc apply], [ps_2proc compress] and [kv_2proc
    device], each naming the card."""
    for r in mh["ranks"]:
        for t in r["apply"]:
            log(f"[ps_2proc apply] rank {r['rank']} -mv_apply_workers="
                f"{t['workers']}: {APPLY_ROUNDS - APPLY_WARM} timed rounds x "
                f"4 tables of {BURST_IDS}-id fire-and-forget AddRows + 4 "
                f"GetRows of {PS_IDS} ids in {t['wall_s']:.4f} s; the "
                f"engine's apply "
                f"{t['apply_busy_s']:.4f} s, exchange {t['xw_busy_s']:.4f} "
                f"s; {t['mh_window_exchanges']} windows, "
                f"{t['apply_pool_inline']} took the pool (share "
                f"{t['pool_share']:.3f}) with {t['apply_pool_jobs']} pool "
                f"jobs + {t['apply_pool_inline']} inline; launches "
                f"{t['launches']} ({card})")
        for w in sorted(set(APPLY_TURNS)):
            walls = [t["wall_s"] for t in r["apply"] if t["workers"] == w]
            apply_s = [t["apply_busy_s"] for t in r["apply"]
                       if t["workers"] == w]
            log(f"[ps_2proc apply] rank {r['rank']} -mv_apply_workers={w}: "
                f"median burst {np.median(walls):.4f} s, median apply "
                f"{np.median(apply_s):.4f} s ({card})")
        for t in r["compress"]:
            ratio = (f", window bytes {t['pre_bytes']} -> {t['post_bytes']}"
                     f" (ratio {t['post_bytes'] / t['pre_bytes']:.4f})"
                     if t["pre_bytes"] else "")
            err = (f", max error {t['max_err']:.6g} = "
                   f"{t['max_err_over_bound']:.4f} of the int8 bound"
                   if "max_err" in t else "")
            log(f"[ps_2proc compress] rank {r['rank']} {t['turn']}: round "
                f"median {np.median(t['round_ms']):.3f} ms "
                f"{[round(x, 3) for x in t['round_ms']]}, exchange "
                f"{t['exchange_s']:.4f} s{ratio}{err} ({card})")
        kv = r["kv"]
        log(f"[kv_2proc device] rank {r['rank']}: {kv['keys']} keys a rank "
            f"(half shared), {kv['table_keys']} in the table (capacity "
            f"{kv['capacity']}), bucket {kv['bucket']}: device_slots "
            f"{kv['slots_s']:.4f} s, device_place_slots "
            f"{kv['place_s']:.4f} s, scatter-add {kv['scatter_add_s']:.4f} "
            f"s, gather {kv['gather_s']:.4f} s; the twin's host Add "
            f"{kv['twin_add_s']:.4f} s ({card})")
    for i, c in enumerate(mh["apply_critpath"]):
        log(critpath_line(f"[ps_2proc apply] turn {i} -mv_apply_workers="
                          f"{c['workers']}", c, card))
    log("[ps_2proc apply] every table bitwise equal across the ranks and "
        "the turns; add and sgd == the oracle; pool jobs only at 4 workers")
    log("[ps_2proc compress] -mv_compress alone bitwise the plain turn; the "
        "lossy turn bitwise equal across the ranks, inside the int8 bound")
    log("[kv_2proc device] values bitwise equal across the ranks and to the "
        "twin's host Adds; each rank's lanes of the global gather == its "
        "keys' values")


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


# -- [ps_combine], [ps_get_cache]: the worker-side fast paths -------------------

def combine_batches(seed: int) -> list:
    """[ps_combine]'s burst: BURST_VERBS (ids, integer deltas) of BURST_IDS
    unique random rows each."""
    g = np.random.default_rng([seed, 1100])
    return [(g.choice(PS_ROWS, BURST_IDS, replace=False).astype(np.int32),
             g.integers(-3, 4, (BURST_IDS, PS_COLS)).astype(np.float32))
            for _ in range(BURST_VERBS)]


def combine_turn(torch, mv, turn: str, batches, get_ids, argv=()) -> dict:
    """One world: every batch pushed fire-and-forget to the add and the
    momentum table (momentum 0.5) by one worker, then ``DrainServer`` and
    one GetRows of ``get_ids`` a table; ``turn`` "plain" runs at
    -mv_write_combine=0. Returns the burst's host seconds (drain and the
    card's queue included), the Add messages the engine received, the
    combine hits, the Gets and the whole momentum table."""
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.updaters.base import AddOption
    from multiverso_tpu_torch.zoo import Zoo
    mv.MV_Init(list(argv) + ([] if turn == "combined"
                             else ["-mv_write_combine=0"]))
    try:
        add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                  num_cols=PS_COLS))
        mom = mv.MV_CreateTable(MatrixTableOption(
            num_rows=PS_ROWS, num_cols=PS_COLS, updater_type="momentum"))
        on_card = add.server().state["data"].device.type == "cuda"
        eng = Zoo.Get().server_engine
        mopt = AddOption(momentum=0.5)
        m0 = eng.add_messages
        h0 = counter("worker.write_combine_hits")
        t0 = time.perf_counter()
        for ids, deltas in batches:
            add.AddFireForget(deltas, row_ids=ids)
            mom.AddFireForget(deltas, row_ids=ids, option=mopt)
        Zoo.Get().DrainServer()
        if on_card:
            torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
        return {"turn": turn, "burst_s": burst_s,
                "add_messages": eng.add_messages - m0,
                "combine_hits": counter("worker.write_combine_hits") - h0,
                "add_rows": add.GetRows(get_ids),
                "mom_rows": mom.GetRows(get_ids), "mom": mom.Get()}
    finally:
        mv.MV_ShutDown()


def warm_index_add(torch, dev) -> None:
    """One small ``index_add_`` of 2-D float rows on the card: the engine's
    merged run of a window's Adds (``ProcessAddRun``) sums with it, and
    CUDA loads its module at the first call (~0.3 s), which would land in
    whichever burst merges first."""
    torch.zeros((4, PS_COLS + 2), device=dev).index_add_(
        0, torch.zeros(2, dtype=torch.long, device=dev),
        torch.ones((2, PS_COLS + 2), device=dev))
    torch.cuda.synchronize()


def ps_combine_phase(torch, mv, cr, dev, seed: int) -> dict:
    """[ps_combine]: the burst in COMBINE_TURNS on the card. The add table
    must equal the oracle bitwise in every turn; the engine must receive
    ceil(BURST_VERBS / COMBINE_CAP) Add messages a table in a combined turn
    and BURST_VERBS in a plain one; the momentum table must be bitwise
    equal across the combined turns, and within rtol 1e-5, atol 1e-6 of
    the same combined burst in a world on the CPU (a combined Add applies
    the momentum step once for its members' summed deltas, so the plain
    turns' momentum table is another, equally valid, result)."""
    batches = combine_batches(seed)
    oracle = np.zeros((PS_ROWS, PS_COLS), np.float32)
    for ids, deltas in batches:
        oracle[ids] += deltas
    get_ids = np.random.default_rng([seed, 1101]).choice(
        PS_ROWS, PS_IDS, replace=False).astype(np.int32)
    warm_index_add(torch, dev)
    turns = []
    for turn in COMBINE_TURNS:
        r = combine_turn(torch, mv, turn, batches, get_ids)
        np.testing.assert_array_equal(r.pop("add_rows"), oracle[get_ids],
                                      err_msg=f"[ps_combine] {turn} turn")
        want = 2 * (-(-BURST_VERBS // COMBINE_CAP) if turn == "combined"
                    else BURST_VERBS)
        if r["add_messages"] != want:
            raise AssertionError(f"[ps_combine] {turn} turn: the engine "
                                 f"received {r['add_messages']} Add "
                                 f"messages, not {want}")
        turns.append(r)
    comb = [t for t in turns if t["turn"] == "combined"]
    if not np.array_equal(comb[0]["mom"], comb[1]["mom"]):
        raise AssertionError("[ps_combine] the momentum table differs "
                             "between the two combined turns")
    # the combined burst with telemetry at its defaults and off, in turns:
    # the same tables either way
    tele = []
    for turn in COMBINE_TELE_TURNS:
        r = combine_turn(torch, mv, "combined", batches, get_ids,
                         tele_argv(turn))
        np.testing.assert_array_equal(r["add_rows"], oracle[get_ids],
                                      err_msg=f"[ps_combine] telemetry "
                                              f"{turn}")
        if not np.array_equal(r["mom"], comb[0]["mom"]):
            raise AssertionError(f"[ps_combine] telemetry {turn}: the "
                                 f"momentum table differs")
        tele.append({"turn": turn, "burst_s": r["burst_s"]})
    tmed = {k: [t["burst_s"] for t in tele if t["turn"] == k]
            for k in ("on", "off")}
    cpu = combine_turn(torch, mv, "combined", batches, get_ids,
                       ["-mv_device=cpu"])
    np.testing.assert_allclose(comb[0]["mom"], cpu["mom"], rtol=1e-5,
                               atol=1e-6, err_msg="[ps_combine] momentum "
                                                  "card vs CPU")
    mom_diff = float(np.abs(comb[0]["mom"] - cpu["mom"]).max())
    torch.cuda.synchronize()
    if cr.read_error(dev) != 0:
        raise AssertionError("error word set on the combined PS path")
    for t in turns:
        del t["mom"], t["mom_rows"]
    return {"turns": turns, "momentum_card_vs_cpu_max_abs": mom_diff,
            "cpu_add_messages": cpu["add_messages"], "tele_turns": tele,
            "tele_on_median_s": float(np.median(tmed["on"])),
            "tele_off_median_s": float(np.median(tmed["off"])),
            "tele_on_spread": spread(tmed["on"]),
            "tele_off_spread": spread(tmed["off"])}


def ps_get_cache_phase(torch, mv, cr, dev, seed: int) -> dict:
    """[ps_get_cache]: -mv_get_staleness=CACHE_STALENESS on the card, the add
    table after a few blocking AddRows: CACHE_GETS identical GetRows of
    PS_IDS ids with no Add between. The first misses and launches the row
    gather; every later one is a hit, bitwise the miss, launching nothing.
    After the worker's own AddRows the next GetRows misses and equals the
    oracle. Each Get's host seconds."""
    from multiverso_tpu_torch.tables import MatrixTableOption
    g = np.random.default_rng([seed, 1102])
    get_ids = g.choice(PS_ROWS, PS_IDS, replace=False).astype(np.int32)
    oracle = np.zeros((PS_ROWS, PS_COLS), np.float32)
    mv.MV_Init([f"-mv_get_staleness={CACHE_STALENESS}"])
    try:
        add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                  num_cols=PS_COLS))
        for _ in range(3):
            ids = g.choice(PS_ROWS, PS_IDS, replace=False).astype(np.int32)
            deltas = g.integers(-3, 4, (PS_IDS, PS_COLS)).astype(np.float32)
            add.AddRows(ids, deltas)
            oracle[ids] += deltas
        gets = []
        for _ in range(CACHE_GETS):
            h0 = counter("worker.get_cache_hits")
            k0 = cr.LAUNCHES["gather_rows"]
            t0 = time.perf_counter()
            rows = add.GetRows(get_ids)
            gets.append({"s": time.perf_counter() - t0,
                         "hit": counter("worker.get_cache_hits") - h0,
                         "gathers": cr.LAUNCHES["gather_rows"] - k0,
                         "rows": rows})
        first = gets[0]
        if first["hit"] or not first["gathers"]:
            raise AssertionError(f"[ps_get_cache] the first GetRows: hit "
                                 f"{first['hit']}, gathers {first['gathers']}")
        np.testing.assert_array_equal(first["rows"], oracle[get_ids])
        for i, gt in enumerate(gets[1:], 1):
            if gt["hit"] != 1 or gt["gathers"]:
                raise AssertionError(f"[ps_get_cache] GetRows {i}: hit "
                                     f"{gt['hit']}, gathers {gt['gathers']}")
            np.testing.assert_array_equal(gt["rows"], first["rows"])
        deltas = g.integers(-3, 4, (PS_IDS, PS_COLS)).astype(np.float32)
        add.AddRows(get_ids, deltas)
        oracle[get_ids] += deltas
        h0, k0 = counter("worker.get_cache_hits"), cr.LAUNCHES["gather_rows"]
        t0 = time.perf_counter()
        after = add.GetRows(get_ids)
        after_s = time.perf_counter() - t0
        if counter("worker.get_cache_hits") != h0 or \
                cr.LAUNCHES["gather_rows"] == k0:
            raise AssertionError("[ps_get_cache] the GetRows after the "
                                 "worker's own Add did not miss")
        np.testing.assert_array_equal(after, oracle[get_ids])
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError("error word set on the Get cache path")
    finally:
        mv.MV_ShutDown()
    # what a hit's copy of the cached rows costs alone: into a new array
    # each time (as a hit does, the copies kept alive as the Gets' results
    # were) and into one reused buffer
    fresh, reused, kept = [], [], []
    buf = np.empty_like(first["rows"])
    for _ in range(CACHE_GETS - 1):
        t0 = time.perf_counter()
        kept.append(first["rows"].copy())
        fresh.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.copyto(buf, first["rows"])
        reused.append(time.perf_counter() - t0)
    return {"miss_s": first["s"], "hit_s": [gt["s"] for gt in gets[1:]],
            "copy_new_median_s": float(np.median(fresh)),
            "copy_reused_median_s": float(np.median(reused)),
            "hit_median_s": float(np.median([gt["s"] for gt in gets[1:]])),
            "after_add_miss_s": after_s,
            "hits": sum(gt["hit"] for gt in gets)}


def time_combined_add(torch, cr, dev, batches, seed: int) -> dict:
    """<kAdd> at the combined Add's shape: each group of COMBINE_CAP
    consecutive batches of the burst concatenated, duplicates pre-combined
    (the unique ids and their summed deltas, as the server's duplicate-row
    pre-combine hands them to the update), on the 1,000,001 x 52 storage.
    Bitwise against its plain version on every group, then timed as phase
    2 times it, beside the byte bound of this data and ``index_add_``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    cols = PS_COLS + 2
    data = torch.randn(PS_ROWS + 1, cols, generator=g).to(dev)
    sets = []
    for i in range(0, len(batches), COMBINE_CAP):
        grp = batches[i:i + COMBINE_CAP]
        uniq, inv = np.unique(np.concatenate([b[0] for b in grp]),
                              return_inverse=True)
        summed = np.zeros((len(uniq), cols), np.float32)
        np.add.at(summed, inv, np.pad(np.concatenate([b[1] for b in grp]),
                                      ((0, 0), (0, cols - PS_COLS))))
        sets.append((torch.from_numpy(uniq.astype(np.int32)).to(dev),
                     torch.from_numpy(summed).to(dev)))
    ids64 = [s[0].long() for s in sets]
    a, b = data.clone(), data.clone()
    for ids, src in sets:
        cr.update_rows(a, ids, src, 1)
        cr.update_rows_plain(b, ids, src, 1)
    if not torch.equal(a[:PS_ROWS], b[:PS_ROWS]):
        raise AssertionError("<kAdd> at the combined shape != its plain "
                             "version")
    err = float((a[:PS_ROWS] - b[:PS_ROWS]).abs().max())
    n = [int(s[0].shape[0]) for s in sets]
    res = {"ms": median_ms(torch, lambda i: cr.update_rows(
               a, sets[i][0], sets[i][1], 1), len(sets)),
           "stream_ms": stream_ms(torch, lambda i: cr.update_rows(
               a, sets[i][0], sets[i][1], 1), len(sets)),
           "plain_ms": median_ms(torch, lambda i: cr.update_rows_plain(
               b, sets[i][0], sets[i][1], 1), len(sets)),
           "library_ms": median_ms(torch, lambda i: b.index_add_(
               0, ids64[i], sets[i][1]), len(sets)),
           "bound_ms": float(np.mean([3 * k * cols * 4 + 4 * k for k in n]))
           / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err, "shape": [PS_ROWS + 1, cols,
                                         float(np.mean(n))]}
    torch.cuda.synchronize()
    if cr.read_error(dev) != 0:
        raise AssertionError("error word set at the combined shape")
    return res


# -- [binding]: the reference binding and the C ABI on the card ------------------

def binding_phase(torch, mv, cr, dev, seed: int) -> dict:
    """The Python handlers on the card: a MatrixTableHandler of PS_ROWS x
    PS_COLS and an ArrayTableHandler of PS_ROWS, each with an integer init
    value, BINDING_ROUNDS rounds of BINDING_ADDS async adds (rows of PS_IDS
    random ids; whole vectors) and one get, each get equal to the oracle;
    then a TorchParamManager over an nn.Module on the card in each of 2
    worker threads sharing one table, the delta trick: the server and both
    workers' models end at the base plus both deltas."""
    import multiverso_tpu_torch.binding as b
    from multiverso_tpu_torch.binding.param_manager import TorchParamManager
    g = np.random.default_rng([seed, 1200])
    oracle_m = g.integers(-4, 5, (PS_ROWS, PS_COLS)).astype(np.float32)
    oracle_a = g.integers(-4, 5, PS_ROWS).astype(np.float32)
    h0 = counter("worker.write_combine_hits")
    b.init()
    try:
        mat = b.MatrixTableHandler(PS_ROWS, PS_COLS, init_value=oracle_m)
        arr = b.ArrayTableHandler(PS_ROWS, init_value=oracle_a)
        if mat._table.server().state["data"].device != dev:
            raise AssertionError("[binding] the handlers' tables are not on "
                                 "the card")
        round_s = []
        for _ in range(BINDING_ROUNDS):
            ids = g.choice(PS_ROWS, PS_IDS, replace=False).astype(np.int32)
            deltas = [g.integers(-3, 4, (PS_IDS, PS_COLS)).astype(np.float32)
                      for _ in range(BINDING_ADDS)]
            t0 = time.perf_counter()
            for d in deltas:
                mat.add(d, row_ids=ids, sync=False)
            got = mat.get(ids)
            round_s.append(time.perf_counter() - t0)
            for d in deltas:
                oracle_m[ids] += d
            np.testing.assert_array_equal(got, oracle_m[ids],
                                          err_msg="[binding] matrix rows")
            for _ in range(BINDING_ADDS):
                v = g.integers(-3, 4, PS_ROWS).astype(np.float32)
                arr.add(v, sync=False)
                oracle_a += v
            np.testing.assert_array_equal(arr.get(), oracle_a,
                                          err_msg="[binding] array")
        # the matrix handler's (the array table does not combine)
        hits = counter("worker.write_combine_hits") - h0
    finally:
        b.shutdown()
    w = BINDING_WIDTH
    weight = g.integers(-4, 5, (w, w)).astype(np.float32)
    bias = g.integers(-4, 5, w).astype(np.float32)
    base = np.concatenate([weight.ravel(), bias])
    merged = {}
    b.init(args=["-num_workers=2"])
    try:
        shared = b.ArrayTableHandler(base.size, init_value=base)

        def worker(wid):
            with mv.MV_WorkerContext(wid):
                model = torch.nn.Linear(w, w).to(dev)
                with torch.no_grad():
                    model.weight.copy_(torch.from_numpy(weight))
                    model.bias.copy_(torch.from_numpy(bias))
                mgr = TorchParamManager(model, table=shared)
                with torch.no_grad():
                    model.weight += float(wid + 1)      # local training
                mgr.sync_all_param()
                b.barrier()                            # both pushes landed
                mgr.sync_all_param()
                if model.weight.device != dev:
                    raise AssertionError("[binding] the model left the card")
                merged[wid] = torch.cat([model.weight.reshape(-1),
                                         model.bias]).detach().cpu().numpy()

        run_threads(worker, 2)
        server = shared.get()
    finally:
        b.shutdown()
    want = base.copy()
    want[: weight.size] += 3.0
    for name, got in (("server", server), ("worker 0", merged[0]),
                      ("worker 1", merged[1])):
        np.testing.assert_array_equal(got, want, err_msg=f"[binding] param "
                                                         f"manager {name}")
    return {"round_s": round_s, "round_median_s": float(np.median(round_s)),
            "combine_hits": hits, "param_manager_floats": int(base.size)}


def c_abi_phase(torch, cr, dev, seed: int) -> dict:
    """The C ABI on the card: the port's bridge installed into the port's
    build of the native library, ``MV_Init`` through ctypes (the bridge
    brings the world up on the card), ``MV_NewMatrixTable(PS_ROWS,
    PS_COLS)``, BINDING_ROUNDS rounds of BINDING_ADDS
    ``MV_AddAsyncMatrixTableByRows`` of PS_IDS random ids and one
    ``MV_GetMatrixTableByRows``, each equal to the oracle."""
    import ctypes

    from multiverso_tpu_torch import native
    from multiverso_tpu_torch.binding import native_bridge
    lib = native.lib()
    if lib is None:
        raise AssertionError(f"[binding] no native library: "
                             f"{native.last_build_error}")
    g = np.random.default_rng([seed, 1201])
    fptr, iptr = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    oracle = np.zeros((PS_ROWS, PS_COLS), np.float32)
    h0 = counter("worker.write_combine_hits")
    bridge = native_bridge.install(lib)
    argc = ctypes.c_int(1)
    lib.MV_Init(ctypes.byref(argc), (ctypes.c_char_p * 1)(b"chip_smoke"))
    try:
        handle = ctypes.c_void_p()
        lib.MV_NewMatrixTable(PS_ROWS, PS_COLS, ctypes.byref(handle))
        entry = bridge._tables[0]
        if entry.server.state["data"].device != dev:
            raise AssertionError("[binding] the C ABI's table is not on the "
                                 "card")
        round_s = []
        out = np.zeros((PS_IDS, PS_COLS), np.float32)
        for _ in range(BINDING_ROUNDS):
            ids = g.choice(PS_ROWS, PS_IDS, replace=False).astype(np.int32)
            deltas = [g.integers(-3, 4, (PS_IDS, PS_COLS)).astype(np.float32)
                      for _ in range(BINDING_ADDS)]
            t0 = time.perf_counter()
            for d in deltas:
                lib.MV_AddAsyncMatrixTableByRows(
                    handle, d.ctypes.data_as(fptr), d.size,
                    ids.ctypes.data_as(iptr), PS_IDS)
            lib.MV_GetMatrixTableByRows(handle, out.ctypes.data_as(fptr),
                                        out.size, ids.ctypes.data_as(iptr),
                                        PS_IDS)
            round_s.append(time.perf_counter() - t0)
            for d in deltas:
                oracle[ids] += d
            np.testing.assert_array_equal(out, oracle[ids],
                                          err_msg="[binding] C ABI rows")
        hits = counter("worker.write_combine_hits") - h0
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError("error word set on the C ABI path")
    finally:
        lib.MV_ShutDown()
        bridge.uninstall()
    return {"round_s": round_s, "round_median_s": float(np.median(round_s)),
            "combine_hits": hits}


# -- [serve]: the serving plane beside a trainer --------------------------------

def zipf_cdf(rows: int) -> np.ndarray:
    """The CDF of Zipf(s=1.0) over ``rows`` ranks (rank k drawn with weight
    1/(k+1)): a word-frequency skew, row 0 the most frequent word, as in a
    WordEmbedding vocabulary sorted by count."""
    cdf = np.cumsum(1.0 / np.arange(1, rows + 1, dtype=np.float64))
    return cdf / cdf[-1]


def zipf_ids(cdf: np.ndarray, g, n: int) -> np.ndarray:
    return np.minimum(np.searchsorted(cdf, g.random(n), side="right"),
                      len(cdf) - 1).astype(np.int64)


def serve_batches(seed: int, n: int) -> list:
    """The trainer's AddRows batches: SERVE_IDS unique random rows and
    small normal deltas (AdaGrad takes real-valued gradients)."""
    g = np.random.default_rng([seed, 900])
    return [(g.choice(SERVE_ROWS, SERVE_IDS, replace=False).astype(np.int32),
             (g.standard_normal((SERVE_IDS, SERVE_COLS)) * 0.01).astype(
                 np.float32)) for _ in range(n)]


def serve_traffic(mv, tables, batches, cdf, wall_s: float, seed: int,
                  check_residence) -> dict:
    """One trainer thread pushes ``batches`` in turn to both tables and
    publishes every SERVE_PUBLISH_EVERY of them while SERVE_CLIENTS client
    threads each look up SERVE_LOOKUP_IDS Zipf ids, alternating the
    tables, on the latest version for ``wall_s`` seconds. Every served
    block must be finite and of its shape; ``check_residence(v)`` holds
    each published version's residences."""
    stop = threading.Event()
    pub_ms, trained, errors = [], [0], []

    def trainer():
        try:
            i = 0
            while not stop.is_set():
                ids, deltas = batches[i % len(batches)]
                for t in tables:
                    t.AddRows(ids, deltas)
                i += 1
                trained[0] = i
                if i % SERVE_PUBLISH_EVERY == 0:
                    t0 = time.perf_counter()
                    v = mv.MV_PublishSnapshot()
                    pub_ms.append((time.perf_counter() - t0) * 1e3)
                    check_residence(v)
        except BaseException as exc:         # re-raised below
            errors.append(exc)

    lat = [[] for _ in range(SERVE_CLIENTS)]
    t_end = time.perf_counter() + wall_s

    def client(c):
        g = np.random.default_rng([seed, 910, c])
        k = 0
        while time.perf_counter() < t_end:
            table = tables[k % len(tables)]
            ids = zipf_ids(cdf, g, SERVE_LOOKUP_IDS)
            t0 = time.perf_counter()
            got = mv.MV_ServingLookup(table, ids)
            lat[c].append(time.perf_counter() - t0)
            if got.shape != (SERVE_LOOKUP_IDS, SERVE_COLS) or \
                    not np.isfinite(got).all():
                raise AssertionError(f"client {c}: a served block of shape "
                                     f"{got.shape}, finite "
                                     f"{np.isfinite(got).all()}")
            k += 1

    th = threading.Thread(target=trainer)
    t0 = time.perf_counter()
    th.start()
    try:
        run_threads(client, SERVE_CLIENTS)
    finally:
        stop.set()
        th.join(JOIN_S)
    wall = time.perf_counter() - t0
    if th.is_alive():
        raise AssertionError(f"[serve] the trainer hung past {JOIN_S} s")
    if errors:
        raise errors[0]
    flat = np.concatenate([np.asarray(x) for x in lat])
    return {"wall_s": wall, "lookups": int(flat.size),
            "lookups_per_s": flat.size / wall,
            "client_p50_ms": float(np.percentile(flat, 50)) * 1e3,
            "client_p99_ms": float(np.percentile(flat, 99)) * 1e3,
            "train_batches": trained[0], "publishes": len(pub_ms),
            "publish_median_ms": (float(np.median(pub_ms)) if pub_ms
                                  else 0.0)}


def device_idle(torch, fn) -> tuple:
    """``fn()`` under torch.profiler (CUDA activity): (its result, the
    device-busy seconds: the summed spans of the device-side events on the
    one stream, the wall seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return out, busy_us / 1e6, wall


def serve_phase(torch, mv, cr, dev, seed: int) -> dict:
    """[serve]: MV_Init on the card, an sgd and an AdaGrad MatrixTable at
    SERVE_ROWS x SERVE_COLS. Memory through retention (3 publishes, one
    pinned: three device copies; unpin: two), each table's residence
    (sgd device, AdaGrad host, on every published version), the publish
    times; the traffic (``serve_traffic``) for SERVE_WALL_S and again
    for SERVE_IDLE_S under the profiler (device idle); then, quiesced,
    served rows against the training GetRows at one cut (sgd bitwise,
    AdaGrad rtol / atol 1e-6), the device-resident lookups' ``<kGather>``
    launches, and a pinned version's rows bitwise after SERVE_PIN_ADDS
    more Add batches and two publishes."""
    from multiverso_tpu_torch.serving import get_plane
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.zoo import Zoo
    cdf = zipf_cdf(SERVE_ROWS)
    batches = serve_batches(seed, SERVE_PUBLISH_EVERY)
    res = {}
    mv.MV_Init([])
    try:
        sgd = mv.MV_CreateTable(MatrixTableOption(
            num_rows=SERVE_ROWS, num_cols=SERVE_COLS, updater_type="sgd"))
        ada = mv.MV_CreateTable(MatrixTableOption(
            num_rows=SERVE_ROWS, num_cols=SERVE_COLS,
            updater_type="adagrad"))
        tables = (sgd, ada)
        storage = sgd.server().state["data"]
        if storage.device != dev or ada.server().state["data"].device != dev:
            raise AssertionError("the [serve] tables are not on the card")
        plane = get_plane()
        store = plane.store
        copy_bytes = storage.numel() * storage.element_size()

        def check_residence(v):
            snap = store.get(v)
            got = (snap.tables[sgd.table_id].residence,
                   snap.tables[ada.table_id].residence)
            if got != ("device", "host"):
                raise AssertionError(f"[serve] version {v}: residences "
                                     f"{got}, not (device, host)")

        # memory through retention: -mv_serving_keep 2 plus a pin
        torch.cuda.synchronize()
        mem = [torch.cuda.memory_allocated(dev)]
        v1 = mv.MV_PublishSnapshot()
        mv.MV_PinVersion(v1)
        for _ in range(2):
            check_residence(mv.MV_PublishSnapshot())
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated(dev))
        live_pinned = store.live_versions()
        mv.MV_UnpinVersion(v1)
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated(dev))
        live_after = store.live_versions()
        for k, n in ((1, 3), (2, 2)):
            grown = mem[k] - mem[0]
            if not n * copy_bytes <= grown <= n * (copy_bytes + (2 << 20)):
                raise AssertionError(f"[serve] memory: {grown} bytes over "
                                     f"the tables, not {n} copies of "
                                     f"{copy_bytes}")
        if live_pinned != [1, 2, 3] or live_after != [2, 3]:
            raise AssertionError(f"[serve] live versions {live_pinned} "
                                 f"pinned, {live_after} after the unpin")
        res.update(memory_bytes=mem, copy_bytes=copy_bytes,
                   live_pinned=live_pinned, live_after=live_after)

        # publish times: each table's export on the engine thread (host
        # clock; the device export only enqueues its clone), the clone on
        # the card (CUDA events), a publish waited for
        exports = {"device": [], "host": []}
        clone_ms, publish_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            v = mv.MV_PublishSnapshot()
            torch.cuda.synchronize()
            publish_ms.append((time.perf_counter() - t0) * 1e3)
            snap = store.get(v)
            exports["device"].append(snap.export_s[sgd.table_id] * 1e3)
            exports["host"].append(snap.export_s[ada.table_id] * 1e3)
            del snap
            start, end = _event(torch), _event(torch)
            start.record()
            c = storage.clone()
            end.record()
            torch.cuda.synchronize()
            clone_ms.append(start.elapsed_time(end))
            del c
        res.update(export_device_ms=float(np.median(exports["device"])),
                   export_host_ms=float(np.median(exports["host"])),
                   clone_ms=float(np.median(clone_ms)),
                   publish_synced_ms=float(np.median(publish_ms)))

        # the traffic, then a window of it under the profiler
        from multiverso_tpu_torch.telemetry import metrics
        s0 = metrics.snapshot()
        traffic = serve_traffic(mv, tables, batches, cdf,
                                SERVE_WALL_S, seed, check_residence)
        traffic["frontend"] = serving_stats(s0, metrics.snapshot())
        res["traffic"] = traffic
        _, busy, wall = device_idle(torch, lambda: serve_traffic(
            mv, tables, batches, cdf, SERVE_IDLE_S, seed + 1,
            check_residence))
        res.update(idle_busy_s=busy, idle_wall_s=wall,
                   idle_share=1.0 - busy / wall)

        # quiesced: served rows against the training Get at one cut
        Zoo.Get().DrainServer()
        g = np.random.default_rng([seed, 920])
        ids = np.unique(np.concatenate([
            zipf_ids(cdf, g, 4096),
            g.choice(SERVE_ROWS, 4096, replace=False)])).astype(np.int32)
        train = [t.GetRows(ids) for t in tables]
        v = mv.MV_PublishSnapshot()
        ts = store.get(v).tables[sgd.table_id]
        l0, d0 = cr.LAUNCHES["gather_rows"], ts.dispatches
        served = [mv.MV_ServingLookup(t, ids, version=v) for t in tables]
        for _ in range(7):
            mv.MV_ServingLookup(sgd, zipf_ids(cdf, g, SERVE_LOOKUP_IDS),
                                version=v)
        gathers = cr.LAUNCHES["gather_rows"] - l0
        if gathers != ts.dispatches - d0 or gathers != 8:
            raise AssertionError(f"[serve] {gathers} <kGather> launches for "
                                 f"{ts.dispatches - d0} device-resident "
                                 f"reads (8 lookups)")
        del ts
        np.testing.assert_array_equal(served[0], train[0],
                                      err_msg="[serve] sgd served != Get")
        np.testing.assert_allclose(served[1], train[1], rtol=1e-6,
                                   atol=1e-6,
                                   err_msg="[serve] AdaGrad served != Get")
        res.update(cut_ids=int(ids.size), device_gathers=gathers,
                   ada_bitwise=bool(np.array_equal(served[1], train[1])))

        # a pinned version past later Adds and retention
        mv.MV_PinVersion(v)
        g2 = np.random.default_rng([seed, 930])
        for i in range(SERVE_PIN_ADDS):
            deltas = (g2.standard_normal((ids.size, SERVE_COLS))
                      * 0.01).astype(np.float32)
            for t in tables:
                t.AddRows(ids, deltas)
            if i % 8 == 7:
                mv.MV_PublishSnapshot()
        if v not in store.live_versions():
            raise AssertionError("[serve] the pinned version was evicted")
        for t, before in zip(tables, served):
            np.testing.assert_array_equal(
                mv.MV_ServingLookup(t, ids, version=v), before,
                err_msg="[serve] a pinned version changed")
            if np.array_equal(t.GetRows(ids), before):
                raise AssertionError("[serve] the Adds after the pin did "
                                     "not move the live table")
        mv.MV_UnpinVersion(v)
        if v in store.live_versions():
            raise AssertionError("[serve] the unpinned version stayed live")
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError("error word set on the serving path")
    finally:
        mv.MV_ShutDown()
    return res


def time_serve_gather(torch, cr, dev, mean_batch: float, seed: int) -> dict:
    """``<kGather>`` at the serve path's union shape: a SERVE_ROWS + 1 x
    SERVE_COLS storage copy, each id set the sorted union of
    round(mean_batch) lookups of SERVE_LOOKUP_IDS Zipf ids (the coalesced
    batches [serve] measured); bitwise against the plain version, timed
    both ways beside ``index_select`` and this data's byte bound (each
    union row read once and written once, each id read once)."""
    cdf = zipf_cdf(SERVE_ROWS)
    g = np.random.default_rng([seed, 940])
    tg = torch.Generator(device="cpu").manual_seed(seed)
    data = torch.randn(SERVE_ROWS + 1, SERVE_COLS, generator=tg).to(dev)
    b = max(1, int(round(mean_batch)))
    unions = [np.unique(zipf_ids(cdf, g, b * SERVE_LOOKUP_IDS))
              for _ in range(ID_SETS)]
    ids = [torch.from_numpy(u.astype(np.int32)).to(dev) for u in unions]
    ids64 = [i.long() for i in ids]
    err = 0.0
    for i, x in enumerate(ids):
        got, want = cr.gather_rows(data, x), cr.gather_rows_plain(data, x)
        if not torch.equal(got, want):
            raise AssertionError(f"[serve] gather at the union shape, set {i}")
        err = max(err, float((got - want).abs().max()))
    n = float(np.mean([u.size for u in unions]))
    res = {"ms": median_ms(torch, lambda i: cr.gather_rows(data, ids[i]),
                           ID_SETS),
           "stream_ms": stream_ms(torch, lambda i: cr.gather_rows(
               data, ids[i]), ID_SETS),
           "plain_ms": median_ms(torch, lambda i: cr.gather_rows_plain(
               data, ids[i]), ID_SETS),
           "library_ms": median_ms(torch, lambda i: torch.index_select(
               data, 0, ids64[i]), ID_SETS),
           "bound_ms": (2 * n * SERVE_COLS * 4 + 4 * n) / HBM_BYTES_PER_S
           * 1e3,
           "max_abs_err": err, "lookups_per_union": b, "union_ids": n,
           "shape": [SERVE_ROWS + 1, SERVE_COLS, round(n)]}
    torch.cuda.synchronize()
    if cr.read_error(dev) != 0:
        raise AssertionError("error word set at the serve union shape")
    return res


def report_serve(sv: dict, k: dict, launches: dict, card: str) -> None:
    """The [serve] lines."""
    tr, fe = sv["traffic"], sv["traffic"]["frontend"]
    mb = [m / 2 ** 20 for m in sv["memory_bytes"]]
    log(f"[serve] {card}: {SERVE_ROWS:,} x {SERVE_COLS} sgd and AdaGrad "
        f"MatrixTables, one process on the card; residence: sgd -> device "
        f"(one clone, read by <kGather>), AdaGrad -> host (aux state), on "
        f"every published version")
    log(f"[serve] memory allocated on the card: {mb[0]:.1f} MiB before "
        f"publishing, {mb[1]:.1f} MiB after 3 publishes with the first "
        f"pinned (live {sv['live_pinned']}: 3 copies of "
        f"{sv['copy_bytes']:,} bytes), {mb[2]:.1f} MiB after the unpin "
        f"(live {sv['live_after']})")
    log(f"[serve] publish: device export {sv['export_device_ms']:.4f} ms "
        f"(host clock, enqueues the clone; the clone on the card "
        f"{sv['clone_ms']:.4f} ms by CUDA events), host export "
        f"{sv['export_host_ms']:.4f} ms (AdaGrad table to host memory); "
        f"MV_PublishSnapshot + synchronize {sv['publish_synced_ms']:.4f} "
        f"ms; under traffic median {tr['publish_median_ms']:.4f} ms over "
        f"{tr['publishes']} publishes")
    log(f"[serve] traffic {tr['wall_s']:.3f} s: {SERVE_CLIENTS} clients x "
        f"{SERVE_LOOKUP_IDS} Zipf(1.0) ids, tables alternating, beside a "
        f"trainer ({tr['train_batches']} AddRows batches of {SERVE_IDS} "
        f"ids on both tables, a publish every {SERVE_PUBLISH_EVERY}): "
        f"{tr['lookups']} lookups = {tr['lookups_per_s']:.1f} lookups/s; "
        f"client latency p50 {tr['client_p50_ms']:.4f} ms, p99 "
        f"{tr['client_p99_ms']:.4f} ms; front-end p50 "
        f"{fe['latency_p50_s'] * 1e3:.4f} ms, p99 "
        f"{fe['latency_p99_s'] * 1e3:.4f} ms; mean coalesced batch "
        f"{fe['mean_batch']:.4f} lookups over {fe['batches']} batches; "
        f"dispatches {fe['dispatches']}; shed {fe['shed']}")
    log(f"[serve] device idle over {sv['idle_wall_s']:.3f} s of the same "
        f"traffic under torch.profiler: busy {sv['idle_busy_s']:.4f} s, "
        f"idle share {sv['idle_share']:.4f}")
    log(f"[serve] quiesced cut, {sv['cut_ids']} ids: served == training "
        f"GetRows (sgd bitwise; AdaGrad rtol/atol 1e-6, bitwise "
        f"{sv['ada_bitwise']}); {sv['device_gathers']} <kGather> launches "
        f"for 8 device-resident lookups (one per read); a pinned version "
        f"bitwise unchanged after {SERVE_PIN_ADDS} Add batches and 2 "
        f"publishes, evicted at its unpin; launches on the path {launches}")
    log(f"[kernels] serve union {k['shape'][0]}x{k['shape'][1]}, "
        f"{k['union_ids']:.1f} ids (unions of {k['lookups_per_union']} "
        f"lookups of {SERVE_LOOKUP_IDS} Zipf ids) gather_rows: kernel == "
        f"plain bitwise; per-pair {k['ms']:.7f} ms, stream "
        f"{k['stream_ms']:.7f} ms (bound {k['bound_ms']:.7f}, plain "
        f"{k['plain_ms']:.7f}, library {k['library_ms']:.7f}, all "
        f"per-pair), max_abs_err {k['max_abs_err']}")


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


class GradSumProbe:
    """Counts the LR objective's duplicate-key sums (``_scatter_rows``)
    during one run and keeps a copy of the first call's inputs, so that
    they can be timed afterwards against a plain ``index_add_`` on the same
    inputs."""

    def __init__(self, objective):
        self.objective, self.fn = objective, objective._scatter_rows
        self.calls, self.args = 0, None

    def __enter__(self):
        def probe(n_rows, keys, contrib):
            self.calls += 1
            if self.args is None:
                self.args = (n_rows, keys.clone(), contrib.clone())
            return self.fn(n_rows, keys, contrib)
        self.objective._scatter_rows = probe
        return self

    def __exit__(self, *exc):
        self.objective._scatter_rows = self.fn


def waits_for_card(torch, fn) -> bool:
    """``fn(0)`` enqueued behind a spin kernel: True when the call returned
    only after the spin ended, so it waits for the card."""
    fn(0)
    torch.cuda.synchronize()
    spin_start, held = _spin(torch)
    t0 = time.perf_counter()
    fn(0)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host_ms >= spin_start.elapsed_time(held)


def sync_sites(torch, fn) -> list:
    """The source lines where ``fn(0)`` made torch synchronise with the
    card (``torch.cuda.set_sync_debug_mode``'s warnings)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sorted({f"{os.path.relpath(w.filename)}:{w.lineno}"
                   for w in caught})


#: GradSumProbe's repeats of one input, each bitwise the first; the rows
#: of its crowded input (every lane's key modulo GRAD_SUM_CROWD)
GRAD_SUM_REPEATS, GRAD_SUM_CROWD = 10, 50


def grad_sum_cost(torch, probe: GradSumProbe, train_s: float) -> dict:
    """The objective's duplicate-key sums against ``index_add_`` at the
    first call's inputs: the same sums within rtol 1e-5, atol 1e-6, and the
    same bits in each of GRAD_SUM_REPEATS repeats, also with every key
    folded onto GRAD_SUM_CROWD rows (``index_add_``'s repeats are counted,
    not held); each call's host-inclusive ms (call_ms), whether it waits
    for the card and where it synchronises, and the run's extra seconds at
    its call count over its train_s."""
    n_rows, keys, contrib = probe.args
    out = contrib.shape[-1]
    flat_keys, flat = keys.reshape(-1), contrib.reshape(-1, out)

    def plain(_, k=flat_keys):
        return torch.zeros((n_rows, out), dtype=contrib.dtype,
                           device=contrib.device).index_add_(0, k, flat)

    def det(_, k=keys):
        return probe.fn(n_rows, k, contrib)

    # the same sums, in another order where keys repeat
    torch.testing.assert_close(det(0), plain(0), rtol=1e-5, atol=1e-6)
    crowd = torch.remainder(flat_keys, GRAD_SUM_CROWD)
    plain_differ = 0
    for k in (keys, crowd.view(keys.shape)):
        first, first_plain = det(0, k), plain(0, k.reshape(-1))
        for _ in range(GRAD_SUM_REPEATS):
            if not torch.equal(det(0, k), first):
                raise AssertionError("the LR objective's duplicate-key sums "
                                     "differ between runs of one input")
            plain_differ += not torch.equal(plain(0, k.reshape(-1)),
                                            first_plain)
    r = {"calls": probe.calls, "lanes": int(flat_keys.numel()),
         "rows": int(n_rows), "out": int(out),
         "det_call_ms": call_ms(torch, det, 1),
         "index_add_call_ms": call_ms(torch, plain, 1),
         "det_waits": waits_for_card(torch, det),
         "index_add_waits": waits_for_card(torch, plain),
         "det_sync_sites": sync_sites(torch, det),
         "index_add_repeats_differing": plain_differ}
    r["extra_s"] = probe.calls * (r["det_call_ms"]
                                  - r["index_add_call_ms"]) / 1e3
    r["extra_share"] = r["extra_s"] / train_s
    return r


def lr_phase(torch, dev, seed: int, workdir: str, lr_data: dict, drive,
             results: dict) -> None:
    """Each LR run as a main path of its own (``drive``), then the card
    against the CPU. Each run's duplicate-key sums are counted and, where
    it made any, timed against ``index_add_`` (GradSumProbe)."""
    from multiverso_tpu_torch.models.logreg import objective
    runs = lr_runs(workdir, seed, lr_data)
    weights = {}
    for name, (what, needs, cfg, native_needs) in runs.items():
        with GradSumProbe(objective) as probe:
            r, weights[name] = drive(name, lambda: lr_run(torch, cfg, dev),
                                     needs, native_needs)
        check_lr(name, r)
        if probe.calls:
            r["grad_sums"] = gs = grad_sum_cost(torch, probe, r["train_s"])
            log(f"[lr] {name} duplicate-key sums: {gs['calls']} calls, the "
                f"first of {gs['lanes']} lanes onto {gs['rows']} x "
                f"{gs['out']} rows; deterministic {gs['det_call_ms']:.4f} ms "
                f"a call with its host time (waits for the card: "
                f"{gs['det_waits']}, syncs at {gs['det_sync_sites']}), "
                f"index_add_ {gs['index_add_call_ms']:.4f} ms (waits: "
                f"{gs['index_add_waits']}): {gs['extra_s']:.4f} s more at "
                f"this run's calls, {gs['extra_share']:.4f} of its train_s; "
                f"{GRAD_SUM_REPEATS} repeats bitwise the first, also onto "
                f"{GRAD_SUM_CROWD} rows (index_add_: "
                f"{gs['index_add_repeats_differing']} of "
                f"{2 * GRAD_SUM_REPEATS} differ)")
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
        wa, wb = weights["lr_sparse_compress"], weights["lr_sparse_host"]
        raise AssertionError(
            f"lr_sparse_compress: weights or epoch losses differ from the "
            f"uncompressed run: {int((wa != wb).sum())} weights differ, max "
            f"{float(np.abs(wa - wb).max())}; losses {a['epoch_loss']} vs "
            f"{b['epoch_loss']}")
    log("[lr_sparse_compress] final weights and every epoch's loss bitwise "
        "equal to lr_sparse_host's (uncompressed)")
    if not results["lr_softmax_1bit"]["wire_stats"].get("payload_bytes"):
        raise AssertionError("lr_softmax_1bit pushed no compressed payload")
    results["lr_card_vs_cpu_max_abs_diff"] = lr_card_vs_cpu(torch, workdir,
                                                            seed)
    log(f"[lr] sparse sigmoid 1,000 x 1, 400 samples, card vs CPU weights: "
        f"max abs diff {results['lr_card_vs_cpu_max_abs_diff']:.3g} "
        f"(rtol 1e-4, atol 1e-5)")


# -- two processes: both apps data-parallel ([lr_2proc], [we_2proc]) ---------

def split_lines(path: str, share: float, stem: str) -> list:
    """The lines of ``path`` cut in two: rank 0 takes the first ``share``
    of them, rank 1 the rest; -> the two files' paths."""
    with open(path) as f:
        lines = f.readlines()
    cut = int(round(len(lines) * share))
    ext = os.path.splitext(path)[1]
    paths = []
    for r, part in enumerate((lines[:cut], lines[cut:])):
        out = f"{stem}_{r}{ext}"
        with open(out, "w") as f:
            f.writelines(part)
        paths.append(out)
    return paths


def lr2_data(workdir: str, seed: int) -> None:
    """[lr_2proc]'s shards: phase 5's dense softmax and sparse sigmoid
    samples cut LR2_SHARE / the rest (unequal: the rank with fewer windows
    joins with fillers), FTRL's cut in halves (its host KV verbs need
    equal streams)."""
    path = lambda name: os.path.join(workdir, name)  # noqa: E731
    split_lines(lr_dense_file(path("lr2_dense.data"), seed), LR2_SHARE,
                path("lr2_dense"))
    split_lines(write_lr_sparse(path("lr2_sparse.data"), lr_sparse_samples(
        seed + 2, LR_SPARSE_IN, 1)), LR2_SHARE, path("lr2_sparse"))
    split_lines(write_lr_sparse(path("lr2_ftrl.data"), lr_sparse_samples(
        seed + 6, LR_FTRL_IN, 1)), 0.5, path("lr2_ftrl"))


def lr2_configs(workdir: str, rank: int, platform: str) -> dict:
    """[lr_2proc]'s runs on ``rank``'s shards: the dense softmax (in
    float32, so the card-against-CPU check measures the collective path
    rather than bf16 rounding) and the sparse sigmoid on the device plane,
    FTRL (device_plane asked for: a multi-process world rides the
    collective host KV verbs)."""
    path = lambda kind: os.path.join(workdir,  # noqa: E731
                                     f"lr2_{kind}_{rank}.data")
    sparse_kw = dict(sparse=True, regular_type="L2", updater_type="sgd",
                     sync_frequency=LR_SPARSE_SYNC)
    return {
        "lr2_dense": lr_config(path("dense"), LR_DENSE_IN, LR_DENSE_OUT,
                               LR2_EPOCHS["lr2_dense"],
                               objective_type="softmax", regular_type="L2",
                               updater_type="sgd", learning_rate_coef=7e6,
                               regular_coef=0.0007, sync_frequency=100,
                               platform=platform),
        "lr2_sparse": lr_config(path("sparse"), LR_SPARSE_IN, 1,
                                LR2_EPOCHS["lr2_sparse"],
                                objective_type="sigmoid", platform=platform,
                                **sparse_kw),
        "lr2_ftrl": lr_config(path("ftrl"), LR_FTRL_IN, 1,
                              LR2_EPOCHS["lr2_ftrl"], objective_type="ftrl",
                              alpha=2.0, beta=1.0, lambda1=0.01,
                              lambda2=0.01, sync_frequency=LR_SPARSE_SYNC,
                              platform=platform)}


def collective_line(run: dict) -> str:
    """A run's lockstep rounds: the application thread's
    (multihost.STATS) and the engine's window exchanges, and their share
    of the run's seconds."""
    st, secs = run["collective"], run["train_s"]
    coll = st["agree_s"] + st["write_s"]
    return (f"the engine's window exchanges {run['engine_xw_s']:.4f} s; "
            f"agreements {st['agree_n']} in {st['agree_s']:.4f} s, "
            f"collective writes {st['write_n']}: device->host "
            f"{st['d2h_s']:.4f} s, all-gathers {st['write_s']:.4f} s, host "
            f"merge {st['merge_s']:.4f} s, apply {st['apply_s']:.4f} s; "
            f"agreements + all-gathers {coll:.4f} s = {coll / secs:.3f} of "
            f"{secs:.4f} s")


def lr_2proc_rank(rank: int, port: int, seed: int, out: str,
                  workdir: str) -> int:
    """One rank of [lr_2proc]: each LR run on this rank's shard in the
    two-rank world on ``cuda:0`` (the counts and the lockstep rounds'
    seconds zeroed before each), then the same runs in a two-rank world on
    the CPU (the plain versions): the final weights within rtol 1e-4,
    atol 1e-5 of the card's."""
    import hashlib

    import torch

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.ops import cuda_rows as cr
    from multiverso_tpu_torch.parallel import multihost as mh
    from multiverso_tpu_torch.zoo import Zoo
    dev = torch.device("cuda", 0)
    base = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2"]
    res = {"rank": rank, "runs": {}}
    weights = {}
    mv.MV_Init(base)
    eng = Zoo.Get().server_engine
    for name, cfg in lr2_configs(workdir, rank, "cuda").items():
        cr.reset_launches()
        mh.reset_stats()
        x0 = eng.xw_busy_s
        r, weights[name] = lr_run(torch, cfg, dev)
        torch.cuda.synchronize()
        r.update(launches=dict(cr.LAUNCHES), collective=dict(mh.STATS),
                 engine_xw_s=eng.xw_busy_s - x0,
                 digest=hashlib.sha256(weights[name].tobytes()).hexdigest())
        res["runs"][name] = r
    if cr.read_error(dev) != 0:
        raise AssertionError("error word set on the 2-process LR path")
    mv.MV_ShutDown(finalize_net=False)      # the process group stays up
    mv.MV_Init(base + ["-mv_device=cpu"])
    for name, cfg in lr2_configs(workdir, rank, "cpu").items():
        _, W = lr_run(torch, cfg)
        np.testing.assert_allclose(weights[name], W, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name}: card vs CPU")
        res["runs"][name]["cpu_max_abs_diff"] = float(
            np.abs(weights[name] - W).max())
    mv.MV_ShutDown()
    with open(out, "w") as f:
        json.dump(res, f)
    print(f"[lr_2proc rank {rank}] ok", flush=True)
    return 0


def lr_2proc_phase(seed: int, workdir: str) -> dict:
    """[lr_2proc]: both ranks; the final weights bitwise equal across the
    ranks, each run's loss bound (check_lr), and every rank launching
    the row gather and the fused update on the sparse run. Returns the
    ranks' results and the launches summed over ranks and runs."""
    lr2_data(workdir, seed)
    ranks = rank_children("lr", seed, workdir)
    for name in ranks[0]["runs"]:
        runs = [r["runs"][name] for r in ranks]
        if runs[0]["digest"] != runs[1]["digest"]:
            raise AssertionError(f"[lr_2proc] {name}: the ranks' final "
                                 f"weights differ")
        for r in runs:
            check_lr(name.replace("lr2_", "lr_"), r)
    for r in ranks:
        for k in ("gather_rows", "update_rows"):
            if r["runs"]["lr2_sparse"]["launches"][k] == 0:
                raise AssertionError(f"[lr_2proc] rank {r['rank']} never "
                                     f"launched {k}")
    launches = {k: sum(run["launches"][k] for r in ranks
                       for run in r["runs"].values())
                for k in ("gather_rows", "scatter_set_rows", "update_rows")}
    return {"ranks": ranks, "launches": launches}


def write_topic_corpus(workdir: str) -> tuple:
    """tests/test_wordembedding.py's topic corpus (300 sentences of 12
    words, each sentence from one of 4 topics of 5 words), as
    ``we_small_reference`` writes it, with a vocabulary file."""
    rng = np.random.default_rng(0)
    corpus = os.path.join(workdir, "topics.txt")
    with open(corpus, "w") as f:
        for _ in range(300):
            topic = rng.integers(4)
            f.write(" ".join(f"w{topic * 5 + rng.integers(5)}"
                             for _ in range(12)) + "\n")
    vocab = os.path.join(workdir, "topics_vocab.txt")
    with open(vocab, "w") as f:
        f.writelines(f"w{i} 100\n" for i in range(20))
    return vocab, corpus


def we2_data(workdir: str, seed: int) -> None:
    """[we_2proc]'s shards (``we2_data_paths``): the word2vec-scale Zipf
    corpus (phase 4's ``_big`` one) and the topic corpus, each cut
    WE2_SHARE / the rest by sentences (unequal: the rank whose shard runs
    out joins with empty blocks), and the WE corpus cut in halves (the
    device plane needs equal block streams)."""
    for (vocab, corpus), stem, share in (
            (write_zipf_corpus(workdir, seed, WE_BIG_VOCAB, WE_BLOCKS,
                               "_big")[:2], "we2_big", WE2_SHARE),
            (write_topic_corpus(workdir), "we2_topics", WE2_SHARE),
            (write_zipf_corpus(workdir, seed)[:2], "we2_small", 0.5)):
        split_lines(corpus, share, os.path.join(workdir, stem))


def we2_data_paths(workdir: str) -> dict:
    """Run -> (vocabulary, the two ranks' corpora)."""
    def shards(stem):
        return [os.path.join(workdir, f"{stem}_{r}.txt") for r in range(2)]
    return {"we2_topics": (os.path.join(workdir, "topics_vocab.txt"),
                           shards("we2_topics")),
            "we2_pairs": (os.path.join(workdir, "vocab_big.txt"),
                          shards("we2_big")),
            "we2_device": (os.path.join(workdir, "vocab.txt"),
                           shards("we2_small"))}


def we2_options(workdir: str, seed: int, rank: int, run: str,
                platform: str = "cuda"):
    """[we_2proc]'s runs: ``we2_topics`` (-device_pairs 1 -use_adagrad 1 on
    the topic corpus at ``we_pairs_card_vs_cpu``'s options, blocks of 500
    words a rank, the touched-rows step forced by the caller),
    ``we2_pairs`` (-device_pairs 1 -use_adagrad 1 at 1,000,000 x 128, the
    touched-rows step, blocks of WE2_BLOCK_BYTES a rank) and
    ``we2_device`` (-device_plane 1 at 100,000 x 128)."""
    vocab, corpora = we2_data_paths(workdir)[run]
    extra = {"we2_topics": (
                 "-device_pairs", "1", "-use_adagrad", "1", "-lr", "0.1",
                 "-size", "16", "-window", "2", "-negative", "3",
                 "-pair_batch", "256", "-data_block_size", "4000"),
             "we2_pairs": (
                 "-device_pairs", "1", "-use_adagrad", "1", "-lr",
                 str(WE_ADAGRAD_LR), "-data_block_size",
                 str(WE2_BLOCK_BYTES)),
             "we2_device": ()}[run]
    return we_options(workdir, seed, vocab, corpora[rank],
                      extra=extra + ("-platform", platform))


def we2_train(torch, opt) -> tuple:
    """One WE run in the world up: prepare, a timed ``train()``; returns
    (stats, the app). Every block's loss per pair finite and below the
    untrained loss 0.69 * (1 + K)."""
    from multiverso_tpu_torch.models.wordembedding.distributed import \
        DistributedWordEmbedding
    we = DistributedWordEmbedding(opt)
    we.prepare()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = we.train()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    limit = 0.69 * (1 + opt.negative_num)
    blocks = [{"words": w, "pairs": p, "loss_per_pair": lo / max(p, 1)}
              for w, p, lo in we.block_log]
    for b in blocks:
        if not (math.isfinite(b["loss_per_pair"])
                and b["loss_per_pair"] < limit):
            raise AssertionError(f"block loss out of bounds (< {limit}): "
                                 f"{b}")
    words = sum(b["words"] for b in blocks)
    return {"train_s": secs, "words": words, "words_per_s": words / secs,
            "avg_loss_per_pair": loss, "blocks": blocks, "limit": limit,
            "loader_wait_s": we.loader_wait_s}, we


def we_tables(we) -> list:
    c = we.comm
    return [t for t in (c.input_table, c.output_table, c.ie_g2_table,
                        c.eo_g2_table) if t is not None]


class FirstGlobalBlock:
    """While installed, the first ``-device_pairs`` block trains with numpy
    draws made from ``seed`` (the same on every rank) instead of the
    card's generator, and its global layout, draws and lr are kept; with
    ``snapshot`` the tables' logical views after it are kept too."""

    def __init__(self, dp, seed: int, snapshot: bool):
        self.dp, self.seed, self.snapshot, self.rec = dp, seed, snapshot, {}

    def __enter__(self):
        self.orig = orig = self.dp.DevicePairsTrainer.train_block
        rec, seed, snapshot = self.rec, self.seed, self.snapshot

        def train_block(trainer, token_ids, token_sent, lr, b=None,
                        draws=None, agreed=None):
            if rec:
                return orig(trainer, token_ids, token_sent, lr,
                            agreed=agreed)
            ids, sent = trainer.global_layout(agreed)
            W, K = trainer.opt.window_size, trainer.opt.negative_num
            rng = np.random.default_rng([seed, 91])
            b = rng.integers(1, W + 1, len(ids))
            draws = rng.integers(0, trainer.slots.shape[0],
                                 (2 * W * len(ids), K))
            rec.update(ids=ids, sent=sent, b=b, draws=draws, lr=lr)
            out = orig(trainer, token_ids, token_sent, lr, b=b, draws=draws,
                       agreed=agreed)
            if snapshot:
                rec["tables"] = [s.raw() for s in trainer._servers()]
            return out

        self.dp.DevicePairsTrainer.train_block = train_block
        return self

    def __exit__(self, *exc):
        self.dp.DevicePairsTrainer.train_block = self.orig


class ForcedSteps:
    """While installed, every touched-rows step a block program takes on
    the CPU is taken on the card too, with the same batch, three ways:
    ``forced``, from the CPU's state before the step (after it, the
    batch's touched rows and the trash row are reset to the CPU's), and
    two free-running twins from the initial tables, with the sorted
    segment sums (``free[True]``, the two-rank path) and with
    ``index_add_``'s (``free[False]``, the one-process path). Keeps the
    forced steps' largest difference from the CPU's and their elements
    outside rtol 1e-3, atol 1e-4, and how many batches touched each
    storage row of the input and output tables."""

    def __init__(self, torch, dp, init: list, dev):
        self.torch, self.dp, self.dev = torch, dp, dev
        self.forced = [t.to(dev, copy=True) for t in init]
        self.free = {det: [t.to(dev, copy=True) for t in init]
                     for det in (True, False)}
        self.touches = [torch.zeros(init[k].shape[0], dtype=torch.int32)
                        for k in (0, 1)]
        self.steps, self.outside, self.max_diff = 0, 0, 0.0
        self.worst_steps = []

    def __enter__(self):
        self.orig = orig = self.dp.sparse_adagrad_step
        torch, dev, TrainState = self.torch, self.dev, self.dp.TrainState

        def step(state, inputs, imask, outputs, labels, omask, lr, **kw):
            args = [a.to(dev) for a in (inputs, imask, outputs, labels,
                                        omask)]
            for det, tabs in self.free.items():
                orig(TrainState(*tabs), *args, lr, deterministic=det)
            orig(TrainState(*self.forced), *args, lr, deterministic=True)
            state, loss = orig(state, inputs, imask, outputs, labels, omask,
                               lr, **kw)
            touched = [torch.unique(a.reshape(-1).long()) for a in (inputs,
                                                                  outputs)]
            for k in (0, 1):
                self.touches[k][touched[k]] += 1
            outside, diff = 0, 0.0
            for k, (tab, card) in enumerate(zip(state, self.forced)):
                rows = touched[k % 2]
                rows = rows[(rows >= 0) & (rows < tab.shape[0] - 1)]
                got = card[rows.to(dev)].cpu()
                want = tab[rows]
                outside += int((~torch.isclose(got, want, rtol=1e-3,
                                               atol=1e-4)).sum())
                if rows.numel():
                    diff = max(diff, float((got - want).abs().max()))
                card[rows.to(dev)] = want.to(dev)
                card[-1] = tab[-1].to(dev)
            self.steps += 1
            self.outside += outside
            self.max_diff = max(self.max_diff, diff)
            if outside:
                self.worst_steps.append((self.steps, outside, diff))
            return state, loss

        self.dp.sparse_adagrad_step = step
        return self

    def __exit__(self, *exc):
        self.dp.sparse_adagrad_step = self.orig


def outside_share(a: np.ndarray, b: np.ndarray) -> tuple:
    """(elements of ``a`` outside rtol 1e-3, atol 1e-4 of ``b``, the
    largest difference), ``b`` the reference."""
    return (int((~np.isclose(a, b, rtol=1e-3, atol=1e-4)).sum()),
            float(np.abs(a - b).max()))


def we2_block_on_cpu(torch, workdir: str, seed: int, run: str,
                     rec: dict, witness: bool = False, card=None) -> dict:
    """A recorded first global block of ``run`` in a one-process world on
    the CPU: the block program on the same global layout, draws and lr,
    from the same initial tables (the plain versions); -> the largest
    difference from the card's two-rank tables, the share of elements
    outside rtol 1e-3, atol 1e-4, and the seconds.

    ``witness`` (the 1,000,000 x 128 run, where the two differ by more;
    on ``card``, ``cuda:0`` by default) adds what tells rounding from a
    fault (``ForcedSteps``): every batch
    step retaken on the card from the CPU's state (``forced_*``: each
    step alone against the CPU's; ``forced_equal``: after the last step
    the card's tables are the CPU's bit for bit, so no other row was
    written), the block in one process on the card with the sorted sums
    (``sorted_equal``: bitwise the two-rank tables) and with
    ``index_add_``'s (``atomic_*``), the CPU's own block from the input
    table nudged one ulp (``nudge_*``), and where the two-rank tables'
    outside elements lie: the median number of batches that touched
    their rows against that of every touched row, and the share of them
    whose CPU AdaGrad sum is under 100 x eps (1e-8)."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.wordembedding import device_pairs as dp
    from multiverso_tpu_torch.models.wordembedding.communicator import \
        Communicator
    from multiverso_tpu_torch.models.wordembedding.dictionary import \
        Dictionary
    opt = we2_options(workdir, seed, 0, run, "cpu")
    d = Dictionary.load_vocab(opt.read_vocab_file)
    d.RemoveWordsLessThan(1)
    t0 = time.perf_counter()
    args = [torch.from_numpy(np.asarray(rec[k]))
            for k in ("ids", "sent", "b", "draws")]
    out = {}
    mv.MV_Init(["-mv_device=cpu"])
    try:
        comm = Communicator(opt, d.Size())
        trainer = dp.DevicePairsTrainer(opt, comm, d.counts())
        servers = trainer._servers()
        init = [s.state["data"].clone() for s in servers] if witness \
            else None
        with (ForcedSteps(torch, dp, init, card or torch.device("cuda", 0))
              if witness else contextlib.nullcontext()) as forced:
            loss, pairs = trainer.program(*args, rec["lr"])
        if not (math.isfinite(float(loss)) and int(pairs) > 0):
            raise AssertionError("the CPU block trained nothing")
        got = [s.raw() for s in servers]
        if witness:
            V, D = got[0].shape
            out.update(forced_steps=forced.steps,
                       forced_outside=forced.outside,
                       forced_max_abs_diff=forced.max_diff,
                       forced_worst_steps=forced.worst_steps[:10],
                       forced_equal=all(
                           torch.equal(c.cpu(), s.state["data"])
                           for c, s in zip(forced.forced, servers)))
            touches = [t[:V].numpy() for t in forced.touches]
            free = {det: [t[:V, :D].cpu().numpy() for t in tabs]
                    for det, tabs in forced.free.items()}
            del forced
            out["sorted_equal"] = all(np.array_equal(a, b) for a, b in
                                      zip(free[True], rec["tables"]))
            n, m = zip(*(outside_share(a, b)
                         for a, b in zip(free[False], got)))
            out.update(atomic_outside=sum(n), atomic_max_abs_diff=max(m))
            del free
            for s, t in zip(servers, init):
                s.state["data"] = t
            ie = servers[0].state["data"]
            ie.copy_(torch.nextafter(ie, torch.full_like(ie, math.inf)))
            trainer.program(*args, rec["lr"])
            n, m = zip(*(outside_share(s.raw(), b)
                         for s, b in zip(servers, got)))
            out.update(nudge_outside=sum(n), nudge_max_abs_diff=max(m))
            rows, small = [], 0
            for k, (a, b) in enumerate(zip(rec["tables"], got)):
                r, c = np.nonzero(~np.isclose(a, b, rtol=1e-3, atol=1e-4))
                rows.append(touches[k % 2][r])
                small += int((got[2 + k % 2][r, c] < 1e-8).sum())
            rows = np.concatenate(rows)
            out.update(
                outside_row_touches_median=float(np.median(rows))
                if rows.size else None,
                touched_row_touches_median=float(np.median(np.concatenate(
                    [t[t > 0] for t in touches]))),
                outside_g2_small_share=small / max(rows.size, 1))
    finally:
        mv.MV_ShutDown()
    n, m = zip(*(outside_share(a, b) for a, b in zip(rec["tables"], got)))
    out.update(max_abs_diff=max(m), outside=sum(n),
               outside_share=sum(n) / sum(a.size for a in got),
               elements=sum(a.size for a in got),
               seconds=time.perf_counter() - t0)
    return out


def check_we2_witness(w: dict) -> None:
    """The 1,000,000 x 128 block's gates (``we2_block_on_cpu``): each
    batch step on the card within rtol 1e-3, atol 1e-4 of the CPU's step
    from the same state, and no other row written; the two-rank tables
    bitwise the one-process sorted-sums block on the card; the two-rank
    tables' elements outside rtol 1e-3, atol 1e-4 of the CPU's block at
    most 3x those a one-ulp nudge of the input table moves there on the
    CPU alone (the block amplifies rounding; the steps do not)."""
    if w["forced_outside"] or not w["forced_equal"]:
        raise AssertionError(f"we2_pairs: a batch step on the card differs "
                             f"from the CPU's step from the same state: "
                             f"{w}")
    if not w["sorted_equal"]:
        raise AssertionError(f"we2_pairs: the two-rank tables differ from "
                             f"the same block in one process on the card: "
                             f"{w}")
    if w["outside"] > 3 * w["nudge_outside"]:
        raise AssertionError(f"we2_pairs: the block on the card is further "
                             f"from the CPU's than rounding explains: {w}")


def we_2proc_rank(rank: int, port: int, seed: int, out: str,
                  workdir: str) -> int:
    """One rank of [we_2proc] on ``cuda:0``, a world a run:
    ``we2_topics`` (the touched-rows step forced) and ``we2_pairs``, the
    first global block of each trained with numpy draws (the same on both
    ranks: ``FirstGlobalBlock``) and, on rank 0, the tables kept after it
    and, on ``we2_pairs``, its first batches' output lanes; then
    ``we2_device``. Each run's tables digested (logical views: the trash
    rows are free). After the world is down, rank 0 trains each recorded
    block in a one-process world on the CPU (``we2_block_on_cpu``):
    ``we2_topics``' tables must agree within ``we_pairs_card_vs_cpu``'s
    rtol 1e-3, atol 1e-4; ``we2_pairs``' difference is measured."""
    import hashlib

    import torch

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.wordembedding import device_pairs as dp
    from multiverso_tpu_torch.ops import cuda_rows as cr
    from multiverso_tpu_torch.parallel import multihost as mh
    from multiverso_tpu_torch.zoo import Zoo
    dev = torch.device("cuda", 0)
    base = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2"]
    res = {"rank": rank, "runs": {}}
    recs = {}
    sparse_bytes = dp._SPARSE_BYTES
    for run in WE2_RUNS:
        mv.MV_Init(base)
        eng = Zoo.Get().server_engine
        cr.reset_launches()
        mh.reset_stats()
        dp._SPARSE_BYTES = 0 if run == "we2_topics" else sparse_bytes
        batches = FirstBatches(dp, ID_SETS) if (
            rank == 0 and run == "we2_pairs") else contextlib.nullcontext()
        block = (FirstGlobalBlock(dp, seed, rank == 0)
                 if run != "we2_device" else contextlib.nullcontext())
        with batches as first, block as rec:
            r, we = we2_train(torch, we2_options(workdir, seed, rank, run))
        dp._SPARSE_BYTES = sparse_bytes
        torch.cuda.synchronize()
        if cr.read_error(dev) != 0:
            raise AssertionError(f"error word set on {run}")
        r.update(launches=dict(cr.LAUNCHES), collective=dict(mh.STATS),
                 engine_xw_s=eng.xw_busy_s,
                 digests=[hashlib.sha256(t.server().raw().tobytes())
                          .hexdigest() for t in we_tables(we)])
        if we.dp_trainer is not None:
            r.update(batches=we.dp_trainer.batches,
                     sparse_batches=we.dp_trainer.sparse_batches)
        if first is not None:
            np.savez(os.path.join(workdir, "we2_first_batches.npz"),
                     *[o.cpu().numpy() for o in first.outputs])
        if rec is not None and rank == 0:
            recs[run] = rec.rec
        res["runs"][run] = r
        del we
        mv.MV_ShutDown(finalize_net=run == WE2_RUNS[-1])
    for run, rec in recs.items():
        dp._SPARSE_BYTES = 0 if run == "we2_topics" else sparse_bytes
        cpu = we2_block_on_cpu(torch, workdir, seed, run, rec,
                               witness=run == "we2_pairs")
        dp._SPARSE_BYTES = sparse_bytes
        res["runs"][run]["block1_vs_cpu"] = cpu
        if run == "we2_topics" and cpu["outside"] > 0:
            raise AssertionError(f"we2_topics: the first global block on "
                                 f"the card differs from the CPU's beyond "
                                 f"rtol 1e-3, atol 1e-4: {cpu}")
        if run == "we2_pairs":
            check_we2_witness(cpu)
    with open(out, "w") as f:
        json.dump(res, f)
    print(f"[we_2proc rank {rank}] ok", flush=True)
    return 0


def we_2proc_phase(seed: int, workdir: str) -> dict:
    """[we_2proc]: both ranks; every table bitwise equal across the ranks
    (digests of the logical tables), the runs' launches (the pairs runs:
    row gather and scatter-set; the device plane: row gather and fused
    update, on every rank)."""
    we2_data(workdir, seed)
    ranks = rank_children("we", seed, workdir)
    needs = {"we2_topics": ("gather_rows", "scatter_set_rows"),
             "we2_pairs": ("gather_rows", "scatter_set_rows"),
             "we2_device": ("gather_rows", "update_rows")}
    for name, ks in needs.items():
        if ranks[0]["runs"][name]["digests"] != \
                ranks[1]["runs"][name]["digests"]:
            raise AssertionError(f"[we_2proc] {name}: the ranks' tables "
                                 f"differ")
        for r in ranks:
            for k in ks:
                if r["runs"][name]["launches"][k] == 0:
                    raise AssertionError(f"[we_2proc] {name}: rank "
                                         f"{r['rank']} never launched {k}")
    launches = {k: sum(run["launches"][k] for r in ranks
                       for run in r["runs"].values())
                for k in ("gather_rows", "scatter_set_rows", "update_rows")}
    first = np.load(os.path.join(workdir, "we2_first_batches.npz"))
    outputs = [first[k] for k in first.files]
    return {"ranks": ranks, "launches": launches, "first_outputs": outputs}


def repeatable_sums(torch, dev, seed: int) -> dict:
    """The scatter-adds the replicas rely on, run five times on the same
    inputs on the card (200,000 lanes onto 50 rows of 128: many
    duplicates a row): the deterministic segment sums of ``ops.rows``
    must give the same bits every time (and the CPU's ``index_add_``
    bits); ``index_add_``'s repeatability on the card is reported."""
    from multiverso_tpu_torch.ops.rows import dedup_rows, scatter_add_rows
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 50, (200_000,), generator=g)
    rows = torch.randn(200_000, 128, generator=g)
    ids_d, rows_d = ids.to(dev), rows.to(dev)
    runs = {
        "dedup_rows": [dedup_rows(ids_d.int(), rows_d, True)[1]
                       for _ in range(5)],
        "scatter_add_rows": [scatter_add_rows(
            torch.ones(51, 128, device=dev), ids_d, rows_d, True)
            for _ in range(5)],
        "index_add_": [torch.ones(51, 128, device=dev).index_add_(
            0, ids_d, rows_d) for _ in range(5)]}
    out = {k: all(torch.equal(v[0], x) for x in v[1:])
           for k, v in runs.items()}
    cpu = torch.ones(51, 128).index_add_(0, ids, rows)
    out["scatter_add_rows_equals_cpu"] = torch.equal(
        runs["scatter_add_rows"][0][:50].cpu(), cpu[:50])
    if not (out["dedup_rows"] and out["scatter_add_rows"]
            and out["scatter_add_rows_equals_cpu"]):
        raise AssertionError(f"the deterministic segment sums are not "
                             f"repeatable on the card: {out}")
    return out


def apps_2proc(torch, cr, dev, seed: int, workdir: str, lr_data: dict,
               paths: dict, results: dict) -> dict:
    """[lr_2proc] and [we_2proc], each a main path of its own (the ranks
    count their launches from zero), then the row kernels at the shapes
    they give them first: the sparse LR run's merged window (both ranks'
    first windows' rows) and [we_2proc]'s global touched-rows batches.
    Returns those timings by path."""
    lr2 = lr_2proc_phase(seed, workdir)
    paths["lr_2proc"] = lr2["launches"]
    results["lr_2proc"] = lr2
    log(f"[main path] lr_2proc: launches {lr2['launches']} (both ranks; "
        f"each rank's sparse run must launch gather_rows, update_rows)")
    for r in lr2["ranks"]:
        for name, run in r["runs"].items():
            log(f"[lr_2proc] rank {r['rank']} {name}: {run['samples']} "
                f"samples ({'global' if 'ftrl' not in name else 'own'}) in "
                f"{run['train_s']:.3f} s = {run['samples_per_s']:.0f} "
                f"samples/s; loss per epoch "
                f"{[round(x, 5) for x in run['epoch_loss']]}; "
                f"{collective_line(run)}; "
                f"launches {run['launches']}; card vs CPU world weights max "
                f"abs diff {run['cpu_max_abs_diff']:.3g}")
    log("[lr_2proc] final weights bitwise equal across the ranks in every "
        "run; within rtol 1e-4, atol 1e-5 of the two-rank CPU world's")
    we2 = we_2proc_phase(seed, workdir)
    paths["we_2proc"] = we2["launches"]
    results["we_2proc"] = {k: v for k, v in we2.items()
                           if k != "first_outputs"}
    log(f"[main path] we_2proc: launches {we2['launches']} (both ranks; "
        f"the pairs run must launch gather_rows, scatter_set_rows, the "
        f"device plane gather_rows, update_rows, on each rank)")
    for name in WE2_RUNS:
        runs = [r["runs"][name] for r in we2["ranks"]]
        all_words = sum(run["words"] for run in runs)
        for r, run in zip(we2["ranks"], runs):
            log(f"[we_2proc] rank {r['rank']} {name}: its {run['words']} "
                f"words in {run['train_s']:.3f} s = "
                f"{run['words_per_s']:.0f} words/s (both ranks' "
                f"{all_words} words: {all_words / run['train_s']:.0f} "
                f"words/s); loss per pair by block "
                f"{[round(b['loss_per_pair'], 4) for b in run['blocks']]} "
                f"(bound {run['limit']:.4f}); {collective_line(run)}; "
                f"launches {run['launches']}"
                + (f"; {run['batches']} batch steps, "
                   f"{run['sparse_batches']} on the touched-rows step"
                   if "batches" in run else ""))
        cpu = runs[0].get("block1_vs_cpu")
        if cpu:
            log(f"[we_2proc] {name}: its first global block on the card "
                f"(rank 0) against the same block on the CPU (plain "
                f"versions, same draws, {cpu['seconds']:.1f} s): max abs "
                f"diff {cpu['max_abs_diff']:.3g}, elements outside rtol "
                f"1e-3, atol 1e-4: {cpu['outside']} of {cpu['elements']}"
                + (" (must be 0)" if name == "we2_topics" else
                   " (at most 3x the nudge's, below)"))
        if cpu and "forced_steps" in cpu:
            log(f"[we_2proc] {name} witness: {cpu['forced_steps']} batch "
                f"steps each retaken on the card from the CPU's state: "
                f"{cpu['forced_outside']} elements outside rtol 1e-3, atol "
                f"1e-4 (must be 0), max abs diff "
                f"{cpu['forced_max_abs_diff']:.3g}, tables then equal to "
                f"the CPU's bitwise {cpu['forced_equal']}; one process on "
                f"the card, sorted sums: bitwise the two-rank tables "
                f"{cpu['sorted_equal']}; index_add_ sums: "
                f"{cpu['atomic_outside']} outside, max abs diff "
                f"{cpu['atomic_max_abs_diff']:.3g}; the CPU's block from "
                f"the input table nudged one ulp: {cpu['nudge_outside']} "
                f"outside, max abs diff {cpu['nudge_max_abs_diff']:.3g}; "
                f"the outside elements' rows touched by a median "
                f"{cpu['outside_row_touches_median']} batches (every "
                f"touched row: {cpu['touched_row_touches_median']}), "
                f"{cpu['outside_g2_small_share']:.3g} of them with an "
                f"AdaGrad sum under 1e-8")
    log("[we_2proc] every table bitwise equal across the ranks on every "
        "run")
    rep = repeatable_sums(torch, dev, seed + 13)
    results["repeatable_sums"] = rep
    log(f"[we_2proc] five runs of the same scatter-add on the card (200,000 "
        f"lanes onto 50 rows): the deterministic segment sums repeat "
        f"bitwise (dedup_rows {rep['dedup_rows']}, scatter_add_rows "
        f"{rep['scatter_add_rows']}, equal to the CPU's index_add_ "
        f"{rep['scatter_add_rows_equals_cpu']}); index_add_ repeats: "
        f"{rep['index_add_']}")
    samples = lr_data["lr_sparse"]
    cut = int(round(LR_SAMPLES * LR2_SHARE))
    window = LR_SPARSE_SYNC * LR_MINIBATCH
    merged = np.union1d(samples[0][:window], samples[0][cut: cut + window])
    lr2_k = time_kernels(torch, cr, dev, LR_SPARSE_IN, 4, len(merged),
                         seed + 11)
    touched = time_touched_rows(
        torch, cr, dev, WE_BIG_VOCAB + 1, WE_DIM,
        [torch.from_numpy(o) for o in we2["first_outputs"]], seed + 12)
    for label, res in ((f"lr_2proc merged window {LR_SPARSE_IN + 1}x4, "
                        f"{len(merged)} ids", lr2_k),
                       (f"we_2proc global touched-rows batch "
                        f"{WE_BIG_VOCAB + 1}x{WE_DIM}", touched)):
        for k in ("gather_rows", "scatter_set_rows", "update_rows"):
            if k in res:
                r = res[k]
                log(f"[kernels] {label} {k}: per-pair {r['ms']:.7f} ms, "
                    f"stream {r['stream_ms']:.7f} ms (bound "
                    f"{r['bound_ms']:.7f}, plain {r['plain_ms']:.7f}, "
                    f"library {r['library_ms']:.7f}, all per-pair), "
                    f"max_abs_err {r['max_abs_err']}"
                    + (f", {r['distinct_rows']:.1f} distinct rows of "
                       f"{r['shape'][2]} lanes" if "distinct_rows" in r
                       else ""))
    if "update_rows_sgd_ms" in lr2_k:
        # the LR write is the sgd sign
        lr2_k["update_rows"] = dict(
            lr2_k["update_rows"], ms=lr2_k["update_rows_sgd_ms"],
            stream_ms=lr2_k["update_rows_sgd_stream_ms"],
            plain_ms=lr2_k["update_rows_sgd_plain_ms"],
            library_ms=lr2_k["update_rows_sgd_library_ms"],
            max_abs_err=lr2_k["update_rows_sgd_max_abs_err"])
        log(f"[kernels] lr_2proc merged window update (sgd sign): per-pair "
            f"{lr2_k['update_rows']['ms']:.7f} ms, stream "
            f"{lr2_k['update_rows']['stream_ms']:.7f} ms")
    results["kernels_lr_2proc_shape"] = lr2_k
    results["kernels_we_2proc_touched_rows"] = touched
    return {"lr_2proc": lr2_k, "we_2proc": touched}


def fs_counts() -> dict:
    """This process's failsafe and chaos counters (FS_COUNTERS)."""
    return {k: counter(k) for k in FS_COUNTERS}


def fs_delta(c0: dict, c1: dict) -> dict:
    return {k: c1[k] - c0[k] for k in c0}


def fs_check_counts(tag: str, moved: dict, sites) -> None:
    """Each armed site fired and the recovery it drives engaged."""
    for k in ("failsafe.dedup_hits", "failsafe.retries",
              *(f"chaos.{s}" for s in sites)):
        if moved[k] <= 0:
            raise AssertionError(f"{tag}: {k} did not move ({moved})")


def fs_quiet_engine() -> None:
    """Wait for an engine thread a deadline abandoned (the drill's stalled
    apply) to finish before the next path: its late launch must not land
    in another path's counts."""
    for t in threading.enumerate():
        if t.name.startswith("mvt-server"):
            t.join(FS_DELAY_S + 5.0)
            if t.is_alive():
                raise AssertionError(f"engine thread {t.name} still runs "
                                     f"{FS_DELAY_S + 5.0} s after the drill")


def failsafe_phase(torch, mv, cr, dev, seed: int) -> dict:
    """[failsafe] on the PS path in one process: the PS rounds
    (``ps_phase``) in a world a turn of FS_TURNS on the default engine and
    on ``-mv_engine_shards=1``, the chaos turns under FS_SPEC: every GetRows
    equal to the oracle, the final tables bitwise the clean turn's, the
    dedup, retry and every armed site's counters moved; the deadline drill;
    the PS rounds at ``-mv_deadline_s`` 0 and 30 in turns."""
    from multiverso_tpu_torch.failsafe.errors import DeadlineExceeded
    out = {"engines": {}}
    for engine, eflags in (("default", ()),
                           ("one", ("-mv_engine_shards=1",))):
        turns, clean = [], None
        for turn in FS_TURNS:
            flags = list(eflags) + (list(FS_CHAOS) if turn == "chaos"
                                    else [])
            c0 = fs_counts()
            stats, final = ps_phase(torch, mv, cr, dev, seed, flags)
            moved = fs_delta(c0, fs_counts())
            if turn == "chaos":
                fs_check_counts(f"[failsafe] {engine} chaos turn", moved,
                                FS_SITES)
            elif any(moved[k] for k in moved):
                raise AssertionError(f"[failsafe] a clean turn moved the "
                                     f"failsafe counters: {moved}")
            if clean is None:
                clean = final
            for k in ("add", "momentum"):
                if not np.array_equal(final[k], clean[k]):
                    raise AssertionError(f"[failsafe] {engine} {turn} turn: "
                                         f"the {k} table differs from the "
                                         f"clean turn's")
            del final
            turns.append({"turn": turn, "engine": stats["engine"],
                          "add_round_ms": stats["add_round_ms"],
                          "momentum_round_ms": stats["momentum_round_ms"],
                          "round_median_ms": float(np.median(
                              np.add(stats["add_round_ms"],
                                     stats["momentum_round_ms"]))),
                          "counters": moved})
        del clean
        out["engines"][engine] = turns
    # the deadline drill: the engine's window apply stalls FS_DELAY_S under
    # a deadline of FS_DEADLINE_S
    from multiverso_tpu_torch.tables import MatrixTableOption
    mv.MV_Init([f"-mv_deadline_s={FS_DEADLINE_S}",
                f"-chaos_spec=apply.delay:1.0@{FS_DELAY_S}"])
    try:
        add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                  num_cols=PS_COLS))
        ids = np.random.default_rng([seed, 1500]).choice(
            PS_ROWS, PS_IDS, replace=False).astype(np.int32)
        d0 = counter("failsafe.deadline_exceeded")
        t0 = time.perf_counter()
        try:
            add.GetRows(ids)
        except DeadlineExceeded as exc:
            raised_s = time.perf_counter() - t0
            text = str(exc)
        else:
            raise AssertionError("[failsafe] the stalled GetRows returned")
        moved = counter("failsafe.deadline_exceeded") - d0
    finally:
        t0 = time.perf_counter()
        mv.MV_ShutDown()
        shutdown_s = time.perf_counter() - t0
    fs_quiet_engine()
    if not FS_DEADLINE_S <= raised_s <= 2.0:
        raise AssertionError(f"[failsafe] the deadline fired after "
                             f"{raised_s:.3f} s, outside [{FS_DEADLINE_S}, "
                             f"2.0]")
    titles = [ln[3:-3] for ln in text.splitlines()
              if ln.startswith("-- ") and ln.endswith(" --")]
    if titles != ["threads", "engine", "in-flight requests", "telemetry",
                  "flight"]:
        raise AssertionError(f"[failsafe] the bundle's sections: {titles}")
    msg_id = text.split("reply to msg_id ", 1)[1].split()[0]
    if f"waiting on msg_ids [{msg_id}]" not in text:
        raise AssertionError(f"[failsafe] the bundle does not name the "
                             f"waiting msg_id {msg_id}")
    if moved != 1:
        raise AssertionError(f"[failsafe] failsafe.deadline_exceeded moved "
                             f"by {moved}, not 1")
    if shutdown_s > FS_SHUTDOWN_S:
        raise AssertionError(f"[failsafe] MV_ShutDown took {shutdown_s:.3f}"
                             f" s on the stalled engine (bound "
                             f"{FS_SHUTDOWN_S} s)")
    out["drill"] = {"raised_s": raised_s, "shutdown_s": shutdown_s,
                    "bundle_chars": len(text), "msg_id": int(msg_id)}
    # the bounded waits' cost: the PS rounds at -mv_deadline_s 0 and 30
    dl = []
    for turn in FS_DEADLINE_TURNS:
        flags = ["-mv_deadline_s=30"] if turn == "on" else []
        stats, final = ps_phase(torch, mv, cr, dev, seed, flags)
        del final
        dl.append({"turn": turn, "round_ms": [
            float(x) for x in np.add(stats["add_round_ms"],
                                     stats["momentum_round_ms"])]})
    out["deadline_turns"] = dl
    return out


def report_failsafe(fs: dict, card: str) -> None:
    for engine, turns in fs["engines"].items():
        for t in turns:
            log(f"[failsafe] {engine} engine ({t['engine']}) {t['turn']} "
                f"turn: PS round (AddRows + GetRows of {PS_IDS} ids on the "
                f"add and the momentum table) median "
                f"{t['round_median_ms']:.4f} ms (add "
                f"{[round(x, 4) for x in t['add_round_ms']]}, momentum "
                f"{[round(x, 4) for x in t['momentum_round_ms']]}); "
                f"counters {t['counters']} ({card})")
    log(f"[failsafe] chaos {','.join(FS_CHAOS)}: every GetRows == the oracle"
        f" (add exact, momentum rtol 1e-6), the final tables bitwise the "
        f"clean turn's on both engines; dedup, retry and every armed site's "
        f"counters moved in every chaos turn")
    d = fs["drill"]
    log(f"[failsafe] deadline drill (-mv_deadline_s={FS_DEADLINE_S}, "
        f"apply.delay:1.0@{FS_DELAY_S}): GetRows raised DeadlineExceeded "
        f"after {d['raised_s']:.4f} s with the bundle's five sections and "
        f"msg_id {d['msg_id']} ({d['bundle_chars']} chars); "
        f"failsafe.deadline_exceeded moved by 1; MV_ShutDown "
        f"{d['shutdown_s']:.4f} s ({card})")
    for t in fs["deadline_turns"]:
        log(f"[failsafe] -mv_deadline_s={30 if t['turn'] == 'on' else 0}: "
            f"PS round median {np.median(t['round_ms']):.4f} ms "
            f"{[round(x, 4) for x in t['round_ms']]} ({card})")


def fs_2proc_rank(rank: int, port: int, seed: int, out: str) -> int:
    """One rank of [ps_2proc chaos] (``--rank-child R --child-phase fs``):
    the PS shape on an add and a momentum table, [ps_2proc]'s 5 rounds of
    AddRows + GetRows of each rank's 10,000 ids, in a world a turn of
    FS_TURNS at ``-mv_deadline_s=60`` (the window exchanges through the
    bounded runner), the chaos turns under FS_CHAOS plus
    ``wire.bitflip:0.05`` on the default wire: every GetRows equal to the
    oracle of both ranks' Adds, the final tables' digest (the parent holds
    it across the ranks and the turns); then the rounds at
    ``-mv_deadline_s`` 0 and 30 in turns. Writes its measurements and
    launch counts to ``out``."""
    import hashlib

    import torch
    try:
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch.ops import cuda_rows as cr
        from multiverso_tpu_torch.parallel import multihost
        from multiverso_tpu_torch.updaters.base import AddOption
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    base = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2"]
    batches = [[ps2_batch(seed, r, k) for r in range(PS_ROUNDS)]
               for k in range(2)]
    expect, oracle_add, oracle_mom = ps2_oracle(batches, 0.5)
    mopt = AddOption(momentum=0.5)
    res = {"rank": rank, "turns": [], "deadline_turns": []}
    cr.reset_launches()

    def rounds(flags, final: bool) -> tuple:
        mv.MV_Init(base + flags)
        try:
            wire = multihost.wire_name()
            add, mom = ps_tables(mv)
            ms = []
            for r, (ids, deltas) in enumerate(batches[rank]):
                t0 = time.perf_counter()
                add.AddRows(ids, deltas)
                got_add = add.GetRows(ids)
                mom.AddRows(ids, deltas, mopt)
                got_mom = mom.GetRows(ids)
                ms.append((time.perf_counter() - t0) * 1e3)
                np.testing.assert_array_equal(got_add, expect[r][rank][0])
                np.testing.assert_allclose(got_mom, expect[r][rank][1],
                                           rtol=1e-6, atol=1e-6)
            digest = None
            if final:
                fa, fm = add.Get(), mom.Get()
                np.testing.assert_array_equal(fa, oracle_add)
                np.testing.assert_allclose(fm, oracle_mom, rtol=1e-6,
                                           atol=1e-6)
                digest = hashlib.sha256(fa.tobytes()
                                        + fm.tobytes()).hexdigest()
                del fa, fm
            torch.cuda.synchronize()
            if cr.read_error(dev) != 0:
                raise AssertionError("error word set on the chaos path")
        finally:
            mv.MV_ShutDown(finalize_net=False)
        return ms, digest, wire

    for turn in FS_TURNS:
        flags = ["-mv_deadline_s=60"]
        if turn == "chaos":
            flags += [f"-chaos_spec={FS_SPEC},wire.bitflip:0.05",
                      *FS_CHAOS[1:]]
        c0 = fs_counts()
        ms, digest, wire = rounds(flags, True)
        moved = fs_delta(c0, fs_counts())
        if wire != "shm":
            raise AssertionError(f"[ps_2proc chaos] rode {wire}, not shm")
        if turn == "chaos":
            fs_check_counts(f"[ps_2proc chaos] rank {rank}", moved,
                            FS_SITES + ("wire.bitflip",))
            if not 0 < moved["chaos.wire.bitflip"] <= moved["wire.crc_failures"]:
                raise AssertionError(f"[ps_2proc chaos] rank {rank}: "
                                     f"flipped frames not caught: {moved}")
        res["turns"].append({"turn": turn, "round_ms": ms,
                             "digest": digest, "counters": moved})
    for turn in FS_DEADLINE_TURNS:
        flags = ["-mv_deadline_s=30"] if turn == "on" else []
        ms, _, _ = rounds(flags, False)
        res["deadline_turns"].append({"turn": turn, "round_ms": ms})
    res["launches"] = dict(cr.LAUNCHES)
    multihost.net_finalize()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def fs_2proc_phase(seed: int, workdir: str) -> dict:
    """[ps_2proc chaos]: both ranks (``fs_2proc_rank``); the final tables
    bitwise equal across the ranks and across every turn; each rank
    launching all three kernels."""
    ranks = rank_children("fs", seed, workdir)
    digests = {t["digest"] for r in ranks for t in r["turns"]}
    if len(digests) != 1:
        raise AssertionError(f"[ps_2proc chaos] the final tables differ "
                             f"across the ranks or the turns: {digests}")
    for r in ranks:
        for k, n in r["launches"].items():
            if n == 0:
                raise AssertionError(f"[ps_2proc chaos] rank {r['rank']} "
                                     f"never launched {k}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    return {"ranks": ranks, "launches": launches}


def report_fs_2proc(fs2: dict, card: str) -> None:
    for r in fs2["ranks"]:
        med = {}
        for t in r["turns"]:
            med.setdefault(t["turn"], []).append(
                float(np.median(t["round_ms"])))
        log(f"[ps_2proc chaos] rank {r['rank']}: PS round medians "
            + ", ".join(f"{t['turn']} {np.median(t['round_ms']):.4f}"
                        for t in r["turns"])
            + f" ms (chaos / clean {np.median(med['chaos']) / np.median(med['clean']):.4f}); "
            f"chaos counters {[t['counters'] for t in r['turns'] if t['turn'] == 'chaos']} "
            f"({card})")
        log(f"[ps_2proc chaos] rank {r['rank']}: -mv_deadline_s 0 / 30 round "
            f"medians " + ", ".join(
                f"{t['turn']} {np.median(t['round_ms']):.4f}"
                for t in r["deadline_turns"]) + f" ms ({card})")
    log("[ps_2proc chaos] every GetRows == the oracle of both ranks' Adds, "
        "the final tables bitwise equal across the ranks and the turns, "
        "every flipped frame caught by the CRC and re-exchanged")


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
                    help="run one rank of a two-process phase (the script "
                         "starts both itself)")
    ap.add_argument("--child-phase", default="ps",
                    choices=("ps", "mh", "fs", "lr", "we"),
                    help="the two-process phase of --rank-child: "
                         "[ps_2proc]; [ps_2proc apply], [ps_2proc "
                         "compress] and [kv_2proc device]; [ps_2proc "
                         "chaos]; [lr_2proc] or [we_2proc]")
    ap.add_argument("--port", type=int, default=0,
                    help="a two-process phase's rank 0 rendezvous port")
    ap.add_argument("--workdir", default="",
                    help="a two-process phase's data directory")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if args.rank_child >= 0:
        if args.child_phase in ("ps", "mh", "fs"):
            return {"ps": ps_2proc_rank, "mh": mh_2proc_rank,
                    "fs": fs_2proc_rank}[
                args.child_phase](args.rank_child, args.port, args.seed,
                                  args.json_out)
        return {"lr": lr_2proc_rank, "we": we_2proc_rank}[args.child_phase](
            args.rank_child, args.port, args.seed, args.json_out,
            args.workdir)
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
            f"{res['update_gather_rows_bound_ms']:.7f}, plain per-pair "
            f"{res['update_gather_rows_plain_ms']:.7f}, no single library "
            f"call)")
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
    # [failsafe]: seeded chaos on the PS path (both engines), the deadline
    # drill and the bounded waits' cost
    fs = drive("failsafe", lambda: failsafe_phase(torch, mv, cr, dev,
                                                  args.seed), every)
    results["failsafe"] = fs
    report_failsafe(fs, card)
    with tempfile.TemporaryDirectory(prefix="mvt_smoke_") as workdir:
        # [telemetry]: the default-on telemetry against off, the profiler,
        # the metrics snapshot, the byte ledger and the ops endpoint
        tele = drive("telemetry", lambda: telemetry_phase(
            torch, mv, cr, dev, args.seed, workdir), every)
        results["telemetry"] = tele
        for t in tele["turns"]:
            log(f"[telemetry] turn {t['turn']}: PS round (AddRows + GetRows "
                f"of {PS_IDS} ids on the add and the momentum table) median "
                f"{t['median_ms']:.4f} ms over {len(t['round_ms'])} rounds "
                f"{[round(x, 4) for x in t['round_ms']]}; "
                f"{t['instruments']} instruments registered ({card})")
        log(f"[telemetry] PS round median of the turns' medians: on "
            f"{tele['on_median_ms']:.4f} ms (spread {tele['on_spread']:.4f})"
            f", metrics without the flight ring "
            f"{tele['metrics_median_ms']:.4f} ms (spread "
            f"{tele['metrics_spread']:.4f}), off {tele['off_median_ms']:.4f} "
            f"ms (spread {tele['off_spread']:.4f}); on / off "
            f"{tele['on_over_off']:.4f}, metrics / off "
            f"{tele['metrics_over_off']:.4f}; medians of every timed round: "
            f"on {tele['on_pooled_ms']:.4f}, metrics "
            f"{tele['metrics_pooled_ms']:.4f}, off {tele['off_pooled_ms']:.4f}"
            f" ms ({card})")
        pr = tele["profiler"]
        log(f"[telemetry] MV_StartProfiler around {TELE_PROBE_ROUNDS} "
            f"rounds: {pr['kernel_events']} CUDA kernel events "
            f"{pr['kernel_names']} == the wrappers' launches "
            f"{pr['launched']}; host spans {pr['spans']}; trace "
            f"{pr['trace_mb']:.2f} MB")
        led = tele["ledger"]
        log(f"[telemetry] MV_MetricsSnapshot counts {tele['snapshot_counts']}"
            f" == the verbs issued; ledger device bytes {led['per_table']} "
            f"(the tables' storage), mem.tables.device_bytes "
            f"{led['device_bytes']:.0f} <= memory_allocated "
            f"{led['allocated']}; the probe launched nothing; ops endpoint "
            f"{tele['ops']}")
        # [ps_2proc]: the two ranks count their own launches from zero
        log(f"[ps_2proc] {shm_mount_line()}; the shm wire needs 2 ranks x "
            f"2 channels x 4 MiB at most")
        two = ps_2proc_phase(args.seed, workdir)
        paths["ps_2proc"] = two["launches"]
        results["ps_2proc"] = two
        log(f"[main path] ps_2proc: launches {two['launches']} (both ranks; "
            f"each rank must launch gather_rows, scatter_set_rows, "
            f"update_rows)")
        for r in two["ranks"]:
            share = r["exchange_s"] / r["round_s"]
            log(f"[ps_2proc] rank {r['rank']} of 2 on cuda:0 over "
                f"{r['wire']}, {r['engine']}: 1,000,000 x 50, {PS_ROUNDS} rounds of "
                f"{PS_IDS} ids of its own: add round median "
                f"{np.median(r['add_round_ms']):.3f} ms "
                f"{[round(x, 3) for x in r['add_round_ms']]}, momentum "
                f"round median {np.median(r['momentum_round_ms']):.3f} ms "
                f"{[round(x, 3) for x in r['momentum_round_ms']]}; in the "
                f"window exchanges {r['exchange_s']:.4f} s of "
                f"the rounds' {r['round_s']:.4f} s (share {share:.3f}), "
                f"{r['window_exchanges']} window "
                f"exchanges for {r['window_verbs']} verbs, apply "
                f"{r['engine_apply_s']:.4f} s; BSP round median "
                f"{np.median(r['bsp_round_ms']):.3f} ms; MV_Aggregate "
                f"{[round(x, 4) for x in r['aggregate_s']]} s; launches on "
                f"the PS rounds {r['ps_launches']}, on the whole rank "
                f"{r['launches']}")
        for r in two["ranks"]:
            ts = r["tele"]
            log(f"[ps_2proc telemetry] rank {r['rank']}: round medians "
                + ", ".join(f"{t['turn']} {t['median_ms']:.4f}" for t in ts)
                + f" ms ({card})")
        tl = two["tele"]
        log(f"[ps_2proc telemetry] both ranks: on {tl['on']['median_ms']:.4f}"
            f" ms (spread {tl['on']['spread']:.4f}), off "
            f"{tl['off']['median_ms']:.4f} ms (spread "
            f"{tl['off']['spread']:.4f}); on / off {tl['on_over_off']:.4f}; "
            f"{TELE2_ROUNDS - TELE_WARM} timed rounds a turn after "
            f"{TELE_WARM}; the tables bitwise equal across the turns and "
            f"the ranks ({card})")
        log(critpath_line("[ps_2proc]", two["critpath"], card))
        report_wire_turns(two["ranks"])
        for r in two["ranks"]:
            turns = r["burst"]
            for t in turns:
                log(f"[ps_2proc burst] rank {r['rank']} {t['turn']}: "
                    f"{BURST_VERBS - BURST_WARM} fire-and-forget AddRows of "
                    f"{BURST_IDS} ids a rank reaching the engine as "
                    f"{t['add_messages']} Add messages, {t['verbs']} verbs "
                    f"(both ranks) in {t['exchanges']} windows, "
                    f"{t['wall_s']:.4f} s; the engine's exchange "
                    f"{t['exchange_s']:.4f} s + apply {t['apply_s']:.4f} s "
                    f"= {(t['exchange_s'] + t['apply_s']) / t['wall_s']:.3f}"
                    f" of the burst")
            med = {k: float(np.median([t["wall_s"] for t in turns
                                       if t["turn"] == k]))
                   for k in ("pipeline", "serial", "pipeline_wc0")}
            r["burst_median_s"] = med
            log(f"[ps_2proc burst] rank {r['rank']} median: pipelined "
                f"{med['pipeline']:.4f} s, serial {med['serial']:.4f} s "
                f"(pipelined / serial {med['pipeline'] / med['serial']:.3f})"
                f"; pipelined at -mv_write_combine=0 "
                f"{med['pipeline_wc0']:.4f} s")
        log("[ps_2proc burst] final tables == the oracle of both ranks' "
            "Adds on every turn, bitwise equal across the ranks")
        for r in two["ranks"]:
            sv = r["serve"]
            log(f"[ps_2proc serve] rank {r['rank']}: MV_PublishSnapshot "
                f"{sv['publish_s'] * 1e3:.4f} ms, version {sv['version']} "
                f"(both ranks: {sv['versions']}), residence "
                f"{sv['residence']}; {sv['lookups']} lookups of "
                f"{SERVE_LOOKUP_IDS} ids from 4 threads in "
                f"{sv['lookup_s']:.4f} s, each bitwise the rank's Get at "
                f"the cut; host collective rounds on the lookup path "
                f"{sv['lookup_rounds']}")
        log("[ps_2proc] every GetRows == the oracle of both ranks' Adds "
            "(add exact, momentum rtol 1e-6); final tables bitwise equal "
            "across the ranks; BSP i-th GetRows == the oracle after both "
            "ranks' i-th Adds; MV_Aggregate (2 ranks x 2 threads) == the "
            "exact sum")
        # the rest of the multi-process table surface: the parallel window
        # apply, the window codecs, the KV device verbs (each path's
        # launches zeroed before it in each rank)
        mh = mh_2proc_phase(args.seed, workdir)
        results["mh_2proc"] = mh
        paths.update(mh["launches"])
        for name, counts in mh["launches"].items():
            log(f"[main path] {name}: launches {counts} (both ranks)"
                + (" (the KV device verbs run no row kernel: index_select "
                   "and the segment sums, XLA in the JAX package)"
                   if name == "kv_2proc_device" else ""))
        report_mh_2proc(mh, card)
        # [ps_2proc chaos]: the chaos soak across two ranks (two more
        # ranks, their launches counted from zero)
        fs2 = fs_2proc_phase(args.seed, workdir)
        results["fs_2proc"] = fs2
        paths["fs_2proc"] = fs2["launches"]
        log(f"[main path] fs_2proc: launches {fs2['launches']} (both ranks;"
            f" each rank must launch gather_rows, scatter_set_rows, "
            f"update_rows)")
        report_fs_2proc(fs2, card)
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
        two_k = apps_2proc(torch, cr, dev, args.seed, workdir, lr_data,
                           paths, results)
    # the worker fast paths and the binding after the apps' phases, so the
    # earlier phases run in the process state they ran in before these
    # phases existed (their 1,000,000 x 50 worlds, one of them on the CPU,
    # leave the host's memory otherwise) and stay comparable across runs
    pcomb = drive("ps_combine", lambda: ps_combine_phase(
        torch, mv, cr, dev, args.seed), every)
    results["ps_combine"] = pcomb
    for t in pcomb["turns"]:
        log(f"[ps_combine] {t['turn']} turn (-mv_write_combine="
            f"{COMBINE_CAP if t['turn'] == 'combined' else 0}): "
            f"{BURST_VERBS} fire-and-forget AddRows of {BURST_IDS} ids to "
            f"each of the add and the momentum table, DrainServer: "
            f"{t['burst_s']:.4f} s; the engine received {t['add_messages']} "
            f"Add messages for {2 * BURST_VERBS} pushes, combine hits "
            f"{t['combine_hits']}; add table GetRows == oracle")
    log(f"[ps_combine] telemetry turns (combined): "
        + ", ".join(f"{t['turn']} {t['burst_s']:.4f} s"
                    for t in pcomb["tele_turns"])
        + f"; on median {pcomb['tele_on_median_s']:.4f} s (spread "
        f"{pcomb['tele_on_spread']:.4f}), off "
        f"{pcomb['tele_off_median_s']:.4f} s (spread "
        f"{pcomb['tele_off_spread']:.4f}); tables bitwise equal ({card})")
    log(f"[ps_combine] momentum table bitwise equal across the combined "
        f"turns; card vs the same combined burst on the CPU max abs diff "
        f"{pcomb['momentum_card_vs_cpu_max_abs']:.3g} (rtol 1e-5, atol "
        f"1e-6); the CPU world's engine received "
        f"{pcomb['cpu_add_messages']} Add messages")
    combine_k = time_combined_add(torch, cr, dev, combine_batches(args.seed),
                                  args.seed + 12)
    results["kernels_combined_shape"] = combine_k
    log(f"[kernels] update_rows at the combined Add's shape "
        f"({PS_ROWS + 1}x{PS_COLS + 2}, {combine_k['shape'][2]:.1f} unique "
        f"ids of {COMBINE_CAP} x {BURST_IDS}): kernel == plain bitwise; "
        f"per-pair {combine_k['ms']:.7f} ms, stream "
        f"{combine_k['stream_ms']:.7f} ms (bound {combine_k['bound_ms']:.7f}, "
        f"plain {combine_k['plain_ms']:.7f}, index_add_ "
        f"{combine_k['library_ms']:.7f}, all per-pair), max_abs_err "
        f"{combine_k['max_abs_err']}")
    gcache = drive("ps_get_cache", lambda: ps_get_cache_phase(
        torch, mv, cr, dev, args.seed), rows_and_update)
    results["ps_get_cache"] = gcache
    log(f"[ps_get_cache] -mv_get_staleness={CACHE_STALENESS}: {CACHE_GETS} "
        f"GetRows of {PS_IDS} ids, no Add between: the miss "
        f"{gcache['miss_s'] * 1e3:.4f} ms, {gcache['hits']} hits (median "
        f"{gcache['hit_median_s'] * 1e3:.4f} ms "
        f"{[round(x * 1e3, 4) for x in gcache['hit_s']]}) bitwise the miss, "
        f"no row gather launched; after the worker's own AddRows a miss "
        f"({gcache['after_add_miss_s'] * 1e3:.4f} ms) == the oracle; the "
        f"rows' copy alone: into a new array "
        f"{gcache['copy_new_median_s'] * 1e3:.4f} ms, into one reused "
        f"buffer {gcache['copy_reused_median_s'] * 1e3:.4f} ms (medians)")
    bind = drive("binding", lambda: binding_phase(torch, mv, cr, dev,
                                                  args.seed),
                 rows_and_update)
    results["binding"] = bind
    cabi = drive("binding_c_abi", lambda: c_abi_phase(torch, cr, dev,
                                                      args.seed),
                 rows_and_update)
    results["binding_c_abi"] = cabi
    for label, r in (("Python handlers", bind), ("C ABI", cabi)):
        log(f"[binding] {label} on the card, {PS_ROWS:,} x {PS_COLS}: "
            f"{BINDING_ROUNDS} rounds of {BINDING_ADDS} async row adds of "
            f"{PS_IDS} ids + one get: round median "
            f"{r['round_median_s'] * 1e3:.3f} ms "
            f"{[round(x * 1e3, 3) for x in r['round_s']]}; every get == the "
            f"oracle; combine hits {r['combine_hits']}")
    log(f"[binding] TorchParamManager, 2 worker threads on one table of "
        f"{bind['param_manager_floats']} floats, models on the card: the "
        f"server and both models == base + both deltas")
    # [serve] runs last: no other phase follows its traffic (512 MB host
    # snapshots, nine threads) in this process
    sv = drive("serve", lambda: serve_phase(torch, mv, cr, dev, args.seed),
               every)
    results["serve"] = sv
    serve_k = time_serve_gather(torch, cr, dev,
                                sv["traffic"]["frontend"]["mean_batch"],
                                args.seed + 11)
    results["kernels_serve_shape"] = serve_k
    report_serve(sv, serve_k, paths["serve"], card)
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
                + ([touched[k]["max_abs_err"]] if k in touched else [])
                + ([serve_k["max_abs_err"]] if k == "gather_rows" else [])
                + ([combine_k["max_abs_err"]] if k == "update_rows" else [])
                + [s[k]["max_abs_err"] for s in two_k.values() if k in s]),
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
        for name, shapes in two_k.items():
            if k in shapes:
                entry[name] = {key: shapes[k][key] for key in (
                    "ms", "stream_ms", "plain_ms", "library_ms",
                    "max_abs_err", "bound_ms", "shape")}
        if k == "gather_rows":
            # a device-resident snapshot's union gather ([serve])
            entry["serve"] = dict({key: serve_k[key] for key in (
                "ms", "stream_ms", "plain_ms", "library_ms", "max_abs_err",
                "bound_ms", "shape")}, launches=paths["serve"][k],
                device_resident_launches=results["serve"]["device_gathers"])
        if k == "update_rows":
            # a combined Add ([ps_combine], [binding])
            entry["ps_combine"] = {key: combine_k[key] for key in (
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
