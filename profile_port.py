#!/usr/bin/env python3
"""Where the time goes: the port's two main paths under torch.profiler.

    python3 profile_port.py [--seed N] [--out DIR] [--paths a,b,...]

On one CUDA device, after a warm-up, profiles (CPU + CUDA activities)

* PS: 5 rounds of AddRows + GetRows of 10,000 random rows on a
  1,000,000 x 50 add-updater MatrixTable through the engine (host clock),
  then the same rounds' server-side work (ProcessAdd + ProcessGet) on
  the calling thread under the profiler;
* PS threads: THREAD_ROUNDS rounds from 4 worker threads on an add and
  an sgd table, each worker on rows of its own, through the default
  engine (the ShardedServer: the two tables on two shard threads sharing
  the card's one stream) and through ``-mv_engine_shards=1`` (one engine
  thread), in turns (THREAD_TURNS: default, one, one, default, twice),
  with the pairs of turns each engine won;
* WE: ``train()`` of three WordEmbedding runs of chip_smoke.py: ``we``
  (100,000 x 128, 3 blocks, -device_plane 1), ``we_pairs`` (the same with
  -device_pairs 1: pairs made on the card) and ``we_pairs_adagrad``
  (1,000,000 x 128, -device_pairs 1 -use_adagrad 1: the touched-rows
  step on the row gather and scatter-set),
* LR: ``Train()`` of each LogisticRegression run of chip_smoke.py (dense
  softmax on both planes, sparse sigmoid and softmax, FTRL), after one
  unprofiled warm-up run of the sparse sigmoid configuration; then,
  without the profiler, the first epoch of each sparse-text run with the
  native libsvm reader and with the Python line parser in turns;
* ckpt: chip_smoke.py's [ckpt] tables (1,000,000 x 50 momentum, 47,236 x
  1 sgd) after its rounds: ``MV_SaveCheckpoint`` (the serialization on
  the engine thread) and, in a new world, ``MV_LoadCheckpoint`` under
  the profiler; then the same serialization and load on this thread
  under cProfile, for the Python functions the host time goes to;
* ps_compress: chip_smoke.py's [ps_compress] rounds on the
  ``compress="sparse"`` table and its uncompressed twin by the host
  clock, in turns (PS_TURNS: compressed, plain, plain, compressed), then
  the compressed rounds' worker-side compression and server-side work
  (ProcessAdd of the compressed payload + ProcessGet) on this thread
  under the profiler;
* ps_2proc: chip_smoke.py's [ps_2proc] PS rounds in a world of two ranks
  of this script (``--rank-child``) on the one card over gloo, the add and
  momentum tables at the PS shape: after 3 warm-up rounds, 5 rounds, rank
  0 under the profiler and rank 1 beside it, with the engine's seconds in
  the window exchange and in the apply,
* bsp: chip_smoke.py's [bsp] phase (one process, 4 worker threads,
  ``-sync=true``) BSP_WORLDS times in each of a row of processes by the
  host clock, no profiler; with ``--baseline DIR`` (another checkout, e.g.
  the parent commit unpacked with ``git archive``) the processes take
  turns (BSP_TURNS: baseline, this, this, baseline, twice), each
  importing its checkout's package under this script's phase,

and prints, per path, the wall seconds, the device-busy seconds (the sum
of the self device time of every op: kernels and copies on the one
stream), the device-idle share, and the ops with the most device and the
most host time, for WE the seconds the trainer waited on the block
loader, and for LR the seconds of the first epoch (which parses the text)
and of the later ones (replayed from the epoch cache). The PS Chrome trace and a JSON summary land in DIR (default
chiprun_out/profile). ``--paths`` picks some of ps, ps_threads, we, lr,
parse, ckpt, ps_compress, ps_2proc, bsp (default: all).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np


def summarize(torch, prof, wall_s: float, top: int = 6) -> dict:
    """Device-busy seconds = the summed spans of the device-side events
    (kernels, copies, memsets: one stream, so they never overlap); the
    top lists name device-side events and host-side ops."""
    from torch.autograd import DeviceType
    events = prof.events()
    busy_us = sum(e.time_range.elapsed_us() for e in events
                  if e.device_type == DeviceType.CUDA)
    dev_tot, host_tot = {}, {}
    for e in events:
        tot = dev_tot if e.device_type == DeviceType.CUDA else host_tot
        n, us = tot.get(e.name, (0, 0.0))
        tot[e.name] = (n + 1, us + (e.time_range.elapsed_us()
                                    if tot is dev_tot
                                    else e.self_cpu_time_total))

    def head(tot):
        return [(k[:90], n, us / 1e3) for k, (n, us) in
                sorted(tot.items(), key=lambda kv: -kv[1][1])[:top]]

    return {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "top_device_ms": head(dev_tot), "top_host_ms": head(host_tot)}


def profile_ps(torch, seed: int, out: str) -> dict:
    """Engine rounds by the host clock, then the same rounds' server-side
    work (ProcessAdd + ProcessGet) called on this thread under the
    profiler: the difference is the worker + mailbox + engine share."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    from chip_smoke import PS_COLS, PS_IDS, PS_ROWS
    rng = np.random.default_rng(seed)
    mv.MV_Init([])
    try:
        t = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                num_cols=PS_COLS))
        srv = t.server()
        batches = [(rng.choice(PS_ROWS, PS_IDS, replace=False).astype(
            np.int32), rng.integers(-3, 4, (PS_IDS, PS_COLS)).astype(
                np.float32)) for _ in range(8)]
        for ids, d in batches[:3]:               # warm-up
            t.AddRows(ids, d)
            t.GetRows(ids)
        t0 = time.perf_counter()
        for ids, d in batches[3:]:
            t.AddRows(ids, d)
            t.GetRows(ids)
        round_ms = (time.perf_counter() - t0) / 5 * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for ids, d in batches[3:]:
                srv.ProcessAdd(values=d, row_ids=ids)
                srv.ProcessGet(row_ids=ids)
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(os.path.join(out, "ps_trace.json"))
    finally:
        mv.MV_ShutDown()
    res = summarize(torch, prof, wall)
    res["round_ms"] = round_ms
    res["server_ms_per_round"] = wall / 5 * 1e3
    return res


def top_functions(prof, top: int = 8) -> list:
    """A cProfile run's functions with the most own time: (name, calls,
    seconds)."""
    import pstats
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [(f"{os.path.basename(file)}:{line}({name})"[:90], calls, tt)
            for (file, line, name), (_, calls, tt, _, _) in rows]


def profile_ckpt(torch, seed: int) -> dict:
    """chip_smoke.py's [ckpt] save and load at the PS shape: the device
    view under torch.profiler, then the host view of the same work on
    this thread under cProfile."""
    import cProfile
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import checkpoint
    from multiverso_tpu_torch.zoo import Zoo
    from chip_smoke import (PS_ROUNDS, ckpt_batches, ckpt_rounds,
                            ckpt_tables)
    batches = ckpt_batches(seed, PS_ROUNDS)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    res = {}
    with tempfile.TemporaryDirectory(prefix="mvt_prof_ckpt_") as workdir:
        path = os.path.join(workdir, "ckpt.mvt")
        for what in ("save", "load"):
            mv.MV_Init([])
            try:
                tables = ckpt_tables(mv)
                if what == "save":
                    ckpt_rounds(tables, batches)
                torch.cuda.synchronize()
                call = (mv.MV_SaveCheckpoint if what == "save"
                        else mv.MV_LoadCheckpoint)
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    call(path)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                res[what] = summarize(torch, prof, wall)
                host = cProfile.Profile()
                t0 = time.perf_counter()
                host.enable()
                if what == "save":
                    checkpoint._serialize_to_bytes(path,
                                                   Zoo.Get().server_tables)
                else:
                    checkpoint.load_checkpoint(path)
                host.disable()
                res[what]["host_s"] = time.perf_counter() - t0
                res[what]["top_host_functions"] = top_functions(host)
            finally:
                mv.MV_ShutDown()
        res["file_bytes"] = os.path.getsize(path)
    return res


#: [ps_compress]'s tables in turns
PS_TURNS = ("sparse", None, None, "sparse")


def profile_ps_compress(torch, seed: int) -> dict:
    """[ps_compress]'s rounds by the host clock on both twins in turns,
    then the compressed rounds' two halves on this thread: the worker's
    compression (host) and the server's ProcessAdd + ProcessGet under the
    profiler."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    from chip_smoke import PS_COLS, PS_ROWS, compress_batch
    rng = np.random.default_rng([seed, 400])
    batches = [compress_batch(rng) for _ in range(8)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    mv.MV_Init([])
    try:
        twins = {c: mv.MV_CreateTable(MatrixTableOption(
            num_rows=PS_ROWS, num_cols=PS_COLS, compress=c))
            for c in (None, "sparse")}
        for t in twins.values():                 # warm-up
            for ids, d in batches[:3]:
                t.AddRows(ids, d)
                t.GetRows(ids)
        turns = []
        for c in PS_TURNS:
            t0 = time.perf_counter()
            for ids, d in batches[3:]:
                twins[c].AddRows(ids, d)
                twins[c].GetRows(ids)
            turns.append(((time.perf_counter() - t0) / 5 * 1e3,
                          c or "plain"))
        t, srv = twins["sparse"], twins["sparse"].server()
        t0 = time.perf_counter()
        comps = [t._compressed_payload(ids, d) for ids, d in batches[3:]]
        compress_ms = (time.perf_counter() - t0) / 5 * 1e3
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for comp in comps:
                srv.ProcessAdd(compressed=comp)
                srv.ProcessGet(row_ids=comp["row_ids"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        mv.MV_ShutDown()
    res = summarize(torch, prof, wall)
    res["turns_ms"] = turns
    res["compress_ms_per_round"] = compress_ms
    res["server_ms_per_round"] = wall / 5 * 1e3
    return res


#: the threaded PS profile's engines in turns, and its rounds per worker
THREAD_TURNS = ("default", "one", "one", "default") * 2
THREAD_ROUNDS = 20
ENGINE_ARGV = {"default": [], "one": ["-mv_engine_shards=1"]}


def profile_ps_threads(torch, seed: int, argv) -> dict:
    """THREAD_ROUNDS rounds (AddRows + GetRows on both tables) from
    PS_WORKERS threads under the profiler, on the engine ``argv``
    selects."""
    import threading
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.zoo import Zoo
    from chip_smoke import (PS_COLS, PS_IDS, PS_ROWS, PS_WORKERS,
                            engine_info, run_threads)
    mv.MV_Init([f"-num_workers={PS_WORKERS}"] + list(argv))
    try:
        tables = [mv.MV_CreateTable(MatrixTableOption(
            num_rows=PS_ROWS, num_cols=PS_COLS, updater_type=u))
            for u in (None, "sgd")]
        info = engine_info()
        batches = []
        for w in range(PS_WORKERS):
            rng = np.random.default_rng([seed, w])
            rows = np.arange(w, PS_ROWS, PS_WORKERS)
            batches.append([(rng.choice(rows, PS_IDS, replace=False).astype(
                np.int32), rng.integers(-3, 4, (PS_IDS, PS_COLS)).astype(
                    np.float32)) for _ in range(THREAD_ROUNDS + 3)])
        round_ms = []
        lock = threading.Lock()

        def rounds(w, first, last, timed):
            with Zoo.Get().worker_context(w):
                for ids, d in batches[w][first:last]:
                    t0 = time.perf_counter()
                    for t in tables:
                        t.AddRows(ids, d)
                        t.GetRows(ids)
                    if timed:
                        with lock:
                            round_ms.append((time.perf_counter() - t0) * 1e3)

        run_threads(lambda w: rounds(w, 0, 3, False), PS_WORKERS)  # warm-up
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_threads(lambda w: rounds(w, 3, 3 + THREAD_ROUNDS, True),
                        PS_WORKERS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        mv.MV_ShutDown()
    res = summarize(torch, prof, wall)
    res.update(info, round_median_ms=float(np.median(round_ms)),
               rounds_per_s=PS_WORKERS * THREAD_ROUNDS / wall)
    return res


#: the WordEmbedding runs of chip_smoke.py that are profiled
WE_RUNS = ("we", "we_pairs", "we_pairs_adagrad")


def profile_we(torch, seed: int) -> dict:
    from chip_smoke import we_options, we_run_table, write_zipf_corpus
    from multiverso_tpu_torch.models.wordembedding.distributed import \
        DistributedWordEmbedding
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    res = {}
    with tempfile.TemporaryDirectory(prefix="mvt_prof_") as workdir:
        runs = we_run_table(workdir, seed, write_zipf_corpus(workdir, seed))
        for name in WE_RUNS:
            kw = runs[name][2]
            vocab, corpus, words = kw["corpus_files"]
            opt = we_options(workdir, seed, vocab, corpus,
                             kw.get("device_plane", True),
                             kw.get("extra", ()))
            we = DistributedWordEmbedding(opt)
            try:
                we.prepare()
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    we.train()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                we.close()
            res[name] = dict(summarize(torch, prof, wall),
                             loader_wait_s=we.loader_wait_s,
                             words_per_s=words / wall)
            if we.dp_trainer is not None:
                res[name]["batches"] = we.dp_trainer.batches
    return res


def profile_lr(torch, seed: int) -> dict:
    from chip_smoke import lr_runs, lr_samples
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    res = {}
    with tempfile.TemporaryDirectory(prefix="mvt_prof_lr_") as workdir:
        runs = lr_runs(workdir, seed, lr_samples(seed))
        for i, name in enumerate(["lr_sparse"] + list(runs)):
            app = LogReg(runs[name][2])
            try:
                torch.cuda.synchronize()
                with (torch.profiler.profile(activities=acts) if i
                      else contextlib.nullcontext()) as prof:
                    t0 = time.perf_counter()
                    app.Train()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                app.close()
            if i:                                   # not the warm-up
                secs = [s for _, _, s in app.epoch_log]
                res[name] = dict(summarize(torch, prof, wall),
                                 first_epoch_s=secs[0],
                                 later_epochs_s=sum(secs[1:]))
    return res


#: the sparse-text LR runs whose first epoch is timed with each parser,
#: and the parsers' turns
PARSE_RUNS = ("lr_sparse", "lr_softmax", "lr_ftrl")
PARSE_TURNS = ("native", "python", "python", "native") * 2


def parse_turns(torch, seed: int) -> dict:
    """The first epoch (the text parse, window staging, the first upload)
    of each sparse-text LR run with the native library (the libsvm reader;
    for FTRL also the KV slot index) and without it (``native.lib``
    hidden: the Python line parser and the numpy index), in turns, no
    profiler: name -> "native" | "python" -> the first epoch's seconds per
    turn."""
    from chip_smoke import lr_runs, lr_samples
    from multiverso_tpu_torch import native
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    res = {name: {"native": [], "python": []} for name in PARSE_RUNS}
    lib = native.lib
    lib()                               # built and loaded before the turns
    with tempfile.TemporaryDirectory(prefix="mvt_prof_parse_") as workdir:
        runs = lr_runs(workdir, seed, lr_samples(seed))
        for turn in PARSE_TURNS:
            for name in PARSE_RUNS:
                native.lib = lib if turn == "native" else (lambda: None)
                try:
                    app = LogReg(runs[name][2])
                    try:
                        app.Train()
                    finally:
                        app.close()
                finally:
                    native.lib = lib
                res[name][turn].append(app.epoch_log[0][2])
    return res


def ps_2proc_rank(torch, rank: int, port: int, seed: int, out: str) -> int:
    """One rank of the ps_2proc profile (``--rank-child``): rounds of
    chip_smoke.py's [ps_2proc] on both tables, the measured ones under the
    profiler on rank 0."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.updaters.base import AddOption
    from multiverso_tpu_torch.zoo import Zoo
    from chip_smoke import PS_COLS, PS_ROUNDS, PS_ROWS, ps2_batch
    mv.MV_Init([f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
                "-dist_size=2"])
    try:
        add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                  num_cols=PS_COLS))
        mom = mv.MV_CreateTable(MatrixTableOption(
            num_rows=PS_ROWS, num_cols=PS_COLS, updater_type="momentum"))
        mopt = AddOption(momentum=0.5)
        eng = Zoo.Get().server_engine

        def rounds(first: int, n: int) -> float:
            t0 = time.perf_counter()
            for r in range(first, first + n):
                ids, deltas = ps2_batch(seed, r, rank)
                add.AddRows(ids, deltas)
                add.GetRows(ids)
                mom.AddRows(ids, deltas, mopt)
                mom.GetRows(ids)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        rounds(0, 3)                                   # warm-up
        x0, a0 = eng.xw_busy_s, eng.apply_busy_s
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = None
        # the ranks meet once the profiler runs, so neither's rounds
        # include the other's profiler start
        if rank == 0:
            with torch.profiler.profile(activities=acts) as prof:
                mv.MV_Barrier()
                wall = rounds(3, PS_ROUNDS)
        else:
            mv.MV_Barrier()
            wall = rounds(3, PS_ROUNDS)
        res = summarize(torch, prof, wall) if prof is not None else {
            "wall_s": wall}
        res.update(rank=rank, round_ms=wall / PS_ROUNDS * 1e3,
                   engine_xw_s=eng.xw_busy_s - x0,
                   engine_apply_s=eng.apply_busy_s - a0)
    finally:
        mv.MV_ShutDown()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def profile_ps_2proc(seed: int, out: str) -> dict:
    """Both ranks of the ps_2proc profile; returns rank 0's profile with
    rank 1's round time."""
    import socket
    import subprocess
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    outs = [os.path.join(out, f"ps_2proc_rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-child", str(r),
         "--port", str(port), "--seed", str(seed), "--out", outs[r]])
        for r in range(2)]
    try:
        for r, p in enumerate(procs):
            if p.wait(600) != 0:
                raise AssertionError(f"ps_2proc rank {r} failed "
                                     f"(exit {p.returncode})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return dict(ranks[0], rank1_round_ms=ranks[1]["round_ms"])


def bsp_child(torch, root: str, seed: int, out: str) -> int:
    """One process of the bsp turns: ``root``'s package under
    chip_smoke.py's [bsp] phase (this script's copy), BSP_WORLDS worlds;
    writes each world's round median."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(root))
    spec = importlib.util.spec_from_file_location(
        "smoke_phases", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.ops import cuda_rows as cr
    if not mv.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {mv.__file__}, not {root}'s package")
    dev = torch.device("cuda", 0)
    medians = [smoke.bsp_phase(torch, mv, cr, dev, seed)["round_median_ms"]
               for _ in range(BSP_WORLDS)]
    with open(out, "w") as f:
        json.dump({"root": root, "round_median_ms": medians}, f)
    return 0


def bsp_turns(seed: int, out: str, baseline: str) -> list:
    """The bsp processes in turns; returns each turn's world medians."""
    import subprocess
    roots = {"this": os.path.dirname(os.path.abspath(__file__)),
             "baseline": baseline}
    res = []
    for i, who in enumerate(BSP_TURNS if baseline else ("this",) * 2):
        path = os.path.join(out, f"bsp_turn{i}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--bsp-child", roots[who], "--seed", str(seed),
                        "--out", path], check=True, timeout=600)
        with open(path) as f:
            res.append(dict(json.load(f), turn=who))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/profile")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="the paths to profile, comma-separated")
    ap.add_argument("--rank-child", type=int, default=-1,
                    help="run one rank of the ps_2proc profile (the script "
                         "starts both itself)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--baseline", default="",
                    help="bsp: another checkout whose package takes turns "
                         "with this one's")
    ap.add_argument("--bsp-child", default="",
                    help="run one process of the bsp turns on this "
                         "checkout's package (the script starts them)")
    args = ap.parse_args()
    if args.rank_child >= 0:
        import torch
        return ps_2proc_rank(torch, args.rank_child, args.port, args.seed,
                             args.out)
    if args.bsp_child:
        import torch
        return bsp_child(torch, args.bsp_child, args.seed, args.out)
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS)
    if unknown:
        ap.error(f"unknown paths {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    from chip_smoke import card_line
    card = card_line()
    print(card, flush=True)
    runs = {"ps": lambda: profile_ps(torch, args.seed, args.out),
            "ps_threads": lambda: [
                dict(profile_ps_threads(torch, args.seed, ENGINE_ARGV[name]),
                     turn=name) for name in THREAD_TURNS],
            "we": lambda: profile_we(torch, args.seed),
            "lr": lambda: profile_lr(torch, args.seed),
            "parse": lambda: parse_turns(torch, args.seed),
            "ckpt": lambda: profile_ckpt(torch, args.seed),
            "ps_compress": lambda: profile_ps_compress(torch, args.seed),
            "ps_2proc": lambda: profile_ps_2proc(args.seed, args.out),
            "bsp": lambda: bsp_turns(args.seed, args.out, args.baseline)}
    res = {"card": card}
    for name in PATHS:
        if name in paths:
            res[name] = runs[name]()
    report(res)
    with open(os.path.join(args.out, "profile.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


#: every path main() can profile, in its order
PATHS = ("ps", "ps_threads", "we", "lr", "parse", "ckpt", "ps_compress",
         "ps_2proc", "bsp")
#: bsp: worlds a process, and the processes' order against a baseline
BSP_WORLDS = 3
BSP_TURNS = ("baseline", "this", "this", "baseline") * 2


def print_tops(path: str, r: dict) -> None:
    for label in ("top_device_ms", "top_host_ms"):
        for key, count, ms in r[label]:
            print(f"[{path}]   {label} {key} x{count}: {ms:.3f} ms",
                  flush=True)


def report(res: dict) -> None:
    """Print each profiled path's lines."""
    turns = res.get("ps_threads", [])
    for i, r in enumerate(turns):
        print(f"[ps_threads] turn {i + 1} {r['turn']}: {r['engine']} live "
              f"slots {r['live_slots']}, worker round median "
              f"{r['round_median_ms']:.3f} ms, {r['rounds_per_s']:.1f} worker "
              f"rounds/s, device busy {r['device_busy_s']:.4f} of "
              f"{r['wall_s']:.4f} s (idle share "
              f"{r['device_idle_share']:.3f}); host "
              + ", ".join(f"{k} x{n} {ms:.3f} ms" for k, n, ms in
                          r["top_host_ms"] if k.startswith(
                              ("cudaMemcpyAsync", "cudaStreamSynchronize"))),
              flush=True)
    if turns:
        by = {name: [r["rounds_per_s"] for r in turns if r["turn"] == name]
              for name in ENGINE_ARGV}
        won = sum(d > o for d, o in zip(by["default"], by["one"]))
        print(f"[ps_threads] worker rounds/s median: default "
              f"{np.median(by['default']):.1f}, one engine "
              f"{np.median(by['one']):.1f}; the default engine won {won} of "
              f"{len(by['one'])} pairs", flush=True)
    for path, r in ([("ps", res["ps"])] if "ps" in res else []) + list(
            res.get("we", {}).items()):
        if path == "ps":
            print(f"[ps] engine round {r['round_ms']:.3f} ms, of which "
                  f"server work {r['server_ms_per_round']:.3f} ms",
                  flush=True)
        else:
            print(f"[{path}] trainer waited {r['loader_wait_s']:.3f} s on "
                  f"the block loader; {r['words_per_s']:.0f} words/s under "
                  f"the profiler"
                  + (f"; {r['batches']} batch steps" if "batches" in r
                     else ""), flush=True)
        print(f"[{path}] wall {r['wall_s']:.4f} s, device busy "
              f"{r['device_busy_s']:.4f} s, idle share "
              f"{r['device_idle_share']:.3f}", flush=True)
        print_tops(path, r)
    for name, r in res.get("lr", {}).items():
        print(f"[{name}] wall {r['wall_s']:.4f} s (first epoch "
              f"{r['first_epoch_s']:.4f} s = "
              f"{r['first_epoch_s'] / r['wall_s']:.3f} of it, later epochs "
              f"{r['later_epochs_s']:.4f} s), device busy "
              f"{r['device_busy_s']:.4f} s, idle share "
              f"{r['device_idle_share']:.3f}", flush=True)
        print_tops(name, r)
    for name, by in res.get("parse", {}).items():
        print(f"[{name}] first epoch in turns "
              f"({', '.join(PARSE_TURNS)}): native reader "
              f"{[round(x, 4) for x in by['native']]} s (median "
              f"{np.median(by['native']):.4f}), Python parser "
              f"{[round(x, 4) for x in by['python']]} s (median "
              f"{np.median(by['python']):.4f})", flush=True)
    if "ckpt" in res:
        for what in ("save", "load"):
            r = res["ckpt"][what]
            print(f"[ckpt] {what} of {res['ckpt']['file_bytes']} bytes: wall "
                  f"{r['wall_s']:.4f} s, device busy {r['device_busy_s']:.4f}"
                  f" s, idle share {r['device_idle_share']:.3f}; the same "
                  f"work on this thread {r['host_s']:.4f} s", flush=True)
            print_tops(f"ckpt {what}", r)
            for key, calls, secs in r["top_host_functions"]:
                print(f"[ckpt {what}]   host function {key} x{calls}: "
                      f"{secs:.4f} s", flush=True)
    if "ps_compress" in res:
        r = res["ps_compress"]
        print(f"[ps_compress] engine rounds in turns: "
              + ", ".join(f"{c} {ms:.3f} ms" for ms, c in r["turns_ms"])
              + f"; the compressed round's halves: worker compression "
              f"{r['compress_ms_per_round']:.3f} ms, server work "
              f"{r['server_ms_per_round']:.3f} ms (wall {r['wall_s']:.4f} s,"
              f" device busy {r['device_busy_s']:.4f} s, idle share "
              f"{r['device_idle_share']:.3f})", flush=True)
        print_tops("ps_compress", r)
    if "ps_2proc" in res:
        r = res["ps_2proc"]
        print(f"[ps_2proc] two ranks on one card over gloo, add + momentum "
              f"round (AddRows + GetRows on both tables): rank 0 "
              f"{r['round_ms']:.3f} ms under the profiler, rank 1 "
              f"{r['rank1_round_ms']:.3f} ms; rank 0's engine: exchange "
              f"{r['engine_xw_s']:.4f} s, apply {r['engine_apply_s']:.4f} s "
              f"of the rounds' {r['wall_s']:.4f} s; device busy "
              f"{r['device_busy_s']:.4f} s, idle share "
              f"{r['device_idle_share']:.3f}", flush=True)
        print_tops("ps_2proc", r)
    turns = res.get("bsp", [])
    for i, r in enumerate(turns):
        print(f"[bsp] turn {i + 1} {r['turn']} ({r['root']}): round medians "
              f"of its {BSP_WORLDS} worlds "
              f"{[round(x, 3) for x in r['round_median_ms']]} ms", flush=True)
    for who in ("this", "baseline"):
        ms = [x for r in turns if r["turn"] == who
              for x in r["round_median_ms"]]
        if ms:
            print(f"[bsp] {who}: median of its worlds' round medians "
                  f"{np.median(ms):.3f} ms, range {min(ms):.3f}-"
                  f"{max(ms):.3f} ms over {len(ms)} worlds", flush=True)


if __name__ == "__main__":
    sys.exit(main())
