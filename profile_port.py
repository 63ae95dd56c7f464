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
  of this script (``--rank-child``) on the one card, one world a wire
  (PS2_WIRES: shm, gloo, shm with two engine shards, tcp; chip_smoke.py's
  ``ps2_wire_flags``), the add and momentum tables at the PS shape: after
  3 warm-up rounds, 5 rounds, rank 0 under the profiler and cProfile
  (which on Python 3.12 sees the engine's exchange threads: the host
  functions the exchange time goes to) and rank 1 beside it, with the
  engine's seconds in the window exchange and in the apply,
* ps_2proc_apply: chip_smoke.py's [ps_2proc apply] burst (the add, sgd,
  momentum and AdaGrad tables at the PS shape, APPLY_ROUNDS rounds of
  fire-and-forget AddRows of BURST_IDS ids a rank to each table in turn,
  then a GetRows of PS_IDS ids on each) in a world of two ranks of this
  script (``--rank-child --child-phase apply``) a turn, at
  ``-mv_apply_workers`` 4 and 1 (APPLY_PROFILE_TURNS): after a warm-up
  burst, rank 0's burst under the profiler and cProfile (on Python 3.12
  it sees the apply pool's threads): device idle, the engine's apply and
  exchange seconds, pool and inline jobs, the host functions; whether
  the interpreter lock serializes the pool's jobs shows as apply seconds
  that do not fall at 4 workers;
* lr_2proc, we_2proc: chip_smoke.py's [lr_2proc] runs (the LR device
  plane, dense and sparse, on unequal shards; FTRL on the collective host
  KV verbs) and [we_2proc] runs (-device_pairs 1 -use_adagrad 1 at
  1,000,000 x 128 on unequal shards, every rank running the global
  blocks; -device_plane 1 at 100,000 x 128) in a world of two ranks of
  this script (``--rank-child --child-phase lr|we``) on the one card over
  gloo, rank 0 under the profiler: per run its device-idle share, the
  seconds of its tagged agreements, of the collective writes'
  device->host copies, all-gathers, host merge and apply, and of the
  engine's window exchanges;
* serve: chip_smoke.py's [serve] tables (1,000,000 x 128, sgd with a
  device-resident snapshot, AdaGrad with a host one) after a publish: one
  thread's lookups of SERVE_LOOKUP_IDS Zipf ids taken apart stage by stage
  by the host clock (the union's ``np.unique``, the ids' lane mapping and
  copy to the card, the ``<kGather>`` launch, the device->host copy that
  waits for it, each caller's ``searchsorted`` slice; the host snapshot's
  row index) for unions of 1 and of SERVE_CLIENTS lookups, beside a whole
  ``MV_ServingLookup``; then SERVE_CLIENTS client threads' lookups for
  SERVE_IDLE_S under the profiler (no trainer); then, without the
  profiler, [serve]'s traffic (trainer and clients) for SERVE_IDLE_S on
  the sgd table alone and beside the AdaGrad table, in turns
  (SERVE_TURNS), for what a host-resident table's publish costs the
  lookups;
* ps_combine: chip_smoke.py's [ps_combine] burst (200 fire-and-forget
  AddRows of 2,000 ids to each of the add and the momentum table at the
  PS shape, then DrainServer) at the default -mv_write_combine and at 0,
  in turns (COMBINE_TURNS), each after an unprofiled warm-up burst, under
  the profiler and cProfile (on Python 3.12 it sees every thread: the
  pushing worker and the engine shards): per turn the burst's seconds,
  device idle, the Add messages the engine received and the host
  functions the time goes to;
* binding: chip_smoke.py's [binding] rounds (8 async row adds of 10,000
  ids and one get on a 1,000,000 x 50 MatrixTable) through the Python
  handlers by the host clock, then through the C ABI (the port's bridge in
  its build of the native library) under the profiler and cProfile;
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
parse, ckpt, ps_compress, ps_2proc, ps_2proc_apply, lr_2proc, we_2proc,
serve, ps_combine, binding, bsp (default: all).
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


def _profiled(torch, fn):
    """``fn()`` under torch.profiler (CPU + CUDA) and cProfile (which on
    Python 3.12 sees every thread of the interpreter); the summary, the
    top host functions and fn's result."""
    import cProfile
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cp = cProfile.Profile()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cp.enable()
        out = fn()
        torch.cuda.synchronize()
        cp.disable()
        wall = time.perf_counter() - t0
    res = summarize(torch, prof, wall)
    res["top_host_functions"] = top_functions(cp)
    return res, out


def profile_ps_combine(torch, seed: int) -> list:
    """[ps_combine]'s burst in COMBINE_TURNS: a world a turn, a warm-up
    burst, then the burst profiled."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.updaters.base import AddOption
    from multiverso_tpu_torch.zoo import Zoo
    from chip_smoke import (COMBINE_TURNS, PS_COLS, PS_ROWS,
                            combine_batches, warm_index_add)
    warm_index_add(torch, torch.device("cuda", 0))
    batches = combine_batches(seed)
    warm = combine_batches(seed + 1)[:16]
    mopt = AddOption(momentum=0.5)
    out = []
    for turn in COMBINE_TURNS:
        mv.MV_Init([] if turn == "combined" else ["-mv_write_combine=0"])
        try:
            add = mv.MV_CreateTable(MatrixTableOption(num_rows=PS_ROWS,
                                                      num_cols=PS_COLS))
            mom = mv.MV_CreateTable(MatrixTableOption(
                num_rows=PS_ROWS, num_cols=PS_COLS, updater_type="momentum"))
            eng = Zoo.Get().server_engine

            def burst(bs):
                for ids, d in bs:
                    add.AddFireForget(d, row_ids=ids)
                    mom.AddFireForget(d, row_ids=ids, option=mopt)
                Zoo.Get().DrainServer()

            burst(warm)
            torch.cuda.synchronize()
            m0 = eng.add_messages
            res, _ = _profiled(torch, lambda: burst(batches))
            res.update(turn=turn, add_messages=eng.add_messages - m0)
        finally:
            mv.MV_ShutDown()
        out.append(res)
    return out


def profile_binding(torch, seed: int) -> dict:
    """[binding]'s rounds through the handlers by the host clock, then
    through the C ABI profiled."""
    import ctypes

    import multiverso_tpu_torch.binding as b
    from multiverso_tpu_torch import native
    from multiverso_tpu_torch.binding import native_bridge
    from chip_smoke import (BINDING_ADDS, BINDING_ROUNDS, PS_COLS, PS_IDS,
                            PS_ROWS)
    g = np.random.default_rng([seed, 1300])
    rounds = [(g.choice(PS_ROWS, PS_IDS, replace=False).astype(np.int32),
               [g.integers(-3, 4, (PS_IDS, PS_COLS)).astype(np.float32)
                for _ in range(BINDING_ADDS)])
              for _ in range(BINDING_ROUNDS + 2)]
    b.init()
    try:
        mat = b.MatrixTableHandler(PS_ROWS, PS_COLS)
        for i, (ids, deltas) in enumerate(rounds):
            if i == 2:                               # after 2 warm-up rounds
                t0 = time.perf_counter()
            for d in deltas:
                mat.add(d, row_ids=ids, sync=False)
            mat.get(ids)
        handler_ms = (time.perf_counter() - t0) / BINDING_ROUNDS * 1e3
    finally:
        b.shutdown()
    lib = native.lib()
    if lib is None:
        raise RuntimeError(f"no native library: {native.last_build_error}")
    fptr, iptr = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    bridge = native_bridge.install(lib)
    argc = ctypes.c_int(1)
    lib.MV_Init(ctypes.byref(argc), (ctypes.c_char_p * 1)(b"profile_port"))
    try:
        handle = ctypes.c_void_p()
        lib.MV_NewMatrixTable(PS_ROWS, PS_COLS, ctypes.byref(handle))
        out = np.zeros((PS_IDS, PS_COLS), np.float32)

        def c_rounds(rs):
            for ids, deltas in rs:
                for d in deltas:
                    lib.MV_AddAsyncMatrixTableByRows(
                        handle, d.ctypes.data_as(fptr), d.size,
                        ids.ctypes.data_as(iptr), PS_IDS)
                lib.MV_GetMatrixTableByRows(
                    handle, out.ctypes.data_as(fptr), out.size,
                    ids.ctypes.data_as(iptr), PS_IDS)

        c_rounds(rounds[:2])
        torch.cuda.synchronize()
        res, _ = _profiled(torch, lambda: c_rounds(rounds[2:]))
    finally:
        lib.MV_ShutDown()
        bridge.uninstall()
    res["c_round_ms"] = res["wall_s"] / BINDING_ROUNDS * 1e3
    res["handler_round_ms"] = handler_ms
    return res


#: the threaded PS profile's engines in turns, and its rounds per worker
THREAD_TURNS = ("default", "one", "one", "default") * 2
THREAD_ROUNDS = 20
ENGINE_ARGV = {"default": [], "one": ["-mv_engine_shards=1"]}


def serve_stages(mv, tables, cdf, lookups: int, reads: int,
                 seed: int) -> dict:
    """Per read of a union of ``lookups`` Zipf lookups, the median host
    milliseconds of each stage of the front-end's serve on each table's
    snapshot (the device snapshot's gather split into the lane mapping,
    the launch and the waiting device->host copy), and of a whole
    ``MV_ServingLookup`` of one lookup."""
    from chip_smoke import SERVE_LOOKUP_IDS, zipf_ids
    from multiverso_tpu_torch import ops
    from multiverso_tpu_torch.serving import get_plane
    g = np.random.default_rng([seed, 960, lookups])
    snap = get_plane().store.get(None)
    out = {}
    for t in tables:
        ts = snap.tables[t.table_id]
        st = {k: [] for k in ("unique", "lanes", "launch", "d2h", "index",
                              "slice", "lookup")}
        for _ in range(reads):
            parts = [zipf_ids(cdf, g, SERVE_LOOKUP_IDS)
                     for _ in range(lookups)]
            t0 = time.perf_counter()
            union = np.unique(np.concatenate(parts))
            t1 = time.perf_counter()
            st["unique"].append(t1 - t0)
            if ts.residence == "device":
                data, _ = ts._dev
                _, ids_t = t.server()._lanes_tensor(union)
                t2 = time.perf_counter()
                rows_t = ops.gather_rows(data, ids_t)
                t3 = time.perf_counter()
                rows_u = rows_t.cpu().numpy()
                t4 = time.perf_counter()
                st["lanes"].append(t2 - t1)
                st["launch"].append(t3 - t2)
                st["d2h"].append(t4 - t3)
            else:
                t3 = time.perf_counter()
                rows_u = ts.lookup_union(union)
                st["index"].append(time.perf_counter() - t3)
            t5 = time.perf_counter()
            for ids in parts:
                rows_u[np.searchsorted(union, ids)]
            st["slice"].append(time.perf_counter() - t5)
            t6 = time.perf_counter()
            mv.MV_ServingLookup(t, parts[0])
            st["lookup"].append(time.perf_counter() - t6)
        out[ts.residence] = {k: float(np.median(v)) * 1e3
                             for k, v in st.items() if v}
    return out


def profile_serve(torch, seed: int) -> dict:
    """The lookups of chip_smoke.py's [serve] path taken apart by stage
    (``serve_stages``), then SERVE_CLIENTS client threads' lookups for
    SERVE_IDLE_S under the profiler."""
    import threading

    import multiverso_tpu_torch as mv
    from chip_smoke import (SERVE_CLIENTS, SERVE_COLS, SERVE_IDLE_S,
                            SERVE_LOOKUP_IDS, SERVE_ROWS, run_threads,
                            serve_batches, serving_stats, zipf_cdf,
                            zipf_ids)
    from multiverso_tpu_torch.tables import MatrixTableOption
    cdf = zipf_cdf(SERVE_ROWS)
    mv.MV_Init([])
    try:
        tables = [mv.MV_CreateTable(MatrixTableOption(
            num_rows=SERVE_ROWS, num_cols=SERVE_COLS, updater_type=u))
            for u in ("sgd", "adagrad")]
        for ids, deltas in serve_batches(seed, 4):
            for t in tables:
                t.AddRows(ids, deltas)
        mv.MV_PublishSnapshot()
        serve_stages(mv, tables, cdf, 1, 20, seed)     # warm-up
        stages = {n: serve_stages(mv, tables, cdf, n, 200, seed)
                  for n in (1, SERVE_CLIENTS)}
        from multiverso_tpu_torch.telemetry import metrics
        s0 = metrics.snapshot()
        counts = [0] * SERVE_CLIENTS

        def client(c):
            g = np.random.default_rng([seed, 970, c])
            t_end = time.perf_counter() + SERVE_IDLE_S
            while time.perf_counter() < t_end:
                mv.MV_ServingLookup(tables[counts[c] % 2],
                                    zipf_ids(cdf, g, SERVE_LOOKUP_IDS))
                counts[c] += 1

        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_threads(client, SERVE_CLIENTS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        res = summarize(torch, prof, wall, top=8)
        res.update(stages=stages, lookups=sum(counts),
                   lookups_per_s=sum(counts) / wall,
                   frontend=serving_stats(s0, metrics.snapshot()),
                   threads=threading.active_count())
    finally:
        mv.MV_ShutDown()
    res["turns"] = [dict(serve_turn(torch, mv, updaters, seed), turn=name)
                    for name, updaters in SERVE_TURNS]
    return res


#: the serve turns: chip_smoke.py's traffic on the sgd table alone (every
#: publish one device clone) and beside the AdaGrad table (every publish
#: also copies 512 MB to host memory), in turns
SERVE_TURNS = (("sgd", ("sgd",)), ("sgd+adagrad", ("sgd", "adagrad")),
               ("sgd+adagrad", ("sgd", "adagrad")), ("sgd", ("sgd",)))


def serve_turn(torch, mv, updaters, seed: int) -> dict:
    """chip_smoke.py's [serve] traffic for SERVE_IDLE_S on a world of
    one SERVE_ROWS x SERVE_COLS table per updater, no profiler."""
    from chip_smoke import (SERVE_COLS, SERVE_IDLE_S, SERVE_PUBLISH_EVERY,
                            SERVE_ROWS, serve_batches, serve_traffic,
                            zipf_cdf)
    from multiverso_tpu_torch.tables import MatrixTableOption
    mv.MV_Init([])
    try:
        tables = tuple(mv.MV_CreateTable(MatrixTableOption(
            num_rows=SERVE_ROWS, num_cols=SERVE_COLS, updater_type=u))
            for u in updaters)
        mv.MV_PublishSnapshot()
        return serve_traffic(mv, tables,
                             serve_batches(seed, SERVE_PUBLISH_EVERY),
                             zipf_cdf(SERVE_ROWS), SERVE_IDLE_S, seed,
                             lambda v: None)
    finally:
        mv.MV_ShutDown()


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


def ps_2proc_rank(torch, rank: int, port: int, seed: int, out: str,
                  wire: str) -> int:
    """One rank of the ps_2proc profile (``--rank-child``) on ``wire``'s
    world: rounds of chip_smoke.py's [ps_2proc] on both tables, the
    measured ones under the profilers on rank 0."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.updaters.base import AddOption
    from multiverso_tpu_torch.zoo import Zoo
    from chip_smoke import (PS_COLS, PS_ROUNDS, PS_ROWS, engine_sum,
                            ps2_batch, ps2_wire_flags)
    flags, want = ps2_wire_flags(wire, rank)
    mv.MV_Init([f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
                "-dist_size=2", *flags])
    try:
        if multihost.wire_name() != want:
            raise AssertionError(f"ps_2proc {wire}: the engine rides "
                                 f"{multihost.wire_name()}, not {want}")
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
        x0 = engine_sum(eng, "xw_busy_s")
        a0 = engine_sum(eng, "apply_busy_s")
        # the ranks meet once the profilers run, so neither's rounds
        # include the other's profiler start
        if rank == 0:
            def measured():
                mv.MV_Barrier()
                return rounds(3, PS_ROUNDS)

            res, wall = _profiled(torch, measured)
        else:
            mv.MV_Barrier()
            wall = rounds(3, PS_ROUNDS)
            res = {"wall_s": wall}
        res.update(rank=rank, wire=multihost.wire_name(),
                   engine=type(eng).__name__,
                   round_ms=wall / PS_ROUNDS * 1e3,
                   engine_xw_s=engine_sum(eng, "xw_busy_s") - x0,
                   engine_apply_s=engine_sum(eng, "apply_busy_s") - a0)
    finally:
        mv.MV_ShutDown()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def profile_ps_2proc(seed: int, out: str) -> list:
    """Both ranks of the ps_2proc profile, one world a wire of PS2_WIRES;
    returns rank 0's profile of each with rank 1's round time."""
    out_ranks = [_two_ranks(seed, out, f"ps_2proc_{wire}",
                            ["--wire", wire]) for wire in PS2_WIRES]
    return [dict(r0, rank1_round_ms=r1["round_ms"]) for r0, r1 in out_ranks]


def _two_ranks(seed: int, out: str, tag: str, extra: list) -> list:
    """Both ranks of a two-process profile (this script's ``--rank-child``
    with ``extra``); returns their JSON results."""
    import socket
    import subprocess
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    outs = [os.path.join(out, f"{tag}_rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-child", str(r),
         "--port", str(port), "--seed", str(seed), "--out", outs[r],
         *extra])
        for r in range(2)]
    try:
        for r, p in enumerate(procs):
            if p.wait(600) != 0:
                raise AssertionError(f"{tag} rank {r} failed "
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
    return ranks


def ps_2proc_apply_rank(torch, rank: int, port: int, seed: int, out: str,
                        workers: int) -> int:
    """One rank of the ps_2proc_apply profile (``--rank-child
    --child-phase apply``) at ``-mv_apply_workers=workers``: a warm-up
    burst, then chip_smoke.py's [ps_2proc apply] burst, rank 0's under the
    profilers."""
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.updaters.base import AddOption
    from multiverso_tpu_torch.zoo import Zoo
    from chip_smoke import (APPLY_KINDS, APPLY_WARM, PS_COLS, PS_ROWS,
                            apply_batches, counter, ps2_batch)
    mv.MV_Init([f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
                "-dist_size=2", f"-mv_apply_workers={workers}",
                "-mv_write_combine=0"])
    try:
        tables = [mv.MV_CreateTable(MatrixTableOption(
            num_rows=PS_ROWS, num_cols=PS_COLS, updater_type=u))
            for _, u in APPLY_KINDS]
        opts = [None, None, AddOption(momentum=0.5),
                AddOption(learning_rate=2.0, rho=0.25)]
        mine = apply_batches(seed, rank)
        get_ids = ps2_batch(seed, 3999, rank)[0]
        eng = Zoo.Get().server_engine
        counters = ("apply_busy_s", "xw_busy_s", "mh_window_exchanges")
        pool = {"apply_pool_jobs": "engine.apply_pool.jobs",
                "apply_pool_inline": "engine.apply_pool.inline_jobs"}

        def burst(batches) -> float:
            mv.MV_Barrier()
            t0 = time.perf_counter()
            for batch in batches:
                for t, opt, (ids, deltas) in zip(tables, opts, batch):
                    t.AddFireForget(deltas, row_ids=ids, option=opt)
            for t in tables:
                t.GetRows(get_ids)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        burst(mine[:APPLY_WARM])                       # warm-up
        c0 = {c: getattr(eng, c) for c in counters}
        p0 = {k: counter(name) for k, name in pool.items()}
        if rank == 0:
            res, wall = _profiled(torch, lambda: burst(mine[APPLY_WARM:]))
        else:
            wall = burst(mine[APPLY_WARM:])
            res = {"wall_s": wall}
        res.update({c: getattr(eng, c) - c0[c] for c in counters},
                   rank=rank, workers=workers, burst_s=wall)
        res.update({k: int(counter(name) - p0[k])
                    for k, name in pool.items()})
    finally:
        mv.MV_ShutDown()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def profile_ps_2proc_apply(seed: int, out: str) -> list:
    """Both ranks of the ps_2proc_apply profile, one world a turn of
    APPLY_PROFILE_TURNS; rank 0's profile of each with rank 1's burst."""
    res = []
    for i, workers in enumerate(APPLY_PROFILE_TURNS):
        r0, r1 = _two_ranks(seed, out, f"ps_2proc_apply{i}",
                            ["--child-phase", "apply", "--apply-workers",
                             str(workers)])
        res.append(dict(r0, rank1_burst_s=r1["burst_s"]))
    return res


def apps_2proc_rank(torch, phase: str, rank: int, port: int, seed: int,
                    out: str, workdir: str) -> int:
    """One rank of the lr_2proc / we_2proc profile (``--rank-child``):
    chip_smoke.py's [lr_2proc] or [we_2proc] runs on this rank's shard in
    a two-rank world on ``cuda:0``, rank 0's ``Train()`` / ``train()``
    under the profiler; per run the application thread's lockstep rounds
    (``multihost.STATS``) and the engine's window-exchange seconds."""
    import multiverso_tpu_torch as mv
    from chip_smoke import lr2_configs, we2_options
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    from multiverso_tpu_torch.models.wordembedding.distributed import \
        DistributedWordEmbedding
    from multiverso_tpu_torch.parallel import multihost as mh
    from multiverso_tpu_torch.zoo import Zoo
    # rank 0 reads its trace while rank 1 waits at the next run's
    # collectives: past the default timeout it would count as lost
    base = [f"-dist_coordinator=127.0.0.1:{port}", f"-dist_rank={rank}",
            "-dist_size=2", "-mv_dist_timeout_s=1200"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    if phase == "lr":
        runs = {name: cfg for name, cfg in
                lr2_configs(workdir, rank, "cuda").items()}
    else:
        runs = {name: we2_options(workdir, seed, rank, name)
                for name in ("we2_pairs", "we2_device")}
    res = {}
    for name, cfg in runs.items():
        mv.MV_Init(base)
        try:
            eng = Zoo.Get().server_engine
            if phase == "lr":
                app = LogReg(cfg)
                work = app.Train
            else:
                app = DistributedWordEmbedding(cfg)
                app.prepare()
                work = app.train
            mv.MV_Barrier()
            mh.reset_stats()
            x0 = eng.xw_busy_s
            prof = contextlib.nullcontext()
            if rank == 0:
                prof = torch.profiler.profile(activities=acts)
            with prof as p:
                t0 = time.perf_counter()
                work()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            r = summarize(torch, p, wall) if rank == 0 else {"wall_s": wall}
            r.update(collective=dict(mh.STATS),
                     engine_xw_s=eng.xw_busy_s - x0)
            if phase == "lr":
                r["samples"] = sum(n for n, _, _ in app.epoch_log)
            else:
                r["words"] = sum(w for w, _, _ in app.block_log)
            res[name] = r
        finally:
            mv.MV_ShutDown(finalize_net=name == list(runs)[-1])
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def profile_apps_2proc(phase: str, seed: int, out: str) -> dict:
    """Both ranks of the lr_2proc / we_2proc profile on chip_smoke.py's
    shards; returns rank 0's profile of each run with rank 1's wall."""
    import socket
    import subprocess

    import chip_smoke
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    with tempfile.TemporaryDirectory(prefix="mvt_prof_") as workdir:
        (chip_smoke.lr2_data if phase == "lr" else chip_smoke.we2_data)(
            workdir, seed)
        outs = [os.path.join(out, f"{phase}_2proc_rank{r}.json")
                for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-child",
             str(r), "--child-phase", phase, "--port", str(port), "--seed",
             str(seed), "--out", outs[r], "--workdir", workdir])
            for r in range(2)]
        try:
            for r, p in enumerate(procs):
                if p.wait(1500) != 0:
                    raise AssertionError(f"{phase}_2proc rank {r} failed "
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
    return {name: dict(r, rank1_wall_s=ranks[1][name]["wall_s"])
            for name, r in ranks[0].items()}


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
                    help="run one rank of a two-process profile (the script "
                         "starts both itself)")
    ap.add_argument("--child-phase", default="ps",
                    choices=("ps", "apply", "lr", "we"),
                    help="the two-process profile of --rank-child")
    ap.add_argument("--apply-workers", type=int, default=4,
                    help="the apply rank child's -mv_apply_workers")
    ap.add_argument("--workdir", default="",
                    help="lr/we --rank-child: the shards' directory")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--wire", default="shm", choices=PS2_WIRES,
                    help="the ps_2proc rank child's world (chip_smoke.py's "
                         "ps2_wire_flags)")
    ap.add_argument("--baseline", default="",
                    help="bsp: another checkout whose package takes turns "
                         "with this one's")
    ap.add_argument("--bsp-child", default="",
                    help="run one process of the bsp turns on this "
                         "checkout's package (the script starts them)")
    args = ap.parse_args()
    if args.rank_child >= 0:
        import torch
        if args.child_phase == "apply":
            return ps_2proc_apply_rank(torch, args.rank_child, args.port,
                                       args.seed, args.out,
                                       args.apply_workers)
        if args.child_phase != "ps":
            return apps_2proc_rank(torch, args.child_phase, args.rank_child,
                                   args.port, args.seed, args.out,
                                   args.workdir)
        return ps_2proc_rank(torch, args.rank_child, args.port, args.seed,
                             args.out, args.wire)
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
            "ps_2proc_apply": lambda: profile_ps_2proc_apply(args.seed,
                                                             args.out),
            "lr_2proc": lambda: profile_apps_2proc("lr", args.seed,
                                                   args.out),
            "we_2proc": lambda: profile_apps_2proc("we", args.seed,
                                                   args.out),
            "serve": lambda: profile_serve(torch, args.seed),
            "ps_combine": lambda: profile_ps_combine(torch, args.seed),
            "binding": lambda: profile_binding(torch, args.seed),
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
         "ps_2proc", "ps_2proc_apply", "lr_2proc", "we_2proc", "serve",
         "ps_combine", "binding", "bsp")
#: ps_2proc: one world a wire, in this order
PS2_WIRES = ("shm", "gloo", "shm_sharded", "tcp")
#: ps_2proc_apply: -mv_apply_workers a world, in this order
APPLY_PROFILE_TURNS = (4, 1, 1, 4)
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
    for r in res.get("ps_2proc", []):
        print(f"[ps_2proc] two ranks on one card over {r['wire']} "
              f"({r['engine']}), add + momentum round (AddRows + GetRows on "
              f"both tables): rank 0 {r['round_ms']:.3f} ms under the "
              f"profilers, rank 1 {r['rank1_round_ms']:.3f} ms; rank 0's "
              f"engine: exchange {r['engine_xw_s']:.4f} s, apply "
              f"{r['engine_apply_s']:.4f} s; over the profiled "
              f"{r['wall_s']:.4f} s device busy {r['device_busy_s']:.4f} s,"
              f" idle share {r['device_idle_share']:.3f}", flush=True)
        print_tops(f"ps_2proc {r['wire']}", r)
        for name, calls, secs in r["top_host_functions"]:
            print(f"[ps_2proc {r['wire']}]   host function {name} "
                  f"x{calls}: {secs:.4f} s", flush=True)
    for r in res.get("ps_2proc_apply", []):
        tag = f"ps_2proc_apply workers={r['workers']}"
        print(f"[{tag}] rank 0 burst {r['burst_s']:.4f} s under the "
              f"profilers, rank 1 {r['rank1_burst_s']:.4f} s; rank 0's "
              f"engine: apply {r['apply_busy_s']:.4f} s, exchange "
              f"{r['xw_busy_s']:.4f} s, {r['mh_window_exchanges']} windows, "
              f"{r['apply_pool_jobs']} pool jobs + {r['apply_pool_inline']} "
              f"inline; device busy {r['device_busy_s']:.4f} of "
              f"{r['wall_s']:.4f} s, idle share "
              f"{r['device_idle_share']:.3f}", flush=True)
        print_tops(tag, r)
        for name, calls, secs in r["top_host_functions"]:
            print(f"[{tag}]   host function {name} x{calls}: {secs:.4f} s",
                  flush=True)
    for path in ("lr_2proc", "we_2proc"):
        for name, r in res.get(path, {}).items():
            st = r["collective"]
            count = (f"{r['samples']} samples" if "samples" in r
                     else f"{r['words']} words (rank 0's)")
            print(f"[{path}] {name}: rank 0 {r['wall_s']:.4f} s under the "
                  f"profiler ({count}), rank 1 {r['rank1_wall_s']:.4f} s; "
                  f"device busy {r['device_busy_s']:.4f} s, idle share "
                  f"{r['device_idle_share']:.3f}; agreements {st['agree_n']} "
                  f"in {st['agree_s']:.4f} s, collective writes "
                  f"{st['write_n']}: device->host {st['d2h_s']:.4f} s, "
                  f"all-gathers {st['write_s']:.4f} s, host merge "
                  f"{st['merge_s']:.4f} s, apply {st['apply_s']:.4f} s; the "
                  f"engine's window exchanges {r['engine_xw_s']:.4f} s",
                  flush=True)
            print_tops(f"{path} {name}", r)
    if "serve" in res:
        r = res["serve"]
        for n, by in r["stages"].items():
            for residence, st in by.items():
                print(f"[serve] one read of a union of {n} lookup(s), "
                      f"{residence} snapshot, median host ms: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in st.items()),
                      flush=True)
        fe = r["frontend"]
        print(f"[serve] {r['lookups']} lookups from the clients under the "
              f"profiler ({r['lookups_per_s']:.1f}/s, mean coalesced batch "
              f"{fe['mean_batch']:.4f}, p50 {fe['latency_p50_s'] * 1e3:.4f} "
              f"ms, p99 {fe['latency_p99_s'] * 1e3:.4f} ms): wall "
              f"{r['wall_s']:.4f} s, device busy {r['device_busy_s']:.4f} s, "
              f"idle share {r['device_idle_share']:.3f}", flush=True)
        print_tops("serve", r)
        for t in r["turns"]:
            print(f"[serve] turn {t['turn']} (trainer + {t['publishes']} "
                  f"publishes, no profiler): {t['lookups_per_s']:.1f} "
                  f"lookups/s, client p50 {t['client_p50_ms']:.4f} ms, p99 "
                  f"{t['client_p99_ms']:.4f} ms, publish median "
                  f"{t['publish_median_ms']:.4f} ms, "
                  f"{t['train_batches']} trainer batches", flush=True)
    for i, r in enumerate(res.get("ps_combine", [])):
        print(f"[ps_combine] turn {i + 1} {r['turn']}: burst "
              f"{r['wall_s']:.4f} s, {r['add_messages']} Add messages; "
              f"device busy {r['device_busy_s']:.4f} s, idle share "
              f"{r['device_idle_share']:.3f}", flush=True)
        print_tops(f"ps_combine {r['turn']}", r)
        for key, calls, secs in r["top_host_functions"]:
            print(f"[ps_combine {r['turn']}]   host function {key} x{calls}: "
                  f"{secs:.4f} s", flush=True)
    if "binding" in res:
        r = res["binding"]
        print(f"[binding] round (8 async row adds + one get): Python "
              f"handlers {r['handler_round_ms']:.3f} ms, C ABI "
              f"{r['c_round_ms']:.3f} ms under the profiler; device busy "
              f"{r['device_busy_s']:.4f} of {r['wall_s']:.4f} s, idle share "
              f"{r['device_idle_share']:.3f}", flush=True)
        print_tops("binding", r)
        for key, calls, secs in r["top_host_functions"]:
            print(f"[binding]   host function {key} x{calls}: {secs:.4f} s",
                  flush=True)
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
