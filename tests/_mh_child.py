"""One rank of a two-process world, for tests/test_torch_multihost.py and
tests/test_torch_windowed.py.

    python tests/_mh_child.py PKG MODE RANK PORT OUTDIR LIBPATH [EXTRA...]

PKG is ``jax`` (the JAX package on the CPU) or ``torch`` (the port with
``-mv_device=cpu``); both run the same seeded script of MODE, so their
results can be compared. Every input comes from numpy generators seeded
with the round and the rank, so each rank also knows its peer's inputs and
checks every Get against a numpy oracle of both ranks' Adds. Results go
to ``OUTDIR/PKG_MODE_RANK.npz``; the last line printed is ``child RANK
MODE OK``. LIBPATH is the port's build of the repo's C++ library, which
the JAX package's loader is handed instead of running ``make`` ("" = none).
"""

import os
import sys
import threading
import time

import numpy as np

PKG, MODE, RANK, PORT, OUTDIR, LIBPATH = sys.argv[1:7]
EXTRA = sys.argv[7:]
RANK = int(RANK)
SEED = 11
ROWS, COLS, IDS = 200, 6, 40
results = {}


def rng(*key):
    return np.random.default_rng([SEED, *key])


def boot(extra=()):
    """MV_Init the two-process world of PKG; returns the package."""
    flags = [f"-dist_coordinator=127.0.0.1:{PORT}", f"-dist_rank={RANK}",
             "-dist_size=2", *extra]
    if PKG == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from multiverso_tpu import native as jnative

        def no_make():
            raise AssertionError("the JAX loader ran make -C native")

        jnative._lib = jnative._try_load(LIBPATH) if LIBPATH else None
        jnative._tried = True
        jnative._build = no_make
        import multiverso_tpu as mv
        flags.append("-mv_write_combine=0")
    else:
        import multiverso_tpu_torch as mv
        flags += ["-mv_device=cpu", "-mv_dist_timeout_s=60"]
    mv.MV_Init(flags)
    assert mv.MV_Size() == 2 and mv.MV_Rank() == RANK
    return mv


def tables_mod():
    if PKG == "jax":
        from multiverso_tpu import tables
        from multiverso_tpu.updaters.base import AddOption, GetOption
        from multiverso_tpu.zoo import Zoo
    else:
        from multiverso_tpu_torch import tables
        from multiverso_tpu_torch.updaters.base import AddOption, GetOption
        from multiverso_tpu_torch.zoo import Zoo
    return tables, AddOption, GetOption, Zoo


def row_batch(r, rank):
    """Round r's (ids, integer deltas) of ``rank``: ids overlap across the
    ranks and repeat inside a batch."""
    g = rng(r, rank)
    return (g.integers(0, ROWS, IDS).astype(np.int32),
            g.integers(-3, 4, (IDS, COLS)).astype(np.float32))


def combined(ids_list, deltas_list):
    out = np.zeros((ROWS, COLS), np.float32)
    for ids, d in zip(ids_list, deltas_list):
        np.add.at(out, ids, d)
    return out


def run_tables(mv):
    """Array, Matrix (add, momentum), KV with divergent keys, SparseMatrix
    dirty rows, MV_Aggregate across 2 processes x 2 threads, checkpoint
    save (rank 0 writes) and reload."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=64))
    mat = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=ROWS,
                                                     num_cols=COLS))
    mom = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS, updater_type="momentum"))
    kv = mv.MV_CreateTable(tables.KVTableOption())
    m = np.float32(0.5)
    mopt = AddOption(momentum=float(m))
    o_arr = np.zeros(64, np.float32)
    o_mat = np.zeros((ROWS, COLS), np.float32)
    o_mom = np.zeros((ROWS, COLS), np.float32)
    smooth = np.zeros((ROWS, COLS), np.float32)
    o_kv = {}
    for r in range(4):
        vals = [rng(100, r, k).integers(-5, 6, 64).astype(np.float32)
                for k in range(2)]
        arr.Add(vals[RANK])
        o_arr += vals[0] + vals[1]
        got = arr.Get()
        np.testing.assert_array_equal(got, o_arr)
        results[f"arr_get{r}"] = got
        batches = [row_batch(r, k) for k in range(2)]
        ids, deltas = batches[RANK]
        mat.AddRows(ids, deltas)
        o_mat += combined(*zip(*batches))
        got = mat.GetRows(ids)
        np.testing.assert_array_equal(got, o_mat[ids])
        results[f"mat_get{r}"] = got
        mom.AddRows(ids, deltas, mopt)
        delta = combined(*zip(*batches))
        touched = np.unique(np.concatenate([b[0] for b in batches]))
        smooth[touched] = (m * smooth[touched]
                           + (np.float32(1) - m) * delta[touched])
        o_mom[touched] -= smooth[touched]
        got = mom.GetRows(ids)
        np.testing.assert_allclose(got, o_mom[ids], rtol=1e-6, atol=1e-6)
        results[f"mom_get{r}"] = got
        # KV: each rank's keys of its own plus keys both ranks add
        keys = [np.concatenate([
            np.array([7000 + 10 * k + r, 500 + r, 500], np.int64),
            rng(200, r, k).integers(0, 50, 6).astype(np.int64)])
            for k in range(2)]
        kvals = [rng(201, r, k).integers(1, 4, len(keys[k])).astype(
            np.float32) for k in range(2)]
        kv.Add(keys[RANK], kvals[RANK])
        for k in range(2):
            for key, v in zip(keys[k], kvals[k]):
                o_kv[int(key)] = o_kv.get(int(key), 0.0) + float(v)
        ask = np.array(sorted(o_kv) + [123456], np.int64)
        got = kv.Get(ask)
        np.testing.assert_array_equal(
            got, np.array([o_kv.get(int(k), 0.0) for k in ask], np.float32))
        results[f"kv_get{r}"] = got
    results["kv_keys"] = np.array(sorted(o_kv), np.int64)

    # SparseMatrix: per-(global worker, row) freshness across processes
    sp = mv.MV_CreateTable(tables.SparseMatrixTableOption(num_rows=16,
                                                          num_cols=3))
    sp_log = []
    sp.AddRows(np.array([1, 3] if RANK == 0 else [5, 7], np.int32),
               np.full((2, 3), float(RANK + 1), np.float32))
    sp_log.append(sp.Get())
    sp_log.append(sp.Get())
    sp.AddRows(np.array([5] if RANK == 0 else [9], np.int32),
               np.full((1, 3), float(RANK + 1), np.float32))
    sp_log.append(sp.Get())
    sp.AddRows(np.array([2] if RANK == 0 else [12], np.int32),
               np.full((1, 3), 1.0, np.float32))
    sp_log.append(sp.GetRows(np.array([2, 3, 12], np.int32)))
    sp.Add(np.ones((16, 3), np.float32))
    sp_log.append(sp.Get())
    assert sp_log[0][0].tolist() == ([5, 7] if RANK == 0 else [1, 3])
    assert sp_log[1][0].tolist() == [0]
    for i, (ids, rows) in enumerate(sp_log):
        results[f"sp_ids{i}"] = np.asarray(ids)
        results[f"sp_rows{i}"] = np.asarray(rows)

    # MV_Aggregate: 2 processes x 2 worker threads, float64 accumulation
    parts = [rng(300, k).standard_normal((50, 7), dtype=np.float32)
             for k in range(4)]
    want = sum(p.astype(np.float64) for p in parts).astype(np.float32)
    mine = [parts[2 * RANK + w].copy() for w in range(2)]
    errors = []

    def agg(w):
        try:
            with Zoo.Get().worker_context(w):
                mv.MV_Aggregate(mine[w])
                mv.MV_Barrier()
        except BaseException as exc:       # re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=agg, args=(w,)) for w in range(2)]
    [t.start() for t in threads]
    [t.join(60) for t in threads]
    assert not errors and not any(t.is_alive() for t in threads), errors
    for w in range(2):
        if PKG == "jax":
            # the JAX package's cross-process leg gathers through jax
            # arrays without x64: each process's float64 thread sum is
            # rounded to float32 before the processes' sum
            np.testing.assert_allclose(mine[w], want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(mine[w], want)
    results["aggregate"] = mine[0]

    # checkpoint: rank 0 writes, both reload
    uri = f"file://{OUTDIR}/{PKG}_ckpt.mvt"
    before = [arr.Get(), mat.Get(), mom.Get()]
    mv.MV_SaveCheckpoint(uri)
    if RANK == 0:
        assert os.path.getsize(f"{OUTDIR}/{PKG}_ckpt.mvt") > 0
    arr.Add(np.ones(64, np.float32))
    mat.AddRows(np.array([RANK], np.int32), np.ones((1, COLS), np.float32))
    mom.AddRows(np.array([RANK], np.int32), np.ones((1, COLS), np.float32),
                mopt)
    mv.MV_LoadCheckpoint(uri)
    after = [arr.Get(), mat.Get(), mom.Get()]
    for b, a in zip(before, after):
        np.testing.assert_array_equal(a, b)
    ids, deltas = row_batch(9, RANK)
    mom.AddRows(ids, deltas, mopt)
    results["final_arr"] = arr.Get()
    results["final_mat"] = mat.Get()
    results["final_mom"] = mom.Get()
    results["final_kv"] = kv.Get(results["kv_keys"])
    results["final_sp"] = sp.Get(GetOption(worker_id=-1))[1]


def run_burst(mv):
    """Fire-and-forget bursts on four tables with tracked Gets between
    them: windows drain raggedly across the ranks (verbs past the agreed
    prefix lead the next exchange) and a table's Adds merge across
    positions and ranks."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    add = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=ROWS,
                                                     num_cols=COLS))
    sgd = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS, updater_type="sgd"))
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=32))
    kv = mv.MV_CreateTable(tables.KVTableOption())
    o_add = np.zeros((ROWS, COLS), np.float32)
    o_arr = np.zeros(32, np.float32)
    o_kv = np.zeros(40, np.float32)
    for r in range(30):
        batches = [row_batch(1000 + r, k) for k in range(2)]
        ids, deltas = batches[RANK]
        add.AddFireForget(deltas, row_ids=ids)
        sgd.AddFireForget(deltas, row_ids=ids)
        o_add += combined(*zip(*batches))
        vals = [rng(400, r, k).integers(-2, 3, 32).astype(np.float32)
                for k in range(2)]
        arr.AddFireForget(vals[RANK])
        o_arr += vals[0] + vals[1]
        keys = [rng(401, r, k).integers(0, 40, 5).astype(np.int64)
                for k in range(2)]
        kv.Add(keys[RANK], np.ones(5, np.float32))
        for k in range(2):
            np.add.at(o_kv, keys[k], 1.0)
        if r % 6 == 5:
            # a tracked Get observes at least every Add queued before it
            results[f"arr_get{r}"] = arr.Get()
            results[f"add_get{r}"] = add.GetRows(ids)
    results["final_add"] = add.Get()
    results["final_sgd"] = sgd.Get()
    results["final_arr"] = arr.Get()
    results["final_kv"] = kv.Get(np.arange(40, dtype=np.int64))
    np.testing.assert_array_equal(results["final_add"], o_add)
    np.testing.assert_array_equal(results["final_sgd"], -o_add)
    np.testing.assert_array_equal(results["final_arr"], o_arr)
    np.testing.assert_array_equal(results["final_kv"], o_kv)
    if PKG == "torch":
        eng = Zoo.Get().server_engine
        results["window_verbs"] = np.array(eng.mh_window_verbs)
        results["exchanges"] = np.array(eng.mh_window_exchanges)
        results["merged_runs"] = np.array(eng.mh_add_run_merged)


def run_bsp(mv):
    """-sync=true, one worker a process (a process's verb sequence must not
    depend on how its threads interleave: the SPMD collective contract),
    an Array and a Matrix table: each rank's i-th Get equals the other's
    and the oracle after both ranks' i-th Adds."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    assert type(Zoo.Get().server_engine).__name__ == "SyncServer"
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=16))
    mat = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=ROWS,
                                                     num_cols=COLS))
    o_mat = np.zeros((ROWS, COLS), np.float32)
    for i in range(4):
        ids, deltas = row_batch(500 + i, RANK)
        arr.Add(np.full(16, float(RANK + 1), np.float32))
        mat.AddRows(ids, deltas)
        o_mat += combined(*zip(*[row_batch(500 + i, k) for k in range(2)]))
        np.testing.assert_array_equal(arr.Get(), np.full(16, 3.0 * (i + 1)))
        got = mat.GetRows(np.arange(ROWS, dtype=np.int32))
        np.testing.assert_array_equal(got, o_mat)
        results[f"mat_{i}"] = got


def run_wiring(mv):
    """A world from MV_NetBind/MV_NetConnect or the machine file (booted
    by the caller): the control group's collectives and one collective Add,
    then the unported multi-process paths, each failing loudly on every
    rank (and leaving the replica as it was)."""
    import torch
    tables, AddOption, GetOption, Zoo = tables_mod()
    from multiverso_tpu_torch.parallel import multihost as mh
    # the host collectives of the control group, in rank order
    assert mh.host_allreduce_sum(np.full(4, RANK + 1.0)).tolist() == [3.0] * 4
    assert mh.host_allgather_objects({"r": RANK}) == [{"r": 0}, {"r": 1}]
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=8))
    arr.Add(np.full(8, float(RANK + 1), np.float32))
    np.testing.assert_array_equal(arr.Get(), np.full(8, 3.0))
    comp = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=16, num_cols=4, compress="sparse"))
    delta = np.zeros((2, 4), np.float32)
    delta[:, 0] = 1.0
    try:
        comp.AddRows(np.array([0, 1], np.int32), delta)
    except Exception as exc:
        assert "not ported yet" in str(exc), exc
    else:
        raise AssertionError("a compressed push across processes applied")
    from multiverso_tpu_torch.utils.world import WorldOwner
    mat = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=16,
                                                     num_cols=4))
    kv = mv.MV_CreateTable(tables.KVTableOption())
    kv.Add(np.array([3], np.int64), np.ones(1, np.float32))
    ms, asrv, ksrv = mat.server(), arr.server(), kv.server()
    ids, rows = np.array([RANK], np.int32), np.ones((1, 4), np.float32)
    slots = ksrv.device_place_slots(ksrv.device_slots([3]))
    unported = {
        "LogisticRegression": lambda: WorldOwner.require_single_process(
            "LogisticRegression"),
        "device_apply_rows": lambda: ms.device_apply_rows(ids, rows),
        "device_update_gather_rows": lambda: ms.device_update_gather_rows(
            ids, rows),
        "device_update": lambda: asrv.device_update(
            asrv.device_state(), torch.ones(asrv.padded), None),
        "device_set_state": lambda: asrv.device_set_state(
            asrv.device_state()),
        "device_slots(create=True)": lambda: ksrv.device_slots(
            [RANK + 10], create=True),
        "device_set_values": lambda: ksrv.device_set_values(
            ksrv.device_values()),
        "device_scatter_add_slots": lambda: ksrv.device_scatter_add_slots(
            ksrv.device_values(), slots, torch.ones(len(slots))),
    }
    for name, call in unported.items():
        try:
            call()
        except NotImplementedError as exc:
            assert name in str(exc) and "not ported yet" in str(exc), exc
        else:
            raise AssertionError(f"{name} ran in a multi-process world")
    np.testing.assert_array_equal(mat.Get(), np.zeros((16, 4)))
    np.testing.assert_array_equal(arr.Get(), np.full(8, 3.0))
    np.testing.assert_array_equal(kv.Get(np.array([3, 10, 11], np.int64)),
                                  [2.0, 0.0, 0.0])
    mv.MV_Barrier()


def run_diverge(mv):
    """Rank 0 issues an Add where rank 1 issues a Get: the first window
    exchange fails its CHECK on both ranks, the waiter raises, and later
    verbs fail fast on the poisoned engine."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    mat = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=16,
                                                     num_cols=4))
    t0 = time.perf_counter()
    try:
        if RANK == 0:
            mat.AddRows(np.array([1], np.int32), np.ones((1, 4), np.float32))
        else:
            mat.GetRows(np.array([1], np.int32))
    except Exception as exc:
        assert "diverge" in str(exc), exc
    else:
        raise AssertionError("a diverging verb stream applied")
    try:
        mat.GetRows(np.array([2], np.int32))
    except Exception as exc:
        assert "died" in str(exc), exc
    else:
        raise AssertionError("the engine kept running a desynced stream")
    results["fail_s"] = np.array(time.perf_counter() - t0)


def run_dead(mv):
    """Rank 1 dies without a word; rank 0's next collective Add fails
    within the process group's timeout instead of hanging."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=8))
    arr.Add(np.ones(8, np.float32))
    mv.MV_Barrier()
    if RANK == 1:
        os._exit(0)
    time.sleep(1.0)
    t0 = time.perf_counter()
    try:
        arr.Add(np.ones(8, np.float32))
    except Exception:
        pass
    else:
        raise AssertionError("an Add applied with its peer dead")
    results["fail_s"] = np.array(time.perf_counter() - t0)


def main():
    extra = {"bsp": ["-sync=true"],
             "tables": ["-num_workers=2"]}.get(MODE, [])
    if MODE == "wiring":
        how = EXTRA[0]
        import multiverso_tpu_torch as mv
        if how == "netbind":
            eps = [f"127.0.0.1:{PORT}", f"127.0.0.1:{int(PORT) + 1}"]
            assert mv.MV_NetBind(RANK, eps[RANK]) == 0
            assert mv.MV_NetConnect([0, 1], eps) == 0
            mv.MV_Init(["-mv_device=cpu", "-mv_dist_timeout_s=60"])
        else:
            mv.MV_Init([f"-machine_file={EXTRA[1]}", f"-dist_rank={RANK}",
                        "-mv_device=cpu", "-mv_dist_timeout_s=60"])
        assert mv.MV_Size() == 2 and mv.MV_Rank() == RANK
    else:
        mv = boot(extra + EXTRA)
    {"tables": run_tables, "burst": run_burst, "bsp": run_bsp,
     "wiring": run_wiring, "diverge": run_diverge, "dead": run_dead}[MODE](mv)
    if MODE != "dead":
        mv.MV_ShutDown()
    np.savez(os.path.join(OUTDIR, f"{PKG}_{MODE}_{RANK}.npz"), **results)
    print(f"child {RANK} {MODE} OK", flush=True)
    if MODE == "dead":
        # a world whose peer died cannot be shut down cleanly
        os._exit(0)


if __name__ == "__main__":
    main()
