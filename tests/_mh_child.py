"""One rank of a two-process world, for tests/test_torch_multihost.py,
tests/test_torch_windowed.py, tests/test_torch_mh_logreg.py,
tests/test_torch_mh_wordembedding.py, tests/test_torch_serving_mh.py,
tests/test_torch_apply_pool.py (mode ``apply``),
tests/test_torch_mh_kv_device.py (mode ``kv_device``) and
tests/test_torch_telemetry_mh.py and tests/test_torch_telemetry_exchange.py
(mode ``telemetry``) and tests/test_torch_failsafe_mh.py (mode
``failsafe``).

    python tests/_mh_child.py PKG MODE RANK PORT OUTDIR LIBPATH [EXTRA...]

PKG is ``jax`` (the JAX package on the CPU) or ``torch`` (the port with
``-mv_device=cpu``); both run the same seeded script of MODE, so their
results can be compared. Every input comes from numpy generators seeded
with the round and the rank, so each rank also knows its peer's inputs and
checks every Get against a numpy oracle of both ranks' Adds. Results go
to ``OUTDIR/PKG_MODE_RANK.npz``; the last line printed is ``child RANK
MODE OK``. LIBPATH is the port's build of the repo's C++ library, which
the JAX package's loader is handed instead of running ``make`` ("" = none).
EXTRA are more flags for ``MV_Init``, except the options of the host-wire
modes (``wire``, ``compress``, ``lr_compress``): ``want=NAME`` asserts
that the world's engine exchanges ride the wire NAME (shm, tcp or gloo);
``tables=local`` runs mode ``wire`` on the two tables whose apply the JAX
package's sharded multi-process engine keeps on the host (an add Matrix
and a KV table; it refuses a momentum or Array table there);
``hosts=split`` gives each rank a host label of its own
(``-mv_wire_hostname``: a loopback cross-host world); ``break=shm`` or
``break=tcp`` makes rank 0's setup of that wire fail.
The app modes (``lr``, ``lr_dev``, ``lr_compress``, ``we``, ``we_pairs``,
``we_ragged``) read the data files their test wrote into OUTDIR; each rank
trains on its own shard through the apps' entry points. The JAX worlds run
at ``-mv_write_combine=0`` except in the modes of ``DEFAULT_MODES``
(tests/test_torch_write_combine.py and the host-wire tests), where both
packages run at the JAX package's default.
"""

import os
import sys
import threading
import time

import numpy as np

PKG, MODE, RANK, PORT, OUTDIR, LIBPATH = sys.argv[1:7]
_OPTS = ("want=", "tables=", "hosts=", "break=")
OPTS = dict(a.split("=", 1) for a in sys.argv[7:] if a.startswith(_OPTS))
EXTRA = [a for a in sys.argv[7:] if not a.startswith(_OPTS)]
WANT = [OPTS["want"]] if "want" in OPTS else []
LOCAL_TABLES = OPTS.get("tables") == "local"
#: the modes whose JAX world runs at the package's default write combining
DEFAULT_MODES = ("combine", "wire", "compress", "lr_compress")
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
    if OPTS.get("hosts") == "split":
        flags.append(f"-mv_wire_hostname=node{'AB'[RANK]}")
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
        if MODE not in DEFAULT_MODES:
            flags.append("-mv_write_combine=0")
    else:
        import multiverso_tpu_torch as mv
        flags += ["-mv_device=cpu", "-mv_dist_timeout_s=60"]
    if "break" in OPTS and RANK == 0:
        break_wire(OPTS["break"])
    mv.MV_Init(flags)
    assert mv.MV_Size() == 2 and mv.MV_Rank() == RANK
    return mv


def break_wire(kind):
    """This rank's setup of the ``kind`` wire fails (an exhausted
    ``/dev/shm``, a listener that cannot bind)."""
    if PKG == "jax":
        from multiverso_tpu.parallel import shm_wire, tcp_wire
    else:
        from multiverso_tpu_torch.parallel import shm_wire, tcp_wire
    mod, name = ((shm_wire, "ShmWire") if kind == "shm"
                 else (tcp_wire, "TcpWire"))

    class Broken(getattr(mod, name)):
        def __init__(self, *a, **k):
            raise OSError(f"simulated {kind} wire setup failure")

    setattr(mod, name, Broken)


def set_flag(name, value):
    """SetCMDFlag of PKG's flag registry."""
    if PKG == "jax":
        from multiverso_tpu.utils.configure import SetCMDFlag
    else:
        from multiverso_tpu_torch.utils.configure import SetCMDFlag
    SetCMDFlag(name, value)


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


def run_telemetry(mv):
    """Mode ``burst``, then the collective metrics snapshot after a
    barrier: the merged counters against this rank's own. The flight rings
    go to ``-mv_diag_dir`` at shutdown (EXTRA)."""
    run_burst(mv)
    mv.MV_Barrier()
    merged = mv.MV_MetricsSnapshot()
    if PKG == "jax":
        from multiverso_tpu.telemetry import metrics
    else:
        from multiverso_tpu_torch.telemetry import metrics
    local = metrics.snapshot()
    for name in ("server.window.exchanges", "server.window.verbs",
                 "table.matrix0.add.count"):
        results[f"merged:{name}"] = np.array(merged[name]["value"])
        results[f"local:{name}"] = np.array(local[name]["value"])
    results["merged_names"] = np.array(sorted(merged))
    if PKG == "torch":
        # each engine shard's collective seconds, by its window stream
        eng = tables_mod()[3].Get().server_engine
        shards = [eng] + list(getattr(eng, "_subs", {}).values())
        results["xw_stream"] = np.array([s.mh_stream for s in shards])
        results["xw_busy_s"] = np.array([s.xw_busy_s for s in shards])


def run_combine(mv):
    """Fire-and-forget bursts on an add, a momentum and a KV table at the
    default -mv_write_combine, with a tracked Get and an MV_Barrier inside
    them: the replicas, and the Add messages each rank's engine received
    (the JAX engine's counted at its mailbox)."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    add = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=ROWS,
                                                     num_cols=COLS))
    mom = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS, updater_type="momentum"))
    kv = mv.MV_CreateTable(tables.KVTableOption())
    eng = Zoo.Get().server_engine
    if PKG == "jax":
        from multiverso_tpu.message import MsgType
        adds = [0]
        recv = eng.Receive

        def counting(msg):
            adds[0] += msg.msg_type == MsgType.Request_Add
            return recv(msg)

        eng.Receive = counting

        def n_adds():
            return adds[0]
    else:
        def n_adds():
            return eng.add_messages
    a0 = n_adds()
    opt = AddOption(worker_id=0, momentum=0.5)
    o_add = np.zeros((ROWS, COLS), np.float32)
    o_kv = np.zeros(40, np.float32)
    for r in range(20):
        batches = [row_batch(1200 + r, k) for k in range(2)]
        ids, deltas = batches[RANK]
        add.AddFireForget(deltas, row_ids=ids)
        mom.AddFireForget(deltas, row_ids=ids, option=opt)
        o_add += combined(*zip(*batches))
        keys = [rng(402, r, k).integers(0, 40, 5).astype(np.int64)
                for k in range(2)]
        kv.AddFireForget(keys[RANK], np.ones(5, np.float32))
        for k in range(2):
            np.add.at(o_kv, keys[k], 1.0)
        if r == 9:
            results["mid_add"] = add.GetRows(np.arange(ROWS, dtype=np.int32))
        if r == 14:
            mv.MV_Barrier()
    results["final_add"] = add.Get()
    results["final_mom"] = mom.Get()
    results["final_kv"] = kv.Get(np.arange(40, dtype=np.int64))
    np.testing.assert_array_equal(results["final_add"], o_add)
    np.testing.assert_array_equal(results["final_kv"], o_kv)
    results["adds"] = np.array(n_adds() - a0)
    results["pushes"] = np.array(3 * 20)


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
    by the caller), on the shm wire: the control group's collectives and
    one collective Add; a compressed table's push and device write (both
    ranks' rows applied on every replica); the tables' device writes as
    collectives (each rank's own batch, every replica the merge); a tagged
    agreement and a collective write whose Add options diverge, each
    failing on every rank; LR with ``compress=`` starting on its
    compressed table; then the KV device verbs as collectives."""
    import torch
    tables, AddOption, GetOption, Zoo = tables_mod()
    from multiverso_tpu_torch.parallel import multihost as mh
    # the host collectives of the control group, in rank order
    assert mh.host_allreduce_sum(np.full(4, RANK + 1.0)).tolist() == [3.0] * 4
    assert mh.host_allgather_objects({"r": RANK}) == [{"r": 0}, {"r": 1}]
    assert mh.host_allgather_objects_capped(RANK, "agree") == [0, 1]
    assert mh.wire_name() == "shm", mh.wire_name()
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=8))
    arr.Add(np.full(8, float(RANK + 1), np.float32))
    np.testing.assert_array_equal(arr.Get(), np.full(8, 3.0))
    comp = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=16, num_cols=4, compress="sparse"))
    # each rank pushes one sparse row of its own (compressed) and row 2
    # (both ranks): every replica holds both ranks' rows
    delta = np.zeros((2, 4), np.float32)
    delta[:, 0] = RANK + 1.0
    comp.AddRows(np.array([RANK, 2], np.int32), delta)
    want = np.zeros((16, 4), np.float32)
    want[0, 0], want[1, 0], want[2, 0] = 1.0, 2.0, 3.0
    np.testing.assert_array_equal(comp.Get(), want)
    assert comp.server().wire_stats["payload_bytes"] > 0
    # a device write to a compressed table applies its dense rows, as the
    # JAX package's device write does
    comp.server().device_apply_rows(np.array([0], np.int32),
                                    np.ones((1, 4), np.float32))
    want[0] += 2.0
    np.testing.assert_array_equal(comp.Get(), want)
    mat = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=16,
                                                     num_cols=4))
    kv = mv.MV_CreateTable(tables.KVTableOption())
    kv.Add(np.array([3], np.int64), np.ones(1, np.float32))
    ms, asrv, ksrv = mat.server(), arr.server(), kv.server()

    # the collective device writes: rank r adds r+1 to rows {r, 2} (row 2
    # from both ranks), device deltas on rank 0, host deltas on rank 1
    ids = np.array([RANK, 2], np.int32)
    rows = np.full((2, 4), RANK + 1.0, np.float32)
    loss = ms.device_apply_rows(ids, torch.from_numpy(rows) if RANK == 0
                                else rows, ride=torch.tensor(RANK + 0.5))
    assert loss == 2.0, loss
    want = np.zeros((16, 4), np.float32)
    want[0], want[1], want[2] = 1.0, 2.0, 3.0
    np.testing.assert_array_equal(mat.Get(), want)
    got = ms.device_update_gather_rows(np.array([2], np.int32),
                                       np.ones((1, 4), np.float32))
    np.testing.assert_array_equal(got.numpy(), np.full((1, 4), 5.0))
    opt = AddOption().as_tensors()
    new, total = asrv.device_update(asrv.device_state(),
                                    torch.full((8,), float(RANK + 1)), opt,
                                    ride=RANK + 1.0)
    assert total == 3.0, total
    asrv.device_set_state(new)
    np.testing.assert_array_equal(arr.Get(), np.full(8, 6.0))
    try:                # a state this rank made alone
        asrv.device_set_state(dict(asrv.device_state()))
    except Exception as exc:
        assert "collective device_update" in str(exc), exc
    else:
        raise AssertionError("device_set_state took a rank's own state")

    # divergences fail on every rank, in one round
    try:
        mh.host_allgather_objects_capped(RANK, "lr_pop" if RANK == 0
                                         else "we_pop")
    except Exception as exc:
        assert "diverge" in str(exc) and "lr_pop" in str(exc) \
            and "we_pop" in str(exc), exc
    else:
        raise AssertionError("diverged agreements paired up")
    try:
        ms.device_apply_rows(ids, rows, AddOption(worker_id=RANK))
    except Exception as exc:
        assert "options diverge" in str(exc), exc
    else:
        raise AssertionError("a write with diverged options applied")
    np.testing.assert_array_equal(ms.raw()[:3], [[1.0] * 4, [2.0] * 4,
                                                 [5.0] * 4])

    from multiverso_tpu_torch.models.logreg.configure import Configure
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    app = LogReg(Configure(input_size=8, output_size=1, sparse=True,
                           use_ps=True, compress="sparse", platform="cpu",
                           output_model_file="", output_file=""))
    try:
        assert app.model.table.server().compress == "sparse"
    finally:
        app.close()
    # the KV device verbs, collective: each rank creates its own key and
    # both add to key 3 through the global batch
    slots = ksrv.device_slots([RANK + 10, 3], create=True)
    assert len(slots) == 8 and ksrv.size == 3, (slots, ksrv.size)
    deltas = torch.zeros(len(slots))
    deltas[:2] = RANK + 1.0
    gslots, gdeltas = ksrv.device_place_slots(slots, deltas)
    assert gslots.shape == (16,) and gdeltas.shape == (16,)
    ksrv.device_set_values(ksrv.device_scatter_add_slots(
        ksrv.device_values(), gslots, gdeltas))
    np.testing.assert_array_equal(kv.Get(np.array([3, 10, 11], np.int64)),
                                  [5.0, 1.0, 2.0])
    mine = ksrv.device_gather_slots(ksrv.device_values(), gslots)
    np.testing.assert_array_equal(mine[RANK * 8: RANK * 8 + 2].numpy(),
                                  [RANK + 1.0, 5.0])
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


def run_serving(mv):
    """Matrix, Array and KV tables take both ranks' Adds; both ranks publish
    at the same stream position (host residence, whatever the flag asks)
    and pin the version; four reader threads a rank hold its lookups to
    the training Get at the cut while a training burst runs; after a
    drain, 50 lookups issue no host collective; the versions agree across
    the ranks."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    if PKG == "jax":
        from multiverso_tpu import serving
        from multiverso_tpu.parallel import multihost as mh

        def rounds():
            return mh.STATS["host_collective_rounds"]
    else:
        from multiverso_tpu_torch import serving
        from multiverso_tpu_torch.parallel import multihost as mh
        rounds = mh.collective_rounds
    mat = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=ROWS,
                                                     num_cols=COLS))
    arr = mv.MV_CreateTable(tables.ArrayTableOption(size=16))
    kv = mv.MV_CreateTable(tables.KVTableOption())
    all_ids = np.arange(ROWS, dtype=np.int32)
    keys = np.arange(0, 40, 3, dtype=np.int64)
    for r in range(4):
        ids, deltas = row_batch(800 + r, RANK)
        mat.AddRows(ids, deltas)
        arr.Add(rng(801, r, RANK).integers(-3, 4, 16).astype(np.float32))
        kv.Add(rng(802, r, RANK).integers(0, 40, 5).astype(np.int64),
               np.ones(5, np.float32))
    mv.MV_Barrier()
    train = {"mat": mat.GetRows(all_ids), "arr": arr.Get(),
             "kv": kv.Get(keys)}
    v = mv.MV_PublishSnapshot()
    mv.MV_PinVersion(v)
    snap = serving.get_plane().store.get(v)
    assert getattr(snap.tables[mat.table_id], "_dev", None) is None
    served = {"mat": mv.MV_ServingLookup(mat, all_ids, version=v),
              "arr": mv.MV_ServingLookup(arr, None, version=v),
              "kv": mv.MV_ServingLookup(kv, keys, version=v)}
    for k, want in train.items():
        np.testing.assert_array_equal(served[k], want, err_msg=k)
        results[f"{k}_served"] = served[k]

    # readers hold the pinned version while training goes on
    errors, reads, stop = [], [0] * 4, threading.Event()

    def reader(i):
        g = rng(803, RANK, i)
        while not stop.is_set():
            sel = np.sort(g.choice(ROWS, 16, replace=False))
            got = mv.MV_ServingLookup(mat, sel, version=v, deadline=30.0)
            if not np.array_equal(got, served["mat"][sel]):
                errors.append(sel)
                return
            reads[i] += 1

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(4)]
    [t.start() for t in threads]
    for r in range(6):
        ids, deltas = row_batch(810 + r, RANK)
        mat.AddRows(ids, deltas)
        mat.AddFireForget(deltas, row_ids=ids)
    while min(reads) == 0 and not errors:
        time.sleep(0.01)
    stop.set()
    [t.join(30) for t in threads]
    assert not any(t.is_alive() for t in threads), "a reader hung"
    assert not errors, f"a read off the pinned version: {errors[0]}"

    if PKG == "jax":
        # the JAX engine dispatches a barrier at once when its pipeline is
        # idle and head-marks it when busy, so a cut right after a
        # fire-and-forget burst can strand one rank in a marker exchange
        # (ROADMAP.md §3); a blocking Get quiesces both engines first. The
        # port head-marks every barrier and drains right after the burst.
        mat.GetRows(all_ids[:1])
    # the lookup path issues no host collective
    Zoo.Get().DrainServer()
    mv.MV_Barrier()
    before = rounds()
    g = rng(804, RANK)
    for _ in range(50):
        sel = g.integers(0, ROWS, 16)
        np.testing.assert_array_equal(
            mv.MV_ServingLookup(mat, sel, version=v), served["mat"][sel])
    results["lookup_rounds"] = np.array(rounds() - before)
    results["live"] = mat.Get()
    v2 = mv.MV_PublishSnapshot()
    np.testing.assert_array_equal(mv.MV_ServingLookup(mat, None, version=v2),
                                  results["live"])
    results["versions"] = np.array(mh.host_allgather_objects((v, v2)))


# -- the host wires ------------------------------------------------------------

FAILSAFE_SPEC = ("mailbox.drop:0.06,mailbox.dup:0.08,mailbox.delay:0.08@0.002,"
                 "verb.transient:0.06,verb.failack:0.06,wire.bitflip:0.05")
FAILSAFE_COUNTERS = ("chaos.mailbox.drop", "chaos.mailbox.dup",
                     "chaos.mailbox.delay", "chaos.verb.transient",
                     "chaos.verb.failack", "chaos.wire.bitflip",
                     "failsafe.retries", "failsafe.dedup_hits",
                     "wire.crc_failures")


def run_failsafe(mv):
    """The chaos soak (the JAX package's tests/test_failsafe_multiproc.py
    spec without the serving sites, ``-chaos_seed=1234``): 12 rounds of
    tracked AddRows + GetRows on an add and a momentum table, every Get of
    the add table held to the oracle of both ranks' Adds; then chaos off,
    quiesced, the final tables and this process's failsafe counters."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    if PKG == "jax":
        from multiverso_tpu.failsafe import chaos
        from multiverso_tpu.telemetry import metrics
    else:
        from multiverso_tpu_torch.failsafe import chaos
        from multiverso_tpu_torch.telemetry import metrics
    add = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=ROWS,
                                                     num_cols=COLS))
    mom = mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS, updater_type="momentum"))
    mopt = AddOption(momentum=0.5)
    o_add = np.zeros((ROWS, COLS), np.float32)
    for r in range(12):
        batches = [row_batch(1700 + r, k) for k in range(2)]
        ids, deltas = batches[RANK]
        add.AddRows(ids, deltas)
        o_add += combined(*zip(*batches))
        results[f"add_get{r}"] = add.GetRows(ids)
        np.testing.assert_array_equal(results[f"add_get{r}"], o_add[ids])
        mom.AddRows(ids, deltas, mopt)
        results[f"mom_get{r}"] = mom.GetRows(ids)
    chaos.quiesce()
    set_flag("chaos_spec", "")
    chaos.quiesce()
    results["final_add"] = add.Get()
    results["final_mom"] = mom.Get()
    np.testing.assert_array_equal(results["final_add"], o_add)
    for name in FAILSAFE_COUNTERS:
        results[name] = np.array(metrics.counter(name).value)


def mh_mod():
    if PKG == "jax":
        from multiverso_tpu.parallel import multihost
    else:
        from multiverso_tpu_torch.parallel import multihost
    return multihost


def check_wire(results_prefix=""):
    """The world's engine exchanges ride the wire the test asked for;
    records its name, its session token and each channel's rounds."""
    mh = mh_mod()
    assert mh.wire_name() == WANT[0], (mh.wire_name(), WANT)
    w = mh.active_wire()
    results[results_prefix + "wire"] = np.array(mh.wire_name())
    if w is not None:
        st = w.stats()
        results[results_prefix + "token"] = np.array(st["token"])
        results[results_prefix + "rounds"] = np.array(st["rounds"])


def run_wire(mv):
    """The PS tables on the world's host wire: an add and a momentum
    Matrix table (tables 0 and 1: shards 0 and 1, so channels 0 and 1 under
    ``-mv_engine_shards=2``), a KV and an Array table (``tables=local``:
    the add table and the KV table, on channels 0 and 1); blocking rounds
    held to the oracle of both ranks' Adds, a fire-and-forget burst, then
    a checkpoint cut (every shard fences) and its reload."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    add = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=ROWS,
                                                     num_cols=COLS))
    if LOCAL_TABLES:
        mom = arr = None
    else:
        mom = mv.MV_CreateTable(tables.MatrixTableOption(
            num_rows=ROWS, num_cols=COLS, updater_type="momentum"))
    kv = mv.MV_CreateTable(tables.KVTableOption())
    if not LOCAL_TABLES:
        arr = mv.MV_CreateTable(tables.ArrayTableOption(size=32))
    results["engine"] = np.array(type(Zoo.Get().server_engine).__name__)
    m = np.float32(0.5)
    mopt = AddOption(momentum=float(m))
    o_add = np.zeros((ROWS, COLS), np.float32)
    o_mom = np.zeros((ROWS, COLS), np.float32)
    smooth = np.zeros((ROWS, COLS), np.float32)
    for r in range(4):
        batches = [row_batch(1400 + r, k) for k in range(2)]
        ids, deltas = batches[RANK]
        add.AddRows(ids, deltas)
        delta = combined(*zip(*batches))
        o_add += delta
        results[f"add_get{r}"] = add.GetRows(ids)
        np.testing.assert_array_equal(results[f"add_get{r}"], o_add[ids])
        kv.Add(rng(1401, r, RANK).integers(0, 30, 4).astype(np.int64),
               np.ones(4, np.float32))
        if LOCAL_TABLES:
            continue
        mom.AddRows(ids, deltas, mopt)
        touched = np.unique(np.concatenate([b[0] for b in batches]))
        smooth[touched] = (m * smooth[touched]
                           + (np.float32(1) - m) * delta[touched])
        o_mom[touched] -= smooth[touched]
        results[f"mom_get{r}"] = mom.GetRows(ids)
        np.testing.assert_allclose(results[f"mom_get{r}"], o_mom[ids],
                                   rtol=1e-6, atol=1e-6)
        arr.Add(np.full(32, RANK + 1.0, np.float32))
    for r in range(12):
        batches = [row_batch(1500 + r, k) for k in range(2)]
        add.AddFireForget(batches[RANK][1], row_ids=batches[RANK][0])
        o_add += combined(*zip(*batches))
        kv.AddFireForget(rng(1501, r, RANK).integers(0, 30, 3).astype(
            np.int64), np.ones(3, np.float32))
    # blocking Gets on every table quiesce both ranks' shards before the
    # cut (the JAX engine dispatches a barrier at once on an idle
    # pipeline, ROADMAP.md §3)
    np.testing.assert_array_equal(add.Get(), o_add)
    kv.Get(np.arange(2, dtype=np.int64))
    dense = {"add": add} if LOCAL_TABLES else {"add": add, "mom": mom,
                                                "arr": arr}
    for t in dense.values():
        t.Get()
    check_wire()
    mh = mh_mod()
    if mh.active_wire() is not None and str(results["engine"]) == "Server":
        # the same world's exchanges on gloo for a stretch (one stream:
        # the one-engine world only), then back on the wire
        with mh.wire_bypass():
            assert mh.wire_name() == "gloo"
            np.testing.assert_array_equal(add.Get(), o_add)
        assert mh.wire_name() == WANT[0]
    uri = f"file://{OUTDIR}/{PKG}_wire.mvt"
    before = {k: t.Get() for k, t in dense.items()}
    mv.MV_SaveCheckpoint(uri)
    if not LOCAL_TABLES:
        # (the JAX package's sharded multi-process engine refuses the
        # windows after a load: the load drops the add table's host
        # mirror, and its next apply would be a collective)
        add.AddRows(np.array([RANK], np.int32),
                    np.ones((1, COLS), np.float32))
        mv.MV_LoadCheckpoint(uri)
    for k, t in dense.items():
        np.testing.assert_array_equal(t.Get(), before[k], err_msg=k)
        results[f"final_{k}"] = before[k]
    results["final_kv"] = kv.Get(np.arange(30, dtype=np.int64))
    if mh.active_wire() is not None:
        results["rounds_end"] = np.array(mh.active_wire().stats()["rounds"])


def run_compress(mv):
    """Compressed row Adds across the ranks on the world's wire:
    ``compress="sparse"`` add and momentum tables beside uncompressed
    twins (even steps 80% zeros, compressed; odd steps dense, so a rank's
    dense fallback meets its peer's compressed payload in one position),
    then ``compress="1bit"`` pushes of constant rows to each rank's own
    rows (the JAX test's 1bit drill, tests/test_windowed_multihost.py)."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    R, C = 128, 16

    def mat(**kw):
        return mv.MV_CreateTable(tables.MatrixTableOption(
            num_rows=R, num_cols=C, **kw))

    comp, plain = mat(compress="sparse"), mat()
    cmom = mat(compress="sparse", updater_type="momentum")
    pmom = mat(updater_type="momentum")
    mopt = AddOption(momentum=0.5)
    g = rng(1600, RANK)
    for step in range(6):
        ids = np.sort(g.choice(R, 12, replace=False)).astype(np.int32)
        deltas = np.zeros((12, C), np.float32)
        nz = 3 if step % 2 == 0 else C
        deltas[:, :nz] = g.standard_normal((12, nz)).astype(np.float32)
        comp.AddRows(ids, deltas)
        plain.AddRows(ids, deltas)
        cmom.AddRows(ids, deltas, mopt)
        pmom.AddRows(ids, deltas, mopt)
    all_ids = np.arange(R, dtype=np.int32)
    for name, t in (("sparse", comp), ("plain", plain), ("sparse_mom", cmom),
                    ("plain_mom", pmom)):
        results[name] = t.GetRows(all_ids)
    np.testing.assert_array_equal(results["sparse"], results["plain"])
    np.testing.assert_array_equal(results["sparse_mom"],
                                  results["plain_mom"])
    # the linear table rebuilds the payloads on its device, counted in
    # its wire_stats (the momentum table decompresses on the host)
    ws = comp.server().wire_stats
    assert 0 < ws["payload_bytes"] < ws["dense_bytes"], ws
    results["sparse_wire"] = np.array([ws["dense_bytes"],
                                       ws["payload_bytes"]])
    one, twin = mat(compress="1bit"), mat()
    my_rows = np.arange(8, dtype=np.int32) + RANK * 16
    const = np.tile(np.linspace(-1.0, 1.0, C, dtype=np.float32), (8, 1))
    for _ in range(8):
        one.AddRows(my_rows, const)
        twin.AddRows(my_rows, const)
    both = np.concatenate([np.arange(8), np.arange(8) + 16]).astype(np.int32)
    results["onebit"] = one.GetRows(both)
    results["onebit_twin"] = twin.GetRows(both)
    a, b = results["onebit"], results["onebit_twin"]
    assert np.abs(b).max() > 0, "the twin's rows are empty"
    assert np.abs(a - b).max() < 0.35 * np.abs(b).max(), (
        np.abs(a - b).max(), np.abs(b).max())
    ws = one.server().wire_stats
    assert ws["payload_bytes"] < ws["dense_bytes"], ws
    run_lossy_windows(mv, mat)
    check_wire()


def run_lossy_windows(mv, mat):
    """``-mv_compress`` with one table lossy-opted (``-mv_compress_lossy``):
    its Add values cross the windows as int8 rows, every rank (the sender
    too) applies the same decode, beside a lossless twin; the table stays
    within the int8 bound of its twin (per Add and row, max|row| / 254 an
    element) and the error is not zero (the codec engaged)."""
    lossy, twin = mat(), mat()
    set_flag("mv_compress", True)
    set_flag("mv_compress_lossy", str(lossy.table_id))
    bound = np.zeros((128, 16), np.float32)
    for step in range(6):
        batches = []
        for k in range(2):
            gk = rng(1700, step, k)
            batches.append((gk.choice(128, 24, replace=False).astype(
                np.int32), gk.standard_normal((24, 16)).astype(np.float32)))
            ids, deltas = batches[k]
            bound[ids] += np.abs(deltas).max(axis=1, keepdims=True) / 254
        ids, deltas = batches[RANK]
        lossy.AddRows(ids, deltas)
        twin.AddRows(ids, deltas)
    results["lossy"] = lossy.Get()
    results["lossy_twin"] = twin.Get()
    err = np.abs(results["lossy"] - results["lossy_twin"])
    assert (err <= bound * 1.0001 + 1e-6).all(), (err - bound).max()
    assert err.max() > 0, "the lossy table equals its lossless twin"
    set_flag("mv_compress", False)
    set_flag("mv_compress_lossy", "")
    if PKG == "torch":
        from multiverso_tpu_torch.parallel import compress
        st = compress.stats()
        assert 0 < st["compress.post_bytes.window"] < \
            0.35 * st["compress.pre_bytes.window"], st
        results["lossy_window_bytes"] = np.array(
            [st["compress.pre_bytes.window"],
             st["compress.post_bytes.window"]])


APPLY_ROUNDS = 12
APPLY_KINDS = (("add", "default"), ("sgd", "sgd"), ("mom", "momentum"),
               ("ada", "adagrad"))


def apply_turn(mv, tag, bad=False):
    """One turn of ``apply``: an add, sgd, momentum and AdaGrad table,
    APPLY_ROUNDS rounds of fire-and-forget AddRows (integer deltas) to
    each in turn, so a window carries several tables; with ``bad``, a
    tracked Add to a fifth table with an id out of range in the middle of
    the traffic, which must fail at its caller alone. Returns the engine
    counters' deltas of the turn (the port's)."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    ts = {k: mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS, updater_type=u))
        for k, u in APPLY_KINDS}
    opts = {"add": None, "sgd": None, "mom": AddOption(momentum=0.5),
            "ada": AddOption(learning_rate=2.0, rho=0.25)}
    bad_t = (mv.MV_CreateTable(tables.MatrixTableOption(
        num_rows=ROWS, num_cols=COLS)) if bad else None)
    eng = Zoo.Get().server_engine
    if PKG == "jax":
        from multiverso_tpu.telemetry import metrics
    else:
        from multiverso_tpu_torch.telemetry import metrics

    def counts():
        """The pool's counters (both packages) and the engine's windows."""
        return {"apply_pool_jobs": metrics.counter(
                    "engine.apply_pool.jobs").value,
                "apply_pool_inline": metrics.counter(
                    "engine.apply_pool.inline_jobs").value,
                "mh_window_exchanges": eng.mh_window_exchanges}

    c0 = counts()
    oracle = {k: np.zeros((ROWS, COLS), np.float32) for k in ("add", "sgd")}
    handle = None
    for r in range(APPLY_ROUNDS):
        for j, (k, _) in enumerate(APPLY_KINDS):
            batches = [row_batch(1800 + 10 * r + j, rank) for rank in
                       range(2)]
            ids, deltas = batches[RANK]
            ts[k].AddFireForget(deltas, row_ids=ids, option=opts[k])
            if k in oracle:
                oracle[k] += combined(*zip(*batches))
        if bad and r == APPLY_ROUNDS // 2:
            handle = bad_t.AddAsyncHandle(np.ones((1, COLS), np.float32),
                                          row_ids=np.array([ROWS + 5]))
    if bad:
        try:
            bad_t.Wait(handle)
        except Exception as exc:
            assert "out of range" in str(exc), exc
        else:
            raise AssertionError("an Add out of range applied")
    out = {k: t.Get() for k, t in ts.items()}
    np.testing.assert_array_equal(out["add"], oracle["add"])
    np.testing.assert_array_equal(out["sgd"], -oracle["sgd"])
    for k, v in out.items():
        results[f"{tag}_{k}"] = v
    return {k: v - c0[k] for k, v in counts().items()}


def run_apply(mv):
    """The parallel window apply (``-mv_apply_workers``): the turn at the
    default 4 workers (with the failing Add), then at 1 (and
    ``-mv_pipeline_depth=3``); every table bitwise equal between the
    turns; the port's pool took jobs at 4 and none at 1."""
    four = apply_turn(mv, "w4", bad=True)
    set_flag("mv_apply_workers", 1)
    set_flag("mv_pipeline_depth", 3)
    one = apply_turn(mv, "w1")
    for k, _ in APPLY_KINDS:
        np.testing.assert_array_equal(results[f"w4_{k}"], results[f"w1_{k}"],
                                      err_msg=k)
    if PKG == "torch":
        assert four["apply_pool_jobs"] > 0, four
        assert four["apply_pool_inline"] > 0, four
        assert one["apply_pool_jobs"] == one["apply_pool_inline"] == 0, one
    results["pool_w4"] = np.array([four["apply_pool_jobs"],
                                   four["apply_pool_inline"],
                                   four["mh_window_exchanges"]])
    results["pool_w1"] = np.array([one["apply_pool_jobs"],
                                   one["apply_pool_inline"],
                                   one["mh_window_exchanges"]])


def run_kv_device(mv):
    """The KV device verbs as collectives (the JAX package's two-process
    script, tests/test_multihost.py's kv part, widened): each rank
    resolves its keys with ``create=True`` (half shared with its peer),
    places the global batch, scatter-adds integer deltas and gathers;
    every rank's values equal a twin table that took the same deltas
    through the host Add, and each rank's own lanes of the global gather
    equal its keys' values."""
    tables, AddOption, GetOption, Zoo = tables_mod()
    kv = mv.MV_CreateTable(tables.KVTableOption())
    twin = mv.MV_CreateTable(tables.KVTableOption())
    ksrv = kv.server()
    n = 600
    for step in range(3):
        keys = [np.concatenate([rng(1900, step).integers(0, 10 ** 6, n // 2),
                                rng(1901, step, k).integers(0, 10 ** 6,
                                                            n // 2)
                                + k * 10 ** 6]).astype(np.int64)
                for k in range(2)]
        deltas = [rng(1902, step, k).integers(-3, 4, n).astype(np.float32)
                  for k in range(2)]
        slots = ksrv.device_slots(keys[RANK], create=True)
        b = len(slots)
        pad = np.zeros(b, np.float32)
        pad[:n] = deltas[RANK]
        if PKG == "jax":
            import jax
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            gslots, gdeltas = ksrv.device_place_slots(slots, pad)
            vals = jax.jit(ksrv.device_scatter_add_slots,
                           donate_argnums=(0,))(ksrv.device_values(),
                                                gslots, gdeltas)
            ksrv.device_set_values(vals)
            rep = jax.jit(ksrv.device_gather_slots,
                          out_shardings=NamedSharding(
                              ksrv._zoo.mesh_ctx.mesh, P()))(
                ksrv.device_values(), gslots)
            gathered = np.asarray(rep.addressable_data(0))
        else:
            import torch
            gslots, gdeltas = ksrv.device_place_slots(
                slots, torch.from_numpy(pad) if RANK == 0 else pad)
            assert gslots.shape == (2 * b,)
            ksrv.device_set_values(ksrv.device_scatter_add_slots(
                ksrv.device_values(), gslots, gdeltas))
            gathered = ksrv.device_gather_slots(ksrv.device_values(),
                                                gslots).numpy()
        twin.Add(keys[RANK], deltas[RANK])
        mine = gathered[RANK * b: RANK * b + n]
        np.testing.assert_array_equal(mine, kv.Get(keys[RANK]))
        results[f"mine{step}"] = mine
    all_keys = np.concatenate([
        np.concatenate([rng(1900, s).integers(0, 10 ** 6, n // 2),
                        rng(1901, s, k).integers(0, 10 ** 6, n // 2)
                        + k * 10 ** 6]) for s in range(3)
        for k in range(2)]).astype(np.int64)
    results["values"] = kv.Get(all_keys)
    np.testing.assert_array_equal(results["values"], twin.Get(all_keys))
    results["size"] = np.array(ksrv.size)
    # an explicit bucket without create issues no collective
    fast = ksrv.device_slots(all_keys[:5], bucket=8)
    assert len(fast) == 8 and (fast[:5] < ksrv.capacity - 1).all()


def run_lr_compress(mv):
    """LR's host plane with ``compress=sparse`` and ``compress=1bit`` on
    each rank's own shard of the sparse data."""
    Configure, LogReg = lr_classes()
    for mode in ("sparse", "1bit"):
        lr_run(f"lr_{mode}", Configure, LogReg, sparse=True, compress=mode,
               train_file=f"{OUTDIR}/sparse_{RANK}.data",
               test_file=f"{OUTDIR}/sparse_test.data")
    check_wire()


# -- the apps, data-parallel (each rank its own shard) ------------------------

def lr_classes():
    if PKG == "jax":
        from multiverso_tpu.models.logreg.configure import Configure
        from multiverso_tpu.models.logreg.logreg import LogReg
    else:
        from multiverso_tpu_torch.models.logreg.configure import Configure
        from multiverso_tpu_torch.models.logreg.logreg import LogReg
    return Configure, LogReg


def lr_config(Configure, **kw):
    """The JAX package's two-process LR test configuration
    (tests/test_multihost.py), no pipelined pulls, no output files."""
    base = dict(input_size=16, output_size=1, objective_type="sigmoid",
                updater_type="sgd", learning_rate=0.3, train_epoch=3,
                minibatch_size=32, use_ps=True, sync_frequency=2,
                pipeline=False, output_model_file="", output_file="",
                show_time_per_sample=10 ** 9)
    base.update(kw)
    if PKG == "torch":
        base["platform"] = "cpu"
    return Configure(**base)


def lr_run(name, Configure, LogReg, min_acc=0.85, **kw):
    cfg = lr_config(Configure, **kw)
    lr = LogReg(cfg)
    loss = lr.Train()
    acc = lr.Test()
    results[f"{name}_W"] = np.asarray(lr.model.weights())
    results[f"{name}_loss"] = np.array(float(loss))
    results[f"{name}_acc"] = np.array(acc)
    assert acc > min_acc, (name, acc)


def run_lr(mv):
    """The host plane (dense, equal shards), FTRL on the collective host KV
    verbs (device_plane asked for; equal shards), and, in the port, the
    warm start: both ranks read the loaded weights after it."""
    Configure, LogReg = lr_classes()
    lr_run("host", Configure, LogReg,
           train_file=f"{OUTDIR}/dense_{RANK}.data",
           test_file=f"{OUTDIR}/dense_test.data")
    lr_run("ftrl", Configure, LogReg, objective_type="ftrl",
           updater_type="ftrl", sparse=True, device_plane=True, alpha=2.0,
           beta=1.0, lambda1=0.01, lambda2=0.01,
           train_file=f"{OUTDIR}/sparse_{RANK}.data",
           test_file=f"{OUTDIR}/sparse_test.data")
    if PKG == "torch":
        for sparse in (False, True):
            cfg = lr_config(Configure, sparse=sparse, train_epoch=0,
                            init_model_file=f"{OUTDIR}/init.model")
            W = np.asarray(LogReg(cfg).model.weights())
            results[f"warm_{'sparse' if sparse else 'dense'}"] = W


def run_lr_dev(mv):
    """The device plane, dense and sparse, on ragged shards (filler windows
    on the rank whose shard runs out)."""
    Configure, LogReg = lr_classes()
    for sparse in (False, True):
        kind = "sparse" if sparse else "dense"
        lr_run(kind, Configure, LogReg, sparse=sparse, device_plane=True,
               train_file=f"{OUTDIR}/{kind}_ragged_{RANK}.data",
               test_file=f"{OUTDIR}/{kind}_test.data")


def we_classes():
    if PKG == "jax":
        from multiverso_tpu.models.wordembedding.distributed import \
            DistributedWordEmbedding
        from multiverso_tpu.models.wordembedding.option import Option
    else:
        from multiverso_tpu_torch.models.wordembedding.distributed import \
            DistributedWordEmbedding
        from multiverso_tpu_torch.models.wordembedding.option import Option
    return DistributedWordEmbedding, Option


def we_run(name, corpus, extra=()):
    """One DistributedWordEmbedding run in the booted world; returns it
    (its world stays up)."""
    DWE, Option = we_classes()
    argv = ["-train_file", f"{OUTDIR}/{corpus}_{RANK}.txt",
            "-output", f"{OUTDIR}/{PKG}_{name}_{RANK}.txt",
            "-size", "16", "-epoch", "2", "-negative", "3",
            "-min_count", "1", "-read_vocab", f"{OUTDIR}/{corpus}_vocab.txt",
            "-data_block_size", "20000", "-is_pipeline", "0", *extra]
    if PKG == "torch":
        argv += ["-platform", "cpu"]
    we = DWE(Option.parse_args(argv))
    results[f"{name}_loss"] = np.array(float(we.run()))
    return we


def run_we(mv):
    """The host plane and -device_plane 1 on equal shards."""
    we_run("host", "corpus")
    we_run("device", "corpus", ["-device_plane", "1"])


def run_we_pairs(mv):
    """-device_pairs 1 on ragged shards, in the port, with the JAX
    program's draws injected (recomputed here from its key) and each
    global block's layout and lr recorded, so the test can run the JAX
    program on the same global blocks in one process."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from multiverso_tpu_torch.models.wordembedding import device_pairs as dp
    orig = dp.DevicePairsTrainer.train_block
    blocks = []

    def train_block(self, token_ids, token_sent, lr, b=None, draws=None,
                    agreed=None):
        ids, sent = self.global_layout(agreed)
        opt = self.opt
        n, W = len(ids), opt.window_size
        key = jax.random.fold_in(jax.random.PRNGKey(opt.seed),
                                 self._block_counter + 1)
        kb, kneg = jax.random.split(key)
        b = np.asarray(jax.random.randint(kb, (n,), 1, W + 1))
        draws = np.asarray(jax.random.randint(
            kneg, (2 * W * n, opt.negative_num), 0, self.slots.shape[0]))
        blocks.append((ids, sent, lr))
        return orig(self, token_ids, token_sent, lr, b=b, draws=draws,
                    agreed=agreed)

    dp.DevicePairsTrainer.train_block = train_block
    we = we_run("pairs", "topics", ["-device_pairs", "1",
                                    "-data_block_size", "2000"])
    for i, (ids, sent, lr) in enumerate(blocks):
        results[f"block{i}_ids"] = ids
        results[f"block{i}_sent"] = sent
        results[f"block{i}_lr"] = np.array(lr, np.float32)
    comm = we.comm
    for name in ("input_table", "output_table"):
        results[name] = getattr(comm, name).server().raw()
    results["slots"] = we.dp_trainer.slots.numpy()


def run_we_ragged(mv):
    """The host plane on unequal block streams fails on BOTH ranks, with
    the message that says why, and within the collective timeout."""
    t0 = time.perf_counter()
    try:
        we_run("ragged", "ragged", ["-data_block_size", "2000"])
    except Exception as exc:
        assert "-device_pairs" in str(exc) and "unequal" in str(exc), exc
    else:
        raise AssertionError("a ragged host-plane stream trained")
    results["fail_s"] = np.array(time.perf_counter() - t0)


def main():
    extra = {"bsp": ["-sync=true"],
             "tables": ["-num_workers=2"],
             "apply": ["-mv_write_combine=0"],
             "serving": ["-mv_serving_residence=device"],
             "failsafe": [f"-chaos_spec={FAILSAFE_SPEC}", "-chaos_seed=1234",
                          "-mv_max_retries=12", "-mv_deadline_s=60"],
             }.get(MODE, [])
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
     "combine": run_combine,
     "wiring": run_wiring, "diverge": run_diverge, "dead": run_dead,
     "serving": run_serving, "wire": run_wire, "compress": run_compress,
     "apply": run_apply, "kv_device": run_kv_device,
     "telemetry": run_telemetry, "failsafe": run_failsafe,
     "lr_compress": run_lr_compress,
     "lr": run_lr, "lr_dev": run_lr_dev, "we": run_we,
     "we_pairs": run_we_pairs, "we_ragged": run_we_ragged}[MODE](mv)
    if MODE != "dead":
        mv.MV_ShutDown()
    np.savez(os.path.join(OUTDIR, f"{PKG}_{MODE}_{RANK}.npz"), **results)
    print(f"child {RANK} {MODE} OK", flush=True)
    if MODE == "dead":
        # a world whose peer died cannot be shut down cleanly
        os._exit(0)


if __name__ == "__main__":
    main()
