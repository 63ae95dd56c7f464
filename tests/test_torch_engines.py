"""The port's engine modes against the JAX package's.

Each seeded script runs first in a JAX-package world and then in a port
world on the CPU (``-mv_device=cpu``), one world after the other. Deltas
are integer-valued, so every sum is exact whatever order a window or a
shard applies it in, and results must match bitwise.

(a) the sharded engine: lazy shard spawn and ``shard_states()``;
    ``tests/test_sharded.py``'s multi-table workload on 4 tables, with a
    routing move at a cut half way, equal in the JAX ``ShardedServer``, the
    port's ``ShardedServer`` and the port's single engine; a cut sent in
    the middle of a fire-and-forget burst on 3 shards snapshots every Add
    sent before it and none after; ``DrainServer`` and ``FinishTrain``
    fence every shard; a dead shard raises ``ActorDied`` instead of
    hanging;
(b) BSP (``-sync=true``): the vector clocks; 4 workers' i-th Gets equal
    to one another, to the JAX ``SyncServer``'s and to the oracle; a fast
    worker's cached Get drained by ``FinishTrain``; batched verbs fall back
    to members one at a time;
(c) model-average (``-ma=true``) and the flags: ``MV_Aggregate`` bitwise
    equal to the JAX result (float64 accumulation), ``MV_CreateTable``
    raises, and every engine-selecting flag set builds the JAX package's
    engine class, is consumed by ``ParseCMDFlags`` and, without a card,
    raises unless the CPU is asked for.
"""

import threading

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests.test_sharded import _multi_table_workload

torch.set_num_threads(1)


def _jax_world(argv, body):
    import multiverso_tpu as jmv
    from multiverso_tpu import tables
    from multiverso_tpu.zoo import Zoo
    jmv.MV_Init(argv)
    try:
        return body(jmv, tables, Zoo.Get())
    finally:
        jmv.MV_ShutDown()


def _port_world(argv, body):
    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch import tables
    from multiverso_tpu_torch.zoo import Zoo
    tmv.MV_Init(["-mv_device=cpu"] + argv)
    try:
        return body(tmv, tables, Zoo.Get())
    finally:
        tmv.MV_ShutDown()


def _msg_types(mv):
    """The ``MsgType`` of ``mv``'s own package."""
    import importlib
    return importlib.import_module(f"{mv.__name__}.message").MsgType


def _matrices(mv, tables, n, rows, cols):
    return [mv.MV_CreateTable(tables.MatrixTableOption(num_rows=rows,
                                                       num_cols=cols))
            for _ in range(n)]


def _run_threads(target, n):
    errors = []

    def guarded(wid):
        try:
            target(wid)
        except BaseException as exc:        # re-raised by the test
            errors.append((wid, exc))

    threads = [threading.Thread(target=guarded, args=(w,)) for w in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    assert not errors, errors


# -- (a) the sharded engine ----------------------------------------------------

def test_sharded_engine_matches_jax():
    _check_lazy_spawn()
    _check_workload_parity()
    _check_cut_mid_burst()
    _check_drain_and_finish_fence_every_shard()
    _check_dead_shard_raises()


def _check_lazy_spawn():
    def body(mv, tables, zoo):
        eng = zoo.server_engine
        assert type(eng).__name__ == "ShardedServer"
        slots = []
        for _ in range(4):
            _matrices(mv, tables, 1, 8, 2)
            slots.append([s.get("slot", s.get("shard"))
                          for s in eng.shard_states()])
        return slots, eng.shard_states()

    jslots, _ = _jax_world(["-mv_engine_shards=3"], body)
    tslots, states = _port_world(["-mv_engine_shards=3"], body)
    # lazy spawn: table 0 rides the router, tables 1 and 2 spawn shards,
    # table 3 routes back to slot 0
    assert tslots == jslots == [[0], [0, 1], [0, 1, 2], [0, 1, 2]]
    # the port's keys, then the JAX engine's stream state beside them
    assert [{k: st[k] for k in ("slot", "name", "mailbox_depth", "alive")}
            for st in states] == [
        {"slot": k, "name": "server" if k == 0 else f"server_shard{k}",
         "mailbox_depth": 0, "alive": True} for k in range(3)]
    assert [(st["shard"], st["actor"], st["poisoned"]) for st in states] \
        == [(k, st["name"], None) for k, st in enumerate(states)]


def _check_workload_parity():
    def body(move):
        def run(mv, tables, zoo):
            ts = _matrices(mv, tables, 4, 64, 4)
            rng = np.random.default_rng(99)
            _multi_table_workload(mv, ts, rng, rounds=6)
            moved = None
            if move:
                eng = zoo.server_engine
                moved = zoo.CallOnEngine(
                    _msg_types(mv).Request_StoreLoad,
                    lambda: eng.install_routing({1: 0, 3: 2}), "routing")
                moved = (moved, eng.routing_report()["routing"])
            return _multi_table_workload(mv, ts, rng, rounds=6), moved
        return run

    jgot, jmoved = _jax_world(["-mv_engine_shards=4"], body(True))
    tgot, tmoved = _port_world(["-mv_engine_shards=4"], body(True))
    single, _ = _port_world(["-mv_engine_shards=1"], body(False))
    assert tmoved == ([(1, 1, 0), (3, 3, 2)], {0: 0, 1: 0, 2: 2, 3: 2})
    assert [list(m) for m in jmoved[0]] == [list(m) for m in tmoved[0]]
    assert jmoved[1] == tmoved[1]
    for j, t, s in zip(jgot, tgot, single):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, s)


def _check_cut_mid_burst():
    """A StoreLoad cut sent between two fire-and-forget bursts on 3 shards,
    without waiting for the first: its snapshot holds every Add of the
    first burst and none of the second; a blocking CallOnEngine after the
    second holds both."""
    def body(mv, tables, zoo):
        from multiverso_tpu_torch.message import Message, MsgType
        from multiverso_tpu_torch.utils.waiter import Waiter
        ts = _matrices(mv, tables, 3, 32, 4)
        assert len(zoo.server_engine.shard_states()) == 3
        rng = np.random.default_rng(5)
        ids = np.arange(16, dtype=np.int32)
        oracle = np.zeros((3, 32, 4), np.float32)

        def burst(n):
            for _ in range(n):
                for k, t in enumerate(ts):
                    d = rng.integers(-3, 4, (16, 4)).astype(np.float32)
                    t.AddFireForget(d, row_ids=ids)
                    oracle[k, ids] += d

        def snapshot():
            return np.stack([t.server().raw() for t in ts])

        burst(20)
        pre = oracle.copy()
        waiter = Waiter(1)
        cut = Message(msg_type=MsgType.Request_StoreLoad,
                      payload={"fn": snapshot}, waiter=waiter)
        zoo.SendToServer(cut)
        burst(20)
        waiter.Wait()
        np.testing.assert_array_equal(cut.result, pre)
        after = zoo.CallOnEngine(MsgType.Request_StoreLoad, snapshot, "snap")
        np.testing.assert_array_equal(after, oracle)
        return zoo.server_engine.cut_count

    assert _port_world(["-mv_engine_shards=3"], body) == 2


def _check_drain_and_finish_fence_every_shard():
    def body(mv, tables, zoo):
        ts = _matrices(mv, tables, 2, 16, 2)
        eng = zoo.server_engine
        ids = np.arange(4, dtype=np.int32)

        def burst(n):
            for t in ts:
                for _ in range(n):
                    t.AddFireForget(np.ones((4, 2), np.float32), row_ids=ids)

        burst(5)
        c0 = eng.cut_count
        zoo.DrainServer()           # a barrier ping is a cross-stream cut
        assert eng.cut_count == c0 + 1
        for t in ts:                # read on this thread: every shard done
            np.testing.assert_array_equal(t.server().raw()[:4], 5.0)
        burst(3)
        zoo.FinishTrain()           # one cut per worker
        assert eng.cut_count == c0 + 1 + zoo.num_workers
        for t in ts:
            np.testing.assert_array_equal(t.server().raw()[:4], 8.0)

    _port_world(["-mv_engine_shards=2", "-num_workers=2"], body)


def _check_dead_shard_raises():
    """A shard whose loop thread died: its table's verbs and every cut
    raise ActorDied (whether it died before the cut was sent or with the
    cut's fence queued behind the fatal message), the other shard keeps
    serving, and the world shuts down."""
    from multiverso_tpu_torch.actor import Actor, ActorDied
    from multiverso_tpu_torch.message import Message, MsgType

    def kill(msg):
        raise SystemExit("shard killed by the test")

    def body(mv, tables, zoo):
        ts = _matrices(mv, tables, 2, 8, 2)
        ids = np.arange(2, dtype=np.int32)
        sub = zoo.server_engine._subs[1]
        sub.RegisterHandler(MsgType.Default, kill)
        Actor.Receive(sub, Message(msg_type=MsgType.Default))
        with pytest.raises(ActorDied):
            zoo.DrainServer()       # the fence sat behind the fatal message
        assert sub._poison is not None
        with pytest.raises(ActorDied):
            ts[1].AddRows(ids, np.ones((2, 2), np.float32))
        with pytest.raises(ActorDied):
            zoo.CallOnEngine(MsgType.Request_StoreLoad, lambda: None, "cut")
        ts[0].AddRows(ids, np.ones((2, 2), np.float32))
        np.testing.assert_array_equal(ts[0].GetRows(ids), 1.0)
        assert [s["alive"] for s in zoo.server_engine.shard_states()] == [
            True, False]

    _port_world(["-mv_engine_shards=2"], body)


# -- (b) BSP -------------------------------------------------------------------

def test_bsp_matches_jax():
    _check_vector_clock()
    _check_bsp_rounds()
    _check_uneven_finish_train()
    _check_bsp_multi_verbs()


def _check_vector_clock():
    from multiverso_tpu.sync.server import VectorClock as JClock
    from multiverso_tpu_torch.sync.server import VectorClock as TClock
    script = [("u", 0), ("u", 0), ("u", 1), ("u", 2), ("u", 1), ("f", 0),
              ("u", 2), ("u", 1), ("u", 2), ("f", 1), ("f", 2)]
    j, t = JClock(3), TClock(3)
    for op, i in script:
        fn = "Update" if op == "u" else "FinishTrain"
        assert getattr(t, fn)(i) == getattr(j, fn)(i), (op, i)
        assert t.global_clock() == j.global_clock()
        assert t.staleness() == j.staleness()
        assert t.DebugString() == j.DebugString()


W, ITERS, R, C = 4, 5, 24, 3


def _bsp_script():
    rng = np.random.default_rng(17)
    return [[(np.sort(rng.choice(R, 8, replace=False)).astype(np.int32),
              rng.integers(-4, 5, (8, C)).astype(np.float32))
             for _ in range(ITERS)] for _ in range(W)]


def _check_bsp_rounds():
    script = _bsp_script()

    def body(mv, tables, zoo):
        assert type(zoo.server_engine).__name__ == "SyncServer"
        (t,) = _matrices(mv, tables, 1, R, C)
        got = [[] for _ in range(W)]

        def worker(wid):
            with zoo.worker_context(wid):
                for ids, d in script[wid]:
                    t.AddRows(ids, d)
                    got[wid].append(t.GetRows(np.arange(R, dtype=np.int32)))

        _run_threads(worker, W)
        return got

    argv = ["-sync=true", f"-num_workers={W}"]
    jgot = _jax_world(argv, body)
    tgot = _port_world(argv, body)
    oracle = np.zeros((R, C), np.float32)
    for i in range(ITERS):
        for w in range(W):
            ids, d = script[w][i]
            oracle[ids] += d
        for w in range(W):
            np.testing.assert_array_equal(tgot[w][i], oracle,
                                          err_msg=f"worker {w} Get {i}")
            np.testing.assert_array_equal(jgot[w][i], oracle)


def _check_uneven_finish_train():
    """Worker 0 runs a round ahead of worker 1, which stops: worker 0's
    second Get stays cached until FinishTrain drains it (reference
    server.cpp:188-211)."""
    def body(mv, tables, zoo):
        (t,) = _matrices(mv, tables, 1, 8, 2)
        ids = np.arange(8, dtype=np.int32)
        ones = np.ones((8, 2), np.float32)

        def slow_worker(_):
            with zoo.worker_context(1):
                t.AddRows(ids, ones)
                t.GetRows(ids)

        th = threading.Thread(target=slow_worker, args=(1,))
        th.start()
        with zoo.worker_context(0):
            t.AddRows(ids, ones)
            t.GetRows(ids)
            t.AddRows(ids, ones)        # cached until worker 1's Get
            handle = t.GetAsyncHandle(row_ids=ids)
        th.join(60)
        assert not th.is_alive()
        waiter = getattr(t, "_waiters", {}).get(handle)
        if waiter is not None:          # the port's: still pending
            assert waiter.Wait(0.2) is False
        zoo.FinishTrain()
        return t.Wait(handle)

    argv = ["-sync=true", "-num_workers=2"]
    jgot = _jax_world(argv, body)
    tgot = _port_world(argv, body)
    np.testing.assert_array_equal(tgot, np.full((8, 2), 3.0, np.float32))
    np.testing.assert_array_equal(tgot, jgot)


def _check_bsp_multi_verbs():
    """MV_MultiAdd/MV_MultiGet under BSP: the engine takes the members one
    at a time (no envelope reaches it), and an envelope handed to it
    directly is flattened through the clocked entries."""
    rng = np.random.default_rng(23)
    ids = np.arange(5, dtype=np.int32)
    deltas = [rng.integers(-3, 4, (5, 2)).astype(np.float32) for _ in range(2)]

    def body(mv, tables, zoo):
        ts = _matrices(mv, tables, 2, 10, 2)
        eng = zoo.server_engine
        assert eng.MULTI_VERB_OK is False
        seen = []
        receive = eng.Receive
        eng.Receive = lambda m: (seen.append(m.msg_type), receive(m))[1]
        mv.MV_MultiAdd([(t, {"row_ids": ids, "values": d})
                        for t, d in zip(ts, deltas)])
        got = mv.MV_MultiGet([(t, {"row_ids": ids}) for t in ts])
        del eng.Receive
        if mv.__name__ == "multiverso_tpu_torch":
            from multiverso_tpu_torch.tables.base import MultiCall
            call = MultiCall(2, 2)
            eng.receive_multi([t._multi_member("G", {"row_ids": ids}, None,
                                               call, k, True)
                               for k, t in enumerate(ts)])
            np.testing.assert_array_equal(np.stack(call.Wait()),
                                          np.stack(got))
        return [int(x) for x in seen], got

    argv = ["-sync=true", "-num_workers=1"]
    jseen, jgot = _jax_world(argv, body)
    tseen, tgot = _port_world(argv, body)
    assert tseen == jseen == [2, 2, 1, 1]     # Add, Add, Get, Get
    for j, t, d in zip(jgot, tgot, deltas):
        np.testing.assert_array_equal(t, d)
        np.testing.assert_array_equal(t, j)


# -- (c) model-average and the flags -----------------------------------------

ENGINE_ARGVS = ([], ["-mv_engine_shards=1"], ["-mv_engine_shards=3"],
                ["-sync=true", "-num_workers=2"], ["-ma=true"])


def test_model_average_and_flags_match_jax():
    _check_engine_selection()
    _check_aggregate()
    _check_flags_parse()
    _check_shutdown_signature()
    _check_device_rule_in_every_mode()


def _check_engine_selection():
    """Each argv builds the same engine class in both packages (none under
    -ma, which also has no servers), and leaves nothing in the argv."""
    import multiverso_tpu as jmv
    import multiverso_tpu_torch as tmv
    from multiverso_tpu.zoo import Zoo as JZoo
    from multiverso_tpu_torch.zoo import Zoo as TZoo
    for argv in ENGINE_ARGVS:
        got = []
        for mv, zoo_cls, extra in ((jmv, JZoo, []),
                                   (tmv, TZoo, ["-mv_device=cpu"])):
            rest = mv.MV_Init(list(argv) + extra)
            try:
                eng = zoo_cls.Get().server_engine
                got.append((rest, None if eng is None else type(eng).__name__,
                            mv.MV_NumServers() if "-ma=true" in argv else 0))
            finally:
                mv.MV_ShutDown()
        assert got[0] == got[1], (argv, got)
        assert got[1][0] == [], argv
    assert [g[1] for g in got] == [None, None]
    assert _port_world(["-mv_engine_shards=1"],
                       lambda mv, t, zoo: type(zoo.server_engine).__name__
                       ) == "Server"


def _check_aggregate():
    """4 workers, two rounds, float32 and float64 buffers. Element 0 of the
    float32 buffer is 1 + 2**-24 + 2**-24 + 2**-24: summed in float32 it
    stays 1.0, summed in float64 and cast back it is 1 + 2**-22."""
    rng = np.random.default_rng(31)
    # sums of values within 2**13 of one another are exact in float64,
    # so the result does not depend on the order the workers arrive in
    f32 = [(rng.choice([-1.0, 1.0], 1000) * rng.uniform(0.5, 1.0, 1000)
            * 2.0 ** rng.integers(-6, 7, 1000)).astype(np.float32)
           for _ in range(W)]
    f32[0][0] = 1.0
    for w in range(1, W):
        f32[w][0] = 2.0 ** -24

    def body(mv, tables, zoo):
        assert zoo.server_engine is None
        from multiverso_tpu.utils.log import FatalError as JFatal
        from multiverso_tpu_torch.utils.log import FatalError as TFatal
        with pytest.raises((JFatal, TFatal), match="-ma mode"):
            _matrices(mv, tables, 1, 4, 2)
        out = [None] * W

        def worker(wid):
            with zoo.worker_context(wid):
                a = f32[wid].copy()
                b = np.array([1.0, float(wid)], np.float64)
                ret = mv.MV_Aggregate(a)
                assert ret is a and a.dtype == np.float32
                mv.MV_Aggregate(b)
                out[wid] = (a, b, mv.MV_Aggregate(a.copy()))

        _run_threads(worker, W)
        return out

    argv = ["-ma=true", f"-num_workers={W}"]
    jout = _jax_world(argv, body)
    tout = _port_world(argv, body)
    want = np.sum(np.stack(f32).astype(np.float64), axis=0).astype(
        np.float32)
    assert want[0] == np.float32(1 + 2.0 ** -22)
    for w in range(W):
        a, b, again = tout[w]
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, [4.0, 6.0])
        np.testing.assert_array_equal(again, want * W)
        for x, y in zip(tout[w], jout[w]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _check_flags_parse():
    from multiverso_tpu_torch.utils.configure import (GetFlag, ParseCMDFlags,
                                                      ResetFlagsToDefaults)
    try:
        rest = ParseCMDFlags(["-sync=true", "-ma=false",
                              "-mv_engine_shards=2", "-sync=maybe",
                              "-not_a_flag=1", "pos"])
        assert rest == ["-sync=maybe", "-not_a_flag=1", "pos"]
        assert GetFlag("sync") is True and GetFlag("ma") is False
        assert GetFlag("mv_engine_shards") == 2
    finally:
        ResetFlagsToDefaults()
    assert GetFlag("sync") is False and GetFlag("mv_engine_shards") == 0


def _check_shutdown_signature():
    """MV_ShutDown takes the JAX package's ``finalize_net`` flag, by
    position and by name, in both packages; either way the next world
    starts from the flags' defaults."""
    import multiverso_tpu as jmv
    import multiverso_tpu_torch as tmv
    from multiverso_tpu.utils.configure import GetFlag as JGetFlag
    from multiverso_tpu_torch.utils.configure import GetFlag as TGetFlag
    for mv, get_flag, extra in ((jmv, JGetFlag, []),
                                (tmv, TGetFlag, ["-mv_device=cpu"])):
        for shut in (lambda: mv.MV_ShutDown(False),
                     lambda: mv.MV_ShutDown(finalize_net=True)):
            mv.MV_Init(["-sync=true", f"-num_workers={W}"] + extra)
            try:
                assert get_flag("sync") is True
            finally:
                shut()
            assert get_flag("sync") is False
            assert get_flag("num_workers") == 1
        shut()                          # idempotent


def _check_device_rule_in_every_mode():
    """Without a card, every mode's world raises unless the CPU is asked
    for: -ma starts no engine but still holds the device rule."""
    if torch.cuda.is_available():
        return                      # a card is present: the rule holds
    import multiverso_tpu_torch as tmv
    from multiverso_tpu_torch.utils.log import FatalError
    from multiverso_tpu_torch.zoo import Zoo
    for argv in ENGINE_ARGVS:
        try:
            with pytest.raises(FatalError, match="no CUDA device"):
                tmv.MV_Init(list(argv))
            assert not Zoo.Get().started
        finally:
            tmv.MV_ShutDown()
