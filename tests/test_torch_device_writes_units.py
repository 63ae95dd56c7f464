"""The device plane's collective writes on the device route, in one process.

(1) The application channel's slot protocol between two ranks in threads
    over the plain backend (the agreement and swap rounds a barrier
    rendezvous): write ``seq`` in slot ``seq % 2`` of the channel ``APP``,
    every rank's deltas read back in rank order in their own dtype
    (float32 and int32), a write that outgrows ``MIN_SLOT`` after small
    ones runs the handle swap and frees the replaced slot only after the
    peer closed it, and an engine channel staged beside it keeps its own
    slots.
(2) The collective writes of two simulated ranks, each a thread with its
    own tables of one world (``multihost.world_size``, the route function
    and the control round patched: the round a rendezvous of the
    threads), on the device route and on the host route: the row batches
    merged for the apply (``_update_rows_padded``'s arguments, a lone
    -0.0 delta and duplicates across the ranks included), the tables and
    the rides' sums (the matrix write's float64 sum of float32-rounded
    rides, the array write's float32 lane) bitwise equal across the routes
    and the ranks, the copies' bytes every peer's deltas.
"""

import threading

import numpy as np
import torch

from multiverso_tpu_torch.parallel import device_wire, flat, multihost

torch.set_num_threads(1)


class _Log(device_wire._Shm):
    """The plain backend, logging closes and frees."""

    def __init__(self, token, rank, log):
        super().__init__(token, rank)
        self.log = log

    def close(self, seg):
        self.log.append(("close", seg.name))
        super().close(seg)

    def free(self, seg):
        self.log.append(("free", seg.name))
        super().free(seg)


class _Rendezvous:
    """Every thread's object of one round, in rank order."""

    def __init__(self):
        self.box, self.bar = [None, None], threading.Barrier(2)

    def round(self, rank, obj):
        self.box[rank] = obj
        self.bar.wait(20)
        got = list(self.box)
        self.bar.wait(20)
        return got


def _two_ranks(fn):
    """``fn(rank, rendezvous)`` on two threads; their results."""
    rv, out, errs = _Rendezvous(), [None, None], []

    def run(rank):
        try:
            out[rank] = fn(rank, rv)
        except BaseException as exc:      # reported on the main thread
            errs.append(exc)
            rv.bar.abort()

    ths = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(60)
    assert not errs, errs
    return out


def test_app_channel_slot_protocol():
    log: list = []
    token = device_wire.secrets.token_hex(4)
    wires = [device_wire.DeviceWire(_Log(token, r, log), r, 2)
             for r in range(2)]

    def deltas(rank, seq, n):
        g = np.random.default_rng([seq, rank])
        if seq == 1:
            return [torch.from_numpy(g.integers(-9, 9, n).astype(np.int32))]
        return [torch.from_numpy(g.standard_normal(k).astype(np.float32))
                for k in (n, n // 3 + 1)]

    sizes = ((0, 1000), (1, 300), (2, 400_000), (3, 50))
    seen = {}
    for seq, n in sizes:
        def step(rank, rv, seq=seq, n=n):
            w = wires[rank]
            assert w.next_write() == seq
            mine = deltas(rank, seq, n)
            w.stage_writes(seq, mine)
            if seq == 2:
                # an engine window staged beside the write keeps its slots
                w.stage(0, 0, [("A", 0, {"values": flat.DeferredArray.of(
                    np.arange(10, dtype=np.float32))})])
            specs = rv.round(rank, [t.numel() * t.element_size()
                                    for t in mine])
            rounds, grows = w.settle_writes(
                seq, specs, lambda blob: rv.round(rank, blob))
            got, peer_n, peer_bytes, _ = w.gather_writes(
                seq, specs, mine[0].dtype, torch.device("cpu"))
            want = torch.cat([t for r in range(2)
                              for t in deltas(r, seq, n)])
            assert got.dtype == want.dtype
            assert got.numpy().tobytes() == want.numpy().tobytes()
            assert (peer_n, peer_bytes) == (len(specs[1 - rank]),
                                            sum(specs[1 - rank]))
            return rounds, grows, dict(w._mine)

        seen[seq] = _two_ranks(step)
    for r in range(2):
        # a swap round at the first use of each slot, two when slot 0
        # grew past MIN_SLOT (the replaced slot freed after the close)
        assert [seen[s][r][:2] for s, _ in sizes] == [(1, 2), (1, 2),
                                                      (2, 2), (0, 0)]
        mine = seen[2][r][2]
        app0 = mine[(device_wire.APP, 0)]
        assert app0[1] == 4 << 20        # 2.1 MB of deltas
        assert app0[0].name != seen[1][r][2][(device_wire.APP, 0)][0].name
        assert (0, 0) in mine and mine[(0, 0)][0].name not in {
            s.name for s, _ in seen[1][r][2].values()}
        old = seen[1][r][2][(device_wire.APP, 0)][0].name
        assert ("close", old) in log and ("free", old) in log
        assert log.index(("close", old)) < log.index(("free", old))
    for w in wires:
        w.close()


def test_two_thread_ranks_route_bitwise(monkeypatch):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import (ArrayTableOption,
                                             KVTableOption,
                                             MatrixTableOption)
    from multiverso_tpu_torch.tables import matrix_table
    from multiverso_tpu_torch.updaters.base import AddOption

    R, C = 400, 12
    local = threading.local()
    rv = _Rendezvous()
    token = device_wire.secrets.token_hex(4)
    wires = [device_wire.DeviceWire(device_wire._Shm(token, r), r, 2)
             for r in range(2)]
    route = {"device": True}

    def capped(obj, key, stat="agree"):
        got = rv.round(local.rank, (key, obj))
        assert all(k == key for k, _ in got), got
        return [o for _, o in got]

    stat_keys = list(multihost.STATS)

    class _RankStats(dict):
        """``multihost.STATS`` kept per simulated rank (a thread)."""

        def __init__(self):
            super().__init__()
            self.by_rank = {}

        def _mine(self):
            return self.by_rank.setdefault(local.rank,
                                           dict.fromkeys(stat_keys, 0))

        def __getitem__(self, key):
            return self._mine()[key]

        def __setitem__(self, key, value):
            self._mine()[key] = value

    applied = {}
    orig = matrix_table.MatrixServerTable._update_rows_padded

    def record(self, ids, d, opt):
        applied.setdefault((route["device"], local.rank), []).append(
            (np.asarray(ids).tobytes(), d.numpy().tobytes()))
        return orig(self, ids, d, opt)

    monkeypatch.setattr(matrix_table.MatrixServerTable,
                        "_update_rows_padded", record)

    def batch(rank, step, n):
        g = np.random.default_rng([7, step, rank])
        ids = g.integers(0, R // 2, n).astype(np.int32)
        d = g.standard_normal((n, C)).astype(np.float32)
        d[g.random(d.shape) < 0.2] = -0.0
        if step == 0:
            # a row only this rank writes, its delta all -0.0
            ids[0], d[0] = R - 1 - rank, -0.0
        return ids, d

    mv.MV_Init(["-mv_device=cpu"])
    try:
        worlds = {}
        for dev in (True, False):
            worlds[dev] = [dict(
                mat=mv.MV_CreateTable(MatrixTableOption(
                    num_rows=R, num_cols=C, updater_type="sgd")).server(),
                ada=mv.MV_CreateTable(MatrixTableOption(
                    num_rows=R, num_cols=C,
                    updater_type="adagrad")).server(),
                arr=mv.MV_CreateTable(ArrayTableOption(size=300)).server(),
                kv=mv.MV_CreateTable(KVTableOption()).server())
                for _ in range(2)]

        def ranks(rank, _rv):
            local.rank = rank
            t = worlds[route["device"]][rank]
            opt = AddOption(learning_rate=0.25)
            out = {}
            for step, n in enumerate((30, 20, 25000)):
                ids, d = batch(rank, step, n)
                ride = (torch.tensor(0.1 + step + rank) if step % 2
                        else 1.0 / 3.0 + rank)
                out[f"ride{step}"] = t["mat"].device_apply_rows(
                    ids, torch.from_numpy(d), opt, ride=ride)
            ids, d = batch(rank, 3, 25)
            d = torch.from_numpy(d)
            out["many"] = matrix_table.device_apply_rows_many(
                [(t["mat"], ids, d), (t["ada"], ids[::-1].copy(), d)], opt,
                ride=torch.tensor(2.0 / 7.0, dtype=torch.float64))
            state = t["arr"].device_state()
            g = np.random.default_rng([9, rank])
            delta = torch.from_numpy(g.standard_normal(
                state["data"].numel()).astype(np.float32))
            new, out["arr_ride"] = t["arr"].device_update(
                state, delta, AddOption().as_tensors(),
                ride=torch.tensor(0.3 + rank))
            t["arr"].device_set_state(new)
            keys = np.concatenate([np.arange(20), 100 + rank + 2 *
                                   np.arange(20)]).astype(np.int64)
            slots = t["kv"].device_slots(keys, create=True)
            pad = np.zeros(len(slots), np.float32)
            pad[:40] = g.standard_normal(40).astype(np.float32)
            out["kv_bytes"] = pad.nbytes
            gs, gd = t["kv"].device_place_slots(
                slots, torch.from_numpy(pad) if rank else pad)
            t["kv"].device_set_values(t["kv"].device_scatter_add_slots(
                t["kv"].device_values(), gs, gd))
            out.update(mat=t["mat"].raw(), ada=t["ada"].raw(),
                       arr=t["arr"].device_access(t["arr"].state).numpy(),
                       kv=t["kv"].device_values().numpy().copy())
            return out

        got = {}
        with monkeypatch.context() as m:
            m.setattr(multihost, "world_size", lambda: 2)
            m.setattr(multihost, "host_allgather_objects_capped", capped)
            m.setattr(multihost, "_write_wire", lambda: (
                wires[local.rank] if route["device"] else None))
            for dev in (True, False):
                route["device"] = dev
                stats = _RankStats()
                m.setattr(multihost, "STATS", stats)
                got[dev] = _two_ranks(ranks)
                got[(dev, "stats")] = [stats.by_rank[r] for r in range(2)]
    finally:
        mv.MV_ShutDown()
        for w in wires:
            w.close()
    for rank in range(2):
        for key in got[True][0]:
            a, b = got[True][rank][key], got[False][rank][key]
            if isinstance(a, np.ndarray):
                assert a.tobytes() == b.tobytes(), (rank, key)
                assert a.tobytes() == got[True][0][key].tobytes(), key
            else:
                assert type(a) is type(b) and a == b, (rank, key, a, b)
                assert a == got[True][0][key], key
        assert applied[(True, rank)] == applied[(False, rank)]
    # the rides: the matrix write's float64 sum in rank order of the
    # float32-rounded rides, the array write's float32 lane
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    assert got[True][0]["ride1"] == f32(1.1) + f32(2.1)
    assert got[True][0]["ride0"] == 1.0 / 3.0 + (1.0 / 3.0 + 1)
    assert got[True][0]["arr_ride"] == float(np.float32(0.3) +
                                             np.float32(1.3))
    # the -0.0 row each rank alone wrote merged as -0.0
    ids, deltas = applied[(True, 0)][0]
    ids = np.frombuffer(ids, np.int32)
    deltas = np.frombuffer(deltas, np.float32).reshape(len(ids), -1)
    for lone in (R - 1, R - 2):
        row = deltas[list(ids).index(lone)]
        assert np.all(row == 0) and np.all(np.signbit(row[:C]))
    for rank in range(2):
        dev, host = got[(True, "stats")][rank], got[(False, "stats")][rank]
        peer = got[(True, "stats")][1 - rank]
        assert host["stage_n"] == host["copy_peer_n"] == 0
        assert dev["stage_n"] == 6      # three writes, many, arr, kv
        # each rank copied its peer's deltas, a copy a delta, and no delta
        # crossed to the host: the device scalar rides alone
        assert dev["copy_peer_bytes"] == peer["stage_bytes"]
        assert dev["copy_peer_n"] == 3 + 2 + 1 + 1
        assert dev["d2h_bytes"] == 4 * 3
        # the host route moves every device delta (rank 0's KV deltas are
        # host numpy) and the same rides
        assert host["d2h_bytes"] == dev["stage_bytes"] + dev["d2h_bytes"] \
            - (got[True][0]["kv_bytes"] if rank == 0 else 0)
        # a swap at the first use of either slot, two when slot 0 outgrew
        # MIN_SLOT at the third write (a replaced slot)
        assert dev["swap_n"] == 1 + 1 + 2
