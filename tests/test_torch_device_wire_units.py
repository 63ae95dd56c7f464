"""The device window transport's pieces in one process, against the JAX
package's.

(1) The flat codec's ``v`` tag: a window holding a ``DeferredArray``
    encodes to the JAX package's bytes, each package decodes the other's to
    a ``DeferredArray`` of the same dtype and shape, and ``payload_nbytes``
    / ``payload_has_deferred`` agree with the JAX functions.
(2) The pack-time selection (``Server._mh_maybe_defer``, run unbound on a
    stand-in engine whose tables answer through the real classes'
    ``device_wire_add_ok``): the JAX decision and counter bytes for host,
    device, and auto below and above the floor, a compressed matrix, bf16
    values, a KV payload, a whole-table matrix Add, an array whole-table
    Add (and a wrong-size one), a re-led deferred value and a bad table id;
    and the port's own rule that ``auto`` defers nothing under several
    shard streams.
(3) The plain slot protocol between two ranks in threads (the swap round a
    barrier rendezvous): window ``seq`` in slot ``seq % 2``, the peers'
    values read back exactly, a rank-agreed grow with the handle swap, and
    the old slot freed only after the peer closed it; and the device merge
    (``MatrixServerTable._merge_device_rows``: ``dedup_rows(deterministic=
    True)`` in rank order) bitwise ``_combine_duplicate_rows`` on batches
    with duplicates across ranks and ``-0.0`` deltas, and the array's
    rank-order sum bitwise ``np.sum(axis=0)``.
"""

import threading
import types

import ml_dtypes
import numpy as np
import torch

from multiverso_tpu.parallel import flat as jflat
from multiverso_tpu.parallel import wire as jwire
from multiverso_tpu.sync.server import Server as JServer
from multiverso_tpu.tables.array_table import ArrayServer as JArray
from multiverso_tpu.tables.kv_table import KVServerTable as JKV
from multiverso_tpu.tables.matrix_table import MatrixServerTable as JMatrix
from multiverso_tpu_torch.parallel import device_wire
from multiverso_tpu_torch.parallel import flat, wire
from multiverso_tpu_torch.sync.server import Server
from multiverso_tpu_torch.tables.array_table import ArrayServer
from multiverso_tpu_torch.tables.kv_table import KVServerTable
from multiverso_tpu_torch.tables.matrix_table import (MatrixServerTable,
                                                      _combine_duplicate_rows)

torch.set_num_threads(1)


def _body(blob: bytes) -> bytes:
    """A sealed blob without its trailer (the CRC algorithm may differ)."""
    return blob[:len(blob) - (5 if blob[-1] == 0xC2 else 4)]


def test_v_tag_and_byte_accounting_match_jax():
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((6, 5)).astype(np.float32)
    ids = np.arange(6, dtype=np.int32)

    def window(mod):
        return [("A", 3, {"row_ids": ids, "values": mod.DeferredArray.of(
            vals), "option": None}),
                ("A", 1, {"values": mod.DeferredArray(np.float64, (4,))}),
                ("G", 0, {"row_ids": ids, "option": None}),
                ("A", 2, {"row_ids": ids, "values": vals, "option": None})]

    mine = wire.encode_window(window(flat), seq=5)
    theirs = jwire.encode_window(window(jflat), seq=5)
    assert _body(mine) == _body(theirs)
    for blob in (mine, theirs):
        for dec, cls in ((wire.decode_window_seq, flat.DeferredArray),
                         (jwire.decode_window_seq, jflat.DeferredArray)):
            seq, got = dec(blob)
            assert seq == 5
            v0, v1 = got[0][2]["values"], got[1][2]["values"]
            assert isinstance(v0, cls) and isinstance(v1, cls)
            assert (v0.dtype, v0.shape, v0.local) == (vals.dtype, (6, 5),
                                                      None)
            assert (v1.dtype, v1.shape, v1.nbytes) == (np.float64, (4,), 32)
            np.testing.assert_array_equal(got[3][2]["values"], vals)
    for (_, _, p), (_, _, jp) in zip(window(flat), window(jflat)):
        assert wire.payload_nbytes(p) == jwire.payload_nbytes(jp)
        assert wire.payload_has_deferred(p) == jwire.payload_has_deferred(jp)
    d = flat.DeferredArray.of(vals)
    assert (d.size, d.nbytes, d.local is vals) == (30, 120, True)


class _Count:
    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


def _engine(server_cls, classes):
    """A stand-in engine whose tables are the real classes'
    ``device_wire_add_ok`` bound to stand-in state: a 64 x 8 matrix, a
    compressed one, a 256-float array and a KV table."""
    matrix, array, kv = classes

    def table(cls, **state):
        t = types.SimpleNamespace(**state)
        t.device_wire_add_ok = lambda p, t=t: cls.device_wire_add_ok(t, p)
        return t

    eng = types.SimpleNamespace(
        store_=[table(matrix, compress=None),
                table(matrix, compress="sparse"),
                table(array, size=256), table(kv)],
        _t_defer=_Count(), _t_dev_bytes=_Count(),
        mh_single_collective_stream=True)
    return eng, server_cls._mh_maybe_defer


def test_pack_selection_matches_jax():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((40, 8)).astype(np.float32)     # 1280 B
    big = rng.standard_normal((400, 8)).astype(np.float32)     # 12800 B
    ids40, ids400 = np.arange(40, dtype=np.int32), np.arange(
        400, dtype=np.int32) % 64
    cases = [
        ("host", 0, {"row_ids": ids400, "values": big}),
        ("device", 0, {"row_ids": ids40, "values": rows}),
        ("auto", 0, {"row_ids": ids40, "values": rows}),       # below
        ("auto", 0, {"row_ids": ids400, "values": big}),       # above
        ("device", 1, {"row_ids": ids40, "values": rows}),     # compressed
        ("device", 0, {"row_ids": ids40,
                       "values": rows.astype(ml_dtypes.bfloat16)}),
        ("device", 3, {"keys": ids40.astype(np.int64),
                       "values": rows[:, 0].copy()}),          # KV
        ("device", 0, {"row_ids": None, "values": rng.standard_normal(
            (64, 8)).astype(np.float32)}),                     # whole matrix
        ("device", 2, {"values": rng.standard_normal(256).astype(
            np.float32)}),                                     # array
        ("device", 2, {"values": rows[:, 0].copy()}),          # wrong size
        ("device", 9, {"row_ids": ids40, "values": rows}),     # bad table
    ]
    port, port_defer = _engine(Server, (MatrixServerTable, ArrayServer,
                                        KVServerTable))
    jax, jax_defer = _engine(JServer, (JMatrix, JArray, JKV))
    decisions = []
    for mode, tid, payload in cases:
        mine = port_defer(port, tid, dict(payload), mode, 4096, object())
        theirs = jax_defer(jax, tid, dict(payload), mode, 4096)
        d = isinstance(mine["values"], flat.DeferredArray)
        assert d == isinstance(theirs["values"], jflat.DeferredArray), \
            (mode, tid)
        if d:
            assert mine["values"].local is payload["values"]
        decisions.append(d)
    assert decisions == [False, True, False, True, False, False, False,
                         False, True, False, False]
    # a re-led verb: its value stays deferred, counted once
    led = port_defer(port, 0, {"row_ids": ids40, "values": rows}, "device",
                     4096, object())
    jled = jax_defer(jax, 0, {"row_ids": ids40, "values": rows}, "device",
                     4096)
    assert port_defer(port, 0, led, "device", 4096, object()) is led
    assert jax_defer(jax, 0, jled, "device", 4096) is jled
    assert port._t_defer.value == jax._t_defer.value == 4
    assert port._t_dev_bytes.value == jax._t_dev_bytes.value == \
        1280 + 12800 + 1024 + 1280
    # no active wire: a deferred value goes back to its array
    back = port_defer(port, 0, led, "device", 4096, None)
    assert back["values"] is rows
    # the port's departure: under several shard streams auto defers
    # nothing (device still does, and the window then fails its CHECK)
    port.mh_single_collective_stream = False
    big_add = {"row_ids": ids400, "values": big}
    assert port_defer(port, 0, dict(big_add), "auto", 4096,
                      object())["values"] is big
    assert isinstance(port_defer(port, 0, dict(big_add), "device", 4096,
                                 object())["values"], flat.DeferredArray)


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


def _two_ranks(fn):
    """Run ``fn(rank, swap)`` on two threads; ``swap`` is a rendezvous of
    both ranks' blobs."""
    box, bar, out, errs = [None, None], threading.Barrier(2), [None, None], []

    def swap_of(rank):
        def swap(blob):
            box[rank] = blob
            bar.wait(10)
            got = list(box)
            bar.wait(10)
            return got
        return swap

    def run(rank):
        try:
            out[rank] = fn(rank, swap_of(rank))
        except BaseException as exc:      # reported on the main thread
            errs.append(exc)
            bar.abort()

    ths = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(30)
    assert not errs, errs
    return out


def test_slot_protocol_and_the_merge():
    log: list = []
    token = device_wire.secrets.token_hex(4)
    wires = [device_wire.DeviceWire(_Log(token, r, log), r, 2)
             for r in range(2)]
    rng = np.random.default_rng(11)

    def vals(n, seed):
        return np.random.default_rng(seed).standard_normal(n).astype(
            np.float32)

    def window(rank, seq, n):
        return [("A", 0, {"values": flat.DeferredArray.of(
            vals(n, 100 * seq + rank))}),
                ("G", 1, {"row_ids": np.arange(3)}),
                ("A", 2, {"values": flat.DeferredArray.of(
                    vals(n + 7, 100 * seq + rank + 50))})]

    def exchanged(local, rank):
        """What a peer decodes: the same records, values remote."""
        return [(k, t, {key: (flat.DeferredArray(v.dtype, v.shape)
                              if isinstance(v, flat.DeferredArray) else v)
                        for key, v in p.items()}) for k, t, p in local]

    device_wire.reset_stats()
    seen = {}
    for seq, n in ((0, 1000), (1, 500), (2, 300_000), (3, 10)):
        def step(rank, swap, seq=seq, n=n):
            w = wires[rank]
            local = window(rank, seq, n)
            w.stage(0, seq, local)
            swap(b"window")           # the window exchange's edge
            peer = exchanged(window(1 - rank, seq, n), 1 - rank)
            windows = [local, peer] if rank == 0 else [peer, local]
            w.settle(0, seq, windows, swap)
            flat_vals = [p["values"] for win in windows for _, _, p in win
                         if isinstance(p.get("values"), flat.DeferredArray)]
            got = w.gather(flat_vals, torch.device("cpu")).numpy()
            want = np.concatenate([vals(n, 100 * seq + r) if i == 0 else
                                   vals(n + 7, 100 * seq + r + 50)
                                   for r in range(2) for i in range(2)])
            np.testing.assert_array_equal(got, want)
            return dict(w._mine)

        seen[seq] = _two_ranks(step)
    # window seq in slot seq % 2: two segments a rank, the grown one new
    for r in range(2):
        names = {k: s.name for k, (s, _) in seen[1][r].items()}
        assert set(names) == {(0, 0), (0, 1)}
        assert names[(0, 0)] != names[(0, 1)]
        assert seen[2][r][(0, 0)][1] == device_wire.slot_bytes(
            device_wire.layout(window(r, 2, 300_000))[1]) == 4 << 20
        assert seen[2][r][(0, 0)][0].name != names[(0, 0)]
        assert seen[3][r][(0, 0)] == seen[2][r][(0, 0)]
        # the old slot went only after the peer closed its mapping of it
        old = names[(0, 0)]
        assert ("close", old) in log and ("free", old) in log
        assert log.index(("close", old)) < log.index(("free", old))
    # grows: both ranks' two slots, then both ranks' slot 0 again; rounds:
    # one swap at seq 0 and 1, a swap and its close round at seq 2
    assert device_wire.STATS["grows"] == 2 * (2 + 2 + 2)
    assert device_wire.STATS["swaps"] == 2 * (1 + 1 + 2)
    assert device_wire.STATS["copies"] == 2 * 2 * 4
    for w in wires:
        w.close()

    # the device merge, bitwise the host merge (-0.0 and duplicates across
    # ranks), and the array's rank-order sum
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    mv.MV_Init(["-mv_device=cpu"])
    try:
        mat = mv.MV_CreateTable(MatrixTableOption(num_rows=50, num_cols=6))
        srv = mat.server()
        for case in range(4):
            parts = [rng.integers(0, 50, 40).astype(np.int32)
                     for _ in range(3)]
            d = rng.standard_normal((120, 6)).astype(np.float32)
            d[rng.random(d.shape) < 0.2] = -0.0
            ids = np.concatenate(parts)
            if case == 3:             # no duplicate: the batch as it is
                ids, d = rng.permutation(50).astype(np.int32), d[:50]
            want_ids, want = _combine_duplicate_rows(ids, d, 6, np.float32)
            got_ids, got = srv._merge_device_rows(ids, torch.from_numpy(
                d.reshape(-1)))
            np.testing.assert_array_equal(got_ids, want_ids)
            got = got[:, :6].numpy()
            assert got.tobytes() == np.ascontiguousarray(want).tobytes()
    finally:
        mv.MV_ShutDown()
    for n in (2, 3, 5):
        parts = rng.standard_normal((n, 1000)).astype(np.float32)
        t = torch.from_numpy(parts)
        acc = t[0].clone()
        for p in t[1:]:
            acc += p
        assert acc.numpy().tobytes() == np.sum(parts, axis=0).astype(
            np.float32).tobytes()
