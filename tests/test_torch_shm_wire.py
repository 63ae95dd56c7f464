"""The port's shared-memory wire (``multiverso_tpu_torch/parallel/shm_wire.py``)
against the JAX package's.

(a) The protocol, with one end of each package over ONE segment set (the
    segments are per (channel, rank), so threads in one process stand in
    for the two ranks), each package on either rank: a round trip of
    frames of many chunks, independent channels driven by a thread each,
    empty and asymmetric frames; then a payload bitflip and a round
    desync in a JAX writer's segment, each raising the port reader's typed
    ``WireCorruption``. No segment of either end is left in ``/dev/shm``.
(b) A two-rank world of ``tests/_mh_child.py`` mode ``wire`` (add and
    momentum Matrix tables, KV, Array; blocking rounds against the oracle,
    a fire-and-forget burst, a checkpoint cut and its reload): on
    ``-mv_wire=auto`` both packages select the shm wire, and the port's
    tables equal the JAX world's bitwise, across the ranks and on a
    ``-mv_wire=gloo`` world; no segment of the port's session is left.
(c) ``-mv_engine_shards=2`` across the two ranks on the shm wire: the
    add and momentum tables on shards 0 and 1, exchanging on channels 0
    and 1, bitwise equal to the JAX package's world; and the add and KV
    tables bitwise equal to the JAX package's sharded world (which
    refuses a momentum or Array table: its sharded multi-process engine
    takes only tables whose apply stays on the host).
"""

import os
import secrets
import threading

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)


def _left_behind(token: str) -> list:
    return [f for f in os.listdir("/dev/shm") if f.startswith(f"mv{token}")]


def _pair(jax_rank, channels=1, cap=4096, payload_crc=True):
    """A JAX end on ``jax_rank`` and a port end on the other rank, over
    one segment set."""
    from multiverso_tpu.parallel import shm_wire as jshm
    from multiverso_tpu_torch.parallel import shm_wire as tshm
    tok = secrets.token_hex(4)
    ends = [None, None]
    ends[jax_rank] = jshm.ShmWire(tok, jax_rank, 2, channels, cap,
                                  payload_crc=payload_crc)
    ends[1 - jax_rank] = tshm.ShmWire(tok, 1 - jax_rank, 2, channels, cap,
                                      payload_crc=payload_crc)
    for w in ends:
        w.attach_peers()
    return tok, ends


def _both(fns, timeout=30):
    out, errs = {}, {}

    def run(key, fn):
        try:
            out[key] = fn()
        except BaseException as exc:    # reported to the caller
            errs[key] = exc

    ts = [threading.Thread(target=run, args=(k, fn))
          for k, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "wire exchange deadlocked"
    return out, errs


def _drill(corrupt, blob, payload_crc):
    """A JAX writer (rank 0) publishes ``blob``; ``corrupt`` pokes its
    segment before the port reader (rank 1) consumes it; returns what the
    reader's exchange raised."""
    from multiverso_tpu.parallel import shm_wire as jshm
    from multiverso_tpu.utils.configure import SetCMDFlag as jset
    from multiverso_tpu_torch.utils.configure import SetCMDFlag as tset
    # bound both ends: a reader that aborts stops consuming, and the
    # writer's flow control must then fail typed instead of spinning
    jset("mv_deadline_s", 2)
    tset("mv_deadline_s", 2)
    tok, (w0, w1) = _pair(0, cap=4096, payload_crc=payload_crc)
    seg = jshm._attach(jshm.segment_name(tok, 0, 0))
    try:
        u64 = np.frombuffer(seg.buf, np.uint64, count=8)
        base = int(u64[0])
        got = {}

        def writer():
            try:
                got["w"] = w0.exchange(blob, 0)
            except BaseException as exc:   # the drill's expected end
                got["w"] = exc

        def victim():
            import time
            t0 = time.time()
            while int(u64[0]) == base and time.time() - t0 < 10:
                pass                        # wait for the publish
            corrupt(seg)
            try:
                got["v"] = w1.exchange(b"z", 0)
            except BaseException as exc:   # checked by the caller
                got["v"] = exc

        _both([writer, victim])
        del u64
        return got["v"]
    finally:
        jset("mv_deadline_s", 0)
        tset("mv_deadline_s", 0)
        w0.close()
        w1.close()
        try:
            seg.close()
        except BufferError:     # a view of the drill is still alive
            pass
        assert not _left_behind(tok)


def test_protocol_against_the_jax_wire(monkeypatch):
    from multiverso_tpu.parallel import seal as jseal
    from multiverso_tpu.parallel import shm_wire as jshm
    from multiverso_tpu_torch.parallel.seal import WireCorruption
    # the JAX checksum engine resolved anew, from the library the port
    # uses (the fixture's), so both ends pick the same CRC
    monkeypatch.setattr(jseal, "_crc32c_native", False)
    monkeypatch.setattr(jseal, "_crc32c_charp", False)
    for jax_rank in (0, 1):
        # frames of many chunks through a 4 KiB ring
        tok, (w0, w1) = _pair(jax_rank)
        try:
            for i in range(12):
                b0 = bytes([1]) * (i * 1517 % 15000)
                b1 = bytes([2]) * ((i * 911 + 7) % 15000)
                out, errs = _both([lambda b=b0: w0.exchange(b, 0),
                                   lambda b=b1: w1.exchange(b, 0)])
                assert not errs, errs
                assert out[0] == [b0, b1] == out[1]
            # empty and asymmetric frames
            out, errs = _both([lambda: w0.exchange(b"", 0),
                               lambda: w1.exchange(b"xyz", 0)])
            assert not errs and out[0] == [b"", b"xyz"] == out[1], errs
        finally:
            w0.close()
            w1.close()
        assert not _left_behind(tok)
        # independent channels: a thread per (rank, channel), each channel
        # at its own round count
        tok, ends = _pair(jax_rank, channels=3)
        got = {}

        def drive(rank, c, rounds):
            got[(rank, c)] = [ends[rank].exchange(b"%d:%d:%d" % (rank, c, i),
                                                  c) for i in range(rounds)]

        try:
            fns = [lambda r=r, c=c: drive(r, c, 3 + 4 * c)
                   for r in (0, 1) for c in range(3)]
            _, errs = _both(fns)
            assert not errs, errs
            for c in range(3):
                want = [[b"0:%d:%d" % (c, i), b"1:%d:%d" % (c, i)]
                        for i in range(3 + 4 * c)]
                assert got[(0, c)] == want == got[(1, c)]
            port = ends[1 - jax_rank]
            assert port.stats()["rounds"] == [3, 7, 11]
            mem = port.mem_bytes()
            assert mem["segment_bytes"] == mem["peer_mapped_bytes"] > 3 * 4096
        finally:
            for w in ends:
                w.close()
        assert not _left_behind(tok)

    def flip(seg):
        seg.buf[jshm._HDR + 8 * 2 + 123] ^= 0xFF

    exc = _drill(flip, b"Y" * 9000, payload_crc=True)
    assert isinstance(exc, WireCorruption) and "CRC32" in str(exc), exc

    def desync(seg):
        # round rewritten AND the header CRC redone: only the round check
        # can catch it
        u64 = np.frombuffer(seg.buf, np.uint64, count=8)
        u32 = np.frombuffer(seg.buf, np.uint32, count=16)
        u64[jshm._OFF_ROUND // 8] = 7
        u32[jshm._OFF_HCRC // 4] = jshm._header_crc(
            int(u64[jshm._OFF_SEQ // 8]), 7,
            int(u64[jshm._OFF_TOTAL // 8]),
            int(u64[jshm._OFF_CHUNK_OFF // 8]),
            int(u64[jshm._OFF_CHUNK_LEN // 8]),
            int(u32[jshm._OFF_CRC // 4]))
        del u64, u32

    exc = _drill(desync, b"q" * 64, payload_crc=True)
    assert isinstance(exc, WireCorruption) and "desync" in str(exc), exc


def _same(a, b, across_ranks=False):
    """Bitwise equal results: the Gets of a rank's own ids (one rank of two
    worlds) and the final tables."""
    keys = ("final_",) if across_ranks else ("add_get", "mom_get", "final_")
    assert set(a) >= {k for k in b if k.startswith(keys)}
    for key in b:
        if key.startswith(keys):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _port_world(tmp_path, name, *flags):
    sub = tmp_path / name
    sub.mkdir()
    res, _ = run_world("torch", "wire", sub, *flags)
    _same(res[0], res[1], across_ranks=True)
    for r in res:
        if "token" in r:
            assert not _left_behind(str(r["token"])), "segments left behind"
    return res


def test_two_rank_world_selects_shm_and_matches_jax(tmp_path):
    jax_res, _ = run_world("jax", "wire", tmp_path, "want=shm")
    shm = _port_world(tmp_path, "shm", "want=shm")
    gloo = _port_world(tmp_path, "gloo", "want=gloo", "-mv_wire=gloo")
    for r in range(2):
        _same(shm[r], jax_res[r])
        _same(gloo[r], jax_res[r])
        assert str(shm[r]["engine"]) == "Server"
        assert int(shm[r]["rounds_end"][0]) > int(shm[r]["rounds"][0]) > 0
        assert "token" not in gloo[r]


def test_sharded_engine_across_two_ranks_matches_jax(tmp_path):
    (tmp_path / "jax_full").mkdir()
    (tmp_path / "jax_local").mkdir()
    jax_full, _ = run_world("jax", "wire", tmp_path / "jax_full", "want=shm")
    jax_local, _ = run_world("jax", "wire", tmp_path / "jax_local",
                             "want=shm", "-mv_engine_shards=2",
                             "tables=local")
    full = _port_world(tmp_path, "full", "want=shm", "-mv_engine_shards=2")
    local = _port_world(tmp_path, "local", "want=shm",
                        "-mv_engine_shards=2", "tables=local")
    for r in range(2):
        _same(full[r], jax_full[r])
        _same(local[r], jax_local[r])
        for res in (full[r], local[r], jax_local[r]):
            assert str(res["engine"]) == "ShardedServer"
            # both shards exchanged on their own channels
            assert len(res["rounds_end"]) == 2
            assert min(res["rounds_end"]) > 1
    assert "final_mom" in full[0] and "final_mom" not in local[0]

