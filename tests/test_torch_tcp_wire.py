"""The port's TCP wire (``multiverso_tpu_torch/parallel/tcp_wire.py``) against
the JAX package's, and the install's fallback.

(a) The protocol: a JAX end and a port end meshed over loopback, each
    package on either rank (the frame grammar, the sealed hello and the
    mesh direction are the JAX package's): frames of many chunks, and
    independent channels driven by a thread each; then a JAX-built frame
    train fed to the port's parser: a corrupted length prefix is refused
    unread, a flipped body bit trips the seal, a round stamp from another
    round is a desync, each a typed ``WireCorruption``.
(b) A loopback "cross-host" world (``-mv_wire_hostname`` gives each rank a
    host label of its own): ``-mv_wire=auto`` selects the tcp wire when
    ``-mv_engine_shards=2`` asks for two channels, in both packages, and
    the sharded add and KV tables (channels 0 and 1) equal the JAX
    package's bitwise; with one channel the world stays on gloo.
(c) One rank's wire setup failing (its ``ShmWire`` or ``TcpWire`` raises)
    degrades the WHOLE world to gloo under ``auto``, which then clamps
    ``-mv_engine_shards=2`` to one engine and trains correctly; under
    ``-mv_wire=shm`` the same failure fails ``MV_Init`` on both ranks.
"""

import struct
import threading

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)


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


def _mesh(jax_rank, channels):
    from multiverso_tpu.parallel.tcp_wire import TcpWire as JWire
    from multiverso_tpu_torch.parallel.tcp_wire import TcpWire as TWire
    ends = [None, None]
    ends[jax_rank] = JWire("tok", jax_rank, 2, channels, 4096)
    ends[1 - jax_rank] = TWire("tok", 1 - jax_rank, 2, channels, 4096)
    eps = {r: ends[r].listen_endpoints() for r in (0, 1)}
    _, errs = _both([lambda w=w: w.connect(eps) for w in ends])
    assert not errs, errs
    return ends


def test_protocol_against_the_jax_wire(monkeypatch):
    from multiverso_tpu.parallel import seal as jseal
    from multiverso_tpu.parallel.tcp_wire import TcpWire as JWire
    from multiverso_tpu_torch.parallel.seal import WireCorruption
    from multiverso_tpu_torch.parallel.tcp_wire import TcpWire as TWire
    # the JAX checksum engine resolved anew, from the library the port
    # uses (the fixture's), so both ends pick the same CRC
    monkeypatch.setattr(jseal, "_crc32c_native", False)
    monkeypatch.setattr(jseal, "_crc32c_charp", False)
    for jax_rank in (0, 1):
        ends = _mesh(jax_rank, channels=3)
        try:
            for i in range(8):
                b0 = bytes([1]) * (i * 5171 % 30000)
                b1 = bytes([2]) * ((i * 3113 + 7) % 30000)
                out, errs = _both([lambda b=b0: ends[0].exchange(b, 1),
                                   lambda b=b1: ends[1].exchange(b, 1)])
                assert not errs and out[0] == [b0, b1] == out[1], errs
            got = {}

            def drive(rank, c, rounds):
                got[(rank, c)] = [ends[rank].exchange(
                    b"%d:%d:%d" % (rank, c, i), c) for i in range(rounds)]

            _, errs = _both([lambda r=r, c=c: drive(r, c, 2 + 3 * c)
                             for r in (0, 1) for c in range(3)])
            assert not errs, errs
            for c in range(3):
                want = [[b"0:%d:%d" % (c, i), b"1:%d:%d" % (c, i)]
                        for i in range(2 + 3 * c)]
                assert got[(0, c)] == want == got[(1, c)]
            assert ends[1 - jax_rank].stats()["rounds"] == [2, 13, 8]
        finally:
            for w in ends:
                w.close()

    # a JAX-built frame train through the port's parser
    jw = JWire("t", 1, 2, 1, 4096)
    train, sizes = jw._frames(b"Y" * 9000, 7, 0, 0)
    jw.close()
    port = TWire("t", 0, 2, 1, 4096, payload_crc=False)
    port.close()

    def drain(buf, rnd=7):
        s = {"buf": bytearray(buf), "asm": None, "crc": 0, "total": None,
             "crc_latch": 0, "chunks": 0, "done_r": False}
        port._drain_frames(1, 0, rnd, s)
        return s

    assert bytes(drain(train)["asm"]) == b"Y" * 9000
    bad = bytearray(train)
    bad[2] = 0xFF                   # the length prefix past the chunk cap
    with pytest.raises(WireCorruption, match="length prefix"):
        drain(bad)
    bad = bytearray(train)
    bad[200] ^= 0x10                # a body byte of the first frame
    with pytest.raises(WireCorruption):
        drain(bad)
    with pytest.raises(WireCorruption, match="desync"):
        drain(train, rnd=8)
    assert struct.unpack_from("<I", train, 0)[0] == sizes[0] - 4


def test_loopback_cross_host_world_selects_tcp_and_matches_jax(tmp_path):
    split = ("hosts=split", "tables=local")
    (tmp_path / "jax").mkdir()
    (tmp_path / "tcp").mkdir()
    (tmp_path / "gloo").mkdir()
    jres, _ = run_world("jax", "wire", tmp_path / "jax", *split,
                        "want=tcp", "-mv_engine_shards=2")
    tres, _ = run_world("torch", "wire", tmp_path / "tcp", *split,
                        "want=tcp", "-mv_engine_shards=2")
    one, _ = run_world("torch", "wire", tmp_path / "gloo", *split,
                       "want=gloo")
    for r in range(2):
        assert str(tres[r]["engine"]) == "ShardedServer"
        assert len(tres[r]["rounds_end"]) == 2
        assert min(tres[r]["rounds_end"]) > 1
        assert str(one[r]["engine"]) == "Server"
        for key in tres[r]:
            if key.startswith(("add_get", "final_")):
                np.testing.assert_array_equal(tres[r][key], jres[r][key],
                                              err_msg=key)
                np.testing.assert_array_equal(tres[r][key], one[r][key],
                                              err_msg=key)
    for key in ("final_add", "final_kv"):
        np.testing.assert_array_equal(tres[0][key], tres[1][key])


def test_world_degrades_as_a_whole_when_one_rank_fails(tmp_path):
    for kind, flags in (("shm", ()),
                        ("tcp", ("hosts=split", "-mv_engine_shards=2"))):
        sub = tmp_path / kind
        sub.mkdir()
        res, outs = run_world("torch", "wire", sub, f"break={kind}",
                              "want=gloo", "tables=local", *flags)
        assert "falling back to gloo" in outs[0] + outs[1], kind
        for r in range(2):
            assert str(res[r]["engine"]) == "Server", kind
        np.testing.assert_array_equal(res[0]["final_add"],
                                      res[1]["final_add"])
    # a required wire: the same failure fails MV_Init on every rank
    sub = tmp_path / "required"
    sub.mkdir()
    _, outs = run_world("torch", "wire", sub, "break=shm", "-mv_wire=shm",
                        "want=shm", ok_ranks=())
    for out in outs:
        assert "-mv_wire=shm but the wire failed to come up" in out, out
