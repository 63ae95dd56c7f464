"""The port's window codecs (``parallel/compress.py``) against the JAX
package's, in this process.

(a) Every envelope the port writes is byte-equal to the JAX package's for
    the same array (raw, int8 rows, bf16, bitmap-RLE ids; float, integer
    and bool dtypes; empty arrays, zero rows, one row, specials), and both
    packages decode every envelope bit-equal; the byte paths' packers
    (``pack_payload``, ``unpack_payload``, ``pack_serve_rows``,
    ``pack_window_values``) take the same decisions and write the same
    envelopes, and the port's ``stats()`` counts the bytes offered and
    shipped per path; an unknown tag of the reserved range fails loudly in
    both.
(b) The flat codec's ``q`` tag crosses between the packages' window codecs
    in either direction; the sender's ``materialize_window`` and a peer's
    eager decode reconstruct the same bits.
(c) The engine's window packing: ``-mv_compress`` alone leaves the window's
    bytes as they were; with the table lossy-opted, the Add values ride as
    int8 envelopes, the byte budget counts them at the envelope's size (so
    more Adds fit a window), and a verb the budget cut is not packed or
    counted twice.
"""

import pickle

import numpy as np
import pytest

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

_FLOAT_SHAPES = [(0,), (1,), (7,), (0, 5), (3, 0), (1, 9), (5, 7),
                 (100, 50)]


def _set_flags(on: bool, lossy: str = "") -> None:
    from multiverso_tpu.utils.configure import SetCMDFlag as jset
    from multiverso_tpu_torch.utils.configure import SetCMDFlag as tset
    for setter in (jset, tset):
        setter("mv_compress", on)
        setter("mv_compress_lossy", lossy)


@pytest.fixture
def flags():
    yield _set_flags
    _set_flags(False, "")


def _bits_equal(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.ascontiguousarray(a).tobytes() == \
        np.ascontiguousarray(b).tobytes()


def _float_arrays():
    rng = np.random.default_rng(13)
    out = []
    for dt in (np.float32, np.float64):
        for shape in _FLOAT_SHAPES:
            out.append((rng.standard_normal(shape) * 3).astype(dt))
    rows = rng.standard_normal((6, 8)).astype(np.float32)
    rows[2] = 0.0                       # an all-zero row: scale 0
    rows[4, 3] = 1e-40                  # a subnormal
    out.append(rows)
    out.append(np.full((4, 4), 127.5, np.float32))
    out.append(np.array([[0.5, -0.5, 1.5, -1.5]], np.float32))  # ties
    out.append(rng.standard_normal((3, 4)).astype(">f4"))   # big-endian
    out.append(rng.standard_normal((8, 6)).astype(np.float32)[:, ::2])
    return out


def test_envelopes_byte_equal_and_decode_bit_equal(flags):
    from multiverso_tpu.failsafe.errors import WireCorruption as JCorrupt
    from multiverso_tpu.parallel import compress as J
    from multiverso_tpu_torch.parallel import compress as T
    from multiverso_tpu_torch.parallel.seal import WireCorruption

    blobs = []
    floats = _float_arrays()
    for arr in floats:
        for enc in ("encode_raw", "encode_int8_rows"):
            mine = getattr(T, enc)(arr)
            assert mine == getattr(J, enc)(arr), (enc, arr.dtype, arr.shape)
            blobs.append(mine)
        if arr.dtype == np.float32:
            mine = T.encode_bf16(arr)
            assert mine == J.encode_bf16(arr), arr.shape
            blobs.append(mine)
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                         1e-45, 3.4e38, 1.00390625, 1.01171875],
                        np.float32)
    blobs.append(T.encode_bf16(specials))
    assert blobs[-1] == J.encode_bf16(specials)
    rng = np.random.default_rng(14)
    for arr in (np.arange(12, dtype=np.int32).reshape(3, 4),
                rng.integers(-9, 9, (0, 3)).astype(np.int64),
                np.array(7, np.int64), rng.random(5) > 0.5,
                rng.integers(0, 255, 9).astype(np.uint8)):
        blobs.append(T.encode_raw(arr))
        assert blobs[-1] == J.encode_raw(arr)
    id_sets = [np.empty(0, np.int64), np.array([0], np.int64),
               np.arange(5, 200, dtype=np.int64),
               np.unique(rng.integers(0, 10 ** 7, 3000)).astype(np.int64),
               np.array([2, 3, 4, 90, 91, 1 << 40], np.int64)]
    for ids in id_sets:
        assert T.rle_encodable(ids) and J.rle_encodable(ids)
        blobs.append(T.encode_rle_ids(ids))
        assert blobs[-1] == J.encode_rle_ids(ids)
    for bad in (np.array([3, 1], np.int64), np.array([-1, 2], np.int64),
                np.arange(4, dtype=np.int32), [1, 2]):
        assert not T.rle_encodable(bad) and not J.rle_encodable(bad)
    for blob in blobs:
        _bits_equal(T.decode_array(blob), J.decode_array(blob))
    for arr in floats:                  # the lossy codec's bound
        rows = np.asarray(arr, arr.dtype.newbyteorder("="))
        rows = rows.reshape(1, -1) if rows.ndim == 1 else rows
        got = T.decode_array(T.encode_int8_rows(arr)).reshape(rows.shape)
        if rows.size:
            bound = np.abs(rows).max(axis=1, keepdims=True) / 254.0
            assert (np.abs(got - rows) <= bound * (1 + 1e-6)).all()
    for tag in (0xD4, 0xD9, 0xDF):
        for mod, err in ((T, WireCorruption), (J, JCorrupt)):
            with pytest.raises(err, match="newer writer"):
                mod.decode_array(bytes([tag]) + b"\x00" * 8)
    for blob in (b"", b"\x41garbage"):
        with pytest.raises(WireCorruption):
            T.decode_array(blob)
    with pytest.raises(ValueError):
        T.encode_int8_rows(np.zeros((2, 2, 2), np.float32))
    with pytest.raises(ValueError):
        T.encode_bf16(np.zeros(3, np.float64))
    wrapped = T.CompressedArray(T.encode_rle_ids(id_sets[2]))
    again = pickle.loads(pickle.dumps(wrapped))
    assert again.blob == wrapped.blob and again.nbytes == len(wrapped.blob)

    # the packers: the same decisions, envelopes and byte counts
    g = np.random.default_rng(15)
    payloads = [
        {"ids": np.arange(0, 4000, 2, dtype=np.int64),
         "rows": g.standard_normal((2000, 16)).astype(np.float32)},
        {"fam": "kv", "keys": np.arange(300, dtype=np.int64),
         "values": g.standard_normal(300).astype(np.float32)},
        {"values": g.standard_normal((64, 32)).astype(np.float32)},
        {"ids": np.array([5, 3], np.int64),
         "rows": np.zeros((2, 1), np.float32)},
    ]
    for on, lossy in ((False, ""), (True, ""), (True, "7"), (True, "all")):
        flags(on, lossy)
        T.reset_stats()
        for p in payloads:
            mine, theirs = T.pack_payload(7, p), J.pack_payload(7, p)
            assert (mine is p) == (theirs is p)
            assert sorted(mine) == sorted(theirs)
            for k, v in mine.items():
                w = theirs[k]
                assert isinstance(v, T.CompressedArray) == \
                    isinstance(w, J.CompressedArray), k
                if isinstance(v, T.CompressedArray):
                    assert v.blob == w.blob
            back = T.unpack_payload(dict(mine))
            jback = J.unpack_payload(dict(theirs))
            for k in back:
                if isinstance(back[k], np.ndarray):
                    _bits_equal(back[k], jback[k])
            for tid in (7, 8):
                rows = p.get("rows", p.get("values"))
                mine, theirs = (T.pack_serve_rows(tid, rows),
                                J.pack_serve_rows(tid, rows))
                assert (mine is rows) == (theirs is rows)
                if mine is not rows:
                    assert mine.blob == theirs.blob
                mine, theirs = (T.pack_window_values(tid, p),
                                J.pack_window_values(tid, p))
                assert (mine is p) == (theirs is p)
                if mine is not p:
                    assert mine["values"].blob == theirs["values"].blob
        st = T.stats()
        if not on:
            assert not any(st.values()), st
        for path in T.PATHS:
            assert st[f"compress.post_bytes.{path}"] <= \
                st[f"compress.pre_bytes.{path}"]
        if lossy:
            assert 0 < st["compress.post_bytes.window"] < \
                0.3 * st["compress.pre_bytes.window"]


def test_q_tag_crosses_both_window_codecs(flags):
    from multiverso_tpu.parallel import compress as J
    from multiverso_tpu.parallel import wire as jwire
    from multiverso_tpu_torch.parallel import compress as T
    from multiverso_tpu_torch.parallel import flat, wire

    flags(True, "3")
    g = np.random.default_rng(16)
    values = (g.standard_normal((64, 32)) * 0.1).astype(np.float32)
    payload = {"row_ids": np.arange(64, dtype=np.int32), "values": values,
               "option": None}
    tpacked = T.pack_window_values(3, payload)
    jpacked = J.pack_window_values(3, payload)
    assert isinstance(tpacked["values"], T.CompressedArray)
    assert tpacked["values"].blob == jpacked["values"].blob
    assert payload["values"] is values          # the original untouched
    mine = wire.encode_window([("A", 3, tpacked), ("G", 1, {"keys": np.arange(
        4, dtype=np.int64), "option": None})], seq=5)
    theirs = jwire.encode_window([("A", 3, jpacked), ("G", 1, {
        "keys": np.arange(4, dtype=np.int64), "option": None})], seq=5)
    body = len(mine) - (5 if mine[-1] == 0xC2 else 4)
    assert mine[:body] == theirs[:body]
    own = T.materialize_window([("A", 3, tpacked)])[0][2]["values"]
    assert isinstance(tpacked["values"], T.CompressedArray)  # kept packed
    for blob in (mine, theirs):
        seq, got = wire.decode_window_seq(blob)
        jseq, jgot = jwire.decode_window_seq(blob)
        assert seq == jseq == 5
        _bits_equal(got[0][2]["values"], own)
        _bits_equal(jgot[0][2]["values"], own)
        np.testing.assert_array_equal(got[1][2]["keys"], np.arange(4))
    bound = np.abs(values).max(axis=1, keepdims=True) / 254.0
    assert (np.abs(own - values) <= bound * (1 + 1e-6)).all()
    assert np.abs(own - values).max() > 0       # the codec engaged
    # a bare q value in the flat grammar, and a bad envelope inside a frame
    parts = []
    flat.encode_value(parts, tpacked["values"])
    _bits_equal(flat.decode_value(flat._Cursor(b"".join(parts))), own)
    bad = T.CompressedArray(bytes([0xDA]) + b"\x00" * 8)
    blob = wire.encode_window([("A", 3, {"values": bad})], seq=0)
    from multiverso_tpu_torch.parallel.seal import WireCorruption
    with pytest.raises(WireCorruption, match="newer writer"):
        wire.decode_window_seq(blob)
    assert wire.payload_nbytes(tpacked) == (
        payload["row_ids"].nbytes + tpacked["values"].nbytes)
    assert wire.payload_nbytes(tpacked) == jwire.payload_nbytes(jpacked)


def test_engine_window_packing(flags):
    from multiverso_tpu_torch.message import Message, MsgType
    from multiverso_tpu_torch.parallel import compress as T
    from multiverso_tpu_torch.parallel import wire
    from multiverso_tpu_torch.sync.server import Server

    g = np.random.default_rng(17)

    def adds(tid):
        return [Message(msg_type=MsgType.Request_Add, table_id=tid,
                        payload={"row_ids": np.arange(100, dtype=np.int32),
                                 "values": g.standard_normal(
                                     (100, 50)).astype(np.float32),
                                 "option": None})
                for _ in range(8)]

    srv = Server()
    srv.MH_WINDOW_BYTES = 3 * (400 + 100 * 50 * 4)     # three plain Adds
    msgs = adds(2)
    before = [m.payload for m in msgs]
    blob0 = None
    for on in (False, True):            # -mv_compress alone: no change
        flags(on, "")
        local, used = srv._mh_pack_window(msgs)
        assert len(used) == 3 and all(m.payload is p
                                      for m, p in zip(msgs, before))
        blob = wire.encode_window(local, seq=1)
        blob0 = blob0 or blob
        assert blob == blob0
    flags(True, "2")
    T.reset_stats()
    local, used = srv._mh_pack_window(msgs)
    assert len(used) == 8               # envelopes: ~a quarter the bytes
    packed = [m.payload["values"] for m in msgs]
    assert all(isinstance(v, T.CompressedArray) for v in packed)
    nbytes = sum(wire.payload_nbytes(p) for _, _, p in local)
    assert nbytes == sum(400 + v.nbytes for v in packed)
    st = T.stats()
    assert st["compress.pre_bytes.window"] == 8 * 100 * 50 * 4
    assert st["compress.post_bytes.window"] == sum(v.nbytes for v in packed)
    # a second pass (verbs re-led after a cut) neither re-packs nor counts
    local2, _ = srv._mh_pack_window(msgs)
    assert [p["values"] for _, _, p in local2] == packed
    assert T.stats() == st
    # a table not opted stays lossless beside it
    other = adds(5)
    local, used = srv._mh_pack_window(other)
    assert len(used) == 3 and all(isinstance(p["values"], np.ndarray)
                                  for _, _, p in local)
