"""Tagged array codecs for the byte paths between processes (numpy only).

The port's own copy of ``multiverso_tpu/parallel/compress.py``: the same
envelopes, byte for byte, and the same decode, bit for bit, so a window a
JAX rank compressed decodes in the port and the other way round. Every
compressed array travels as an ENVELOPE whose first byte is a codec tag
from the reserved range ``0xD0..0xDF`` (one nibble above the seal's
``0xC0..0xCF`` trailer tags, so a misrouted blob never verifies); a tag
from that range this build does not know fails loudly as "written by a
newer writer" instead of decoding garbage.

Codecs:

* **raw** (``0xD0``): dtype/shape header + raw bytes (lossless);
* **int8 rows** (``0xD1``): one f32 scale a row (``max|row| / 127``) and
  int8 codes; decode is ``q * scale``. LOSSY, ~4x smaller than f32, the
  error of an element at most ``scale / 2 <= max|row| / 254``. For
  delta-shaped traffic (window Add values, replica delta rows);
* **bf16** (``0xD2``): round-to-nearest-even to the upper 16 bits of f32.
  LOSSY, relative error <= 2**-8. For value rows;
* **bitmap-RLE** (``0xD3``): a sorted-unique non-negative int64 id set as
  varint (gap, run) pairs. Lossless.

Everything sits behind ``-mv_compress`` (off: every byte path is the
uncompressed one), and the lossy codecs also need the table's opt-in in
``-mv_compress_lossy`` (comma-separated table ids, or ``all``).

The windowed engine (``sync/server.py``) packs a lossy-opted table's Add
values as int8 (``pack_window_values``); the flat codec carries them under
its ``q`` tag and decodes them eagerly on every peer, and the sending rank
applies its own records through ``materialize_window``, the same decode,
so every replica applies the identical dequantized delta. Decode is a
pure function of the envelope's bytes: no host state, numpy IEEE ops only.

``stats()`` keeps the bytes offered to a codec and the envelope bytes
that shipped, per path (``replica``, ``window``, ``serve``), under the
JAX package's counter names (``compress.pre_bytes.<path>``,
``compress.post_bytes.<path>``).
"""

from __future__ import annotations

import struct
import threading
from typing import Optional

import numpy as np

from multiverso_tpu_torch.parallel.seal import WireCorruption
from multiverso_tpu_torch.utils.configure import (MV_DEFINE_bool,
                                                  MV_DEFINE_string,
                                                  cached_bool_flag,
                                                  cached_flag)

MV_DEFINE_bool("mv_compress", False,
               "compress the byte paths between processes (the windowed "
               "engine's Add values) with the tagged codecs of "
               "parallel/compress.py; off = identity, the uncompressed "
               "bytes")
MV_DEFINE_string("mv_compress_lossy", "",
                 "comma-separated table ids (or 'all') whose float "
                 "payloads may ride the LOSSY int8/bf16 codecs; every "
                 "other table stays lossless regardless of -mv_compress")

_U8 = struct.Struct("<B")
_I64 = struct.Struct("<q")

TAG_BASE = 0xD0
TAG_RAW = 0xD0
TAG_INT8_ROWS = 0xD1
TAG_BF16 = 0xD2
TAG_RLE_IDS = 0xD3

#: the byte paths ``stats()`` counts
PATHS = ("replica", "window", "serve")

_stats_lock = threading.Lock()
_stats: dict = {}


def reset_stats() -> None:
    with _stats_lock:
        for path in PATHS:
            _stats[f"compress.pre_bytes.{path}"] = 0
            _stats[f"compress.post_bytes.{path}"] = 0


reset_stats()


def stats() -> dict:
    """A copy of the per-path byte counts: ``compress.pre_bytes.<path>``
    (array bytes offered to a codec) and ``compress.post_bytes.<path>``
    (envelope bytes that shipped)."""
    with _stats_lock:
        return dict(_stats)


def _note(path: str, pre: int, post: int) -> None:
    with _stats_lock:
        _stats[f"compress.pre_bytes.{path}"] += pre
        _stats[f"compress.post_bytes.{path}"] += post
    # the same bytes in the metrics registry, under the same names
    from multiverso_tpu_torch.telemetry import metrics as _tmetrics
    _tmetrics.counter("compress.pre_bytes." + path).inc(pre)
    _tmetrics.counter("compress.post_bytes." + path).inc(post)


def _parse_lossy(raw: str):
    s = str(raw).strip().lower()
    if not s:
        return frozenset()
    if s in ("all", "*"):
        return "all"
    return frozenset(p.strip() for p in s.split(",") if p.strip())


#: the two flags, read per window through listener caches; the lossy
#: spec is cached parsed, so a membership test does not re-split it
_enabled_flag = cached_bool_flag("mv_compress", False)
_lossy_set_flag = cached_flag("mv_compress_lossy", frozenset(),
                              _parse_lossy)


def enabled() -> bool:
    """True when ``-mv_compress`` is on (listener-cached read)."""
    return _enabled_flag()


def lossy_opted(table_id) -> bool:
    """True when ``table_id`` opted into the lossy codecs through
    ``-mv_compress_lossy`` (lossless by default)."""
    spec = _lossy_set_flag()
    return spec == "all" or str(table_id) in spec


def config_token() -> tuple:
    """Hashable stamp of the live codec configuration: the key part of a
    cache that must miss when a flag flips mid-run (the replica
    publisher's content-addressed encode cache)."""
    return (_enabled_flag(), _lossy_set_flag())


# -- envelope array header (the flat codec's array header, without its tag) --


def _pack_header(parts: list, dtype: np.dtype, shape) -> None:
    ds = dtype.str.encode("ascii")
    parts.append(_U8.pack(len(ds)))
    parts.append(ds)
    parts.append(_U8.pack(len(shape)))
    for dim in shape:
        parts.append(_I64.pack(int(dim)))


def _unpack_header(blob, pos: int):
    (dlen,) = _U8.unpack_from(blob, pos)
    pos += 1
    dtype = np.dtype(bytes(blob[pos:pos + dlen]).decode("ascii"))
    pos += dlen
    (ndim,) = _U8.unpack_from(blob, pos)
    pos += 1
    shape = []
    for _ in range(ndim):
        shape.append(_I64.unpack_from(blob, pos)[0])
        pos += 8
    return dtype, tuple(shape), pos


def _wire_contig(arr: np.ndarray) -> np.ndarray:
    """Contiguous little-endian form for the envelope."""
    arr = np.asarray(arr)
    if arr.ndim:                # ascontiguousarray promotes 0-d to 1-d
        arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return arr


def _count(shape) -> int:
    count = 1
    for dim in shape:
        count *= dim
    return count


# -- codecs ------------------------------------------------------------------


def encode_raw(arr: np.ndarray) -> bytes:
    """Identity envelope (lossless): header + raw bytes."""
    arr = _wire_contig(np.asarray(arr))
    parts: list = [_U8.pack(TAG_RAW)]
    _pack_header(parts, arr.dtype, arr.shape)
    if arr.size:
        parts.append(arr.tobytes())
    return b"".join(parts)


def encode_int8_rows(arr: np.ndarray) -> bytes:
    """Per-row-scale int8 quantization (LOSSY) of a 1-D (one row) or 2-D
    float array; an all-zero or empty row stores scale 0 and decodes
    exactly."""
    arr = _wire_contig(np.asarray(arr))
    if arr.ndim not in (1, 2) or arr.dtype.kind != "f":
        raise ValueError(
            f"int8 row codec wants a 1-D/2-D float array, got "
            f"{arr.dtype} ndim={arr.ndim}")
    rows = arr.reshape(1, -1) if arr.ndim == 1 else arr
    if rows.size:
        maxabs = np.max(np.abs(rows), axis=1)
    else:
        maxabs = np.zeros(rows.shape[0], rows.dtype)
    scale = (maxabs / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0)).astype(rows.dtype)
    q = np.clip(np.rint(rows / safe[:, None]), -127, 127).astype(np.int8)
    parts: list = [_U8.pack(TAG_INT8_ROWS)]
    _pack_header(parts, arr.dtype, arr.shape)
    parts.append(scale.tobytes())
    parts.append(q.tobytes())
    return b"".join(parts)


def encode_bf16(arr: np.ndarray) -> bytes:
    """bfloat16 rounding (nearest even) of a float32 array (LOSSY): the
    upper 16 bits of each float; NaN stays NaN and Inf stays Inf."""
    arr = _wire_contig(np.asarray(arr))
    if arr.dtype != np.float32:
        raise ValueError(f"bf16 codec wants float32, got {arr.dtype}")
    bits = arr.view(np.uint32)
    rounded = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                          & np.uint32(1))
    special = (bits & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    hi = np.where(special, bits >> np.uint32(16),
                  rounded >> np.uint32(16)).astype(np.uint16)
    is_nan = special & ((bits & np.uint32(0x007FFFFF)) != 0)
    hi = np.where(is_nan, hi | np.uint16(1), hi)
    parts: list = [_U8.pack(TAG_BF16)]
    _pack_header(parts, arr.dtype, arr.shape)
    parts.append(np.ascontiguousarray(hi).tobytes())
    return b"".join(parts)


def _varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_varint(blob, pos: int):
    shift = 0
    v = 0
    while True:
        b = blob[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, pos
        shift += 7


def rle_encodable(ids: np.ndarray) -> bool:
    """True when ``ids`` is 1-D int64, strictly increasing and
    non-negative (the bitmap-RLE contract)."""
    if not isinstance(ids, np.ndarray) or ids.dtype != np.int64 \
            or ids.ndim != 1:
        return False
    if ids.size == 0:
        return True
    if int(ids[0]) < 0:
        return False
    return bool(np.all(np.diff(ids) > 0))


def encode_rle_ids(ids: np.ndarray) -> bytes:
    """Bitmap-RLE envelope (LOSSLESS) of an id set that passes
    :func:`rle_encodable`: varint (zeros gap, ones run) pairs."""
    ids = np.asarray(ids)
    out = bytearray(_U8.pack(TAG_RLE_IDS))
    _varint(out, int(ids.size))
    if ids.size:
        brk = np.flatnonzero(np.diff(ids) != 1)
        starts = np.concatenate(([int(ids[0])],
                                 ids[brk + 1])).astype(np.int64)
        ends = np.concatenate((ids[brk],
                               [int(ids[-1])])).astype(np.int64)
        prev_end = -1
        # int() a run: these host arrays feed the fan-out thread, which
        # mvlint keeps off the card (a ``.tolist()`` reads as a tensor's)
        for s, e in zip(map(int, starts), map(int, ends)):
            _varint(out, s - prev_end - 1)
            _varint(out, e - s + 1)
            prev_end = e
    return bytes(out)


def decode_array(blob) -> np.ndarray:
    """One envelope back to its array: a pure function of the bytes. A tag
    of the reserved range this build does not know raises
    ``WireCorruption`` ("written by a newer writer")."""
    if not len(blob):
        raise WireCorruption("empty compression envelope")
    tag = blob[0]
    if tag == TAG_RAW:
        dtype, shape, pos = _unpack_header(blob, 1)
        arr = np.frombuffer(blob, dtype, count=_count(shape), offset=pos)
        return arr.reshape(shape)
    if tag == TAG_INT8_ROWS:
        dtype, shape, pos = _unpack_header(blob, 1)
        nrows = shape[0] if len(shape) == 2 else 1
        scale = np.frombuffer(blob, np.float32, count=nrows, offset=pos)
        pos += nrows * 4
        count = _count(shape)
        q = np.frombuffer(blob, np.int8, count=count, offset=pos)
        if count == 0:      # reshape(-1) cannot infer a dim of size 0
            return np.zeros(shape, dtype)
        out = (q.reshape(nrows, -1).astype(dtype)
               * scale[:, None].astype(dtype))
        return out.reshape(shape)
    if tag == TAG_BF16:
        dtype, shape, pos = _unpack_header(blob, 1)
        hi = np.frombuffer(blob, np.uint16, count=_count(shape), offset=pos)
        out = (hi.astype(np.uint32) << np.uint32(16)).view(np.float32)
        return out.reshape(shape)
    if tag == TAG_RLE_IDS:
        n, pos = _read_varint(blob, 1)
        out = np.empty(n, np.int64)
        filled = 0
        at = 0
        while filled < n:
            gap, pos = _read_varint(blob, pos)
            run, pos = _read_varint(blob, pos)
            start = at + gap
            out[filled:filled + run] = np.arange(start, start + run,
                                                 dtype=np.int64)
            filled += run
            at = start + run
        return out
    if TAG_BASE <= tag <= TAG_BASE + 0x0F:
        raise WireCorruption(
            f"compressed blob carries unknown codec tag {tag:#x} — "
            f"written by a newer writer (upgrade readers before "
            f"writers), or corrupted in the envelope; refusing to parse")
    raise WireCorruption(
        f"not a compression envelope (leading byte {tag:#x})")


class CompressedArray:
    """An ndarray in its envelope form. It rides the flat codec's ``q``
    tag (the flat decoder decodes it eagerly) and pickles as its blob;
    :meth:`decode` materializes it."""

    __slots__ = ("blob",)

    def __init__(self, blob: bytes):
        self.blob = bytes(blob)

    @property
    def nbytes(self) -> int:
        return len(self.blob)

    def decode(self) -> np.ndarray:
        return decode_array(self.blob)

    def __getstate__(self):
        return self.blob

    def __setstate__(self, state):
        self.blob = state

    def __repr__(self) -> str:
        return (f"CompressedArray({len(self.blob)}B, tag={self.blob[0]:#x})"
                if self.blob else "CompressedArray()")


# -- the byte paths' packers --------------------------------------------------


def _pack_float(arr, codec: str) -> Optional[bytes]:
    """``arr``'s envelope under ``codec`` ('int8' or 'bf16'); None when
    the array does not fit the codec or the envelope would not be
    smaller."""
    if not isinstance(arr, np.ndarray) or arr.size == 0:
        return None
    if codec == "int8":
        if arr.ndim not in (1, 2) or arr.dtype.kind != "f":
            return None
        blob = encode_int8_rows(arr)
    else:
        if arr.dtype != np.float32:
            return None
        blob = encode_bf16(arr)
    return blob if len(blob) < arr.nbytes else None


def pack_payload(table_id, payload: dict, path: str = "replica") -> dict:
    """Compress one replica bundle payload: ``ids``/``keys`` as bitmap-RLE
    whenever it is smaller; a lossy-opted table's ``rows``/``values`` as
    int8 (delta-shaped payloads: an id or key vector beside them) or bf16
    (whole-state value rows). Returns ``payload`` itself when compression
    is off or nothing got smaller."""
    if not enabled():
        return payload
    out = None
    pre = post = 0
    for key in ("ids", "keys"):
        v = payload.get(key)
        if isinstance(v, np.ndarray) and v.size and rle_encodable(v):
            blob = encode_rle_ids(v)
            if len(blob) < v.nbytes:
                out = out if out is not None else dict(payload)
                out[key] = CompressedArray(blob)
                pre += v.nbytes
                post += len(blob)
    if lossy_opted(table_id):
        delta_shaped = "ids" in payload or \
            (payload.get("fam") == "kv" and "keys" in payload)
        for key in ("rows", "values"):
            v = payload.get(key)
            blob = _pack_float(v, "int8" if delta_shaped and key != "values"
                               else "bf16")
            if blob is not None:
                out = out if out is not None else dict(payload)
                out[key] = CompressedArray(blob)
                pre += v.nbytes
                post += len(blob)
    if out is None:
        return payload
    _note(path, pre, post)
    return out


def unpack_payload(payload: dict) -> dict:
    """Materialize every CompressedArray of a bundle payload in place."""
    for key, v in payload.items():
        if isinstance(v, CompressedArray):
            payload[key] = v.decode()
    return payload


def pack_window_values(table_id: int, payload: dict) -> dict:
    """A window Add's payload with a lossy-opted table's ``values`` as an
    int8 envelope (a new dict), or ``payload`` unchanged. The sender
    applies its own records through :func:`materialize_window`."""
    if not enabled() or not lossy_opted(table_id):
        return payload
    blob = _pack_float(payload.get("values"), "int8")
    if blob is None:
        return payload
    v = payload["values"]
    out = dict(payload)
    out["values"] = CompressedArray(blob)
    _note("window", v.nbytes, len(blob))
    return out


def materialize_window(verbs: list) -> list:
    """One window's ``(kind, table, payload)`` records with every
    CompressedArray decoded: the sending rank's twin of its peers' eager
    flat decode. Payloads that held one are copied (the message keeps its
    compressed form for a later pack)."""
    out = []
    for rec in verbs:
        kind, tid, payload = rec
        hit = None
        for key, v in payload.items():
            if isinstance(v, CompressedArray):
                hit = hit if hit is not None else dict(payload)
                hit[key] = v.decode()
        out.append((kind, tid, hit) if hit is not None else rec)
    return out


def pack_serve_rows(table_id: int, rows, path: str = "serve"):
    """A lossy-opted table's f32 lookup rows as a bf16 envelope; anything
    else unchanged."""
    if not enabled() or not lossy_opted(table_id):
        return rows
    blob = _pack_float(rows if isinstance(rows, np.ndarray) else None,
                       "bf16")
    if blob is None:
        return rows
    _note(path, rows.nbytes, len(blob))
    return CompressedArray(blob)
