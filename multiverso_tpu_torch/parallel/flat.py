"""Flat value codec: a small header and the raw bytes of each array.

The port's own copy of the value grammar of ``multiverso_tpu/parallel/
flat.py``, the core of the window wire (``parallel/wire.py``). Verb payloads
are almost entirely contiguous numpy arrays; the codec writes a tag, the
dtype and shape, then the raw bytes, and decodes arrays ZERO-COPY with
``np.frombuffer`` against the received blob (read-only views: every
consumer in the parts protocol copies before it mutates).

Value tags (the JAX package's bytes for the tags the port sends)::

    n  None
    a  ndarray   u8 dtype-str len, dtype str, u8 ndim, i64 dims, raw
    d  nested dict: u8 count + entries
    l  list: u32 count + values
    t  bool (u8)    i  int (i64)    f  float (f64)
    s  str / b  bytes: i64 length + raw
    q  compressed ndarray: i64 envelope length + a ``parallel/compress.py``
       envelope; decoded EAGERLY (the consumer gets the reconstructed
       array, and an unknown codec tag fails inside the envelope)
    p  pickle fallback (anything else: exotic options, user payloads,
       arrays whose dtype the flat header cannot represent)

A whole FRAME (``encode_frame``/``decode_frame``: the fleet rollup that
rides a heartbeat) is a kind byte, one value and the seal trailer
(``parallel/seal.py``), byte for byte the JAX package's.

The JAX package's ``v`` (a value deferred to the device wire) is not
ported: the port's windows ride the host wire, and a blob carrying it fails
to decode with an error that says so.
"""

from __future__ import annotations

import pickle
import struct
from typing import Optional, Tuple

import numpy as np

from multiverso_tpu_torch.parallel.compress import (CompressedArray,
                                                    decode_array)

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

#: leading byte of a flat frame
KIND_FLAT = 0x46        # 'F'


class Extension:
    """Hook for domain tags layered over the core grammar (wire.py's
    Add/GetOption records). ``encode`` appends parts and returns True when
    it owns ``v``; ``decode`` returns ``(True, value)`` when it owns
    ``tag``. Extensions run before the pickle fallback."""

    def encode(self, parts: list, v) -> bool:
        return False

    def decode(self, tag: bytes, cur: "_Cursor"):
        return False, None


def dtype_wire_safe(dt) -> bool:
    """True when ``dt``'s ``.str`` tag decodes back to the same dtype
    (extension dtypes stringify as opaque void tags and take the pickle
    fallback instead)."""
    dt = np.dtype(dt)
    try:
        return not dt.hasobject and np.dtype(dt.str) == dt
    except TypeError:
        return False


def _norm_array(v: np.ndarray) -> np.ndarray:
    """Contiguous, little-endian view or copy of ``v`` for the wire."""
    v = np.ascontiguousarray(v)
    if v.dtype.byteorder == ">":
        v = v.astype(v.dtype.newbyteorder("<"))
    return v


def _encode_array_header(parts: list, dtype: np.dtype,
                         shape: Tuple[int, ...]) -> None:
    ds = dtype.str.encode("ascii")
    parts.append(b"a")
    parts.append(_U8.pack(len(ds)))
    parts.append(ds)
    parts.append(_U8.pack(len(shape)))
    for dim in shape:
        parts.append(_I64.pack(dim))


def encode_value(parts: list, v, ext: Optional[Extension] = None) -> None:
    if v is None:
        parts.append(b"n")
    elif isinstance(v, np.ndarray) and dtype_wire_safe(v.dtype):
        v = _norm_array(v)
        _encode_array_header(parts, v.dtype, v.shape)
        if v.size == 0:
            pass
        elif v.ndim == 0:
            parts.append(v.tobytes())  # memoryview can't cast 0-d
        else:
            parts.append(memoryview(v).cast("B"))
    elif isinstance(v, CompressedArray):
        parts.append(b"q")
        parts.append(_I64.pack(len(v.blob)))
        parts.append(v.blob)
    elif ext is not None and ext.encode(parts, v):
        pass
    elif isinstance(v, dict):
        if len(v) > 255:
            raise ValueError("wire dict too wide")
        parts.append(b"d")
        parts.append(_U8.pack(len(v)))
        for key in sorted(v):
            kb = str(key).encode("utf-8")
            parts.append(_U8.pack(len(kb)))
            parts.append(kb)
            encode_value(parts, v[key], ext)
    elif isinstance(v, bool):          # before int: bool is an int subtype
        parts.append(b"t")
        parts.append(_U8.pack(1 if v else 0))
    elif isinstance(v, int) and -(2 ** 63) <= v < 2 ** 63:
        parts.append(b"i")
        parts.append(_I64.pack(v))
    elif isinstance(v, float):
        parts.append(b"f")
        parts.append(_F64.pack(v))
    elif isinstance(v, str):
        sb = v.encode("utf-8")
        parts.append(b"s")
        parts.append(_I64.pack(len(sb)))
        parts.append(sb)
    elif isinstance(v, bytes):
        parts.append(b"b")
        parts.append(_I64.pack(len(v)))
        parts.append(v)
    elif type(v) is list:
        # lists only: a tuple must come back a tuple (pickle keeps it)
        parts.append(b"l")
        parts.append(_U32.pack(len(v)))
        for item in v:
            encode_value(parts, item, ext)
    else:
        pb = pickle.dumps(v)
        parts.append(b"p")
        parts.append(_I64.pack(len(pb)))
        parts.append(pb)


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def unpack(self, st: struct.Struct):
        vals = st.unpack_from(self.buf, self.pos)
        # mv-lint: ok(cross-domain-state): a _Cursor is constructed, walked and dropped inside ONE decode call — instance-local state; the class-level write aggregation is instance-blind here
        self.pos += st.size
        return vals

    def take(self, n: int):
        out = self.buf[self.pos: self.pos + n]
        if len(out) != n:
            raise ValueError("wire blob truncated")
        self.pos += n
        return out


def decode_value(cur: _Cursor, ext: Optional[Extension] = None):
    tag = cur.take(1)
    if tag == b"n":
        return None
    if tag == b"a":
        (dlen,) = cur.unpack(_U8)
        dtype = np.dtype(bytes(cur.take(dlen)).decode("ascii"))
        (ndim,) = cur.unpack(_U8)
        shape = tuple(cur.unpack(_I64)[0] for _ in range(ndim))
        count = 1
        for dim in shape:
            count *= dim
        arr = np.frombuffer(cur.buf, dtype, count=count, offset=cur.pos)
        cur.pos += count * dtype.itemsize
        return arr.reshape(shape)
    if tag == b"d":
        (n,) = cur.unpack(_U8)
        out = {}
        for _ in range(n):
            (klen,) = cur.unpack(_U8)
            key = bytes(cur.take(klen)).decode("utf-8")
            out[key] = decode_value(cur, ext)
        return out
    if tag == b"t":
        return bool(cur.unpack(_U8)[0])
    if tag == b"i":
        return cur.unpack(_I64)[0]
    if tag == b"f":
        return cur.unpack(_F64)[0]
    if tag == b"s":
        (n,) = cur.unpack(_I64)
        return bytes(cur.take(n)).decode("utf-8")
    if tag == b"b":
        (n,) = cur.unpack(_I64)
        return bytes(cur.take(n))
    if tag == b"l":
        (n,) = cur.unpack(_U32)
        return [decode_value(cur, ext) for _ in range(n)]
    if tag == b"p":
        (n,) = cur.unpack(_I64)
        return pickle.loads(bytes(cur.take(n)))
    if tag == b"q":
        (n,) = cur.unpack(_I64)
        return decode_array(cur.take(n))
    if tag == b"v":
        raise ValueError("wire tag b'v' (a device-wire value) is not ported "
                         "yet: the port's windows ride the host wire")
    if ext is not None:
        ok, val = ext.decode(tag, cur)
        if ok:
            return val
    raise ValueError(f"unknown wire tag {tag!r}")


def encode_frame(obj) -> bytes:
    """One flat frame: the kind byte, the value grammar, the seal
    trailer."""
    from multiverso_tpu_torch.parallel import seal
    parts: list = [_U8.pack(KIND_FLAT)]
    encode_value(parts, obj)
    return seal.seal_frame(b"".join(parts))


def decode_frame(blob: bytes):
    """Verify the seal (``WireCorruption`` before any parsing), check the
    kind byte, decode the value. Arrays are zero-copy read-only views into
    ``blob``."""
    from multiverso_tpu_torch.parallel import seal
    seal.check_crc(blob)
    cur = _Cursor(blob)
    (kind,) = cur.unpack(_U8)
    if kind != KIND_FLAT:
        raise ValueError(f"not a flat frame (leading byte {kind:#x})")
    return decode_value(cur)
