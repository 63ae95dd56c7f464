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
    v  DEFERRED ndarray: the header of 'a' and NO raw bytes (a value that
       rides the device wire, ``parallel/device_wire.py``); decodes to a
       ``DeferredArray`` carrying the dtype and shape
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

#: OPTIONAL trace-context entry of a flat request dict: ``[trace_id,
#: span_id]`` of the caller's open span, present only when ``-trace`` is
#: armed on the sending side. A receiver that never reads it is
#: unaffected, and without it the frame is byte-identical to one of a
#: sender that has no tracing
TRACE_KEY = "_tctx"


class Extension:
    """Hook for domain tags layered over the core grammar (wire.py's
    Add/GetOption records). ``encode`` appends parts and returns True when
    it owns ``v``; ``decode`` returns ``(True, value)`` when it owns
    ``tag``. Extensions run before the pickle fallback."""

    def encode(self, parts: list, v) -> bool:
        return False

    def decode(self, tag: bytes, cur: "_Cursor"):
        return False, None


class DeferredArray:
    """An ndarray whose BYTES do not ride the host wire (the JAX package's
    ``flat.DeferredArray``): the encoder writes only its dtype and shape
    (the ``v`` tag), and the owning rank keeps the real array in ``local``
    (None on every other rank after decode). The windowed engine puts these
    in place of large Add values when the device transport is selected;
    the values move through ``parallel/device_wire.py``. ``where`` is the
    port's own: the value's ``(channel, slot, rank, offset)`` in the
    device wire's staging slots once the window has been exchanged."""

    __slots__ = ("dtype", "shape", "local", "where")

    def __init__(self, dtype, shape, local=None):
        self.dtype = np.dtype(dtype)
        self.shape = tuple(int(s) for s in shape)
        self.local = local
        self.where = None

    @classmethod
    def of(cls, arr: np.ndarray) -> "DeferredArray":
        arr = np.asarray(arr)
        return cls(arr.dtype, arr.shape, local=arr)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        tag = "local" if self.local is not None else "remote"
        return f"DeferredArray({self.dtype.str}, {self.shape}, {tag})"


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


def _encode_array_header(parts: list, tag: bytes, dtype: np.dtype,
                         shape: Tuple[int, ...]) -> None:
    ds = dtype.str.encode("ascii")
    parts.append(tag)
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
        _encode_array_header(parts, b"a", v.dtype, v.shape)
        if v.size == 0:
            pass
        elif v.ndim == 0:
            parts.append(v.tobytes())  # memoryview can't cast 0-d
        else:
            parts.append(memoryview(v).cast("B"))
    elif isinstance(v, DeferredArray):
        _encode_array_header(parts, b"v", v.dtype, v.shape)
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
    if tag in (b"a", b"v"):
        (dlen,) = cur.unpack(_U8)
        dtype = np.dtype(bytes(cur.take(dlen)).decode("ascii"))
        (ndim,) = cur.unpack(_U8)
        shape = tuple(cur.unpack(_I64)[0] for _ in range(ndim))
        if tag == b"v":
            return DeferredArray(dtype, shape)
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
