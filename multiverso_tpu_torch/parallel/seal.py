"""Versioned frame sealing: one corruption posture for every exchanged blob.

The port's own copy of ``multiverso_tpu/parallel/seal.py``, trimmed to what
the window exchange and the host wires need. A sealed blob is its body
followed by a trailer; verification runs BEFORE any parsing and raises
``WireCorruption`` on a mismatch, a truncation or an unknown trailer tag.

Two trailers, told apart by the last byte:

* **crc32c** (tag ``0xC2``) — ``body | u32 crc32c | u8 tag``: CRC32C
  through the repo's C++ library (``native.crc32c``, the SSE4.2 path of
  ``native/src/crc32c.cc``). Sealing picks it whenever the library loads.
* **legacy** (no tag) — ``body | u32 crc32`` (little-endian zlib CRC32):
  what sealing falls back to without the library. Both verify anywhere, so
  two ranks that differ on the library still read each other's frames;
  a crc32c-tagged blob on a rank without the library is verified with a
  table-driven Python CRC32C (slow, correctness only).

Tag bytes live in the reserved ``0xC0..0xCF`` range; a blob whose last
byte names a reserved but unknown tag (and which fails the legacy check: a
legacy CRC's high byte may land in the range by chance) fails as "sealed by
a newer writer" instead of decoding garbage.
"""

from __future__ import annotations

import struct
import zlib

#: legacy trailer: little-endian u32 CRC32 over all preceding bytes
CRC_TRAILER_BYTES = 4
#: versioned trailer: u32 checksum + the algorithm tag byte
TAGGED_TRAILER_BYTES = 5
TAG_BASE = 0xC0
TAG_CRC32C = 0xC2

#: chunk of the zlib fallback: zlib.crc32 releases the GIL per call, so a
#: multi-MB seal does not pin other threads behind one C call
_ZLIB_CHUNK = 1 << 20

_U32 = struct.Struct("<I")

#: software CRC32C table (built at the first degraded verify)
_sw_table = None


class WireCorruption(RuntimeError):
    """A received frame failed its seal: flipped bits, a truncation or a
    trailer written by a newer writer. Nothing of it was parsed."""


def _native_crc32c():
    """The library's CRC32C, or None when the library does not load."""
    from multiverso_tpu_torch import native
    return native.crc32c if native.lib() is not None else None


def _sw_crc32c(data, value: int = 0) -> int:
    """Table-driven CRC32C: the degraded verify path only."""
    global _sw_table
    if _sw_table is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            table.append(c)
        # mv-lint: ok(cross-domain-state): idempotent lazy init — racing threads build identical tables; last store wins harmlessly
        _sw_table = table
    crc = (value & 0xFFFFFFFF) ^ 0xFFFFFFFF
    table = _sw_table
    for b in memoryview(data).cast("B"):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data, value: int = 0) -> int:
    """CRC32C of ``data`` chained from ``value`` (the ``zlib.crc32`` call
    shape): the library's when it loads, the Python table's otherwise."""
    fn = _native_crc32c()
    if fn is not None:
        return fn(data, value)
    return _sw_crc32c(data, value)


def fast_crc(data, value: int = 0) -> int:
    """The quickest checksum both ends of a same-build wire agree on:
    CRC32C through the library when it loads, ``zlib.crc32`` otherwise.
    For transports whose two ends are one build on one host (the shm and
    tcp wires' frame headers and optional payload CRC), never for blobs
    sealed for another build: those carry their algorithm in the trailer
    tag."""
    fn = _native_crc32c()
    if fn is not None:
        return fn(data, value)
    return zlib.crc32(data, value) & 0xFFFFFFFF


def _zlib_crc_chunked(body) -> int:
    view = memoryview(body)
    crc = 0
    for off in range(0, len(view), _ZLIB_CHUNK):
        crc = zlib.crc32(view[off:off + _ZLIB_CHUNK], crc)
    return crc & 0xFFFFFFFF


def seal_frame(body: bytes) -> bytes:
    """Append the versioned trailer: CRC32C tagged when the library loads,
    the legacy zlib CRC32 otherwise."""
    fn = _native_crc32c()
    if fn is not None:
        return b"".join((body, _U32.pack(fn(body)), bytes((TAG_CRC32C,))))
    return body + _U32.pack(_zlib_crc_chunked(body))


def seal_trailer(parts) -> bytes:
    """The :func:`seal_frame` trailer of a body given as a sequence of
    buffers, by streaming: ``seal_frame(b"".join(parts)) ==
    b"".join(parts) + seal_trailer(parts)``, with no concatenation (the
    tcp wire writes header and chunk straight into its send buffer and
    appends this)."""
    fn = _native_crc32c()
    crc = 0
    if fn is not None:
        for p in parts:
            crc = fn(p, crc)
        return _U32.pack(crc & 0xFFFFFFFF) + bytes((TAG_CRC32C,))
    for p in parts:
        view = memoryview(p)
        for off in range(0, len(view), _ZLIB_CHUNK):
            crc = zlib.crc32(view[off:off + _ZLIB_CHUNK], crc)
    return _U32.pack(crc & 0xFFFFFFFF)


def seal_frame_legacy(body: bytes) -> bytes:
    """The untagged zlib CRC32 seal that writers without the library
    produce, for the round-trip drills (a reader must open such blobs);
    runtime sealing goes through :func:`seal_frame`."""
    return body + _U32.pack(_zlib_crc_chunked(body))


def _legacy_ok(blob: bytes) -> bool:
    n = len(blob)
    return (n > CRC_TRAILER_BYTES and _zlib_crc_chunked(
        memoryview(blob)[:n - CRC_TRAILER_BYTES])
        == _U32.unpack_from(blob, n - CRC_TRAILER_BYTES)[0])


def _count_failure() -> None:
    from multiverso_tpu_torch.telemetry import metrics as _tmetrics
    _tmetrics.counter("wire.crc_failures").inc()


def _verify(blob: bytes) -> int:
    """Verify ``blob``'s trailer; returns the body length. A failure counts
    ``wire.crc_failures`` before it raises."""
    n = len(blob)
    tag = blob[-1] if n else -1
    if tag == TAG_CRC32C and n > TAGGED_TRAILER_BYTES:
        body = n - TAGGED_TRAILER_BYTES
        if crc32c(memoryview(blob)[:body]) == _U32.unpack_from(blob,
                                                               body)[0]:
            return body
        if _legacy_ok(blob):    # a legacy CRC whose high byte is the tag
            return n - CRC_TRAILER_BYTES
        _count_failure()
        raise WireCorruption(f"wire blob failed its CRC32C seal ({n} "
                             f"bytes): corrupted or truncated frame")
    if _legacy_ok(blob):
        return n - CRC_TRAILER_BYTES
    if TAG_BASE <= tag <= TAG_BASE + 0x0F and n > TAGGED_TRAILER_BYTES:
        _count_failure()
        raise WireCorruption(
            f"wire blob carries unknown seal trailer tag {tag:#x} ({n} "
            f"bytes): sealed by a newer writer, or corrupted in the "
            f"trailer; refusing to parse")
    _count_failure()
    raise WireCorruption(f"wire blob failed CRC check ({n} bytes): "
                         f"corrupted or truncated frame")


def open_frame(blob: bytes) -> bytes:
    """Verify and strip a :func:`seal_frame` trailer."""
    return blob[:_verify(blob)]


def check_crc(blob: bytes) -> None:
    """Verify a sealed blob's trailer (either algorithm) before any
    parsing; front-anchored decoders never read the trailer bytes."""
    _verify(blob)

