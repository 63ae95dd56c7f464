"""Binary stream for table ``Store``/``Load`` (reference io/io.h:45-76).

Byte-compatible with ``multiverso_tpu/utils/io.py``'s ``Stream``:
integers are little-endian int64, so a matrix table stored by one
package loads in the other.
"""

from __future__ import annotations

import io
import struct


class Stream:
    """``Write``/``Read`` raw bytes plus the int helpers the tables use,
    over any binary file object (an in-memory buffer by default)."""

    def __init__(self, fileobj=None):
        self._f = fileobj if fileobj is not None else io.BytesIO()

    def Write(self, data: bytes) -> None:
        self._f.write(data)

    def Read(self, size: int) -> bytes:
        return self._f.read(size)

    def WriteInt(self, value: int) -> None:
        self.Write(struct.pack("<q", value))

    def ReadInt(self) -> int:
        return struct.unpack("<q", self.Read(8))[0]
