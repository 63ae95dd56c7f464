"""Stream IO with URI scheme dispatch (reference io/io.h:24-76,
src/io/io.cpp).

The port's own copy of ``multiverso_tpu/utils/io.py``'s byte layer: a
``URI`` (scheme://host/path), a binary ``Stream`` with the integer,
double and string helpers, and a ``StreamFactory`` that opens a stream by
scheme. Byte-compatible with the JAX package: integers are little-endian
int64, doubles little-endian float64, strings an int64 byte length then
UTF-8, so a table or a checkpoint written by one package loads in the
other.

Local files (``file://`` and scheme-less paths) are built in; another
scheme raises until a backend is registered with
``StreamFactory.RegisterSchemeBackend`` (the reference's extension seam).
The JAX package's fsspec backend for remote schemes is not ported yet
(``ROADMAP.md`` §1).
"""

from __future__ import annotations

import io
import os
import struct
from typing import Callable, Dict


class URI:
    """reference io.h:24-43."""

    def __init__(self, uri: str):
        self.uri = uri
        if "://" in uri:
            self.scheme, rest = uri.split("://", 1)
            if "/" in rest:
                self.host, path = rest.split("/", 1)
                self.path = "/" + path
            else:
                self.host, self.path = rest, "/"
        else:
            self.scheme, self.host, self.path = "file", "", uri

    def name(self) -> str:
        return self.uri


class Stream:
    """``Write``/``Read`` raw bytes plus the helpers the tables and the
    checkpoint use, over any binary file object (an in-memory buffer by
    default)."""

    def __init__(self, fileobj=None, uri_name: str = ""):
        self._f = fileobj if fileobj is not None else io.BytesIO()
        self._name = uri_name

    def Write(self, data: bytes) -> None:
        self._f.write(data)

    def Read(self, size: int) -> bytes:
        return self._f.read(size)

    def WriteInt(self, value: int) -> None:
        self.Write(struct.pack("<q", value))

    def ReadInt(self) -> int:
        return struct.unpack("<q", self.Read(8))[0]

    def WriteDouble(self, value: float) -> None:
        self.Write(struct.pack("<d", value))

    def ReadDouble(self) -> float:
        return struct.unpack("<d", self.Read(8))[0]

    def WriteStr(self, s: str) -> None:
        raw = s.encode("utf-8")
        self.WriteInt(len(raw))
        self.Write(raw)

    def ReadStr(self) -> str:
        return self.Read(self.ReadInt()).decode("utf-8")

    def Good(self) -> bool:
        return self._f is not None and not self._f.closed

    def Flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_MODE_MAP = {"r": "rb", "w": "wb", "a": "ab"}

_scheme_backends: Dict[str, Callable[[URI, str], Stream]] = {}


def _open_local(uri: URI, mode: str) -> Stream:
    path = uri.path if "://" in uri.uri else uri.uri
    pymode = _MODE_MAP.get(mode, mode)
    if "w" in pymode or "a" in pymode:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return Stream(open(path, pymode), uri.name())


_scheme_backends["file"] = _open_local


class StreamFactory:
    """Scheme dispatch (reference src/io/io.cpp:8-24)."""

    @staticmethod
    def GetStream(uri, mode: str = "r") -> Stream:
        if isinstance(uri, str):
            uri = URI(uri)
        backend = _scheme_backends.get(uri.scheme)
        if backend is None:
            raise NotImplementedError(
                f"no stream backend registered for scheme {uri.scheme!r} "
                f"(register one with StreamFactory.RegisterSchemeBackend)")
        return backend(uri, mode)

    @staticmethod
    def RegisterSchemeBackend(scheme: str,
                              factory: Callable[[URI, str], Stream]) -> None:
        _scheme_backends[scheme] = factory
