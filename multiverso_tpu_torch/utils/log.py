"""Leveled logger + CHECK (the port's own copy of
``multiverso_tpu/utils/log.py``, reference util/log.h:22-146).

``Log.Fatal`` and a failed ``CHECK`` raise ``FatalError`` so callers and
tests can catch protocol violations.
"""

from __future__ import annotations

import enum
import sys
import threading
import time


class LogLevel(enum.IntEnum):
    Debug = 0
    Info = 1
    Error = 2
    Fatal = 3


class FatalError(RuntimeError):
    """Raised on Log.Fatal / failed CHECK (the reference aborts)."""


class Log:
    """Static logger front-end writing ``[LEVEL] [TIME] text`` lines to
    stderr."""

    _level = LogLevel.Info
    _lock = threading.Lock()

    @classmethod
    def _write(cls, level: LogLevel, fmt: str, args) -> None:
        if level < cls._level and level != LogLevel.Fatal:
            return
        msg = fmt % args if args else fmt
        stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
        with cls._lock:
            print(f"[{level.name.upper()}] [{stamp}] {msg}", file=sys.stderr,
                  flush=True)

    @classmethod
    def Debug(cls, fmt: str, *args) -> None:
        cls._write(LogLevel.Debug, fmt, args)

    @classmethod
    def Info(cls, fmt: str, *args) -> None:
        cls._write(LogLevel.Info, fmt, args)

    @classmethod
    def Error(cls, fmt: str, *args) -> None:
        cls._write(LogLevel.Error, fmt, args)

    @classmethod
    def Fatal(cls, fmt: str, *args) -> None:
        cls._write(LogLevel.Fatal, fmt, args)
        raise FatalError(fmt % args if args else fmt)


def CHECK(condition, msg: str = "") -> None:
    """Raise ``FatalError`` when ``condition`` is false."""
    if not condition:
        Log.Fatal("Check failed: %s", msg or "<condition>")
