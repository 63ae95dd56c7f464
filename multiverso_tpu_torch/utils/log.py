"""Leveled logger + CHECK (the port's own copy of
``multiverso_tpu/utils/log.py``, reference util/log.h:22-146 and
src/util/log.cpp).

Levels Debug/Info/Error/Fatal, an optional file sink, lines formatted
``[LEVEL] [TIME] text``. ``Log.Fatal`` and a failed ``CHECK`` raise
``FatalError`` by default, so callers and tests can catch protocol
violations; ``ResetKillFatal(True)`` makes them end the process as the
reference does. ``-logtostderr`` sends every line to stderr even with a
file sink (the reference's glog-style flag).
"""

from __future__ import annotations

import enum
import os
import sys
import threading
import time
from typing import IO, Optional

from multiverso_tpu_torch.utils.configure import GetFlag, MV_DEFINE_bool

MV_DEFINE_bool("logtostderr", False, "log to stderr instead of the file sink")


class LogLevel(enum.IntEnum):
    Debug = 0
    Info = 1
    Error = 2
    Fatal = 3


class FatalError(RuntimeError):
    """Raised on Log.Fatal / failed CHECK (the reference aborts)."""


class Logger:
    """Instance logger (reference log.h:60-106)."""

    def __init__(self, level: LogLevel = LogLevel.Info,
                 file: Optional[str] = None):
        self._level = level
        self._file: Optional[IO[str]] = None
        self._lock = threading.Lock()
        self._kill_fatal = False
        #: a zero-arg callable giving the rank each line is tagged with
        self._rank_fn = None
        if file:
            self.ResetLogFile(file)

    def ResetLogFile(self, filename: str) -> None:
        """Append to ``filename`` from now on ("" closes the file sink)."""
        with self._lock:
            if self._file:
                self._file.close()
                self._file = None
            if filename:
                self._file = open(filename, "a")

    def ResetLogLevel(self, level: LogLevel) -> None:
        self._level = LogLevel(level)

    def ResetKillFatal(self, is_kill: bool) -> None:
        self._kill_fatal = bool(is_kill)

    def _write(self, level: LogLevel, msg: str) -> None:
        if level < self._level and level != LogLevel.Fatal:
            return
        stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
        rank = ""
        if self._rank_fn is not None:
            try:
                rank = f" [rank {self._rank_fn()}]"
            except Exception:
                rank = ""
        line = f"[{level.name.upper()}] [{stamp}]{rank} {msg}"
        with self._lock:
            try:
                to_stderr = bool(GetFlag("logtostderr"))
            except Exception:       # the registry torn down at exit
                to_stderr = False
            to_file = self._file is not None and not to_stderr
            print(line, file=self._file if to_file else sys.stderr,
                  flush=True)
            if to_file and level >= LogLevel.Error:
                # errors reach stderr too, as in the reference
                print(line, file=sys.stderr, flush=True)

    def Debug(self, fmt: str, *args) -> None:
        self._write(LogLevel.Debug, fmt % args if args else fmt)

    def Info(self, fmt: str, *args) -> None:
        self._write(LogLevel.Info, fmt % args if args else fmt)

    def Error(self, fmt: str, *args) -> None:
        self._write(LogLevel.Error, fmt % args if args else fmt)

    def Fatal(self, fmt: str, *args) -> None:
        msg = fmt % args if args else fmt
        self._write(LogLevel.Fatal, msg)
        if self._kill_fatal:
            os._exit(1)
        raise FatalError(msg)

    def Write(self, level: LogLevel, fmt: str, *args) -> None:
        if level == LogLevel.Fatal:
            self.Fatal(fmt, *args)
        else:
            self._write(LogLevel(level), fmt % args if args else fmt)


class Log:
    """Static logger front-end (reference log.h:109-146)."""

    _logger = Logger()

    @classmethod
    def ResetLogFile(cls, filename: str) -> None:
        cls._logger.ResetLogFile(filename)

    @classmethod
    def ResetLogLevel(cls, level: LogLevel) -> None:
        cls._logger.ResetLogLevel(level)

    @classmethod
    def ResetKillFatal(cls, is_kill: bool) -> None:
        cls._logger.ResetKillFatal(is_kill)

    @classmethod
    def Debug(cls, fmt: str, *args) -> None:
        cls._logger.Debug(fmt, *args)

    @classmethod
    def Info(cls, fmt: str, *args) -> None:
        cls._logger.Info(fmt, *args)

    @classmethod
    def Error(cls, fmt: str, *args) -> None:
        cls._logger.Error(fmt, *args)

    @classmethod
    def Fatal(cls, fmt: str, *args) -> None:
        cls._logger.Fatal(fmt, *args)

    @classmethod
    def Write(cls, level: LogLevel, fmt: str, *args) -> None:
        cls._logger.Write(level, fmt, *args)


def CHECK(condition, msg: str = "") -> None:
    """Raise ``FatalError`` when ``condition`` is false (reference
    log.h:10-13)."""
    if not condition:
        Log.Fatal("Check failed: %s", msg or "<condition>")


def CHECK_NOTNULL(pointer, name: str = "pointer"):
    """``pointer``, or ``FatalError`` when it is None (reference
    log.h:15-18)."""
    if pointer is None:
        Log.Fatal("Check notnull failed: %s", name)
    return pointer
