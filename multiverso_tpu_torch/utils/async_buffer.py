"""Double-buffer prefetcher.

Counterpart of ``multiverso_tpu/utils/async_buffer.py`` (reference
include/multiverso/util/async_buffer.h:11-118, ``ASyncBuffer``): two
buffers; a background fill function writes the next buffer while the
consumer reads the ready one. ``Get()`` waits for the in-flight fill,
returns the filled buffer and starts filling the other one.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class ASyncBuffer(Generic[T]):
    def __init__(self, buffer0: T, buffer1: T, fill: Callable[[T], None]):
        """``fill(buffer)`` populates a buffer; it runs on a worker
        thread."""
        self._buffers: List[T] = [buffer0, buffer1]
        self._fill = fill
        self._pending: Optional[threading.Thread] = None
        self._ready_idx = 0
        self._launch(self._ready_idx)

    def _launch(self, idx: int) -> None:
        t = threading.Thread(target=self._fill, args=(self._buffers[idx],),
                             daemon=True)
        t.start()
        self._pending = t

    def Get(self) -> T:
        """Wait for the in-flight fill, return its buffer, prefetch the
        other one."""
        assert self._pending is not None, "ASyncBuffer.Get after Join"
        # unbounded-ok: fill() is caller code whose end defines the
        # buffer's readiness (a deadline would hand back a half-filled
        # buffer; a wedged fill is the caller's bug to bound)
        self._pending.join()
        ready = self._buffers[self._ready_idx]
        self._ready_idx ^= 1
        self._launch(self._ready_idx)
        return ready

    def Join(self) -> None:
        """Wait for the last fill; the buffer takes no further Get."""
        if self._pending is not None:
            # unbounded-ok: completion rendezvous with the last fill
            self._pending.join()
            self._pending = None
