"""Wall-clock timer (reference include/multiverso/util/timer.h:10-24)."""

from __future__ import annotations

import time


class Timer:
    """Starts on construction; ``elapse`` is seconds since the last
    Start."""

    def __init__(self):
        self._start = time.perf_counter()

    def Start(self) -> None:
        self._start = time.perf_counter()

    def elapse(self) -> float:
        return time.perf_counter() - self._start

    def elapse_ms(self) -> float:
        return self.elapse() * 1e3
