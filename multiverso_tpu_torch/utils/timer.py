"""Wall-clock timer (reference include/multiverso/util/timer.h:10-24)."""

from __future__ import annotations

import time


class Timer:
    """Starts on construction; ``elapse`` is seconds since then."""

    def __init__(self):
        self._start = time.perf_counter()

    def elapse(self) -> float:
        return time.perf_counter() - self._start
