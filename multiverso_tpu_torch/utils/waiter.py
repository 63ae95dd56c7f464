"""Counting-semaphore Waiter (the port's own copy of
``multiverso_tpu/utils/waiter.py``, reference util/waiter.h:10-34):
``Wait()`` blocks until the counter reaches zero, ``Notify()`` decrements,
``Reset(n)`` re-arms it for n notifications.
"""

from __future__ import annotations

import threading


class Waiter:
    def __init__(self, num_wait: int = 1):
        self._cv = threading.Condition()
        self._num = num_wait

    def Wait(self, timeout: float | None = None) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: self._num <= 0, timeout)

    def Notify(self) -> None:
        with self._cv:
            self._num -= 1
            if self._num <= 0:
                self._cv.notify_all()

    def Reset(self, num_wait: int) -> None:
        with self._cv:
            self._num = num_wait
