"""Thread-safe blocking queue with Exit semantics (the port's own copy of
``multiverso_tpu/utils/mt_queue.py``, reference util/mt_queue.h:19-149).
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, Generic, Optional, Tuple, TypeVar

T = TypeVar("T")


class MtQueue(Generic[T]):
    def __init__(self):
        self._deque: Deque[T] = collections.deque()
        self._cv = threading.Condition()
        self._exit = False

    def Push(self, item: T) -> None:
        with self._cv:
            self._deque.append(item)
            self._cv.notify()

    def Pop(self, timeout: Optional[float] = None) -> Tuple[bool, Optional[T]]:
        """Block until an item, Exit, or ``timeout``. Returns (ok, item)."""
        with self._cv:
            self._cv.wait_for(lambda: self._deque or self._exit, timeout)
            if self._deque:
                return True, self._deque.popleft()
            return False, None

    def TryPop(self) -> Tuple[bool, Optional[T]]:
        with self._cv:
            if self._deque:
                return True, self._deque.popleft()
            return False, None

    def Size(self) -> int:
        with self._cv:
            return len(self._deque)

    def Exit(self) -> None:
        with self._cv:
            self._exit = True
            self._cv.notify_all()
