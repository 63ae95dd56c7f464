"""The server's ``(src, msg_id)`` at-most-once window for Adds (the port's
own copy of ``multiverso_tpu/failsafe/dedup.py``).

A worker retry after a ``TransientError`` (or a duplicated mailbox
delivery) must never apply an Add twice. The engine records every
admitted tracked Add's key before applying and its outcome at reply time;
a later arrival with a seen key is answered from the record instead of
re-entering the apply path, and BEFORE the windowed engine's verb stream,
so a duplicate never becomes an extra collective verb that would diverge
the ranks' streams.

Gets are not deduped: they are idempotent, and re-serving a retried Get
is both correct and cheaper than caching results.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Hashable, Tuple

from multiverso_tpu_torch.utils.configure import MV_DEFINE_int

MV_DEFINE_int("mv_dedup_window", 4096,
              "server-side (src, msg_id) at-most-once window size for "
              "Adds (worker retries / duplicate deliveries inside the "
              "window are answered without re-applying)")

#: outcome placeholder between admission and reply
PENDING = object()


class DedupWindow:
    """Bounded insertion-ordered map of Add keys -> outcomes; the oldest
    entry is evicted first."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Hashable, Any]" = \
            collections.OrderedDict()

    def seen(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def record(self, key: Hashable) -> None:
        """Mark ``key`` admitted for apply (outcome pending)."""
        with self._lock:
            self._entries[key] = PENDING
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def set_outcome(self, key: Hashable, outcome: Any) -> None:
        """Record the apply outcome; the first outcome wins (as the
        message's first reply does)."""
        with self._lock:
            if self._entries.get(key, None) is PENDING:
                self._entries[key] = outcome

    def outcome(self, key: Hashable) -> Tuple[bool, Any]:
        """(ready, outcome) for a seen key; (False, None) while the
        original is still in flight or the key was evicted."""
        with self._lock:
            val = self._entries.get(key, PENDING)
        if val is PENDING:
            return False, None
        return True, val

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
