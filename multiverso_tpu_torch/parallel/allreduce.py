"""Allreduce for model-average (``-ma``) mode.

Counterpart of ``multiverso_tpu/parallel/allreduce.py``'s
``RendezvousAllreduce``: an in-process allreduce across worker threads,
the 1-host stand-in for MPI ranks (the semantics of ``MV_Aggregate`` in
reference Test/test_allreduce.cpp:11-20: every participant contributes its
buffer and receives the elementwise sum).

Not ported (ROADMAP.md): the cross-process leg (``cross_reduce``) and the
device collectives (``device_allreduce``, ``jit_mean_across``), which on
GPUs become NCCL collectives.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class RendezvousAllreduce:
    """N-participant elementwise-sum rendezvous.

    Each participant thread calls ``allreduce(arr)``; all block until every
    contribution arrived, then all receive the sum, accumulated in float64
    and cast back to the caller's dtype. Reusable across rounds (a
    generation counter), as repeated ``MV_Aggregate`` calls need.
    """

    def __init__(self, num_participants: int):
        if num_participants <= 0:
            raise ValueError("num_participants must be positive")
        self.n = num_participants
        self._lock = threading.Condition()
        self._accum: Optional[np.ndarray] = None
        self._arrived = 0
        self._generation = 0
        self._result: Optional[np.ndarray] = None

    def allreduce(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        with self._lock:
            gen = self._generation
            if self._accum is None:
                self._accum = arr.astype(np.float64, copy=True)
            else:
                self._accum += arr
            self._arrived += 1
            if self._arrived == self.n:
                self._result = self._accum
                self._accum = None
                self._arrived = 0
                self._generation += 1
                self._lock.notify_all()
            else:
                # no participant of the next round can arrive before this
                # one returns, so the result read below is this round's
                self._lock.wait_for(lambda: self._generation > gen)
            return self._result.astype(arr.dtype)
