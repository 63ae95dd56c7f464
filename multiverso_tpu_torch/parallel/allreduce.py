"""Allreduce for model-average (``-ma``) mode.

Counterpart of ``multiverso_tpu/parallel/allreduce.py``'s
``RendezvousAllreduce``: an in-process allreduce across worker threads,
the 1-host stand-in for MPI ranks (the semantics of ``MV_Aggregate`` in
reference Test/test_allreduce.cpp:11-20: every participant contributes its
buffer and receives the elementwise sum).

``cross_reduce`` extends the sum beyond the process: the last thread of a
round reduces the thread sum across processes once (``Zoo`` passes
``multihost.host_allreduce_sum`` in a multi-process world; reference
MPI_Allreduce, mpi_net.h:148-152).

Not ported (ROADMAP.md): the device collectives (``device_allreduce``,
``jit_mean_across``), which have no caller in the JAX package outside
their export.
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

    ``cross_reduce`` (optional) runs once per round, on the last-arriving
    thread, over the thread-summed float64 buffer: every process's last
    thread issues the same collective. A raise there still ends the round:
    every participant raises, and the next round works.
    """

    def __init__(self, num_participants: int, cross_reduce=None):
        if num_participants <= 0:
            raise ValueError("num_participants must be positive")
        self.n = num_participants
        self._cross = cross_reduce
        self._lock = threading.Condition()
        self._accum: Optional[np.ndarray] = None
        self._arrived = 0
        self._generation = 0
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

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
                # the round ends whatever cross_reduce does: a raise must
                # not strand the waiters or wedge the next round
                result, error = self._accum, None
                if self._cross is not None:
                    try:
                        result = np.asarray(self._cross(result))
                    except BaseException as exc:
                        error = exc
                self._result, self._error = result, error
                self._accum = None
                self._arrived = 0
                self._generation += 1
                self._lock.notify_all()
            else:
                # no participant of the next round can arrive before this
                # one returns, so the result read below is this round's
                self._lock.wait_for(lambda: self._generation > gen)
            if self._error is not None:
                raise RuntimeError(
                    "cross-process allreduce failed") from self._error
            return self._result.astype(arr.dtype)
