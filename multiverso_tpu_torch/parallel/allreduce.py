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

The rendezvous is bounded by ``-mv_deadline_s``: a participant that never
arrives raises ``DeadlineExceeded`` on the waiting threads and BREAKS the
rendezvous (its contribution is already in the sum, so a retry would
count it twice); every later call raises until the world restarts.

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
    every participant raises, and the next round works. A deadline breaks
    the rendezvous for good (``_broken``).
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
        #: set when a participant's deadline expired mid-round: the round
        #: can never complete correctly (its contribution is in _accum but
        #: its caller moved on), so the rendezvous breaks for everyone
        self._broken = False

    def allreduce(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        from multiverso_tpu_torch.failsafe import deadline as fdeadline
        with self._lock:
            if self._broken:
                fdeadline.raise_deadline(
                    "allreduce rendezvous (broken by an earlier "
                    "participant deadline)")
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
                if not self._lock.wait_for(
                        lambda: self._generation > gen or self._broken,
                        fdeadline.timeout_or_none()):
                    self._broken = True
                    self._lock.notify_all()
                    fdeadline.raise_deadline(
                        "allreduce rendezvous (missing participants)")
                if self._broken and self._generation <= gen:
                    fdeadline.raise_deadline(
                        "allreduce rendezvous (broken by a peer "
                        "participant deadline)")
            if self._error is not None:
                raise RuntimeError(
                    "cross-process allreduce failed") from self._error
            return self._result.astype(arr.dtype)
