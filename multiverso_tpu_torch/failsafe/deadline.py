"""Deadlines on blocking paths: ``-mv_deadline_s``, ``-mv_max_retries``
and the helpers of a bounded wait (the port's own copy of
``multiverso_tpu/failsafe/deadline.py``).

The flag is 0 (off) by default, which keeps every wait blocking as
before. Set, it bounds the worker table's ``Wait``, ``MultiCall.Wait``,
the worker and cross-host barriers, the engine's drain and cut waits, the
pipelined engine's apply fence and window collectives, the allreduce
rendezvous, a serving lookup and a host-wire exchange: expiry raises a
typed :class:`DeadlineExceeded` carrying the diagnostic bundle
(``diagnostics.py``) instead of hanging on a lost peer.

Two shapes of bounded wait:

* condition-variable waits (``Waiter``, ``threading.Barrier``) take the
  timeout natively: :func:`timeout_or_none` feeds it through and
  :func:`raise_deadline` turns expiry into the typed error;
* a collective cannot be interrupted (an exchange blocked on a dead peer
  holds its thread): :func:`bounded` runs the call on a reusable daemon
  runner thread and waits with the deadline. On expiry the caller gets a
  ``DeadlineExceeded`` marked ``mv_fatal`` (the abandoned runner may
  finish the collective later, so the caller's collective stream is
  unsound) and that runner is never used again. The runner issues its
  CUDA work on the caller's device and stream, so a bounded call queues
  on the card exactly where the direct call would.
"""

from __future__ import annotations

import threading
from typing import Optional

from multiverso_tpu_torch.failsafe.errors import DeadlineExceeded
from multiverso_tpu_torch.utils.configure import (MV_DEFINE_double,
                                                  MV_DEFINE_int,
                                                  cached_float_flag)

MV_DEFINE_double("mv_deadline_s", 0.0,
                 "bound every blocking wait (table Wait, barriers, "
                 "window exchange, shutdown drain) and raise "
                 "DeadlineExceeded with a diagnostic bundle on expiry "
                 "(0 = off, preserving blocking semantics)")
MV_DEFINE_int("mv_max_retries", 3,
              "worker verb retries on TransientError (exponential "
              "backoff with jitter; the server dedup window makes "
              "retried Adds at-most-once)")

#: the bounded shutdown join when no deadline is set: MV_ShutDown logs a
#: stuck actor (name and queue depth), never hangs on it
DEFAULT_SHUTDOWN_JOIN_S = 30.0

#: listener-refreshed: deadline_s runs once per tracked Wait and window
#: exchange, where a registry read per call costs too much
_deadline_flag = cached_float_flag("mv_deadline_s", 0.0)


def deadline_s() -> float:
    """The configured deadline in seconds; 0.0 = deadlines off."""
    return max(0.0, _deadline_flag())


def timeout_or_none() -> Optional[float]:
    """The deadline as a ``Condition.wait_for`` timeout: None (block, the
    unbounded path) when the flag is unset."""
    dl = deadline_s()
    return dl if dl > 0 else None


def raise_deadline(what: str, seconds: Optional[float] = None,
                   fatal: bool = False) -> None:
    """Count ``failsafe.deadline_exceeded``, build the diagnostic bundle
    and raise ``DeadlineExceeded``."""
    from multiverso_tpu_torch.failsafe import diagnostics
    from multiverso_tpu_torch.telemetry import metrics
    metrics.counter("failsafe.deadline_exceeded").inc()
    secs = deadline_s() if seconds is None else seconds
    raise DeadlineExceeded(what, secs, diagnostics.bundle(what),
                           fatal=fatal)


def _cuda_context():
    """The caller's CUDA device and current stream, or None when CUDA was
    never initialised in this process (no card, or a CPU world)."""
    import torch
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_device(), torch.cuda.current_stream()


class _Runner:
    """One reusable single-slot worker thread for :func:`bounded`: the
    steady state (two window exchanges a window) reuses it instead of
    paying a thread start and join a call. A runner abandoned by an expiry
    (stuck in an uninterruptible collective) stays ``busy`` and is never
    handed another call: the next call starts a fresh runner."""

    def __init__(self):
        from multiverso_tpu_torch.utils.mt_queue import MtQueue
        self.busy = False
        self._calls: MtQueue = MtQueue()
        threading.Thread(target=self._loop, name="mvt-bounded-runner",
                         daemon=True).start()

    def submit(self, fn, cuda, box: dict, done: threading.Event) -> None:
        self.busy = True
        self._calls.Push((fn, cuda, box, done))

    def _loop(self) -> None:
        while True:
            # unbounded-ok: an idle runner parks here until its owner
            # hands it the next call (a daemon thread; never joined)
            ok, item = self._calls.Pop()
            if not ok:
                return
            fn, cuda, box, done = item
            try:
                if cuda is None:
                    box["result"] = fn()
                else:
                    import torch
                    with torch.cuda.device(cuda[0]), \
                            torch.cuda.stream(cuda[1]):
                        box["result"] = fn()
            except BaseException as exc:     # delivered to the caller
                box["error"] = exc
            self.busy = False
            done.set()


_runner_tl = threading.local()


def bounded(fn, what: str, fatal: bool = True):
    """Run ``fn()`` under the configured deadline.

    Deadline off: a direct call (no thread). Deadline on: ``fn`` runs on
    this thread's runner, with the caller's CUDA device and stream, and
    the caller waits with the deadline; expiry raises ``DeadlineExceeded``
    and abandons the runner (the only honest option for an
    uninterruptible collective)."""
    dl = deadline_s()
    if dl <= 0:
        return fn()
    runner = getattr(_runner_tl, "runner", None)
    if runner is None or runner.busy:
        runner = _Runner()
        _runner_tl.runner = runner
    box: dict = {}
    done = threading.Event()
    runner.submit(fn, _cuda_context(), box, done)
    if not done.wait(dl):
        raise_deadline(what, dl, fatal=fatal)
    if "error" in box:
        raise box["error"]
    return box.get("result")
