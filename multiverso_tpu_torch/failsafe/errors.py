"""Typed failure taxonomy of the failsafe subsystem (the port's own copy
of ``multiverso_tpu/failsafe/errors.py``).

The reference Multiverso's failure model is "hang or die": a lost message
or a diverged rank leaves every peer blocked in ``Waiter::Wait`` or the
controller barrier. These types give every bounded wait, corrupted frame,
retryable fault, shed lookup and dead actor a name the caller can catch,
so recovery code tells "slow" (``DeadlineExceeded``) from "retry"
(``TransientError``), "shed" (``ServingOverloaded``), "corrupt"
(``WireCorruption``) and "gone" (``ActorDied``) without reading log text.

``WireCorruption`` is the class the window seal (``parallel/seal.py``)
raises, re-exported here so each failure has one class.
"""

from __future__ import annotations

from multiverso_tpu_torch.parallel.seal import WireCorruption  # noqa: F401


class FailsafeError(RuntimeError):
    """Base of the failsafe taxonomy."""


class DeadlineExceeded(FailsafeError):
    """A blocking wait outlived its bound (``-mv_deadline_s`` or the
    caller's own). ``what`` names the wait, ``seconds`` the bound that
    expired, ``bundle`` the diagnostic bundle captured at expiry.
    ``mv_fatal`` marks deadlines after which the raising component's state
    is unsound (an abandoned collective exchange): the actor runtime
    poisons itself on those instead of processing further messages."""

    def __init__(self, what: str, seconds: float, bundle: str = "",
                 fatal: bool = False):
        self.what = what
        self.seconds = float(seconds)
        self.bundle = bundle
        self.mv_fatal = bool(fatal)
        msg = f"deadline of {seconds:g}s exceeded waiting for {what}"
        if bundle:
            msg = f"{msg}\n{bundle}"
        super().__init__(msg)


class TransientError(FailsafeError):
    """A retryable fault: the request was not (or may not have been)
    served, and resubmitting the SAME request is safe: the server's
    ``(src, msg_id)`` dedup window never applies an Add twice. The worker
    verb layer retries these with exponential backoff and jitter up to
    ``-mv_max_retries``."""


class ServingOverloaded(FailsafeError):
    """The serving plane shed this lookup: the front-end's admission queue
    already holds ``-mv_serving_max_inflight`` requests, the plane is shut
    down, or the ``serving.overload`` chaos site rehearsed the shed path.
    The request was NOT enqueued, so retrying later is safe: overload
    becomes a typed, immediate error for the marginal caller instead of
    unbounded tail latency for every caller."""


class ActorDied(FailsafeError):
    """An actor's loop thread died; its mailbox is poisoned. Raised at once
    by ``Receive`` and by pending ``Wait``s instead of enqueueing into (or
    blocking on) a dead thread. ``original`` (and ``__cause__``) carries
    the exception that killed the loop."""

    def __init__(self, actor_name: str, original: BaseException):
        self.actor_name = actor_name
        self.original = original
        super().__init__(
            f"actor {actor_name!r} loop thread died: {original!r}")
