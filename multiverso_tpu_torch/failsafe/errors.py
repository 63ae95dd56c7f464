"""Typed failure taxonomy of the failsafe subsystem (the port's own copy
of ``multiverso_tpu/failsafe/errors.py``).

The reference Multiverso's failure model is "hang or die": a lost message
or a diverged rank leaves every peer blocked in ``Waiter::Wait`` or the
controller barrier. These types give every bounded wait, corrupted frame,
retryable fault, shed lookup and dead actor a name the caller can catch,
so recovery code tells "slow" (``DeadlineExceeded``) from "retry"
(``TransientError``), "shed" (``ServingOverloaded``), "corrupt"
(``WireCorruption``), "gone" (``ActorDied``) and "the world changed"
(``MembershipChanged``) without reading log text.

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


class CoordinatorUnreachable(TransientError):
    """The coordinator dialer (``elastic/dialer.py``) exhausted its
    deadline without a TCP connect to ANY endpoint of the ordered list.
    A ``TransientError``, so every retry site that absorbs transients
    keeps working. ``endpoints`` is the list tried, ``deadline_s`` the
    bound that expired."""

    def __init__(self, what: str, endpoints=(), deadline_s: float = 0.0):
        self.what = what
        self.endpoints = tuple(endpoints)
        self.deadline_s = float(deadline_s)
        eps = ",".join(f"{h}:{p}" for h, p in self.endpoints)
        super().__init__(
            f"no coordinator reachable for {what} within "
            f"{deadline_s:g}s (tried [{eps}])")


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


class MembershipChanged(FailsafeError):
    """The elastic world's membership changed under this operation.

    Raised (instead of a hang or a fatal ``DeadlineExceeded``) when a rank
    joins or leaves the running world, gracefully through the
    coordinator's drain/admit protocol or silently when a member's
    heartbeat lease expired mid-collective. It carries the NEW view:

    * a worker whose verb was in flight across the transition receives
      it: its effects were rolled back to the epoch's snapshot cut, so it
      re-runs from its last elastic sync point;
    * a stale identity lookup (``MV_WorkerIdToRank`` past the view)
      receives it instead of a wrong rank.

    ``epoch`` is the membership epoch now in effect, ``members`` the
    surviving boot ranks, ``departed``/``joined`` the delta against the
    previous view."""

    def __init__(self, what: str, epoch: int, members=(),
                 departed=(), joined=()):
        self.what = what
        self.epoch = int(epoch)
        self.members = tuple(members)
        self.departed = tuple(departed)
        self.joined = tuple(joined)
        delta = []
        if self.departed:
            delta.append(f"departed={list(self.departed)}")
        if self.joined:
            delta.append(f"joined={list(self.joined)}")
        super().__init__(
            f"membership changed during {what}: epoch {epoch}, "
            f"members={list(self.members)}"
            + (f" ({', '.join(delta)})" if delta else ""))
