"""Typed failures of the serving plane and of the host wires (the port's
own copy of the part of ``multiverso_tpu/failsafe/errors.py`` they
raise): a caller can tell "slow" (``DeadlineExceeded``) from "shed"
(``ServingOverloaded``), a corrupted frame (``WireCorruption``) from a
lost peer (``ActorDied``) without reading log text.

``WireCorruption`` and ``ActorDied`` are the classes the window codec
(``parallel/seal.py``) and the actor runtime (``actor.py``) already raise,
re-exported here so each failure has one class."""

from __future__ import annotations

from multiverso_tpu_torch.actor import ActorDied  # noqa: F401
from multiverso_tpu_torch.parallel.seal import WireCorruption  # noqa: F401


class FailsafeError(RuntimeError):
    """Base of the failsafe taxonomy."""


class DeadlineExceeded(FailsafeError):
    """A blocking wait outlived its bound (``-mv_deadline_s`` or the
    caller's own). ``what`` names the wait, ``seconds`` the bound that
    expired, ``bundle`` the diagnostic text captured at expiry."""

    def __init__(self, what: str, seconds: float, bundle: str = ""):
        self.what = what
        self.seconds = float(seconds)
        self.bundle = bundle
        msg = f"deadline of {seconds:g}s exceeded waiting for {what}"
        if bundle:
            msg = f"{msg}\n{bundle}"
        super().__init__(msg)


class ServingOverloaded(FailsafeError):
    """The serving plane shed this lookup: the front-end's admission queue
    already holds ``-mv_serving_max_inflight`` requests, or the plane is
    shut down. The request was NOT enqueued, so retrying later is safe:
    overload becomes a typed, immediate error for the marginal caller
    instead of unbounded tail latency for every caller."""
