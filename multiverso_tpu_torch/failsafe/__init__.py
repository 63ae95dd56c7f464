"""Failsafe: bounded waits, seeded chaos, at-most-once Adds, fail-fast
(the port of ``multiverso_tpu/failsafe/``).

* :mod:`deadline` — ``-mv_deadline_s`` bounds every blocking wait of the
  runtime (the worker table's ``Wait``, the barriers, the engine's drain,
  cut waits, apply fence and window collectives, the allreduce
  rendezvous, serving lookups, wire exchanges); expiry raises
  :class:`DeadlineExceeded` carrying a :mod:`diagnostics` bundle.
  ``-mv_max_retries`` bounds the worker's retries of a
  :class:`TransientError`.
* :mod:`chaos` — ``-chaos_spec``/``-chaos_seed``, the seeded fault
  injector: mailbox drop/dup/delay, wire bitflip/truncate, verb
  transient/failack, serving overload/delay, apply delay, tcp
  delay/drop/partition; deterministic given the seed.
* :mod:`dedup` — the engine's ``(src, msg_id)`` at-most-once window
  (``-mv_dedup_window``), so a retried Add never applies twice.
* fail-fast actor death — a dead loop thread poisons its mailbox
  (:class:`ActorDied`).

Importing this package registers every failsafe flag (zoo imports it
before ``ParseCMDFlags`` runs).
"""

from multiverso_tpu_torch.failsafe import chaos, deadline, diagnostics  # noqa: F401
from multiverso_tpu_torch.failsafe.dedup import DedupWindow  # noqa: F401
from multiverso_tpu_torch.failsafe.errors import (  # noqa: F401
    ActorDied,
    DeadlineExceeded,
    FailsafeError,
    ServingOverloaded,
    TransientError,
    WireCorruption,
)
