"""Failsafe: the typed errors and the deadline of the serving plane and
the host wires.

The port's trimmed copy of ``multiverso_tpu/failsafe/``: the error types
serving and the wires raise (``errors.py``) and the ``-mv_deadline_s``
bound on a lookup's wait and on a wire exchange's (``deadline.py``). The
rest of the JAX subsystem (seeded chaos, the server's dedup window, the
diagnostic bundle, deadlines on the engine's own waits) is later work
(``ROADMAP.md``).

Importing this package registers ``-mv_deadline_s`` (zoo imports it
before ``ParseCMDFlags`` runs).
"""

from multiverso_tpu_torch.failsafe import deadline  # noqa: F401
from multiverso_tpu_torch.failsafe.errors import (  # noqa: F401
    ActorDied,
    DeadlineExceeded,
    FailsafeError,
    ServingOverloaded,
    WireCorruption,
)
