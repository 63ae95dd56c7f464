"""Failsafe: the typed errors and the deadline of the serving plane.

The port's trimmed copy of ``multiverso_tpu/failsafe/``: the error types
serving raises (``errors.py``) and the ``-mv_deadline_s`` bound on a
lookup's wait (``deadline.py``). The rest of the JAX subsystem (seeded
chaos, the server's dedup window, the diagnostic bundle, deadlines on the
engine's own waits) is later work (``ROADMAP.md``).

Importing this package registers ``-mv_deadline_s`` (zoo imports it
before ``ParseCMDFlags`` runs).
"""

from multiverso_tpu_torch.failsafe import deadline  # noqa: F401
from multiverso_tpu_torch.failsafe.errors import (  # noqa: F401
    DeadlineExceeded,
    FailsafeError,
    ServingOverloaded,
)
