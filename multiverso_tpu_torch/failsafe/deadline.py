"""``-mv_deadline_s`` and the helpers of a bounded wait (the port's own
copy of the part of ``multiverso_tpu/failsafe/deadline.py`` serving and
the host wires use).

The flag is 0 (off) by default, which keeps waits unbounded. In the port
it bounds a serving lookup's wait (``serving/frontend.py``) and a shm or
tcp wire exchange's (``parallel/shm_wire.py``, ``parallel/tcp_wire.py``);
the engine's own waits are not bounded yet (``ROADMAP.md``).
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Optional

from multiverso_tpu_torch.failsafe.errors import DeadlineExceeded
from multiverso_tpu_torch.utils.configure import GetFlag, MV_DEFINE_double

MV_DEFINE_double("mv_deadline_s", 0.0,
                 "bound every serving lookup's and host-wire exchange's "
                 "wait and raise DeadlineExceeded with the threads' "
                 "stacks on expiry "
                 "(0 = off: waits block)")


def deadline_s() -> float:
    """The configured deadline in seconds; 0.0 = deadlines off."""
    return max(0.0, float(GetFlag("mv_deadline_s")))


def timeout_or_none() -> Optional[float]:
    """The deadline as a ``Condition.wait_for`` timeout: None (block) when
    the flag is unset."""
    dl = deadline_s()
    return dl if dl > 0 else None


def _thread_stacks() -> str:
    """Every live thread's stack, innermost frame last."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"thread {names.get(ident, ident)}:")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out)


def raise_deadline(what: str, seconds: Optional[float] = None) -> None:
    """Raise ``DeadlineExceeded`` for ``what`` with every thread's stack."""
    secs = deadline_s() if seconds is None else seconds
    raise DeadlineExceeded(what, secs,
                           f"-- threads --\n{_thread_stacks()}")
