"""The coordinator dialer: an ordered endpoint list and a bounded retry.

The port's own copy of ``multiverso_tpu/elastic/dialer.py``. Every
coordinator client (``coordinator.MemberClient``) connects through it:

* an **ordered endpoint list** (``-mv_coordinator=host:port[,host:port]``,
  primary first, successors after): a failed connect rotates to the next
  endpoint;
* **jittered exponential backoff** between full-list sweeps;
* a **deadline cap**: exhaustion raises the typed
  :class:`~multiverso_tpu_torch.failsafe.errors.CoordinatorUnreachable`
  (a ``TransientError``) instead of whatever ``OSError`` the last sweep
  hit.

The dialer owns only the CONNECT phase; retrying a request after its bytes
went out is a per-op decision and stays with the callers.

``elastic.client_failovers`` counts every successful dial that lands on
another endpoint than the previous success, and ``elastic.active_endpoint``
gauges the index in use.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import List, Optional, Sequence, Tuple

from multiverso_tpu_torch.failsafe.errors import CoordinatorUnreachable
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.log import CHECK, Log

#: default bound on one dial() — generous enough to ride out a standby
#: takeover (lease expiry + replay), small enough that a world with NO
#: live coordinator fails typed instead of hanging a control path
_DEFAULT_DEADLINE_S = 8.0

#: one TCP connect attempt (an unreachable host blackholes; refused
#: connects return instantly and never wait this long)
_CONNECT_TIMEOUT_S = 10.0

#: backoff between full-list sweeps: base * 2**sweep, capped, jittered
_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 1.0


def parse_endpoints(spec) -> List[Tuple[str, int]]:
    """Normalize an endpoint spec to ``[(host, port), ...]``. Accepts
    the ``-mv_coordinator`` flag form (``"h:p,h:p"``), a single
    ``(host, port)`` tuple, or a sequence of either."""
    if isinstance(spec, tuple) and len(spec) == 2 \
            and not isinstance(spec[0], (tuple, list)):
        spec = [spec]
    if isinstance(spec, str):
        spec = [s for s in spec.split(",") if s.strip()]
    out: List[Tuple[str, int]] = []
    for item in spec:
        if isinstance(item, (tuple, list)):
            host, port = item
        else:
            host, _, port = str(item).strip().rpartition(":")
            CHECK(host and str(port).isdigit(),
                  f"coordinator endpoint must be host:port, got {item!r}")
        out.append((str(host), int(port)))
    CHECK(out, f"empty coordinator endpoint list: {spec!r}")
    return out


class Dialer:
    """One client's connect path to the ordered coordinator endpoint
    list. Thread-safe: the heartbeat thread, the app thread and the
    engine thread may dial concurrently (each gets its own socket; only
    the active-endpoint cursor is shared)."""

    def __init__(self, endpoints, what: str = "coordinator",
                 deadline_s: float = _DEFAULT_DEADLINE_S):
        self.endpoints = parse_endpoints(endpoints)
        self.what = what
        self.deadline_s = float(deadline_s)
        self._lock = threading.Lock()
        self._idx = 0               # where the next dial starts
        self._last_ok: Optional[int] = None
        #: bumps every time a successful dial lands on a DIFFERENT
        #: endpoint than the previous success — consumers (the
        #: publisher's fan-out tick) reset per-endpoint state on it
        self.failover_gen = 0
        tmetrics.counter("elastic.client_failovers")    # eager: shows 0
        tmetrics.counter("elastic.dial_retries")
        tmetrics.gauge("elastic.active_endpoint").set(0)

    @property
    def active(self) -> Tuple[str, int]:
        with self._lock:
            return self.endpoints[self._idx]

    def mark_failed(self) -> None:
        """A POST-connect failure (socket died mid-request): rotate the
        cursor so the next dial tries the next endpoint first."""
        with self._lock:
            if len(self.endpoints) > 1:
                self._idx = (self._idx + 1) % len(self.endpoints)
                tmetrics.gauge("elastic.active_endpoint").set(
                    float(self._idx))

    def _note_success(self, idx: int) -> None:
        with self._lock:
            if self._last_ok is not None and self._last_ok != idx:
                self.failover_gen += 1
                tmetrics.counter("elastic.client_failovers").inc()
                Log.Error(
                    "elastic: %s failed over to coordinator endpoint "
                    "%s:%d (list position %d)", self.what,
                    self.endpoints[idx][0], self.endpoints[idx][1], idx)
            self._last_ok = idx
            self._idx = idx
            tmetrics.gauge("elastic.active_endpoint").set(float(idx))

    def dial(self, deadline_s: Optional[float] = None) -> socket.socket:
        """Connect to the first reachable endpoint, walking the list
        from the active cursor with jittered exponential backoff
        between sweeps. Raises the typed
        :class:`CoordinatorUnreachable` at the deadline."""
        bound = float(deadline_s if deadline_s is not None
                      else self.deadline_s)
        deadline = time.monotonic() + bound
        eps = self.endpoints
        with self._lock:
            start = self._idx
        sweep = 0
        while True:
            for off in range(len(eps)):
                idx = (start + off) % len(eps)
                host, port = eps[idx]
                budget = deadline - time.monotonic()
                if budget <= 0:
                    break
                try:
                    sock = socket.create_connection(
                        (host, port),
                        timeout=min(_CONNECT_TIMEOUT_S, budget))
                except (ConnectionError, OSError):
                    if off or sweep:
                        tmetrics.counter("elastic.dial_retries").inc()
                    continue
                self._note_success(idx)
                return sock
            if time.monotonic() >= deadline:
                raise CoordinatorUnreachable(self.what, endpoints=eps,
                                             deadline_s=bound)
            # jittered exponential backoff between sweeps: refused
            # connects return instantly, so without this a dead world
            # would spin the list at syscall speed
            delay = min(_BACKOFF_CAP_S, _BACKOFF_BASE_S * (2 ** sweep))
            delay *= 0.5 + random.random()
            time.sleep(min(delay, max(0.0,
                                      deadline - time.monotonic())))
            sweep += 1
