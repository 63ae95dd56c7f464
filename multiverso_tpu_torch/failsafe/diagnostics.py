"""The diagnostic bundle every ``DeadlineExceeded`` carries (the port's own
copy of ``multiverso_tpu/failsafe/diagnostics.py``).

A deadline that says only "timed out" makes the operator reproduce the
hang under a debugger. The bundle captures, at expiry, what a post-mortem
needs, in five sections: every thread's stack, the engine (each shard's
mailbox depth and poison, its window exchanges and verbs, the exchange
stage's depth, pending verbs and whether it is mid-exchange, the BSP
clocks), the worker tables' in-flight msg ids, the local telemetry
snapshot and the flight recorder's tail.

It is LOCAL only: no collective and no ``torch.cuda.synchronize()``, so a
wedged peer or a wedged kernel cannot hang the report of it. Every
section is best-effort: diagnostics never turn one failure into two.
"""

from __future__ import annotations

import sys
import threading
import traceback

#: per-section cap, so a bundle embedded in an exception message stays
#: readable even in a process of a hundred threads
_MAX_SECTION = 16000


def _clip(text: str) -> str:
    if len(text) <= _MAX_SECTION:
        return text
    return text[:_MAX_SECTION] + "\n... [clipped]"


def _thread_stacks() -> str:
    """Every live thread's stack, innermost frame last."""
    names = {t.ident: f"{t.name}{' (daemon)' if t.daemon else ''}"
             for t in threading.enumerate()}
    lines = []
    for ident, frame in sys._current_frames().items():
        lines.append(f"thread {names.get(ident, ident)}:")
        lines.extend("  " + ln.rstrip()
                     for ln in traceback.format_stack(frame))
    return "\n".join(lines)


def _shard_state(srv) -> list:
    lines = [
        f"actor {srv.name!r}: mailbox depth {srv.mailbox.Size()}, "
        f"poisoned={srv._poison!r}, window_exchanges="
        f"{getattr(srv, 'mh_window_exchanges', 0)}, "
        f"window_verbs={getattr(srv, 'mh_window_verbs', 0)}, "
        f"barrier_splits={getattr(srv, 'window_barrier_splits', 0)}"]
    stage = getattr(srv, "_ex_stage", None)
    if stage is not None:
        # where the pipeline stood: an exchange waiting for peers shows
        # mid_exchange, a wedged apply shows exchanged items piling up
        lines.append(
            f"exchange stage: depth={stage.depth()} (exchanged, "
            f"unapplied), pending_verbs={stage.pending_verbs()}, "
            f"mid_exchange={bool(stage.busy_since)}, dead={stage.dead!r}")
    for attr, label in (("_get_clocks", "get clocks"),
                        ("_add_clocks", "add clocks")):
        clock = getattr(srv, attr, None)
        if clock is not None:
            lines.append(f"bsp {label}: {clock.DebugString()}")
    return lines


def _engine_state() -> str:
    from multiverso_tpu_torch.zoo import Zoo
    zoo = Zoo.Get()
    if not zoo.started:
        return "zoo not started"
    srv = zoo.server_engine
    if srv is None:
        return "no server engine (-ma mode)"
    lines = _shard_state(srv)
    subs = getattr(srv, "_subs", {})
    for slot in sorted(subs):
        lines.extend(_shard_state(subs[slot]))
    return "\n".join(lines)


def _inflight() -> str:
    from multiverso_tpu_torch.zoo import Zoo
    lines = []
    for i, table in enumerate(Zoo.Get().worker_tables):
        with table._lock:
            ids = sorted(table._waiters)
        if ids:
            lines.append(f"table {i} ({type(table).__name__}): waiting on "
                         f"msg_ids {ids[:32]}"
                         + (" ..." if len(ids) > 32 else ""))
    return "\n".join(lines) or "no tracked requests in flight"


def _telemetry() -> str:
    import json

    from multiverso_tpu_torch.telemetry import metrics
    from multiverso_tpu_torch.telemetry.export import _compact
    snap = metrics.snapshot()
    if not snap:
        return "telemetry off / empty"
    return json.dumps(_compact(snap), sort_keys=True)


def _flight() -> str:
    from multiverso_tpu_torch.telemetry import flight
    if not flight.enabled():
        return "flight recorder off (-mv_flight_events=0)"
    recorded, dropped = flight.stats()
    return (f"recorded {recorded}, dropped {dropped}; tail:\n"
            + flight.tail_text(40))


#: the bundle's sections, in order
SECTIONS = (("threads", _thread_stacks), ("engine", _engine_state),
            ("in-flight requests", _inflight),
            ("telemetry", _telemetry), ("flight", _flight))


def bundle(what: str) -> str:
    """Render the diagnostic bundle for a failure named ``what``."""
    lines = [f"== failsafe diagnostic bundle: {what} =="]
    for title, fn in SECTIONS:
        lines.append(f"-- {title} --")
        try:
            lines.append(_clip(fn()))
        except Exception as exc:   # never turn one failure into two
            lines.append(f"<{title} unavailable: {exc!r}>")
    return "\n".join(lines)
