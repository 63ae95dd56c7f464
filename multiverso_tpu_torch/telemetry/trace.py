"""Span-based structured tracing across the actor runtime.

Dapper-style: a *span* is a named, timed region on one thread; spans
nest through a thread-local stack, and a span's context ``(trace_id,
span_id)`` rides on ``Message.trace_ctx`` so the tree continues on the
thread that dequeues the message — one tree follows a verb from the
worker's ``GetAsync/AddAsync`` through the engine mailbox into the
server's window lifecycle (sync/server.py).

Export is Chrome trace-event JSON (`MV_DumpTrace`), loadable in
Perfetto / chrome://tracing:

* complete events (``ph: "X"``) — one per finished span, with
  ``trace_id/span_id/parent_id`` in ``args`` (the tree is explicit even
  across threads);
* flow events (``ph: "s"`` at message enqueue, ``ph: "f"`` at dequeue)
  — Perfetto draws the worker->server mailbox hop as an arrow.

Device correlation: while ``MV_StartProfiler`` runs a
``torch.profiler`` trace (api.py flips :func:`set_xplane`), every span
also enters a ``torch.profiler.record_function`` of the same name, on
the span's own thread, so host spans appear on the profiler's timeline
next to the CUDA kernels they launched.

Gated by ``-trace`` (default off). The ring buffer is bounded
(:data:`MAX_EVENTS`): a forgotten long-running trace degrades to
keeping the most recent events instead of eating the heap; a dump's
``dropped`` counts what it let go.

A span's ``ts`` is ``perf_counter`` microseconds and its ``tid`` the
Python thread ident. A ``torch.profiler`` trace has its own clock and
thread keys:
:func:`profiler_ns` and :func:`profiler_thread` map a span onto them.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import NamedTuple, Optional

from multiverso_tpu_torch.utils.configure import MV_DEFINE_bool, cached_bool_flag
from multiverso_tpu_torch.utils.log import Log

MV_DEFINE_bool("trace", False,
               "span tracing on/off (export with MV_DumpTrace)")

#: the -trace gate, CACHED behind a flag listener (hot-path span entry
#: must not pay a registry-lock GetFlag per message)
enabled = cached_bool_flag("trace", False)

#: completed-event ring bound — oldest events drop first
MAX_EVENTS = 200_000

_events = collections.deque(maxlen=MAX_EVENTS)
_events_lock = threading.Lock()
#: events the full ring let go since the last clear()
_dropped = 0
_tls = threading.local()
_id_counter = itertools.count(1)
_id_lock = threading.Lock()
#: set by api.MV_StartProfiler/MV_StopProfiler: bridge spans into
#: torch.profiler.record_function while a profiler trace runs
_xplane_active = False


class SpanContext(NamedTuple):
    trace_id: int
    span_id: int




def set_xplane(active: bool) -> None:
    global _xplane_active
    _xplane_active = bool(active)


def _next_id() -> int:
    # pid-prefixed so ids from different ranks' dumps never collide
    with _id_lock:
        return (os.getpid() << 24) | (next(_id_counter) & 0xFFFFFF)


def _now_us() -> float:
    return time.perf_counter() * 1e6


def current_ctx() -> Optional[SpanContext]:
    """The calling thread's innermost open span, or None (used to stamp
    ``Message.trace_ctx`` at enqueue)."""
    return getattr(_tls, "ctx", None)


def _record(event: dict) -> None:
    global _dropped
    with _events_lock:
        if len(_events) == MAX_EVENTS:
            _dropped += 1
        _events.append(event)


class _NullSpan:
    """Shared no-op context manager: the tracing-off fast path must not
    allocate per call (span() sits on per-message hot paths)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_parent", "_prev", "_ctx",
                 "_ann", "_t0")

    def __init__(self, name, parent, cat, args):
        self.name = name
        self.cat = cat
        self.args = args
        self._parent = parent

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        parent_ctx = self._parent if self._parent is not None else self._prev
        self._parent = parent_ctx
        sid = _next_id()
        self._ctx = SpanContext(
            parent_ctx.trace_id if parent_ctx else sid, sid)
        _tls.ctx = self._ctx
        self._ann = None
        if _xplane_active:
            # entered and exited on this thread (a span never migrates)
            try:
                import torch
                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        self._t0 = _now_us()
        return self._ctx

    def __exit__(self, *exc):
        dur = _now_us() - self._t0
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        _tls.ctx = self._prev
        ev_args = {"trace_id": self._ctx.trace_id,
                   "span_id": self._ctx.span_id,
                   "parent_id": self._parent.span_id if self._parent else 0}
        if self.args:
            ev_args.update(self.args)
        _record({"name": self.name, "cat": self.cat, "ph": "X",
                 "ts": self._t0, "dur": dur, "pid": os.getpid(),
                 "tid": threading.get_ident(), "args": ev_args})
        return False


def span(name: str, parent: Optional[SpanContext] = None, cat: str = "mv",
         args: Optional[dict] = None):
    """Context manager opening a span for the ``with`` block. ``parent``
    overrides the thread-local nesting (pass a message's ``trace_ctx``
    when picking work up from a mailbox). ``with`` yields the span's
    context (None when tracing is off)."""
    if not enabled():
        return _NULL_SPAN
    return _Span(name, parent, cat, args)


def flow_start(ctx: Optional[SpanContext], name: str = "mv.msg") -> None:
    """Flow-arrow origin (message enqueue). No-op when ``ctx`` is None
    or tracing is off."""
    if ctx is None or not enabled():
        return
    _record({"name": name, "cat": "msg", "ph": "s", "id": ctx.span_id,
             "ts": _now_us(), "pid": os.getpid(),
             "tid": threading.get_ident()})


def flow_end(ctx: Optional[SpanContext], name: str = "mv.msg") -> None:
    """Flow-arrow target (message dequeue on the actor thread)."""
    if ctx is None or not enabled():
        return
    _record({"name": name, "cat": "msg", "ph": "f", "bp": "e",
             "id": ctx.span_id, "ts": _now_us(), "pid": os.getpid(),
             "tid": threading.get_ident()})


def chrome_trace(events: list, process_names: Optional[dict] = None,
                 thread_names: Optional[dict] = None) -> dict:
    """Wrap prepared trace events as a Chrome trace-event object
    (Perfetto / chrome://tracing loadable) — THE one writer both the
    live span dump below and offline reconstructions
    (telemetry/critpath.py's merged cross-rank timeline) ride, so the
    export schema cannot fork. ``process_names``: {pid: label};
    ``thread_names``: {(pid, tid): label}."""
    meta = []
    for pid, name in sorted((process_names or {}).items()):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": name}})
    for (pid, tid), name in sorted((thread_names or {}).items()):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": name}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def to_chrome_trace() -> dict:
    """The buffered events as a Chrome trace-event object (JSON-ready)."""
    with _events_lock:
        events = list(_events)
    out = chrome_trace(events,
                       process_names={os.getpid(): _process_label()})
    # round 22: a (wall, mono) anchor pair sampled at export time. Span
    # timestamps are perf_counter-based (each process its own zero);
    # an offline trace merge (the JAX package's fleet --trace) uses this
    # pair to map every dump onto one wall timeline before refining the
    # residual offset from matched client/server span pairs.
    out["clock"] = {"wall_s": time.time(), "mono_us": _now_us(),
                    "pid": os.getpid()}
    out["dropped"] = _dropped
    return out


def profiler_ns(ts_us: float, clock: dict) -> int:
    """A span timestamp (``ts``, perf_counter microseconds) on the clock
    of ``torch.profiler``'s records: Unix-epoch nanoseconds. On the
    card's torch (2.11, CUDA 12.8, CUPTI) a CUDA runtime record's
    ``start_ns()`` lies between two ``time.time_ns()`` stamps taken
    around its call, and outside every ``perf_counter`` and monotonic
    pair; the CPU build's ``record_function`` ranges read the same way.
    ``clock`` is a dump's ``{"wall_s", "mono_us"}`` anchor pair
    (:func:`to_chrome_trace`), sampled back to back: the map is exact to
    their sampling gap and to the drift of the two clocks since."""
    return int(round((ts_us - clock["mono_us"]) * 1e3
                     + clock["wall_s"] * 1e9))


def profiler_thread(tid: int) -> int:
    """A span's ``tid`` (the Python thread ident, ``pthread_self``) as
    ``torch.profiler`` keys a CUDA runtime record's thread: its
    ``device_resource_id()`` is the ident cut to a signed 32-bit int
    (its ``start_thread_id()`` reads 1 on every thread)."""
    low = tid & 0xFFFFFFFF
    return low - (1 << 32) if low >= 1 << 31 else low


#: process label for dumps/merges — stamped by set_process_label()
#: from contexts that KNOW their identity (MV_Init on trainer ranks,
#: Replica.start on readers). A lazy multihost.process_index() here
#: would put device work on every dump caller's thread (the replica
#: serve loop exports dumps — device-work-domain law).
_PROC_LABEL = "multiverso"


def set_process_label(label: str) -> None:
    global _PROC_LABEL
    _PROC_LABEL = str(label)


def _process_label() -> str:
    return _PROC_LABEL


def dump(path: str) -> str:
    """Write the buffered span tree as Chrome trace JSON to ``path``
    (per-rank file in multihost jobs — each rank holds its own spans)
    and return the path."""
    data = to_chrome_trace()
    with open(path, "w") as f:
        json.dump(data, f)
    Log.Info("telemetry: wrote %d trace events to %s",
             len(data["traceEvents"]), path)
    return path


def clear() -> None:
    global _dropped
    with _events_lock:
        _events.clear()
        _dropped = 0


def _reset_for_tests() -> None:
    clear()
    set_xplane(False)
