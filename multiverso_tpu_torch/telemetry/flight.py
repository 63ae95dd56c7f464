"""Always-on flight recorder: a bounded ring of structured events (the
port's counterpart of the JAX package's ``telemetry/flight.py``: the same
tuple, header and JSONL format, so either package's offline tools read
the other's dumps).

The reference ships a Logger and a Dashboard; debugging a desynced SPMD
verb stream from those means reading log text after the fact. The
flight recorder is the blackbox complement: every rank keeps the last
``-mv_flight_events`` structured events — window admitted / exchanged /
applied (with the exchange SEQ), fence entered (with its cause),
barriers, CRC retries, dedup hits, snapshot publish/evict, serving
dispatch/shed, actor poison — ALWAYS ON, cheap enough to leave enabled
in production (one lock + tuple append per event; the 2% tier-1
overhead guard in tests/test_opsplane.py holds it to that).

Recording is allocation-cheap by construction: an event is one small
tuple ``(t_wall, t_mono, kind, seq, epoch, detail, mepoch)`` appended
to a ``deque(maxlen=N)`` — no dicts, no formatting, no I/O on the hot
path. Formatting happens only at dump/inspection time.

Every event is DUAL-STAMPED (round 11): ``time.time()`` (wall) for
cross-rank alignment and ``time.perf_counter()`` (monotonic) for
interval math — wall-clock alone corrupted phase durations whenever an
NTP step landed mid-window. The dump header carries BOTH clocks
sampled back to back (``dumped_at`` / ``dumped_at_mono``), so offline
tools can convert any event's monotonic stamp into that rank's wall
timeline: ``wall(tm) = dumped_at - (dumped_at_mono - tm)``.

``-mv_flight_events=0`` disables recording through the same
listener-cached no-op gate pattern as the ``-telemetry``/``-trace``
flags (the off path is one cached int read and a return).

Dumps are JSONL (one event object per line, after a header line naming
rank/pid/recorded/dropped) via :func:`dump` / ``MV_DumpFlightRecorder``;
``telemetry/forensics.py`` aligns dumps from several ranks by exchange
SEQ to pinpoint the first diverging stream position. Failure paths
(the engine's divergence/SEQ CHECKs, DeadlineExceeded escapes) call
:func:`dump_failure`, which writes ``flight_rank<R>.jsonl`` under
``-mv_diag_dir`` when that flag is set — so a crashed 2-proc world
leaves per-rank rings on disk ready for ``python -m
multiverso_tpu_torch.telemetry.forensics``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import List, Optional, Tuple

from multiverso_tpu_torch.utils.configure import (MV_DEFINE_int,
                                                  MV_DEFINE_string,
                                                  cached_int_flag)
from multiverso_tpu_torch.utils.log import Log

MV_DEFINE_int("mv_flight_events", 4096,
              "flight recorder ring capacity (events kept per rank, "
              "always on; 0 disables recording entirely — the gate is "
              "one cached int read per event)")
MV_DEFINE_string("mv_diag_dir", "",
                 "postmortem artifact directory: failure paths dump "
                 "per-rank flight rings here (flight_rank<R>.jsonl), "
                 "and MV_DumpDiagnostics/Zoo.Stop add the telemetry "
                 "snapshot sidecar + span trace dump — ONE flag "
                 "captures a complete postmortem (empty = off)")

#: the -mv_flight_events gate, CACHED behind a flag listener (the
#: record() call sits on per-window engine paths)
_cap = cached_int_flag("mv_flight_events", 4096)

#: default ring capacity when the flag registry is torn down mid-dump
_DEFAULT_CAP = 4096


class FlightRecorder:
    """One process-wide bounded event ring. Thread-safe: every mutation
    is one short critical section (workers, the engine actor, the
    exchange stage and serving threads all record concurrently)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: "collections.deque[Tuple]" = collections.deque(
            maxlen=_DEFAULT_CAP)
        self._recorded = 0

    def record(self, cap: int, kind: str, seq: int, epoch: int,
               detail: str, mepoch: int = 0, stream: int = 0) -> None:
        # dual stamp OUTSIDE the lock (back-to-back, so the pair is
        # coherent): wall for cross-rank alignment, monotonic for
        # NTP-step-proof interval math (telemetry/critpath.py)
        t_wall = time.time()
        t_mono = time.perf_counter()
        with self._lock:
            ring = self._ring
            if ring.maxlen != cap:
                # capacity flag changed: keep the newest events that fit
                ring = collections.deque(ring, maxlen=cap)
                self._ring = ring
            ring.append((t_wall, t_mono, kind, seq, epoch, detail,
                         mepoch, stream))
            self._recorded += 1

    def stats(self) -> Tuple[int, int]:
        """(recorded_total, dropped_total) — dropped = aged out of the
        ring bound (the blackbox keeps the newest events)."""
        with self._lock:
            return self._recorded, self._recorded - len(self._ring)

    def approx_bytes(self, per_event_overhead: int) -> Tuple[int, int]:
        """(event_count, byte_estimate) for the accounting ledger:
        ``events * overhead + total detail chars``, summed from the RAW
        ring tuples — the ledger probes this every watchdog tick, so it
        must not materialize len(ring) dicts per tick the way
        :meth:`events` does. One snapshot-copy under the lock (same as
        every other reader), then plain arithmetic."""
        with self._lock:
            raw = list(self._ring)
        return (len(raw),
                sum(per_event_overhead + len(ev[5]) for ev in raw))

    def last_detail(self, kind: str) -> Optional[str]:
        """The detail of the newest event of ``kind``, or None."""
        with self._lock:
            events = list(self._ring)
        for ev in reversed(events):
            if ev[2] == kind:
                return ev[5]
        return None

    def events(self, n: Optional[int] = None) -> List[dict]:
        """The newest ``n`` events (all when None) as dicts, oldest
        first — the /flight endpoint + bundle tail shape. ``t`` is the
        wall clock, ``tm`` the monotonic stamp taken with it (interval
        math rides ``tm``; cross-rank alignment rides ``t``).
        ``mepoch`` is the membership epoch the event was recorded under
        (0 = boot world; the elastic plane re-bases the exchange SEQ
        per membership epoch). ``stream`` (round 12) is the engine
        shard's window stream the event belongs to (0 = the unsharded
        engine / shard 0): each shard owns an independent exchange
        stream with its own SEQ counter, so the offline tools align by
        (mepoch, stream, seq) — telemetry/align.py is the one rule
        set."""
        with self._lock:
            raw = list(self._ring)
        if n is not None and n > 0:
            raw = raw[-n:]
        return [{"t": ev[0], "tm": ev[1], "kind": ev[2], "seq": ev[3],
                 "epoch": ev[4], "detail": ev[5],
                 "mepoch": ev[6] if len(ev) > 6 else 0,
                 "stream": ev[7] if len(ev) > 7 else 0}
                for ev in raw]

    def tail_text(self, n: int = 40) -> str:
        """Compact textual tail for the failsafe diagnostic bundle."""
        lines = []
        for e in self.events(n):
            me = f" mepoch={e['mepoch']}" if e.get("mepoch") else ""
            st = f" stream={e['stream']}" if e.get("stream") else ""
            lines.append(f"{e['t']:.6f} {e['kind']} seq={e['seq']} "
                         f"epoch={e['epoch']}{me}{st} {e['detail']}")
        return "\n".join(lines) or "<flight ring empty>"

    def _reset_for_tests(self) -> None:
        with self._lock:
            self._ring.clear()
            self._recorded = 0


RECORDER = FlightRecorder()


def record(kind: str, seq: int = -1, epoch: int = -1,
           detail: str = "", mepoch: int = 0, stream: int = 0) -> None:
    """Record one event. The disabled path (``-mv_flight_events=0``)
    is one cached int read and a return — the no-op gate pattern.
    ``mepoch`` stamps the membership epoch (elastic plane; 0 = boot
    world) and ``stream`` the engine shard's window stream (round 12):
    stream events align by (mepoch, stream, seq)."""
    cap = _cap()
    if cap <= 0:
        return
    RECORDER.record(cap, kind, seq, epoch, detail, mepoch, stream)


def enabled() -> bool:
    return _cap() > 0


def stats() -> Tuple[int, int]:
    return RECORDER.stats()


def last_detail(kind: str) -> Optional[str]:
    return RECORDER.last_detail(kind)


def events(n: Optional[int] = None) -> List[dict]:
    return RECORDER.events(n)


def tail_text(n: int = 40) -> str:
    return RECORDER.tail_text(n)


def _rank() -> int:
    try:
        from multiverso_tpu_torch.parallel import multihost
        return multihost.process_index()
    except Exception:       # pragma: no cover - early interpreter state
        return 0


def _host() -> str:
    try:
        from multiverso_tpu_torch.parallel import multihost
        return multihost.host_label()
    except Exception:       # pragma: no cover - early interpreter state
        return ""


def dump(path: str) -> str:
    """Write the ring as JSONL: a header object (rank, host, pid,
    recorded, dropped), then one event object per line, oldest first. Returns
    ``path``. Local-only — never collective (each rank dumps its own
    ring; forensics.correlate aligns them offline)."""
    recorded, dropped = RECORDER.stats()
    # BOTH clocks, sampled back to back: offline tools re-anchor any
    # event's monotonic stamp onto this rank's wall timeline with
    # wall(tm) = dumped_at - (dumped_at_mono - tm)
    header = {"flight_header": 1, "rank": _rank(), "pid": os.getpid(),
              "host": _host(),
              "recorded": recorded, "dropped": dropped,
              "dumped_at": time.time(),
              "dumped_at_mono": time.perf_counter()}
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for e in RECORDER.events():
            f.write(json.dumps(e) + "\n")
    return path


def diag_dir() -> str:
    """The -mv_diag_dir flag value ('' = off), registry-safe."""
    from multiverso_tpu_torch.utils.configure import GetFlag
    try:
        return str(GetFlag("mv_diag_dir"))
    except Exception:       # registry torn down
        return ""


def dump_failure(what: str) -> Optional[str]:
    """Failure-path dump: write this rank's ring to
    ``<mv_diag_dir>/flight_rank<R>.jsonl`` (best-effort, never turns
    one failure into two). No-op (None) when ``-mv_diag_dir`` is unset
    or recording is off. Later failures overwrite earlier ones — the
    ring still holds the earlier events, so the newest dump is the most
    complete."""
    d = diag_dir()
    if not d or not enabled():
        return None
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"flight_rank{_rank()}.jsonl")
        dump(path)
        Log.Error("flight recorder dumped to %s (%s)", path, what)
        return path
    except Exception as exc:    # never turn one failure into two
        Log.Error("flight recorder dump failed: %r", exc)
        return None


def _reset_for_tests() -> None:
    RECORDER._reset_for_tests()
