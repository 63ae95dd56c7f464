"""Profiling dashboard: named monitors accumulating count + elapsed time
(the port's counterpart of ``multiverso_tpu/utils/dashboard.py``).

Behavioral equivalent of reference include/multiverso/dashboard.h:16-73 and
src/dashboard.cpp: a global registry of ``Monitor`` objects, each tracking
(name, count, total elapsed). The reference instruments code regions with
``MONITOR_BEGIN/END`` macros (dashboard.h:61-72); here the idiomatic Python
equivalents are ``Monitor.Begin()/End()`` and the ``monitor_region``
context manager / decorator.

CUDA note: kernel launches are asynchronous; a region that merely
*launches* kernels measures launch cost. Monitors measure the host
wall-clock of the region like the reference did; device-side timing
belongs to ``MV_StartProfiler``'s ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

from multiverso_tpu_torch.utils.log import Log


def format_monitor_line(name: str, count: int, elapse_ms: float,
                        suffix: str = "") -> str:
    """The one place the dashboard line format lives (local Display and
    cross-host DisplayAll share it)."""
    avg = elapse_ms / count if count else 0.0
    return (f"[Monitor] {name}: count = {count}, "
            f"elapse = {elapse_ms:.3f} ms, average = {avg:.3f} ms{suffix}")


class Monitor:
    def __init__(self, name: str, register: bool = True):
        self.name = name
        self._count = 0
        self._elapsed = 0.0  # seconds
        # per-thread Begin stack: a single shared begin slot is
        # corrupted by concurrent regions from two threads (B1 B2 E1 E2
        # loses one region and mis-times the other); thread-locality
        # also makes nested Begin/End on one thread pair up correctly
        self._begin_tls = threading.local()
        self._lock = threading.Lock()
        if register:
            Dashboard.AddMonitor(self)

    def Begin(self) -> None:
        stack = getattr(self._begin_tls, "stack", None)
        if stack is None:
            stack = self._begin_tls.stack = []
        stack.append(time.perf_counter())

    def End(self) -> None:
        stack = getattr(self._begin_tls, "stack", None)
        if not stack:
            return
        dt = time.perf_counter() - stack.pop()
        with self._lock:
            self._count += 1
            self._elapsed += dt

    def Add(self, elapsed_s: float, count: int = 1) -> None:
        with self._lock:
            self._count += count
            self._elapsed += elapsed_s

    @property
    def count(self) -> int:
        return self._count

    @property
    def elapse_ms(self) -> float:
        return self._elapsed * 1e3

    @property
    def average_ms(self) -> float:
        return self.elapse_ms / self._count if self._count else 0.0

    def info_string(self) -> str:
        return format_monitor_line(self.name, self._count, self.elapse_ms)


class Dashboard:
    """Global monitor registry (reference dashboard.h:16-25)."""

    _records: Dict[str, Monitor] = {}
    _lock = threading.Lock()

    @classmethod
    def AddMonitor(cls, monitor: Monitor) -> None:
        with cls._lock:
            cls._records[monitor.name] = monitor

    @classmethod
    def Get(cls, name: str) -> Monitor:
        """Lazily create+register (MONITOR macros' lazy static, dashboard.h:61-66)."""
        with cls._lock:
            mon = cls._records.get(name)
            if mon is None:
                mon = Monitor(name, register=False)
                cls._records[name] = mon
            return mon

    @classmethod
    def Watch(cls, name: str) -> str:
        with cls._lock:
            mon = cls._records.get(name)
        return mon.info_string() if mon else f"[Monitor] {name}: <absent>"

    @classmethod
    def Display(cls) -> str:
        with cls._lock:
            lines = [m.info_string() for m in cls._records.values()]
        out = "\n".join(lines)
        # stats ride the leveled logger (level/sink respected), not a
        # bare print; the return-string contract stays for tests
        for line in lines:
            Log.Info("%s", line)
        return out

    @classmethod
    def AggregateAcrossHosts(cls) -> Dict[str, Dict[str, float]]:
        """Job-wide monitor totals: per name, (count, elapsed_ms) summed
        over every host (SURVEY.md §5: "the same named-region dashboard
        aggregated across hosts"). Collective in multihost jobs — every
        process must call it, but their monitor name sets may differ
        (role-specific regions, hosts with no monitors): names are
        exchanged first and the sum runs over the union, so the
        collectives always agree on shape. Single-process jobs get the
        local totals unchanged.
        """
        import numpy as np

        from multiverso_tpu_torch.parallel import multihost

        with cls._lock:
            local_map = {n: (float(m.count), m.elapse_ms)
                         for n, m in cls._records.items()}
        names = sorted(local_map)
        if multihost.process_count() > 1:
            blobs = multihost.host_allgather_bytes(
                "\x00".join(names).encode())
            union = set()
            for blob in blobs:
                if blob:
                    union.update(blob.decode().split("\x00"))
            names = sorted(union)
            if not names:
                return {}
            local = np.array([local_map.get(n, (0.0, 0.0)) for n in names],
                             np.float64)
            local = multihost.host_allreduce_sum(local)
        else:
            local = np.array([local_map[n] for n in names],
                             np.float64).reshape(len(names), 2)
        return {n: {"count": int(local[i, 0]), "elapse_ms": float(local[i, 1])}
                for i, n in enumerate(names)}

    @classmethod
    def DisplayAll(cls) -> str:
        """Print the cross-host aggregate (Display's job-wide sibling),
        plus this process's serving-plane stats (lookup count/shed,
        latency p99, snapshot age, live versions) when the serving
        front-end has run, and the local ops-plane line (flight
        recorder counts, ops port, last fence cause) — serving and ops
        are per-process state, so their lines are local, not part of
        the collective monitor reduce."""
        lines = [format_monitor_line(name, rec["count"], rec["elapse_ms"],
                                     " (all hosts)")
                 for name, rec in cls.AggregateAcrossHosts().items()]
        try:
            from multiverso_tpu_torch import serving
            lines += serving.status_lines()
        except Exception:       # pragma: no cover - serving torn down
            pass
        # the replica and fleet lines wait with their planes
        # (ROADMAP.md item 5)
        lines += cls._ops_lines()
        out = "\n".join(lines)
        for line in lines:
            Log.Info("%s", line)
        return out

    @staticmethod
    def _ops_lines() -> list:
        """The local [Ops] observability line (round 9): flight events
        recorded/dropped, the live ops endpoint port, and the last
        classified pipeline fence cause. Best-effort — the dashboard
        must render even while telemetry tears down."""
        try:
            from multiverso_tpu_torch.telemetry import flight, ops
            from multiverso_tpu_torch.zoo import Zoo
            recorded, dropped = flight.stats()
            port = ops.port()
            eng = Zoo.Get().server_engine
            last_fence = (getattr(eng, "last_fence_cause", "")
                          if eng is not None else "")
            last_binding = (getattr(eng, "last_binding_phase", "")
                            if eng is not None else "")
            lines = [
                f"[Ops] flight_events = {recorded} recorded / "
                f"{dropped} dropped, ops_port = "
                f"{port if port is not None else 'off'}, "
                f"last_fence = {last_fence or '-'}, "
                f"last_binding_phase = {last_binding or '-'}"]
            # round 12 — sharded engine: one [Engine] line naming the
            # active transport and each shard stream's live depth/
            # pending (a wedged shard shows up as a deep stream here
            # long before /healthz flips)
            if eng is not None:
                from multiverso_tpu_torch.parallel import multihost
                shards = eng.shard_states()
                parts = []
                for s in shards:
                    st = s.get("stage") or {}
                    state = ("DEAD" if s.get("poisoned") is not None
                             or st.get("dead") is not None else
                             f"depth={st.get('depth', 0)}/"
                             f"pending={st.get('pending_verbs', 0)}/"
                             f"mbox={s.get('mailbox_depth', 0)}")
                    parts.append(f"s{s['shard']}:{state}")
                lines.append(
                    f"[Engine] shards = {len(shards)}, transport = "
                    f"{multihost.wire_name()}, " + ", ".join(parts))
            # round 11 — the -mv_row_sketch access-skew measurement:
            # one [RowSkew] line per armed table (top rows + share)
            if eng is not None:
                for tid, table in enumerate(getattr(eng, "store_", [])):
                    sk = getattr(table, "_row_sketch", None)
                    if sk is None:
                        continue
                    # top_share over the same TOP_N the /metrics gauge
                    # and /perf use — one name, one number everywhere;
                    # only the hottest-rows PREVIEW is truncated
                    s = sk.summary()
                    top = ", ".join(f"{r['key']}x{r['count']}"
                                    for r in s["top"][:4])
                    lines.append(
                        f"[RowSkew] table {tid}: top_share = "
                        f"{100 * s['top_share']:.1f}% of "
                        f"{s['total']} gets, hottest = [{top}]")
            # round 13 — watchdog plane: the byte ledger's placement
            # line (where table/snapshot/buffer state actually lives)
            # plus the live alert verdicts when the watchdog is armed
            try:
                from multiverso_tpu_torch.telemetry import accounting
                rep = accounting.memory_report()
                t = rep["components"]["tables"]["totals"]
                lines.append(
                    f"[Mem] total = {rep['total_bytes'] / 1e6:.1f} MB "
                    f"(tables device {t['device_bytes'] / 1e6:.1f} / "
                    f"mirror {t['host_mirror_bytes'] / 1e6:.1f} / "
                    f"host {t['host_bytes'] / 1e6:.1f}, snapshots "
                    f"{rep['components']['snapshots']['bytes'] / 1e6:.1f})")
            except Exception:   # ledger probing a torn-down world
                pass
            try:
                from multiverso_tpu_torch.telemetry import watchdog
                wd = watchdog.peek()
                if wd is not None:
                    alerts = wd.active_alerts()
                    names = (", ".join(a["rule"] for a in alerts)
                             or "none")
                    lines.append(f"[Watchdog] ticks = {wd.ticks}, "
                                 f"active_alerts = {names}")
            except Exception:
                pass
            # the [Elastic] and [CoordHA] lines wait with the elastic
            # plane (ROADMAP.md item 5)
            return lines
        except Exception:       # pragma: no cover - teardown races
            return []

    @classmethod
    def _reset_for_tests(cls) -> None:
        with cls._lock:
            cls._records.clear()


@contextlib.contextmanager
def monitor_region(name: str):
    """``with monitor_region("worker.process_get"): ...`` — MONITOR_BEGIN/END."""
    mon = Dashboard.Get(name)
    start = time.perf_counter()
    try:
        yield mon
    finally:
        mon.Add(time.perf_counter() - start)
