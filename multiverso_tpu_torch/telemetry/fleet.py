"""Fleet observability plane: heartbeat-shipped rollups, the
coordinator-side accumulator behind ``/fleet``, and the trace-merge CLI.

The port's own copy of ``multiverso_tpu/telemetry/fleet.py``. Every other
telemetry surface answers "what is THIS process doing"; the fleet plane
answers "what is the JOB doing" without a collective:

* :func:`build_rollup` snapshots the process's mergeable digest vectors
  (``telemetry/metrics.py`` ``Digest``) and key gauges into one compact
  dict, and :func:`encode_rollup` frames it with the sealed flat codec
  (``parallel/flat.py`` ``encode_frame``), a few KB per heartbeat, never
  collective;
* the blob rides the elastic member heartbeat (``elastic/coordinator.py``
  ``MemberClient.start_heartbeats``), so the plane adds no connection and
  no collective;
* :class:`FleetAccumulator` (one module-global instance on the process
  that hosts the coordinator) stamps each rollup's arrival, derives
  per-member QPS from request-count deltas, merges digests exactly and
  serves the ``/fleet`` document: per-member rows, the fleet-merged
  p50/p95/p99/QPS and the slowest member by p99. A member whose rollup
  stopped refreshing is marked stale (``-mv_fleet_stale_s``).

The watchdog reads :func:`peek_sample` (this module never imports the
watchdog), and the three fleet rules (``fleet_p99_breach``,
``member_qps_outlier``, ``rollup_stale``) live in
``telemetry/watchdog.py``.

``python -m multiverso_tpu_torch.telemetry.fleet --trace -o out.json
dump1.json dump2.json ...`` stitches per-process ``MV_DumpTrace`` files
into one Chrome trace, anchored on the (wall, mono) clock pair each dump
stamps and refined by the median offset of matched client/server spans.

The rollup bytes are the JAX package's: a rollup of either package
decodes in the other.
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Dict, List, Optional

from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.configure import MV_DEFINE_double, cached_float_flag
from multiverso_tpu_torch.utils.log import Log

MV_DEFINE_double(
    "mv_fleet_stale_s", 10.0,
    "age (s) past which a member's fleet rollup counts as STALE: the "
    "member row degrades to warn, the rollup_stale watchdog rule arms, "
    "and /healthz stops trusting its frozen replica-lag numbers")
MV_DEFINE_double(
    "mv_fleet_p99_s", 0.0,
    "fleet-merged request p99 (s) above which the fleet_p99_breach "
    "watchdog rule fires; 0 disables the rule (HOLD)")

stale_s = cached_float_flag("mv_fleet_stale_s", 10.0)

#: request-shaped digest families whose counts define a member's "ops"
#: total (QPS = arrival-stamped delta of this): one per serve surface.
#: Digests live under their own ``digest.`` prefix — several shadow a
#: same-named histogram and the registry CHECKs name/kind collisions.
#: The window-phase digest is deliberately NOT here — a window is not
#: a request.
QPS_FAMILIES = ("digest.serving.latency_s", "digest.replica.serve_s",
                "digest.worker.rtt_s")

#: rollup blob schema version (the seal guards bytes; this guards shape)
ROLLUP_V = 1

#: gauge-name prefixes that ride the rollup (replica lag/subscribers +
#: the memory ledger's totals — the "key gauges" of the fleet view)
_GAUGE_PREFIXES = ("replica.", "mem.")


def eager_register() -> None:
    """Register every always-on ``fleet.*`` family (plus the trainer
    digest families fed from the worker/engine hot paths) so the FIRST
    /metrics scrape shows them at zero. Plane-scoped
    digests (serving.latency_s, replica.serve_s) register at their own
    plane starts."""
    tmetrics.counter("fleet.rollups")
    tmetrics.counter("fleet.rollup_errors")
    tmetrics.gauge("fleet.members")
    tmetrics.digest("digest.worker.rtt_s")
    tmetrics.digest("digest.engine.window_s")


# -- rollup build / codec ----------------------------------------------------

def build_rollup(member: str, role: str) -> dict:
    """Snapshot THIS process's digests + key gauges into one flat-
    encodable dict. Never collective — it reads the local registry
    under its lock and touches nothing else (mvlint pins this function
    as a never-collective root); safe from heartbeat daemon threads.

    ``member`` is the fleet-wide identity the coordinator keys on
    (``rank<N>`` for trainer ranks, ``replica:<rid>`` for readers) —
    callers supply it because this module must not import multihost."""
    import numpy as np

    digests = tmetrics.REGISTRY.digest_vectors()
    ops = sum(vec[0] for name, vec in digests.items()
              if name in QPS_FAMILIES)
    gauges = tmetrics.REGISTRY.gauge_values(_GAUGE_PREFIXES)
    return {"v": ROLLUP_V, "member": member, "role": role,
            "ops": float(ops),
            "digests": {n: np.asarray(v, np.float64)
                        for n, v in digests.items()},
            "gauges": gauges}


def encode_rollup(rollup: dict) -> bytes:
    """Rollup dict -> sealed flat frame (the blob that rides a
    heartbeat). Lazy import: flat pulls compress which registers
    metrics counters — importing it at module top would cycle through
    the telemetry package during its own init."""
    from multiverso_tpu_torch.parallel import flat
    return flat.encode_frame(rollup)


def decode_rollup(blob: bytes) -> dict:
    """Sealed flat frame -> rollup dict (digest vectors as plain float
    lists — the zero-copy views must not outlive the blob)."""
    from multiverso_tpu_torch.parallel import flat
    rollup = flat.decode_frame(blob)
    if not isinstance(rollup, dict) or rollup.get("v") != ROLLUP_V:
        raise ValueError(f"not a v{ROLLUP_V} fleet rollup: "
                         f"{type(rollup).__name__}")
    rollup["digests"] = {n: [float(x) for x in vec]
                         for n, vec in rollup["digests"].items()}
    return rollup


# -- coordinator-side accumulation ------------------------------------------

class _Member:
    """One member's latest rollup + the derived rates/stamps."""

    __slots__ = ("member", "role", "t_arrival", "ops", "qps",
                 "digests", "gauges", "n_rollups")

    def __init__(self, member: str, role: str):
        self.member = member
        self.role = role
        self.t_arrival = 0.0
        self.ops = 0.0
        self.qps = 0.0
        self.digests: Dict[str, List[float]] = {}
        self.gauges: Dict[str, float] = {}
        self.n_rollups = 0


def _request_vec(digests: Dict[str, List[float]]) -> List[float]:
    """Fold a member's request-shaped digests into one vector."""
    vec = tmetrics.Digest.empty_vector()
    for name in QPS_FAMILIES:
        if name in digests:
            vec = tmetrics.Digest.merge_vec(vec, digests[name])
    return vec


class FleetAccumulator:
    """Coordinator-side fold of pushed member rollups.

    Aggregation is pull-free and collective-free BY CONSTRUCTION: the
    only inputs are blobs members already attached to their lease
    heartbeats; merging is the Digest vector merge (exact, order-
    independent) plus counter-delta QPS, all under one short lock.
    Everything it serves (/fleet, the dashboard line, the watchdog
    sample) is a read of this folded state — no rank is ever asked
    anything."""

    def __init__(self):
        self._lock = threading.Lock()
        self._members: Dict[str, _Member] = {}

    def ingest_rollup(self, rollup: dict,
                      now: Optional[float] = None) -> bool:
        member = rollup.get("member")
        if not member:
            tmetrics.counter("fleet.rollup_errors").inc()
            return False
        now = time.monotonic() if now is None else now
        ops = float(rollup.get("ops", 0.0))
        with self._lock:
            rec = self._members.get(member)
            if rec is None:
                rec = _Member(member, str(rollup.get("role", "?")))
                self._members[member] = rec
            dt = now - rec.t_arrival
            if rec.n_rollups > 0 and dt > 0 and ops >= rec.ops:
                rec.qps = (ops - rec.ops) / dt
            else:
                rec.qps = 0.0       # first rollup / counter reset
            rec.t_arrival = now
            rec.ops = ops
            rec.digests = rollup.get("digests", {})
            rec.gauges = rollup.get("gauges", {})
            rec.n_rollups += 1
            n = len(self._members)
        tmetrics.counter("fleet.rollups").inc()
        tmetrics.gauge("fleet.members").set(n)
        return True

    def ingest(self, blob: bytes, now: Optional[float] = None) -> bool:
        """Decode + fold one pushed blob. A torn/foreign blob must not
        take the heartbeat path down with it — it counts an error and
        the lease refresh proceeds."""
        try:
            rollup = decode_rollup(blob)
        except Exception as exc:
            tmetrics.counter("fleet.rollup_errors").inc()
            Log.Error("fleet: dropped undecodable rollup blob (%s)",
                      exc)
            return False
        return self.ingest_rollup(rollup, now=now)

    def rollup_age_s(self, member: str,
                     now: Optional[float] = None) -> Optional[float]:
        now = time.monotonic() if now is None else now
        with self._lock:
            rec = self._members.get(member)
            return None if rec is None else max(0.0, now - rec.t_arrival)

    def forget(self, member: str) -> None:
        """Drop a departed member (coordinator eviction path) so its
        last rollup stops aging into every staleness surface."""
        with self._lock:
            self._members.pop(member, None)
            n = len(self._members)
        tmetrics.gauge("fleet.members").set(n)

    def report(self, now: Optional[float] = None) -> dict:
        """The /fleet document. ALWAYS well-formed — before any rollup
        arrives it is the empty fleet, not an error."""
        now = time.monotonic() if now is None else now
        with self._lock:
            members = sorted(self._members.values(),
                             key=lambda m: m.member)
            rows = []
            fam_vecs: Dict[str, List[float]] = {}
            fleet_vec = tmetrics.Digest.empty_vector()
            binding = None
            stale = []
            limit = stale_s()
            for m in members:
                age = max(0.0, now - m.t_arrival)
                req = _request_vec(m.digests)
                p50 = tmetrics.Digest.quantile(req, 0.50)
                p99 = tmetrics.Digest.quantile(req, 0.99)
                is_stale = age > limit
                if is_stale:
                    stale.append(m.member)
                rows.append({
                    "member": m.member, "role": m.role,
                    "age_s": round(age, 3), "stale": is_stale,
                    "qps": round(m.qps, 3), "ops": m.ops,
                    "n_rollups": m.n_rollups,
                    "count": int(req[0]),
                    "p50_s": p50, "p99_s": p99,
                    "gauges": dict(m.gauges),
                })
                fleet_vec = tmetrics.Digest.merge_vec(fleet_vec, req)
                for name, vec in m.digests.items():
                    have = fam_vecs.get(name)
                    fam_vecs[name] = (list(vec) if have is None else
                                      tmetrics.Digest.merge_vec(have,
                                                                vec))
                if req[0] > 0 and (binding is None
                                   or p99 > binding["p99_s"]):
                    binding = {"member": m.member, "p99_s": p99}
        return {
            "n_members": len(rows),
            "members": rows,
            "fleet": {
                "qps": round(sum(r["qps"] for r in rows), 3),
                "count": int(fleet_vec[0]),
                "p50_s": tmetrics.Digest.quantile(fleet_vec, 0.50),
                "p95_s": tmetrics.Digest.quantile(fleet_vec, 0.95),
                "p99_s": tmetrics.Digest.quantile(fleet_vec, 0.99),
            },
            "binding_p99": binding,
            "digests": {n: tmetrics.Digest._snapshot(v)
                        for n, v in sorted(fam_vecs.items())},
            "stale_s": limit,
            "stale_members": stale,
        }

    def peek_sample(self, now: Optional[float] = None) -> dict:
        """Watchdog inputs — {} while the fleet is empty so every
        fleet rule HOLDs on non-coordinator ranks (same posture as the
        replica sample)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not self._members:
                return {}
            members = list(self._members.values())
            fleet_vec = tmetrics.Digest.empty_vector()
            qps = {}
            ops = {}
            ages = {}
            for m in members:
                fleet_vec = tmetrics.Digest.merge_vec(
                    fleet_vec, _request_vec(m.digests))
                qps[m.member] = m.qps
                ops[m.member] = m.ops
                ages[m.member] = max(0.0, now - m.t_arrival)
        return {
            "fleet_members": len(qps),
            "fleet_qps": sum(qps.values()),
            "fleet_p99_s": tmetrics.Digest.quantile(fleet_vec, 0.99),
            "fleet_member_qps": qps,
            "fleet_member_ops": ops,
            "fleet_rollup_ages_s": ages,
            "fleet_rollup_age_max_s": max(ages.values()),
        }

    def clear(self) -> None:
        """Drop every folded member — the world-shutdown path. The
        fold aggregates members of ONE world's lease planes; letting it
        survive into the next world ages the old members into every
        staleness surface (rollup_stale would fire on a rank that is
        simply from a previous world)."""
        with self._lock:
            self._members.clear()
        tmetrics.gauge("fleet.members").set(0)

    def _reset_for_tests(self) -> None:
        self.clear()


#: THE accumulator — module-global so the coordinator op handlers (in
#: whatever thread/instance hosts them) and the /fleet route read one
#: fold, the Dashboard.Get idiom
_ACC = FleetAccumulator()


def shutdown_plane() -> None:
    """Clear the fold at world shutdown (Zoo.Stop) — the planes that
    fed it (replica heartbeats, elastic member heartbeats, the roster
    poll) are already down, and the next world starts from an empty
    fleet instead of inheriting stale members."""
    _ACC.clear()


def ingest(blob: bytes) -> bool:
    return _ACC.ingest(blob)


def ingest_rollup(rollup: dict) -> bool:
    return _ACC.ingest_rollup(rollup)


def rollup_age_s(member: str) -> Optional[float]:
    return _ACC.rollup_age_s(member)


def forget(member: str) -> None:
    _ACC.forget(member)


def fleet_report() -> dict:
    return _ACC.report()


def peek_sample() -> dict:
    return _ACC.peek_sample()


def status_lines() -> List[str]:
    """The ``[Fleet]`` dashboard line — empty while no rollup has
    arrived (non-coordinator ranks stay quiet)."""
    rep = _ACC.report()
    if not rep["n_members"]:
        return []
    fl = rep["fleet"]
    bind = rep["binding_p99"]
    line = (f"[Fleet] members={rep['n_members']} qps={fl['qps']:.0f} "
            f"p50={fl['p50_s'] * 1e3:.2f}ms p99={fl['p99_s'] * 1e3:.2f}ms")
    if bind is not None:
        line += (f" bind={bind['member']}"
                 f"@{bind['p99_s'] * 1e3:.2f}ms")
    if rep["stale_members"]:
        line += f" stale={','.join(rep['stale_members'])}"
    return [line]


def _reset_for_tests() -> None:
    _ACC._reset_for_tests()


# -- trace merge CLI ---------------------------------------------------------

def _dump_shift_us(dump: dict, ref_clock: Optional[dict]) -> float:
    """Anchor shift mapping this dump's perf_counter µs onto the ref
    dump's timeline via the (wall, mono) pair trace.dump() stamps."""
    clock = dump.get("clock")
    if not clock or not ref_clock:
        return 0.0
    return ((clock["wall_s"] * 1e6 - clock["mono_us"])
            - (ref_clock["wall_s"] * 1e6 - ref_clock["mono_us"]))


def merge_traces(dumps: List[dict]) -> dict:
    """Stitch per-process chrome-trace dumps into ONE trace.

    Two-stage alignment, critpath's recipe: (1) the coarse wall/mono
    anchor above (NTP-grade across hosts, exact same-host); (2) a
    median-offset refinement per dump from matched client/server span
    pairs — wire propagation gives a ``replica.call`` client
    span and its ``replica.serve`` dispatch span the same trace_id, and
    the server span's midpoint must sit at the client span's midpoint
    up to clock skew, so the median midpoint delta IS the residual
    skew (the same estimator critpath runs on exchange-done
    landmarks). ``align_err_us`` reports the worst post-fit residual."""
    ref_clock = next((d.get("clock") for d in dumps if d.get("clock")),
                     None)
    shifts = [_dump_shift_us(d, ref_clock) for d in dumps]

    # matched client/server span pairs by trace_id
    def _spans(d, cat):
        out = {}
        for ev in d.get("traceEvents", []):
            if ev.get("ph") == "X" and ev.get("cat") == cat:
                tid = ev.get("args", {}).get("trace_id")
                if tid is not None:
                    out[tid] = ev
        return out

    clients = [_spans(d, "client") for d in dumps]
    servers = [_spans(d, "server") for d in dumps]

    def _mid(ev, k):
        return ev["ts"] + ev.get("dur", 0.0) / 2.0 + shifts[k]

    residuals: Dict[int, List[float]] = {}
    for i, srv in enumerate(servers):
        for tid, sev in srv.items():
            for j, cli in enumerate(clients):
                if j == i or tid not in cli:
                    continue
                # positive delta = server timeline lags the client's
                delta = _mid(cli[tid], j) - _mid(sev, i)
                residuals.setdefault(i, []).append(delta)
                residuals.setdefault(j, []).append(-delta)
    corrections = [0.0] * len(dumps)
    align_err = 0.0
    for i, deltas in residuals.items():
        med = statistics.median(deltas)
        corrections[i] = med / 2.0      # split the pairwise skew
        align_err = max(align_err,
                        max(abs(d - med) for d in deltas))

    events: List[dict] = []
    process_names: Dict[int, str] = {}
    for k, d in enumerate(dumps):
        off = shifts[k] + corrections[k]
        for ev in d.get("traceEvents", []):
            if ev.get("ph") == "M":
                if (ev.get("name") == "process_name"
                        and "pid" in ev):
                    process_names[ev["pid"]] = ev["args"]["name"]
                continue
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + off
            events.append(ev)
    events.sort(key=lambda e: e.get("ts", 0.0))
    from multiverso_tpu_torch.telemetry import trace as ttrace
    out = ttrace.chrome_trace(events, process_names=process_names)
    out["merge"] = {
        "n_dumps": len(dumps),
        "shift_us": [round(s, 1) for s in shifts],
        "correction_us": [round(c, 1) for c in corrections],
        "align_err_us": round(align_err, 1),
        "n_span_pairs": sum(len(v) for v in residuals.values()) // 2,
    }
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m multiverso_tpu_torch.telemetry.fleet",
        description="fleet plane CLI: merge per-process trace dumps")
    parser.add_argument("--trace", action="store_true",
                        help="merge MV_DumpTrace chrome-trace files "
                             "into one aligned timeline")
    parser.add_argument("-o", "--out", default="fleet_trace.json",
                        help="merged trace output path")
    parser.add_argument("dumps", nargs="*",
                        help="per-process trace JSON files")
    args = parser.parse_args(argv)
    if not args.trace:
        parser.error("--trace is the only mode (so far)")
    if not args.dumps:
        parser.error("no trace dumps given")
    dumps = []
    for path in args.dumps:
        with open(path) as f:
            dumps.append(json.load(f))
    merged = merge_traces(dumps)
    with open(args.out, "w") as f:
        json.dump(merged, f)
    m = merged["merge"]
    sys.stdout.write(f"merged {m['n_dumps']} dumps, "
                     f"{len(merged['traceEvents'])} events, "
                     f"{m['n_span_pairs']} client/server span pairs, "
                     f"align_err={m['align_err_us']}us -> {args.out}\n")
    return 0


if __name__ == "__main__":      # pragma: no cover - CLI entry
    import sys
    sys.exit(main(sys.argv[1:]))
