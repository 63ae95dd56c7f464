"""Ops endpoint: a flag-gated stdlib-HTTP daemon serving /metrics,
/healthz, /flight, /perf, /alerts and /memory (the port's counterpart of
the JAX package's ``telemetry/ops.py``).

``-mv_ops_port=N`` (default -1 = off; 0 = ephemeral, for tests and
multi-world processes) starts one daemon thread at MV_Init running a
``ThreadingHTTPServer`` bound to 127.0.0.1:

* ``GET /metrics`` — the LOCAL metrics snapshot rendered as Prometheus
  text exposition (``# TYPE`` lines + samples; histograms as cumulative
  ``_bucket{le=...}`` + ``_sum`` + ``_count``). Instrument names map
  ``server.window.latency_s`` -> ``mv_server_window_latency_s``.
* ``GET /healthz`` — JSON liveness: engine/actor poison state, exchange
  stage, mailbox depth, snapshot age, shed count, flight stats.
  200 while healthy, 503 once the engine is poisoned / its exchange
  stage died / the world stopped.
* ``GET /flight`` — the recent flight-recorder events as JSON.
* ``GET /perf`` — the LOCAL performance-forensics snapshot (round 11):
  engine.phase.* histograms, per-family apply seconds, the local
  binding-phase proxy and the ``-mv_row_sketch`` row-skew summaries.
  The cross-rank binding verdict needs every rank's dump through
  ``python -m multiverso_tpu_torch.telemetry.critpath`` — the body says so.
* ``GET /alerts`` — the live watchdog plane's state (round 13,
  telemetry/watchdog.py): active typed alerts with durations + every
  rule's hysteresis counters; says "off" while ``-mv_watchdog_s`` is
  unarmed. Active alerts also degrade ``/healthz`` to a distinct
  ``warn`` status — still 200 (503 stays death-only).
* ``GET /fleet`` — the fleet view (``telemetry/fleet.py``): per-member
  rollup rows, the fleet-merged p50/p95/p99/QPS and the slowest member,
  with the coordinator client's endpoint posture; the empty fleet on a
  process that hosts no coordinator.
* ``GET /actions`` — the policy plane's action report (``policy/``):
  guard settings, install/revert/drain counts, actions under revert
  watch, and the bounded action history; says "off" while ``-mv_policy``
  is unarmed.
* ``GET /memory`` — the process byte ledger (round 13,
  telemetry/accounting.py): per-table device/mirror/host placement,
  per-version snapshot retention, flight/dedup/buffer estimates, shm
  ring footprint — refreshed at request time.

THE HANDLER NEVER ISSUES COLLECTIVES — same rule as the PR 2 periodic
reporter: a scrape thread running allgathers would interleave with the
engine's window exchanges and corrupt the SPMD stream. Everything
served here is a local-rank snapshot; job-wide totals remain the
explicitly collective ``MV_MetricsSnapshot()``'s business. Scrape every
rank and aggregate in Prometheus, which is how production PS
deployments surface per-node health anyway.

``Zoo.Stop`` shuts the server down and joins its thread bounded, so
back-to-back worlds in one process never leak the thread or find the port
busy.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from multiverso_tpu_torch.telemetry import flight, metrics
from multiverso_tpu_torch.telemetry.metrics import bucket_bounds
from multiverso_tpu_torch.utils.configure import GetFlag, MV_DEFINE_int
from multiverso_tpu_torch.utils.log import Log

MV_DEFINE_int("mv_ops_port", -1,
              "ops HTTP endpoint (/metrics Prometheus text, /healthz, "
              "/flight) on 127.0.0.1:<port>; -1 = off, 0 = pick an "
              "ephemeral port (tests / multi-world processes). The "
              "handler serves LOCAL snapshots only and never issues "
              "collectives")

_NAME_SAN = re.compile(r"[^a-zA-Z0-9_:]")


def _fmt(v) -> str:
    """Prometheus sample value: integers bare, floats via repr (both
    are valid exposition floats, incl. exponent forms like 1e-06)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prom_name(name: str) -> str:
    """Instrument name -> Prometheus metric name (mv_ prefix, dots and
    other illegal chars to underscores)."""
    return "mv_" + _NAME_SAN.sub("_", name)


def render_prometheus(snap: dict) -> str:
    """Render a LOCAL metrics snapshot ({name: typed dict}) as
    Prometheus text exposition format (version 0.0.4)."""
    lines = []
    for name in sorted(snap):
        rec = snap[name]
        pname = prom_name(name)
        kind = rec.get("type")
        if kind == "counter":
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_fmt(rec['value'])}")
        elif kind == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(rec['value'])}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            buckets = rec.get("buckets", {})
            for i in sorted(int(k) for k in buckets):
                cum += int(buckets[str(i)])
                le = bucket_bounds(i)[1]
                lines.append(f'{pname}_bucket{{le="{repr(le)}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} '
                         f'{int(rec["count"])}')
            lines.append(f"{pname}_sum {_fmt(rec['sum'])}")
            lines.append(f"{pname}_count {int(rec['count'])}")
        elif kind == "digest":
            # round 22 — mergeable digests scrape as Prometheus
            # summaries: clamped quantiles are point estimates, not
            # cumulative buckets (the full bucket vector rides the
            # fleet rollup, not the text exposition)
            lines.append(f"# TYPE {pname} summary")
            for q in ("0.5", "0.95", "0.99"):
                key = "p" + q[2:].ljust(2, "0")
                lines.append(f'{pname}{{quantile="{q}"}} '
                             f"{_fmt(rec.get(key, 0.0))}")
            lines.append(f"{pname}_sum {_fmt(rec['sum'])}")
            lines.append(f"{pname}_count {int(rec['count'])}")
    return "\n".join(lines) + "\n"


def health_report() -> dict:
    """LOCAL liveness snapshot (the /healthz body). Never collective —
    reads in-process state only."""
    out = {"healthy": True, "reasons": []}
    try:
        from multiverso_tpu_torch.zoo import Zoo
        zoo = Zoo.Get()
        out["started"] = bool(zoo.started)
        if not zoo.started:
            out["healthy"] = False
            out["reasons"].append("zoo not started")
        eng = zoo.server_engine
        if eng is not None:
            poison = getattr(eng, "_poison", None)
            out["engine"] = {
                "poisoned": repr(poison) if poison is not None else None,
                "mailbox_depth": eng.mailbox.Size(),
                "window_epoch": getattr(eng, "window_epoch", 0),
                "window_exchanges": getattr(eng, "mh_window_exchanges",
                                            0),
            }
            if poison is not None:
                out["healthy"] = False
                out["reasons"].append(f"engine poisoned: {poison!r}")
            try:
                from multiverso_tpu_torch import elastic
                el = elastic.state_report()
                if el is not None:
                    # the membership epoch and members: the liveness
                    # answer changes meaning across epochs, so the scrape
                    # names the epoch it describes
                    out["elastic"] = el
            except Exception:   # elastic plane torn down mid-scrape
                pass
            stage = getattr(eng, "_ex_stage", None)
            if stage is not None:
                out["engine"]["exchange_stage"] = {
                    "depth": stage.depth(),
                    "pending_verbs": stage.pending_verbs(),
                    "mid_exchange": bool(stage.busy_since),
                    "dead": repr(stage.dead) if stage.dead is not None
                    else None,
                }
                if stage.dead is not None:
                    out["healthy"] = False
                    out["reasons"].append(
                        f"exchange stage dead: {stage.dead!r}")
            # round 12 — sharded engine: per-shard stream state, with a
            # dead SHARD (poisoned actor or dead exchange stage on any
            # stream) reported distinctly from the shard-0 probes above
            shards_fn = getattr(eng, "shard_states", None)
            if shards_fn is not None:
                try:
                    shards = shards_fn()
                except Exception:   # engine torn down mid-scrape
                    shards = []
                if len(shards) > 1:
                    out["engine"]["shards"] = shards
                    from multiverso_tpu_torch.parallel import multihost
                    out["engine"]["transport"] = multihost.wire_name()
                    for s in shards:
                        st = s.get("stage") or {}
                        if s.get("poisoned") is not None:
                            out["healthy"] = False
                            out["reasons"].append(
                                f"engine shard {s['shard']} poisoned: "
                                f"{s['poisoned']}")
                        elif st.get("dead") is not None:
                            out["healthy"] = False
                            out["reasons"].append(
                                f"engine shard {s['shard']} exchange "
                                f"stage dead: {st['dead']}")
    except Exception as exc:    # health must never turn into a crash
        out["healthy"] = False
        out["reasons"].append(f"probe failed: {exc!r}")
    try:
        from multiverso_tpu_torch.serving import peek_plane
        plane = peek_plane()
        if plane is not None:
            latest = plane.store.latest_version()
            age = (plane.store.get(None).age_s()
                   if latest is not None else None)
            snap = metrics.snapshot()
            out["serving"] = {
                "latest_version": latest,
                "snapshot_age_s": age,
                "shed": snap.get("serving.shed", {}).get("value", 0),
                "lookups": snap.get("serving.lookups",
                                    {}).get("value", 0),
            }
    except Exception:           # serving is optional
        pass
    # the replica plane: a line a known subscriber (rid, mode, live/dead/
    # evicted, acked version, lag), from the fan-out thread's CACHED
    # roster: no RPC, no collective; departed readers stay listed, so
    # operators see who left
    try:
        from multiverso_tpu_torch import replica as treplica
        rrep = treplica.status_report()
        if rrep is not None:
            out["replica"] = rrep
    except Exception:           # the replica plane is optional
        pass
    # the policy plane: one line naming whether the runtime is
    # self-driving (armed kill switch), how often it acted, and the last
    # action. Local engine state only.
    try:
        from multiverso_tpu_torch import policy as tpolicy
        pline = tpolicy.status_line()
        if pline is not None:
            out["policy"] = pline
    except Exception:           # policy plane torn down mid-scrape
        pass
    # coordinator HA: the standby replication state (rank 0: solo /
    # replicated / degraded) and this process's client failover posture
    # (endpoint list, active endpoint, failover count). A DEGRADED
    # standby (the primary shed a dead standby and serves solo) stays
    # healthy but is a NAMED warning: redundancy is gone.
    try:
        from multiverso_tpu_torch import elastic
        ha = elastic.ha_status()
        if ha is not None:
            out["coordinator_ha"] = ha
            if ha.get("standby") == "degraded":
                out.setdefault("warnings", []).append(
                    "coordinator standby lost — primary serving solo "
                    "(op log unreplicated)")
    except Exception:           # elastic plane torn down mid-scrape
        pass
    rec, drop = flight.stats()
    out["flight"] = {"recorded": rec, "dropped": drop,
                     "enabled": flight.enabled()}
    # round 13 — watchdog plane: active typed alerts degrade the
    # status to a DISTINCT "warn" (still 200 — 503 stays death-only;
    # an alert is a saturation symptom, not a corpse)
    try:
        from multiverso_tpu_torch.telemetry import watchdog as twatchdog
        alerts = twatchdog.active_alerts()
        out["alerts"] = [a["rule"] for a in alerts]
        out["status"] = ("dead" if not out["healthy"]
                         else ("warn" if alerts or out.get("warnings")
                               else "ok"))
    except Exception:           # watchdog torn down mid-scrape
        out["status"] = ("dead" if not out["healthy"]
                         else ("warn" if out.get("warnings") else "ok"))
    return out


def perf_report() -> dict:
    """LOCAL performance-forensics snapshot (the /perf body): phase
    histograms, per-family apply seconds, the local binding-phase
    proxy, last fence cause and the row-skew sketches. Never
    collective — the cross-rank binding verdict needs every rank's
    flight dump through ``python -m multiverso_tpu_torch.telemetry.critpath``
    (which this body says, so an operator scraping one rank is not
    misled)."""
    snap = metrics.snapshot()

    def _hist(rec):
        return {"count": rec.get("count", 0),
                "sum_s": rec.get("sum", 0.0),
                "p50_s": rec.get("p50", 0.0),
                "p99_s": rec.get("p99", 0.0)}

    out = {"phases": {}, "apply_tables": {}, "binding_phase": None,
           "last_fence_cause": None, "row_skew": [],
           "note": ("local rank only — cross-rank critical path: dump "
                    "flight rings on every rank and run python -m "
                    "multiverso_tpu_torch.telemetry.critpath")}
    for name, rec in snap.items():
        if (name.startswith("engine.phase.")
                and rec.get("type") == "histogram"):
            out["phases"][name[len("engine.phase."):-2]] = _hist(rec)
        elif (name.startswith("engine.apply.table_s.")
                and rec.get("type") == "histogram"):
            out["apply_tables"][name.rsplit(".", 1)[-1]] = _hist(rec)
    try:
        from multiverso_tpu_torch.zoo import Zoo
        eng = Zoo.Get().server_engine
        if eng is not None:
            out["binding_phase"] = (getattr(eng, "last_binding_phase",
                                            "") or None)
            out["last_fence_cause"] = (getattr(eng, "last_fence_cause",
                                               "") or None)
            for tid, table in enumerate(getattr(eng, "store_", [])):
                sk = getattr(table, "_row_sketch", None)
                if sk is not None:
                    out["row_skew"].append(dict(sk.summary(),
                                                table_id=tid))
    except Exception:           # engine torn down mid-scrape
        pass
    return out


class _OpsHandler(BaseHTTPRequestHandler):
    # one scrape per connection is the expected pattern; keep-alive off
    # so a dangling scraper can't pin handler threads across Zoo.Stop
    protocol_version = "HTTP/1.0"

    def log_message(self, fmt, *args):  # route through the leveled log
        Log.Debug("ops http: " + fmt, *args)

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # the ledger probes this handler reaches read storage sizes on the
    # host: no device sync, no launch, no host mirror
    def do_GET(self):           # noqa: N802 - stdlib handler API
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                # mirror the hot paths' plain tallies into their gauges
                # before rendering (local probes only, never
                # collective); a scrape must see current saturation AND
                # ledger numbers even when no watchdog ticks between
                # scrapes (the watchdog is OFF by default — without
                # this the mem.* family would scrape frozen at zero)
                try:
                    from multiverso_tpu_torch.telemetry import \
                        watchdog as twatchdog
                    twatchdog.refresh_saturation_gauges()
                except Exception:
                    pass
                try:
                    from multiverso_tpu_torch.telemetry import accounting
                    accounting.refresh()
                except Exception:
                    pass
                self._send(200, render_prometheus(metrics.snapshot()),
                           "text/plain; version=0.0.4")
            elif path == "/healthz":
                rep = health_report()
                self._send(200 if rep["healthy"] else 503,
                           json.dumps(rep, indent=1, sort_keys=True),
                           "application/json")
            elif path == "/flight":
                rec, drop = flight.stats()
                self._send(200, json.dumps(
                    {"recorded": rec, "dropped": drop,
                     "events": flight.events(512)}),
                    "application/json")
            elif path == "/perf":
                self._send(200, json.dumps(perf_report(), indent=1,
                                           sort_keys=True),
                           "application/json")
            elif path == "/alerts":
                from multiverso_tpu_torch.telemetry import \
                    watchdog as twatchdog
                self._send(200, json.dumps(twatchdog.alerts_report(),
                                           indent=1, sort_keys=True),
                           "application/json")
            elif path == "/fleet":
                from multiverso_tpu_torch import elastic
                from multiverso_tpu_torch.telemetry import fleet as tfleet
                rep = tfleet.fleet_report()
                ha = elastic.ha_status()
                if ha is not None:
                    rep["coordinator_ha"] = ha
                self._send(200, json.dumps(rep, indent=1,
                                           sort_keys=True),
                           "application/json")
            elif path == "/actions":
                from multiverso_tpu_torch import policy as tpolicy
                self._send(200, json.dumps(tpolicy.actions_report(),
                                           indent=1, sort_keys=True),
                           "application/json")
            elif path == "/memory":
                from multiverso_tpu_torch.telemetry import accounting
                self._send(200, json.dumps(accounting.memory_report(),
                                           indent=1, sort_keys=True),
                           "application/json")
            else:
                self._send(404, "unknown path (know /metrics /healthz "
                                "/flight /perf /alerts /actions "
                                "/fleet /memory)\n",
                           "text/plain")
        except Exception as exc:    # never kill the handler thread
            try:
                self._send(500, f"ops handler failed: {exc!r}\n",
                           "text/plain")
            except Exception:
                pass


class OpsServer:
    """One HTTP daemon thread serving the ops endpoint."""

    def __init__(self, port: int):
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          _OpsHandler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="mvt-ops-http",
            daemon=True)

    def start(self) -> None:
        self._thread.start()
        Log.Info("ops endpoint serving on 127.0.0.1:%d "
                 "(/metrics /healthz /flight /perf /alerts /memory)",
                 self.port)

    def stop(self, join_s: float = 5.0) -> None:
        """Shut down + join BOUNDED (Zoo.Stop must never hang on a
        wedged scrape; failsafe.deadline.bounded raises typed, logged
        here, when -mv_deadline_s is set)."""
        from multiverso_tpu_torch.failsafe import deadline as fdeadline
        from multiverso_tpu_torch.failsafe.errors import DeadlineExceeded

        def _shutdown():
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(join_s)

        try:
            fdeadline.bounded(_shutdown, "ops HTTP thread join",
                              fatal=False)
        except DeadlineExceeded as exc:
            Log.Error("ops endpoint stop timed out (%r) — abandoning "
                      "its daemon thread", exc)
        if self._thread.is_alive():
            Log.Error("ops HTTP thread still alive after bounded join "
                      "— daemon thread abandoned")


_server: Optional[OpsServer] = None
_server_lock = threading.Lock()


def start_ops() -> Optional[int]:
    """Start the ops endpoint when ``-mv_ops_port >= 0`` (Zoo.Start).
    Idempotent; returns the bound port or None when off."""
    global _server
    try:
        want = int(GetFlag("mv_ops_port"))
    except Exception:
        want = -1
    with _server_lock:
        if _server is not None:
            return _server.port
        if want < 0:
            return None
        try:
            _server = OpsServer(want)
        except OSError as exc:
            Log.Error("ops endpoint failed to bind port %d: %r — "
                      "continuing without it", want, exc)
            return None
        _server.start()
        return _server.port


def stop_ops() -> None:
    """Stop + join the ops endpoint (Zoo.Stop). Idempotent."""
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()


def port() -> Optional[int]:
    """The live endpoint's bound port (ephemeral ports included), or
    None when off — tests and the dashboard [Ops] line read this."""
    srv = _server
    return srv.port if srv is not None else None


def dump_diagnostics(dir_path: Optional[str] = None) -> Optional[str]:
    """Write the complete postmortem artifact set under ``dir_path``
    (default ``-mv_diag_dir``): the flight ring
    (``flight_rank<R>.jsonl``), the local telemetry snapshot sidecar
    (``telemetry_rank<R>.json``) and the span trace dump
    (``trace_rank<R>.json``) — one directory, one flag, everything a
    postmortem needs. Returns the directory or None when no directory
    is configured. Best-effort per artifact; LOCAL only."""
    import os

    d = dir_path or flight.diag_dir()
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    r = flight._rank()
    try:
        flight.dump(os.path.join(d, f"flight_rank{r}.jsonl"))
    except Exception as exc:
        Log.Error("diag dump: flight ring failed: %r", exc)
    try:
        from multiverso_tpu_torch.telemetry.export import write_snapshot_sidecar
        write_snapshot_sidecar(os.path.join(d, f"telemetry_rank{r}.json"))
    except Exception as exc:
        Log.Error("diag dump: telemetry sidecar failed: %r", exc)
    try:
        from multiverso_tpu_torch.telemetry import trace
        trace.dump(os.path.join(d, f"trace_rank{r}.json"))
    except Exception as exc:
        Log.Error("diag dump: span trace failed: %r", exc)
    return d
