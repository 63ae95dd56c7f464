"""Telemetry — typed metrics, span tracing, the flight recorder, the ops
endpoint, the byte ledger and the watchdog (the port's counterpart of
``multiverso_tpu/telemetry/``).

Instrument names, flag names, defaults and dump formats are the JAX
package's, so a metrics snapshot, a Prometheus scrape or a flight dump of
the port reads exactly like one of the reference, and the offline tools of
either package read the other's dumps.

* ``metrics`` — a thread-safe registry of typed instruments (Counter,
  Gauge, MaxGauge, log-bucketed Histogram, mergeable Digest) with
  fixed-width vector encodings; ``merged_snapshot`` is the
  union-of-names merge across processes on the gloo control group.
* ``trace`` — span trees carried on ``Message`` across the worker ->
  mailbox -> engine-window hops, exported as Chrome trace-event JSON.
  While ``MV_StartProfiler`` runs, every span also enters a
  ``torch.profiler.record_function`` of the same name, so host spans sit
  on the profiler's timeline beside the kernels they launched.
* ``export`` — the ``-stats_interval_s`` periodic reporter and the
  snapshot sidecar.
* ``flight`` — the always-on flight recorder (``-mv_flight_events``) and
  its JSONL dumps (``-mv_diag_dir``).
* ``forensics``, ``critpath``, ``align`` — offline tools over several
  ranks' flight dumps (divergence, cross-rank critical path). They have
  no flags and are not imported here.
* ``ops`` — the ``-mv_ops_port`` HTTP endpoint: ``/metrics``,
  ``/healthz``, ``/flight``, ``/perf``, ``/alerts``, ``/memory``.
* ``accounting`` — the ``mem.*`` byte ledger behind ``/memory``.
* ``watchdog`` — ``-mv_watchdog_s`` typed alert rules with hysteresis
  over local instruments.
* ``sketch`` — the ``-mv_row_sketch`` Space-Saving row-access sketch.

The fleet plane (``telemetry/fleet.py`` in the JAX package) rides the
elastic member heartbeats and the replica plane, which the port does not
have yet (``ROADMAP.md``).

Importing this package registers every telemetry flag (``-telemetry``,
``-trace``, ``-stats_interval_s``, ``-mv_flight_events``,
``-mv_diag_dir``, ``-mv_ops_port``, ``-mv_watchdog_s``,
``-mv_row_sketch``) so ``MV_Init``'s argv parsing claims them.
"""

from multiverso_tpu_torch.telemetry import (export, flight,  # noqa: F401
                                            metrics, ops, sketch, trace)
from multiverso_tpu_torch.telemetry import (  # noqa: F401,E402
    accounting, watchdog)
