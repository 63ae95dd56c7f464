"""Process memory/capacity ledger: where every byte of runtime state
lives, as typed ``mem.*`` gauges and the ``/memory`` ops endpoint (the
port's counterpart of the JAX package's ``telemetry/accounting.py``).

The reference's Dashboard counts time; nothing in this build counted
BYTES — yet the ROADMAP's giant-table scenario (host-RAM authoritative
rows + a device hot-row cache) is unbuildable without knowing, per
table, how much state sits on the device, in host mirrors, and in host
control planes, and the PR 9 components that fail by *saturation*
(shm ring, snapshot retention, write-combine buffers) all fail by
byte growth first. This module is the measurement substrate:

* **pull, not push** — components are PROBED at sample time (the
  watchdog tick, an ops scrape, a Dashboard render); nothing on a verb
  path increments a byte gauge. Every probe is shape/size arithmetic
  under at most one short lock — never a device sync, a kernel launch,
  a host mirror or a copy (``tables/base.py ledger_bytes`` contract: no
  ``.item()``, ``.cpu()`` or ``torch.cuda.synchronize()``).
* **typed gauge families, registered EAGERLY** — ``start_ledger()``
  registers every ``mem.*`` family at zero (the PR 6 rule), so the
  ``-stats_interval_s`` reporter and ``/metrics`` show the whole
  coverage map from the first scrape. Per-table / per-version detail
  lives in the ``/memory`` JSON body; the gauges carry family totals.
* **local only** — the ledger never issues collectives (the reporter/
  ops-handler rule); job-wide totals are Prometheus's aggregation job.

Coverage map (the ``/memory`` body mirrors this):

========================  =============================================
component                 what is counted
========================  =============================================
tables.device_bytes       per-table tensors' STORAGE bytes
                          (``untyped_storage().nbytes()`` over the data
                          and the updater's aux state: padded rows and
                          columns included, so more than the JAX
                          package's logical leaf bytes)
tables.host_mirror_bytes  host mirrors of device state (a CPU matrix
                          table's native store, ``NativeHostStore``:
                          its logical rows x cols floats)
tables.host_bytes         host-authoritative values, freshness bitmaps,
                          key indexes at ALLOCATED capacity — probing-
                          table load-factor headroom included (exact)
snapshots.bytes           every LIVE serving snapshot version
                          (serving/store.retained_bytes)
flight.bytes              flight-recorder ring estimate (events *
                          fixed tuple overhead + detail strings)
dedup.bytes               (src, msg_id) dedup window estimate
write_combine.bytes       worker-side combined-Add buffers (exact)
get_cache.bytes           staleness-bounded Get cache copies (exact)
shm.segment_bytes         owned shared-memory ring segments (+ peer
                          mappings reported separately in the body)
========================  =============================================
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from multiverso_tpu_torch.telemetry import flight as tflight
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.log import Log

#: every family gauge the ledger maintains — registered eagerly at
#: :func:`start_ledger` so the whole coverage map scrapes at zero
#: before the first refresh (tests assert this)
MEM_FAMILIES = (
    "mem.total_bytes",
    "mem.tables.device_bytes",
    "mem.tables.host_mirror_bytes",
    "mem.tables.host_bytes",
    "mem.snapshots.bytes",
    "mem.flight.bytes",
    "mem.dedup.bytes",
    "mem.write_combine.bytes",
    "mem.get_cache.bytes",
    "mem.shm.segment_bytes",
    "mem.shm.frame_hw_bytes",
    "mem.replica.journal_bytes",
)

#: flight-ring estimate: one event is an 8-slot tuple (3 ints, 2
#: floats, 2 interned-ish strings, container overhead ~ this many
#: bytes) plus its detail string's characters. An ESTIMATE, and
#: documented as one in the /memory body — the ring holds python
#: objects, not flat buffers.
_FLIGHT_EVENT_OVERHEAD = 160

#: dedup-window estimate per entry: (src, msg_id) key tuple + ordered-
#: dict slot + outcome pointer
_DEDUP_ENTRY_OVERHEAD = 128

_started = False
_lock = threading.Lock()


def _tables_report() -> dict:
    """Per-table placement via the ``ledger_bytes`` probes (engine
    server tables) + the worker halves' buffered bytes."""
    per_table = []
    totals = {"device_bytes": 0, "host_mirror_bytes": 0, "host_bytes": 0}
    wc_bytes = 0
    gc_bytes = 0
    from multiverso_tpu_torch.zoo import Zoo
    zoo = Zoo.Get()
    eng = zoo.server_engine
    if eng is not None:
        for tid, table in enumerate(getattr(eng, "store_", [])):
            try:
                rec = dict(table.ledger_bytes())
            except Exception as exc:    # one bad probe must not blind
                Log.Debug("ledger: table %d probe failed: %r", tid, exc)
                continue
            rec["table_id"] = tid
            rec["family"] = type(table).__name__
            per_table.append(rec)
            for k in totals:
                totals[k] += int(rec.get(k, 0))
    for wt in list(getattr(zoo, "worker_tables", [])):
        try:
            w = wt.worker_ledger_bytes()
        except Exception as exc:
            Log.Debug("ledger: worker table probe failed: %r", exc)
            continue
        wc_bytes += w.get("write_combine_bytes", 0)
        gc_bytes += w.get("get_cache_bytes", 0)
    return {"per_table": per_table, "totals": totals,
            "write_combine_bytes": wc_bytes, "get_cache_bytes": gc_bytes}


def _snapshots_report() -> dict:
    from multiverso_tpu_torch.serving import peek_plane
    plane = peek_plane()
    if plane is None:
        return {"per_version": {}, "bytes": 0}
    per_version = {str(v): b
                   for v, b in plane.store.retained_bytes().items()}
    return {"per_version": per_version,
            "bytes": sum(per_version.values())}


def _flight_report() -> dict:
    # raw-tuple sum, NOT .events(): this runs every watchdog tick and
    # a full default ring is 4096 events — building a dict per event
    # per tick would dwarf the documented tick body
    count, est = tflight.RECORDER.approx_bytes(_FLIGHT_EVENT_OVERHEAD)
    recorded, dropped = tflight.stats()
    return {"events": count, "recorded": recorded,
            "dropped": dropped, "bytes_estimate": est,
            "note": ("estimate: events * ~%dB tuple overhead + detail "
                     "chars" % _FLIGHT_EVENT_OVERHEAD)}


def _dedup_report() -> dict:
    entries = 0
    from multiverso_tpu_torch.zoo import Zoo
    eng = Zoo.Get().server_engine
    if eng is not None:
        for shard in _engine_shards(eng):
            dd = getattr(shard, "_dedup", None)
            if dd is not None:
                entries += len(dd)
    return {"entries": entries,
            "bytes_estimate": entries * _DEDUP_ENTRY_OVERHEAD}


def _engine_shards(eng) -> list:
    """The engine plus any live sub-shards (each a full engine)."""
    out = [eng]
    out.extend(getattr(eng, "_subs", {}).values())
    return out


def _shm_report() -> Optional[dict]:
    from multiverso_tpu_torch.parallel import multihost
    wire = multihost.active_wire()
    if wire is None:
        return None
    return wire.mem_bytes()


def memory_report() -> dict:
    """The full ``/memory`` body: per-component byte placement with
    per-table / per-version detail, plus the reconciliation totals.
    LOCAL (never collective) and probe-only — safe from any thread;
    every component degrades to absence on teardown races. Also
    refreshes the ``mem.*`` family gauges so a scrape right after sees
    the same numbers."""
    comps: Dict[str, dict] = {}
    try:
        comps["tables"] = _tables_report()
    except Exception as exc:
        Log.Debug("ledger: tables probe failed: %r", exc)
        comps["tables"] = {"per_table": [], "totals": {
            "device_bytes": 0, "host_mirror_bytes": 0, "host_bytes": 0},
            "write_combine_bytes": 0, "get_cache_bytes": 0}
    try:
        comps["snapshots"] = _snapshots_report()
    except Exception as exc:
        Log.Debug("ledger: snapshots probe failed: %r", exc)
        comps["snapshots"] = {"per_version": {}, "bytes": 0}
    try:
        comps["flight"] = _flight_report()
    except Exception as exc:
        Log.Debug("ledger: flight probe failed: %r", exc)
        comps["flight"] = {"events": 0, "bytes_estimate": 0}
    try:
        comps["dedup"] = _dedup_report()
    except Exception as exc:
        Log.Debug("ledger: dedup probe failed: %r", exc)
        comps["dedup"] = {"entries": 0, "bytes_estimate": 0}
    try:
        comps["shm"] = _shm_report()
    except Exception as exc:
        Log.Debug("ledger: wire probe failed: %r", exc)
        comps["shm"] = None
    # the replica fan-out's journals and retained dirty sets (None when
    # the plane is off or this rank is not the fan-out owner)
    try:
        from multiverso_tpu_torch import replica as treplica
        comps["replica"] = treplica.ledger_bytes()
    except Exception as exc:
        Log.Debug("ledger: replica probe failed: %r", exc)
        comps["replica"] = None
    t = comps["tables"]["totals"]
    shm = comps["shm"] or {}
    rep = comps["replica"] or {}
    gauges = {
        "mem.tables.device_bytes": t["device_bytes"],
        "mem.tables.host_mirror_bytes": t["host_mirror_bytes"],
        "mem.tables.host_bytes": t["host_bytes"],
        "mem.snapshots.bytes": comps["snapshots"]["bytes"],
        "mem.flight.bytes": comps["flight"].get("bytes_estimate", 0),
        "mem.dedup.bytes": comps["dedup"].get("bytes_estimate", 0),
        "mem.write_combine.bytes": comps["tables"]["write_combine_bytes"],
        "mem.get_cache.bytes": comps["tables"]["get_cache_bytes"],
        "mem.shm.segment_bytes": shm.get("segment_bytes", 0),
        "mem.shm.frame_hw_bytes": shm.get("frame_hw_bytes", 0),
        "mem.replica.journal_bytes": (rep.get("journal_bytes", 0)
                                      + rep.get("dirty_set_bytes", 0)),
    }
    total = sum(gauges.values()) - gauges["mem.shm.frame_hw_bytes"]
    gauges["mem.total_bytes"] = total
    for name, v in gauges.items():
        tmetrics.gauge(name).set(float(v))
    return {
        "total_bytes": total,
        "components": comps,
        "note": ("local process ledger; device_bytes are the tables' "
                 "tensor STORAGE bytes (padded rows/columns included), "
                 "host bytes exact, flight/dedup are estimates; "
                 "frame_hw_bytes is a high-watermark, excluded from "
                 "total_bytes"),
    }


def refresh() -> dict:
    """Alias used by the watchdog tick: probe + set gauges."""
    return memory_report()


def start_ledger() -> None:
    """Register every ``mem.*`` family gauge at zero (Zoo.Start).
    Idempotent per world; a no-op while ``-telemetry=false`` hands out
    NULL instruments (the registry stays empty, like everything
    else)."""
    global _started
    with _lock:
        for name in MEM_FAMILIES:
            tmetrics.gauge(name)
        _started = True


def stop_ledger() -> None:
    """Zoo.Stop teardown hook. The gauges stay registered (instrument
    registries live for the process); only the started mark resets so
    a later world re-arms cleanly."""
    global _started
    with _lock:
        _started = False


def started() -> bool:
    return _started
