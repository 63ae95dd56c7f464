"""Trainer-side replica fan-out: journals at the cut, ships off it.

The port's own copy of ``multiverso_tpu/replica/publisher.py``. Two
halves, split where the SPMD stream's soundness demands:

* :func:`note_publish` runs ON the engine thread INSIDE the publish cut
  (serving/snapshot._capture_all, every stream fenced): it drains each
  table's publish journal into the dirty-set record of the new version
  and kicks the fan-out thread. Local numpy only, no collective: the cut
  pays nothing for the fan-out.
* The fan-out THREAD does everything slow: it polls the subscription
  roster (a coordinator RPC), encodes base and delta blobs from the
  IMMUTABLE retained snapshots (never the live tables) and ships them:
  same-host readers over a dedicated shm ring a reader (the engine wire's
  transport, two processes point to point, a session token of its own),
  cross-host readers over a dedicated tcp stream (the reader's join token
  carries its listener endpoint; the first ship dials it), relay readers
  through the coordinator's mailbox.

A device-resident snapshot (one process, an aux-free table on the card)
is read through the snapshot's stored gather, ``<kGather>`` on the card,
from the fan-out thread: the clone it reads is immutable, and one process
has no collective stream for the launch to interleave with. Worlds of
several processes keep host residence, so their fan-out does no device
work.

Failure isolation: a reader that stalls or dies costs ONE bounded ring
wait (a lease-derived ``timeout_s`` handed to the wire's exchange; on shm
the reader's pid, carried in its token, turns a dead reader into an
``ActorDied`` at once) and is then evicted: the SPMD world never blocks
on the read tier. Eviction rides the heartbeat lease the coordinator's
``replica_*`` ops keep.

Delta policy: a subscriber acked at version V gets ``delta(V -> latest)``
when every interval dirty set V+1..latest is still retained (retention
follows ``-mv_serving_keep`` plus slack), else a fresh base. The delta
applies to any reader state in ``[V, latest]`` (delta.py's applicability
rule), so ack lag cannot corrupt a mirror: at worst it ships a few rows
the reader already has.
"""

from __future__ import annotations

import collections
import os
import re
import threading
from typing import Dict, List, Optional

from multiverso_tpu_torch.failsafe.errors import (ActorDied, DeadlineExceeded,
                                                  WireCorruption)
from multiverso_tpu_torch.parallel import compress
from multiverso_tpu_torch.replica import delta as rdelta
from multiverso_tpu_torch.telemetry import fleet as tfleet
from multiverso_tpu_torch.telemetry import flight as tflight
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.configure import (GetFlag, cached_bool_flag,
                                                  cached_int_flag)
from multiverso_tpu_torch.utils.log import CHECK, Log

_fanout_flag = cached_bool_flag("mv_replica_fanout", False)
_ring_flag = cached_int_flag("mv_replica_ring_bytes", 8 << 20)
_keep_flag = cached_int_flag("mv_serving_keep", 2)

#: fan-out thread idle poll (the roster refresh between publishes: a new
#: subscriber gets its base without waiting for the next publish)
_POLL_S = 0.25

#: bound of the fan-out thread's coordinator calls
_RPC_TIMEOUT_S = 10.0

#: an shm reader's session token: its pid and a stamp, in hex
#: (``replica.Replica.start``); the publisher's ring probes that pid
_SHM_TOKEN = re.compile(r"^([0-9a-f]+)p[0-9a-f]+$")


def _lease_s() -> float:
    lease = float(GetFlag("mv_replica_lease_s"))
    if lease > 0:
        return lease
    from multiverso_tpu_torch.failsafe import deadline as fdeadline
    dl = fdeadline.deadline_s()
    return max(2.0, 0.8 * dl) if dl > 0 else 5.0


def token_pid(token: str) -> Optional[int]:
    """The reader pid an shm session token carries, or None (a token of
    another format, such as the JAX package's reader's: that reader is
    then watched by its lease alone)."""
    m = _SHM_TOKEN.match(str(token))
    return int(m.group(1), 16) if m else None


class ReplicaPublisher:
    """A process's fan-out state. Only the fan-out OWNER rank (boot rank
    0, the rank that already hosts every coordinator) journals and ships;
    other ranks keep the plane object as an inert flag holder so the
    hooks stay one attribute read."""

    def __init__(self, zoo, active: bool):
        self.zoo = zoo
        self.active = active
        self.client = None              #: coordinator RPC client
        self.endpoint: Optional[str] = None
        self._own_coordinator = None    #: hosted here when no elastic
        self.lease_s = _lease_s()
        self._lock = threading.Lock()
        #: version -> {tid: dirty descriptor} (the interval prev->version)
        self._dirty: "collections.OrderedDict[int, Dict]" = \
            collections.OrderedDict()
        self.latest = -1
        self.fanout_bytes = 0
        self._subs: Dict[int, dict] = {}    #: rid -> local ship state
        self._roster: List[dict] = []       #: last roster (healthz)
        #: fleet identity of the rollup riding the roster poll, stamped by
        #: start_plane on the app thread (the fan-out thread never reads
        #: multihost)
        self.member_label = "rank0"
        #: content-addressed encode cache: N same-lag subscribers share
        #: ONE encode. Keyed by (kind, prev_version, version, codec
        #: config); the entries of superseded versions go at the first
        #: encode against a newer snapshot. Fan-out-thread-only state.
        self._enc_cache: Dict[tuple, bytes] = {}
        self._enc_version = -1
        self.max_lag = 0
        #: the client's failover generation last seen: a takeover voids
        #: the per-subscriber ship dedup (the successor's mailboxes are
        #: empty and needs_base is re-armed there, but last_sent would
        #: skip the re-ship)
        self._failover_gen = 0
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # registered eagerly: the replica family scrapes at zero from the
        # first /metrics read
        self._t_bytes = tmetrics.counter("replica.fanout_bytes")
        self._t_blobs = tmetrics.counter("replica.fanout_blobs")
        self._t_enc_reuse = tmetrics.counter("replica.fanout_encode_reuse")
        self._t_evicted = tmetrics.counter("replica.evictions")
        self._t_subs = tmetrics.gauge("replica.subscribers")
        self._t_lag = tmetrics.gauge("replica.lag_versions")

    # -- engine-thread half (inside the cut) --------------------------------

    def record_cut(self, engine, snap) -> None:
        """Drain every table's journal at the fenced cut: the dirty
        descriptor of the interval (previous publish, ``snap``]."""
        descs: Dict[int, dict] = {}
        for tid, table in enumerate(engine.store_):
            if tid not in snap.tables:
                # a family without a serving export: nothing to fan out,
                # but its journal still DRAINS (an undrained kv write-set
                # would grow without bound across cuts)
                j = getattr(table, "_pub_journal", None)
                if j is not None:
                    j.drain()
                continue
            journal = getattr(table, "_pub_journal", None)
            if journal is None:
                # registered before the plane was up: no coverage for THIS
                # interval (the merge turns it into a whole payload), and
                # the fresh journal covers every later one
                table._pub_journal = rdelta.journal_for_table(table)
                descs[tid] = {"kind": "all"}
            else:
                descs[tid] = journal.drain()
        keep = max(4, _keep_flag() + 2)
        with self._lock:
            self._dirty[snap.version] = descs
            while len(self._dirty) > keep:
                self._dirty.popitem(last=False)
            self.latest = snap.version
        self._kick.set()

    def _merged_descs(self, acked: int,
                      target_snap) -> Optional[Dict[int, dict]]:
        """A table's dirty union over (acked, target]; None = a base is
        needed (an interval's record was pruned already)."""
        with self._lock:
            need = range(acked + 1, target_snap.version + 1)
            if any(v not in self._dirty for v in need):
                return None
            per_version = [self._dirty[v] for v in need]
        out: Dict[int, dict] = {}
        for tid in target_snap.tables:
            # a tid absent from an interval's record did not exist at that
            # cut -> merge_descriptors(None) -> a whole payload
            out[tid] = rdelta.merge_descriptors(
                [d.get(tid) for d in per_version])
        return out

    # -- fan-out thread -----------------------------------------------------

    def start(self) -> None:
        if not self.active or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run,
                                        name="mv-replica-fanout",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:  # mv-lint: ok(never-collective): the only reachable "collectives" are ShmWire.exchange / TcpWire.exchange on a per-replica 2-proc fan-out channel with its own session token — a point-to-point stream to a non-SPMD reader, bounded by an explicit lease timeout; no SPMD rank ever participates, so it cannot interleave with the engine's window streams
        while not self._stop.is_set():
            self._kick.wait(_POLL_S)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self._tick()
            except Exception as exc:    # the fan-out must never die
                if self._stop.is_set():
                    return      # shutdown closed a wire under a stuck
                                # ship: stop() logged the abandonment
                Log.Error("replica fan-out tick failed: %r", exc)

    def _tick(self) -> None:
        from multiverso_tpu_torch.serving import peek_plane
        try:
            # this trainer rank's fleet rollup rides the roster poll that
            # flows every tick. Telemetry must never cost the fan-out: a
            # failure sends an empty blob
            rollup = tfleet.encode_rollup(tfleet.build_rollup(
                self.member_label, "trainer"))
        except Exception:
            rollup = b""
        resp = self.client.call(
            "replica_roster", timeout=_RPC_TIMEOUT_S,
            latest=self.latest if self.latest >= 0 else None,
            rollup=rollup)
        roster = resp["replicas"]
        gen = getattr(self.client, "failover_gen", 0)
        if gen != self._failover_gen:
            # a coordinator failover: the successor replayed the op log
            # (the roster and acked versions survive) but the relay
            # mailboxes died with the primary; drop the local ship dedup
            # so every live subscriber is re-shipped against its replayed
            # ack state on this very tick
            self._failover_gen = gen
            for st in self._subs.values():
                st["last_sent"] = -1
            Log.Error("replica fan-out: coordinator failover detected "
                      "(gen %d) — re-shipping every subscription "
                      "against the successor's replayed state", gen)
        plane = peek_plane()
        store = plane.store if plane is not None else None
        live = 0
        max_lag = 0
        for rec in roster:
            rid = rec["rid"]
            st = self._subs.setdefault(
                rid, {"wire": None, "last_sent": -1, "state": "live"})
            if rec["status"] != "live":
                if st["state"] == "live":
                    self._evict(rid, st, rec["status"])
                continue
            live += 1
            if store is None or store.latest_version() is None:
                continue
            snap = store.get(None)
            if rec["acked"] >= 0:
                # a never-acked subscriber is SYNCING, not lagging:
                # counting it from version 0 would read as the trainer's
                # whole history and fire replica_lag on every join (the
                # lease owns the never-arrives case)
                max_lag = max(max_lag, snap.version - rec["acked"])
            if st["last_sent"] >= snap.version:
                continue
            try:
                blob, kind = self._encode_for(rec, snap)
                sent = self._ship(rec, st, blob, snap.version)
            except (ActorDied, DeadlineExceeded, WireCorruption,
                    OSError, ConnectionError) as exc:
                Log.Error("replica %d ship failed (%r) — evicting its "
                          "subscription", rid, exc)
                try:
                    self.client.call("replica_evict", rid=rid,
                                     timeout=_RPC_TIMEOUT_S)
                except Exception:
                    pass
                self._evict(rid, st, "dead")
                continue
            if not sent:
                # relay mailbox overflow: the coordinator dropped the queue
                # and flagged needs_base; last_sent stays, so the NEXT tick
                # ships that base (a laggard resyncs, it is never evicted
                # for being slow)
                continue
            st["last_sent"] = snap.version
            self.fanout_bytes += len(blob)
            self._t_bytes.inc(len(blob))
            self._t_blobs.inc()
            tflight.record("replica.fanout", detail=f"r{rid} {kind} "
                           f"v{snap.version} {len(blob)}B")
        self._roster = roster
        self.max_lag = max_lag
        self._t_subs.set(float(live))
        self._t_lag.set(float(max_lag))

    def _encode_for(self, rec: dict, snap):
        """(blob, kind) for one subscriber against the newest retained
        snapshot: a delta when the interval is wholly journal-covered and
        the subscriber needs no resync, else a base. Encodes are
        CONTENT-ADDRESSED by (kind, prev_version, version, codec config):
        every same-lag subscriber of this tick (and of later ticks, until
        the version advances) reuses one encode."""
        acked = int(rec["acked"])
        if rec["needs_base"] or acked < 0 or acked >= snap.version:
            acked = -1          # every base rider shares one cache key
            descs = None
        else:
            descs = self._merged_descs(acked, snap)
            if descs is None:
                acked = -1      # an interval pruned: resync with a base
        kind = "base" if descs is None else "delta"
        key = (kind, acked, snap.version, compress.config_token())
        if self._enc_version != snap.version:
            # superseded interval blobs are never asked for again (ships
            # only ever target the NEWEST retained snapshot)
            self._enc_cache.clear()
            self._enc_version = snap.version
        blob = self._enc_cache.get(key)
        if blob is None:
            blob = (rdelta.encode_base(snap) if kind == "base"
                    else rdelta.encode_delta(snap, acked, descs))
            self._enc_cache[key] = blob
        else:
            self._t_enc_reuse.inc()
        return blob, kind

    def _ship(self, rec: dict, st: dict, blob: bytes,
              version: int) -> bool:
        """Ship one blob; False on a relay mailbox overflow (the laggard-
        resync signal, NOT a failure; ship errors raise)."""
        if rec["mode"] == "shm":
            wire = st["wire"]
            if wire is None:
                from multiverso_tpu_torch.parallel.shm_wire import ShmWire
                pid = token_pid(rec["token"])
                wire = ShmWire(rec["token"], rank=0, nprocs=2,
                               channels=1,
                               data_bytes=rec["ring_bytes"]
                               or _ring_flag(),
                               payload_crc=False,
                               peer_pids=(None if pid is None
                                          else [os.getpid(), pid]))
                wire.attach_peers()     # the reader created its segment
                st["wire"] = wire       # before it joined
            wire.exchange(blob, 0,
                          timeout_s=max(2.0 * self.lease_s, 5.0))
            return True
        if rec["mode"] == "tcp":
            wire = st["wire"]
            if wire is None:
                # the reader's join token carries its listener endpoint
                # verbatim, session@host:port (it bound BEFORE joining, so
                # this first dial lands)
                from multiverso_tpu_torch.parallel.tcp_wire import TcpWire
                session, _, ep = str(rec["token"]).partition("@")
                host, _, port = ep.rpartition(":")
                wire = TcpWire(session, rank=0, nprocs=2, channels=1,
                               data_bytes=rec["ring_bytes"]
                               or _ring_flag(),
                               payload_crc=False)
                wire.connect({1: [(host, int(port))]},
                             timeout_s=max(2.0 * self.lease_s, 5.0))
                st["wire"] = wire
            wire.exchange(blob, 0,
                          timeout_s=max(2.0 * self.lease_s, 5.0))
            return True
        resp = self.client.call("replica_put", rid=rec["rid"],
                                version=version, blob=blob,
                                timeout=_RPC_TIMEOUT_S)
        return not resp.get("overflow")

    def _evict(self, rid: int, st: dict, state: str) -> None:
        wire, st["wire"] = st["wire"], None
        if wire is not None:
            wire.close()
        if st["state"] == "live":
            st["state"] = state
            self._t_evicted.inc()
            tflight.record("replica.evict", detail=f"r{rid} {state}")
            Log.Info("replica plane: subscription r%d evicted (%s)",
                     rid, state)

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                Log.Error("replica fan-out thread stuck at shutdown — "
                          "abandoning its daemon thread")
        for st in self._subs.values():
            wire, st["wire"] = st["wire"], None
            if wire is not None:
                wire.close()
        if self._own_coordinator is not None:
            self._own_coordinator.stop()
            self._own_coordinator = None


_publisher: Optional[ReplicaPublisher] = None
_pub_lock = threading.Lock()


def start_plane(zoo) -> bool:
    """Bring the fan-out up when ``-mv_replica_fanout`` is set (Zoo.Start,
    after the elastic plane so its coordinator can be reused). Rank 0
    owns the fan-out; other ranks hold an inert plane object. Returns True
    when the fan-out is active on this rank."""
    global _publisher
    if not _fanout_flag():
        return False
    CHECK(zoo.server_engine is not None,
          "-mv_replica_fanout needs the server engine (not -ma mode): "
          "the dirty journals drain at engine publish cuts")
    from multiverso_tpu_torch import elastic
    from multiverso_tpu_torch.elastic.coordinator import (Coordinator,
                                                          MemberClient)
    from multiverso_tpu_torch.parallel import multihost
    me = multihost.process_index()
    active = me == 0
    pub = ReplicaPublisher(zoo, active)
    pub.member_label = f"rank{me}"
    if active:
        addr = str(GetFlag("mv_replica_addr"))
        ep = elastic.coordinator_endpoint()
        endpoints = None
        if addr:
            host, _, port_s = addr.rpartition(":")
            CHECK(host and port_s.isdigit(),
                  f"-mv_replica_addr must be host:port, got {addr!r}")
            pub._own_coordinator = Coordinator(host, int(port_s),
                                               pub.lease_s)
            port = pub._own_coordinator.port
        elif ep is not None:
            # ride the elastic coordinator and its ORDERED failover list:
            # the relay must follow the membership authority to its
            # successor
            host, port = ep
            endpoints = elastic.coordinator_endpoints()
        else:
            CHECK(multihost.process_count() <= 1,
                  "-mv_replica_fanout in a multi-process world needs "
                  "-mv_elastic (to reuse its coordinator) or an "
                  "explicit -mv_replica_addr")
            pub._own_coordinator = Coordinator("127.0.0.1", 0,
                                               pub.lease_s)
            host, port = "127.0.0.1", pub._own_coordinator.port
        pub.client = MemberClient(host, port, me, pub.lease_s,
                                  endpoints=endpoints)
        pub.endpoint = f"{host}:{port}"
        pub.start()
        Log.Info("replica plane: fan-out up at %s (lease %.1fs)",
                 pub.endpoint, pub.lease_s)
    with _pub_lock:
        _publisher = pub
    return active


def shutdown_plane() -> None:
    global _publisher
    with _pub_lock:
        pub, _publisher = _publisher, None
    if pub is not None:
        pub.stop()


def note_publish(engine, snap) -> None:
    """The publish-cut hook (:meth:`ReplicaPublisher.record_cut`). One
    attribute read when the plane is off or this rank is not the fan-out
    owner."""
    pub = _publisher
    if pub is None or not pub.active:
        return
    pub.record_cut(engine, snap)


def maybe_attach_journal(server_table) -> None:
    """RegisterTable hook: give the table its publish journal, so the
    FIRST interval after a publish is covered from registration (a
    late-attached journal forces one whole-payload fan-out)."""
    pub = _publisher
    if pub is None or not pub.active:
        return
    if getattr(server_table, "_pub_journal", None) is None:
        server_table._pub_journal = rdelta.journal_for_table(server_table)


def publisher_endpoint() -> Optional[str]:
    """host:port a reader joins (tests, the smoke script); None when
    off."""
    pub = _publisher
    return pub.endpoint if pub is not None else None


def status_report() -> Optional[dict]:
    """The local fan-out view for /healthz: a line a known reader
    (departed ones included, so operators see who left). Served from the
    fan-out thread's cached roster; never an RPC, never collective."""
    pub = _publisher
    if pub is None:
        return None
    subs = []
    for rec in pub._roster:
        # lag means something only for live, at-least-once-acked
        # subscribers; a joiner mid-first-base reports None (syncing)
        lag = (pub.latest - rec["acked"]
               if pub.latest >= 0 and rec["acked"] >= 0
               and rec["status"] == "live" else None)
        # a frozen telemetry feed must not render as healthy-looking
        # numbers: each line carries its rollup's age and a stale verdict
        # (against -mv_fleet_stale_s)
        age = rec.get("rollup_age_s")
        subs.append({"rid": rec["rid"], "mode": rec["mode"],
                     "state": rec["status"], "acked": rec["acked"],
                     "lag_versions": lag, "rollup_age_s": age,
                     "rollup_stale": bool(
                         rec["status"] == "live" and age is not None
                         and age > tfleet.stale_s())})
    return {"active": pub.active, "endpoint": pub.endpoint,
            "latest": pub.latest if pub.latest >= 0 else None,
            "fanout_bytes": pub.fanout_bytes, "max_lag": pub.max_lag,
            "subscribers": subs}


def peek_sample() -> Optional[dict]:
    """Watchdog probe: plain local attributes the fan-out tick
    refreshes."""
    pub = _publisher
    if pub is None or not pub.active:
        return None
    live = sum(1 for r in pub._roster if r["status"] == "live")
    sample = {"replica_subscribers": live,
              "replica_lag_versions": pub.max_lag}
    # the replica_lag rule warns of staleness instead of trusting frozen
    # numbers: feed it the oldest live rollup age
    ages = [r["rollup_age_s"] for r in pub._roster
            if r["status"] == "live"
            and r.get("rollup_age_s") is not None]
    if ages:
        sample["replica_rollup_age_max_s"] = max(ages)
    return sample


def ledger_bytes() -> Optional[dict]:
    """Accounting probe: the journals' bitmaps and write-sets on the live
    tables plus the retained per-version dirty descriptors."""
    pub = _publisher
    if pub is None or not pub.active:
        return None
    journal = 0
    eng = pub.zoo.server_engine
    if eng is not None:
        for table in getattr(eng, "store_", []):
            j = getattr(table, "_pub_journal", None)
            if j is not None:
                journal += j.nbytes()
    with pub._lock:
        dirty = sum(rdelta.descriptor_nbytes(d)
                    for descs in pub._dirty.values()
                    for d in descs.values())
    return {"journal_bytes": journal, "dirty_set_bytes": dirty,
            "retained_versions": len(pub._dirty)}
