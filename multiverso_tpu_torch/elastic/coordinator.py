"""Membership coordinator (the rank-0 authority) and the member client.

The port's own copy of ``multiverso_tpu/elastic/coordinator.py``. ONE
authority, hosted by boot rank 0, owns an **epoch-numbered view**: the set
of live members and the shard->owner map. Every membership change is a
staged transition applied at a fenced stream cut, never an in-place
mutation.

Protocol: length-framed pickled dicts over TCP, each sealed with the seal
trailer (``parallel/seal.py``), so a torn or flipped control frame raises
instead of desyncing the state machine. Every operation is idempotent or
rendezvous-shaped, so the client may retry transients:

* ``register``    — a boot member announces itself (plane start).
* ``hb``          — heartbeat: refreshes the member's lease and carries its
                    fleet rollup (``telemetry/fleet.py``). A member whose
                    lease expires is declared DEAD by the next wait that
                    evaluates leases (``dead_check``, ``sync``, ``xchg``).
* ``leave`` / ``join`` — stage a graceful drain / (re)admission, applied at
                    the next sync rendezvous.
* ``sync``        — lockstep rendezvous of all active members; at most one
                    transition per rendezvous, answered identically.
* ``dead_check``  — a member's collective deadline fired: block up to the
                    lease plus 2 s for a lease verdict.
* ``cut``         — fence rendezvous: old-view members report the engine
                    stream SEQ they fenced at; all must agree.
* ``manifest`` / ``shard_put`` / ``shard_get`` — the shard move plane,
                    keyed by ``(epoch, table, shard)``; re-delivery of a
                    key is deduped.
* ``commit``      — rendezvous of every NEW-view member; installs the
                    epoch and frees the shard store.
* ``joiner_wait`` — a (re)joining member parks until a transition
                    admitting it is staged and its manifest published.
* ``xchg`` / ``gbar`` — the post-transition group transport: an all-gather
                    of bytes / a barrier among the CURRENT view's members,
                    relayed through the authority (the boot world's gloo
                    groups cannot subset the world).
* ``state``       — observability snapshot for ``/healthz`` and the
                    Dashboard.
* ``policy_put`` / ``policy_pull`` — the policy plane's control-op stager
                    (``policy/``): actions stage at most once, keyed by
                    ``(epoch, action id)``, and drain through a pull
                    RENDEZVOUS that answers every member the same sorted
                    list, so installs are rank-agreed. Hosted here even in
                    non-elastic multi-process worlds (``-mv_policy_addr``).
* ``replica_*``   — the second member class: a *replica* is a process
                    outside the boot world (``role=replica``) with a
                    heartbeat lease but no verb stream, no view membership
                    and no shards. It subscribes to published snapshot
                    versions; in relay mode its fan-out blobs park in a
                    per-replica mailbox here. A replica whose lease expires
                    is declared dead, and the publisher's next fan-out tick
                    evicts it: the SPMD world never blocks on a replica.

**Coordinator HA.** The authority is a deterministic state machine
replicated over its own op protocol. Every MUTATING op appends a sealed,
sequence-numbered record to an **op log** streamed to a standby process
(``elastic/standby.py``); the op acks its caller only after the standby
acked the append (a bounded wait: on standby death the authority degrades
to solo LOUDLY, flagged in ``/healthz``). Read-only ops never touch the
log; clock-driven events (lease reaps, staged transitions, installs,
policy drains) are logged at their mutation point, so the standby's replay
reproduces them without re-running any rendezvous. Each ``_op_*`` handler
keeps its state mutation in an ``_ap_*`` method that takes exactly the
record's ``data``. On the primary's lease expiry the standby replays the
log into this same class (``replay``; ``state_digest`` pins live ==
replayed), re-bases every lease and ack clock (``rebase_clocks``: a
failover must never manufacture evictions out of the outage), binds the
successor endpoint and serves. Clients walk an ordered endpoint list
(``-mv_coordinator``, ``elastic/dialer.py``); non-idempotent ops carry a
``(member, op_seq)`` tag, so a blind client retry applies once. Rank 0
cannot drain (it hosts the authority), but its death is a failover.
"""

from __future__ import annotations

import collections
import hashlib
import pickle
import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Dict, Optional

from multiverso_tpu_torch.elastic import dialer as _dialer
from multiverso_tpu_torch.failsafe import chaos as fchaos
from multiverso_tpu_torch.failsafe.errors import (MembershipChanged,
                                            TransientError)
from multiverso_tpu_torch.parallel import seal
from multiverso_tpu_torch.telemetry import fleet as tfleet
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.log import CHECK, Log

_LEN = struct.Struct("<I")

#: cap on one control/shard frame (guards the length prefix against
#: reading garbage as a gigabyte allocation)
_MAX_FRAME = 1 << 31


def _send_frame(sock: socket.socket, obj) -> None:
    blob = seal.seal_frame(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("membership peer closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket):
    n = _LEN.unpack(_recv_exact(sock, 4))[0]
    CHECK(0 < n < _MAX_FRAME, f"membership frame length insane: {n}")
    blob = _recv_exact(sock, n)
    # seal.open_frame verifies the trailer (raising the typed
    # WireCorruption, counting wire.crc_failures) BEFORE the unpickle
    return pickle.loads(seal.open_frame(blob))


class _MemberRec:
    __slots__ = ("rank", "status", "last_hb", "lease_s")

    def __init__(self, rank: int, lease_s: float):
        self.rank = rank
        self.status = "active"        # active | left | dead | reaped
        self.last_hb = time.monotonic()
        self.lease_s = lease_s

    def expired(self, now: float) -> bool:
        return (self.status == "active"
                and now - self.last_hb > self.lease_s)


class _ReplicaRec:
    """One subscribed replica (``role=replica``): lease + fan-out
    bookkeeping. Not an epoch-view member — replicas have no verb
    stream and never appear in transitions."""

    __slots__ = ("rid", "mode", "token", "ring_bytes", "lease_s",
                 "last_hb", "status", "acked_version", "needs_base",
                 "mailbox", "joined_at")

    def __init__(self, rid: int, mode: str, token: str, ring_bytes: int,
                 lease_s: float):
        self.rid = rid
        self.mode = mode              # "shm" | "tcp" | "relay"
        self.token = token            # wire session token: shm session,
                                      # or tcp "session@host:port"
                                      # ("" for relay) — relayed to the
                                      # publisher VERBATIM
        self.ring_bytes = int(ring_bytes)
        self.lease_s = float(lease_s)
        self.last_hb = time.monotonic()
        self.status = "live"          # live | dead | evicted
        self.acked_version = -1
        self.needs_base = True
        #: relay-mode fan-out mailbox: [(version, blob)], bounded
        self.mailbox: list = []
        self.joined_at = time.time()

    def expired(self, now: float) -> bool:
        return (self.status == "live"
                and now - self.last_hb > self.lease_s)


#: relay-mode mailbox bound: a replica this far behind gets its queue
#: dropped and a fresh base instead (lag handling, not backpressure on
#: the trainer)
_REPLICA_MAILBOX_CAP = 4

#: bound on the standby append-ack wait per mutating op: past this the
#: authority degrades to solo (availability over replication) instead
#: of stalling the control plane behind a sick standby link
_STANDBY_ACK_S = 2.0

#: (member, op, op_seq) -> response cache depth for non-idempotent op
#: dedup — far above any in-flight retry window; evicted FIFO
_OP_DEDUP_CAP = 512


class Coordinator:
    """The rank-0 membership authority. Thread-per-connection TCP
    server; all state under one lock + condition (rendezvous ops wait
    on it). Never issues collectives itself — it is pure control
    plane."""

    def __init__(self, host: str, port: int, lease_s: float,
                 serve: bool = True):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: HA flag lock (standby link + state string). DELIBERATELY not
        #: _lock: the degrade callback fires from the shipper while a
        #: dispatch thread may hold _lock inside an op handler — taking
        #: the (non-reentrant) state lock there would self-deadlock.
        self._ha_lock = threading.Lock()
        self._lease_s = float(lease_s)
        self.epoch = 0
        self.members: Dict[int, _MemberRec] = {}
        self._pending_join: set = set()
        self._pending_leave: set = set()
        #: staged (not yet committed) transition, or None
        self._transition: Optional[dict] = None
        #: sync rendezvous bookkeeping. Generations are SERVER-assigned
        #: (member's n-th sync call joins generation n): a re-admitted
        #: member's counter re-aligns to the admitting generation at
        #: install, so rejoined worlds rendezvous without the members
        #: having to agree on call counts out of band.
        self._sync_counts: Dict[int, int] = {}
        self._sync_arrived: Dict[int, set] = {}
        self._sync_answer: Dict[int, Optional[dict]] = {}
        #: cut rendezvous: epoch -> {member: seq}
        self._cut_seqs: Dict[int, Dict[int, int]] = {}
        #: shard store: (epoch, table, shard) -> blob; manifest: epoch->
        self._shards: Dict[tuple, bytes] = {}
        self._manifests: Dict[int, dict] = {}
        self._shard_dups = 0
        #: commit rendezvous: epoch -> set of committed members
        self._commits: Dict[int, set] = {}
        #: replica subscriptions (role=replica — NOT epoch members)
        self._replicas: Dict[int, _ReplicaRec] = {}
        self._next_rid = 1
        #: policy-plane control-op staging. Every staged
        #: action (routing-map install, tune, drain request) is keyed
        #: by (epoch, action id): a duplicate delivery — two SPMD ranks
        #: proposing the same content-derived id, a chaos-rehearsed
        #: retransmit — is a NO-OP answered from the seen-set, exactly
        #: the shard_put at-most-once posture. The seen-set survives
        #: the pull that consumes an action, so a late re-delivery of
        #: an already-installed action cannot re-stage it.
        self._policy_staged: list = []
        self._policy_seen: set = set()
        self._policy_dups = 0
        #: pull rendezvous bookkeeping (the sync-generation pattern:
        #: a member's n-th pull joins generation n; the first complete
        #: rendezvous snapshots + clears the staged queue as the
        #: generation's one agreed answer)
        self._ppull_counts: Dict[int, int] = {}
        self._ppull_arrived: Dict[int, set] = {}
        self._ppull_answer: Dict[int, list] = {}
        #: newest published version the publisher announced (replica
        #: heartbeats answer lag from this without touching the trainer)
        self._replica_latest = -1
        #: group transport: (epoch, key, idx) -> {member: blob}; once
        #: complete the ordered blob list parks in _xchg_results until
        #: every participant has read it
        self._xchg: Dict[tuple, Dict[int, bytes]] = {}
        self._xchg_results: Dict[tuple, tuple] = {}
        #: coordinator HA. The op-log shipper to the standby
        #: (None: solo), its health (solo | replicated | degraded), the
        #: per-handler-thread pending log seq (the dispatch-level
        #: replication wait reads it after the handler returns), and
        #: the (member, op, op_seq) response cache that makes retried
        #: non-idempotent ops apply-once.
        self._standby = None
        self.standby_state = "solo"
        self._tls = threading.local()
        self._op_dedup: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._dedup_hits = 0

        self._host = host
        self._server = None
        self._thread = None
        self.port = int(port)
        if serve:
            self.serve()

    def serve(self) -> None:
        """Bind + serve the op endpoint. Separate from ``__init__`` so
        a standby's takeover can replay the op log into a quiescent
        instance BEFORE any client reaches it."""
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    req = _recv_frame(self.request)
                    # the class-qualified call: an untyped `outer._dispatch`
                    # reads to the call graph as every `_dispatch` (the
                    # engine's too)
                    resp = Coordinator._dispatch(outer, req)
                except (MembershipChanged, TransientError) as exc:
                    resp = {"err": type(exc).__name__, "msg": str(exc),
                            "epoch": getattr(exc, "epoch", -1),
                            "members": list(getattr(exc, "members", ())),
                            "departed": list(getattr(exc, "departed", ())),
                            "joined": list(getattr(exc, "joined", ()))}
                except (ConnectionError, BrokenPipeError, OSError):
                    return
                except Exception as exc:
                    Log.Error("elastic coordinator op failed: %r", exc)
                    resp = {"err": "FatalError", "msg": repr(exc)}
                try:
                    _send_frame(self.request, resp)
                except OSError:
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((self._host, self.port), _Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="mv-elastic-coordinator", daemon=True)
        self._thread.start()
        Log.Info("elastic: coordinator up at %s:%d (lease %.1fs)",
                 self._host, self.port, self._lease_s)

    def stop(self) -> None:
        with self._ha_lock:
            ship, self._standby = self._standby, None
        if ship is not None:
            ship.close()
        try:
            if self._server is not None:
                self._server.shutdown()
                self._server.server_close()
        except Exception:       # pragma: no cover - teardown race
            pass

    # -- coordinator HA: op log, replication, replay ----------------------------

    def attach_standby(self, addr) -> None:
        """Start replicating: every mutating op's record streams to the
        standby at ``addr`` (host:port of its ``--listen`` endpoint)
        and mutating responses wait for its append ack. A standby that
        cannot be reached leaves the authority DEGRADED (serving solo,
        flagged in /healthz) instead of failing the world's start."""
        from multiverso_tpu_torch.elastic import standby as _standby
        (host, port), = _dialer.parse_endpoints(addr)
        tmetrics.counter("elastic.standby_degraded")    # eager: shows 0
        try:
            ship = _standby.LogShipper(
                host, port, lease_s=self._lease_s,
                on_degrade=self._standby_degraded)
        except OSError as exc:
            with self._ha_lock:
                self.standby_state = "replicated"
            self._standby_degraded(f"attach to {host}:{port} failed: "
                                   f"{exc!r}")
            return
        with self._ha_lock:
            self._standby = ship
            self.standby_state = "replicated"
        Log.Info("elastic: op log replicating to standby %s:%d",
                 host, port)

    def _standby_degraded(self, why: str) -> None:
        with self._ha_lock:
            if self.standby_state != "replicated":
                return
            self.standby_state = "degraded"
        tmetrics.counter("elastic.standby_degraded").inc()
        Log.Error("elastic: standby link lost (%s) — DEGRADED TO SOLO: "
                  "the authority keeps serving unreplicated "
                  "(availability over replication); a primary death "
                  "from here is unrecoverable until a standby "
                  "re-attaches", why)

    def _log(self, kind: str, **data) -> None:
        """Append one op-log record. Caller holds the lock — the seq
        is assigned and the frame sent in mutation order, so the
        standby's replay order IS the primary's mutation order."""
        ship = self._standby
        if ship is None or not ship.alive:
            return
        seq = ship.append(kind, data)
        if seq is not None:
            self._tls.pending_seq = seq

    def _sync_standby(self) -> None:
        """Dispatch-level replication barrier: if this handler thread
        appended log records, ack the caller only after the standby
        acked the LAST of them (acks are cumulative on the ordered
        stream). Bounded: a standby that stops acking degrades the
        authority to solo instead of stalling the control plane."""
        seq = getattr(self._tls, "pending_seq", None)
        self._tls.pending_seq = None
        ship = self._standby
        if seq is None or ship is None:
            return
        if not ship.wait_acked(seq, timeout=_STANDBY_ACK_S):
            ship.close()
            self._standby_degraded(
                f"append ack for seq {seq} not within "
                f"{_STANDBY_ACK_S:g}s")

    def simulate_kill(self) -> None:
        """Chaos hook (``coord.kill``): die the way ``kill -9`` does —
        stop serving and stop shipping with NO goodbye. The standby
        must find out from its takeover lease, clients from their
        refused connects."""
        with self._ha_lock:
            ship, self._standby = self._standby, None
        if ship is not None:
            ship.abandon()
        try:
            if self._server is not None:
                self._server.shutdown()
                self._server.server_close()
        except Exception:       # pragma: no cover - teardown race
            pass

    def apply_logged(self, rec: dict) -> None:
        """Replay one op-log record's STATE EFFECT (never a rendezvous
        wait — rendezvous completions were logged as their own internal
        events). The standby applies these in seq order at takeover;
        determinism vs the live primary is pinned by ``state_digest``."""
        fn = getattr(self, f"_ap_{rec['kind']}", None)
        CHECK(fn is not None,
              f"elastic: op-log record kind {rec['kind']!r} has no "
              f"replay handler")
        with self._lock:
            fn(rec["data"])

    def replay(self, records) -> int:
        """Replay a full op log (takeover path). Holds the lock across
        the whole log so no client op can interleave mid-replay."""
        n = 0
        with self._lock:
            for rec in records:
                fn = getattr(self, f"_ap_{rec['kind']}", None)
                CHECK(fn is not None,
                      f"elastic: op-log record kind {rec['kind']!r} "
                      f"has no replay handler")
                fn(rec["data"])
                n += 1
        return n

    def rebase_clocks(self) -> None:
        """Takeover clock re-basing: every lease/ack clock restarts at
        the successor's NOW — a failover must never manufacture member
        or replica evictions out of time that passed while no authority
        was serving. Relay replicas are flagged for a fresh base: any
        unfetched mailbox bytes died with the primary (mailbox contents
        are deliberately NOT replicated — fan-out transport state, not
        durable subscription state)."""
        now = time.monotonic()
        with self._lock:
            for rec in self.members.values():
                if rec.status == "active":
                    rec.last_hb = now
            for rrec in self._replicas.values():
                if rrec.status == "live":
                    rrec.last_hb = now
                    rrec.needs_base = True
            self._cv.notify_all()

    def state_digest(self) -> str:
        """SHA-256 over the DURABLE replicated state — the replay
        determinism pin (live primary digest == replayed standby
        digest, byte-exact). Deliberately EXCLUDES: lease/ack clocks
        (re-based at takeover), rendezvous generation bookkeeping
        (``_sync_*``/``_ppull_*``/``_xchg*`` — the successor resets
        them together so every member re-rendezvouses from a common
        zero), relay mailboxes + the needs-base hint (takeover forces
        a re-base), and dedup counters (observability, not state)."""
        with self._lock:
            obj = (
                self.epoch,
                sorted((r, m.status) for r, m in self.members.items()),
                sorted(self._pending_join),
                sorted(self._pending_leave),
                repr(self._transition),
                sorted((e, sorted(d.items()))
                       for e, d in self._cut_seqs.items()),
                sorted((e, repr(m))
                       for e, m in self._manifests.items()),
                sorted((k, zlib.crc32(v))
                       for k, v in self._shards.items()),
                sorted((e, sorted(s)) for e, s in self._commits.items()),
                sorted((k, repr(a)) for k, a in self._policy_staged),
                sorted(map(repr, self._policy_seen)),
                [(r.rid, r.mode, r.token, r.ring_bytes, r.status,
                  r.acked_version)
                 for r in sorted(self._replicas.values(),
                                 key=lambda r: r.rid)],
                self._next_rid,
                self._replica_latest,
            )
        return hashlib.sha256(repr(obj).encode()).hexdigest()

    # -- state machine -------------------------------------------------------

    def _reap_expired(self, now: Optional[float] = None) -> list:
        """Mark lease-expired active members dead; returns the newly
        dead ranks. Caller holds the lock."""
        now = time.monotonic() if now is None else now
        dead = []
        for rec in self.members.values():
            if rec.expired(now):
                rec.status = "dead"
                dead.append(rec.rank)
                Log.Error("elastic: member %d lease expired (%.1fs) — "
                          "declared dead", rec.rank, rec.lease_s)
        if dead:
            tmetrics.counter("elastic.lease_expirations").inc(len(dead))
            # clock-driven mutation: logged as an internal event so the
            # standby's replay reproduces the verdict without a clock
            self._log("reap", ranks=dead)
            self._cv.notify_all()
        return dead

    def _ap_reap(self, d: dict) -> None:
        for rank in d["ranks"]:
            rec = self.members.get(int(rank))
            if rec is not None and rec.status == "active":
                rec.status = "dead"
        self._cv.notify_all()

    def _active(self) -> list:
        return sorted(r for r, m in self.members.items()
                      if m.status == "active")

    def _stage_transition(self, cause: str,
                          sync_gen: Optional[int] = None) -> Optional[dict]:
        """Compute + stage the next epoch view from pending changes.
        Caller holds the lock. None when nothing changes.

        DEATH transitions take only the survivors: pending joins (and
        drains) stay staged for the NEXT graceful sync — the survivors'
        error-path transition (engine_transition) has no shard-move
        plane, so admitting a joiner there would park it forever."""
        if self._transition is not None:
            return self._transition
        old = self._active()
        dead = sorted(r for r, m in self.members.items()
                      if m.status == "dead" and r in
                      self._transitioned_view())
        if cause == "death":
            leaving, joining = [], []
        else:
            leaving = sorted(self._pending_leave)
            joining = sorted(self._pending_join)
        new = sorted((set(old) - set(leaving)) | set(joining))
        if new == self._transitioned_view() and not dead:
            return None
        CHECK(new, "elastic: transition would empty the world")
        t = {
            "epoch": self.epoch + 1,
            "members": new,
            "old_members": self._transitioned_view(),
            "departed": sorted(set(self._transitioned_view()) - set(new)),
            "joined": sorted(set(new) - set(self._transitioned_view())),
            "dead": dead,
            "cause": cause,
            "sync_gen": sync_gen,
        }
        self._ap_stage({"t": t})
        self._log("stage", t=dict(t))
        Log.Info("elastic: staged epoch %d (%s): members %s",
                 t["epoch"], cause, new)
        return self._transition

    def _ap_stage(self, d: dict) -> None:
        t = d["t"]
        self._transition = t
        if t["cause"] != "death":
            self._pending_leave.clear()
            self._pending_join.clear()
        self._cv.notify_all()

    def _transitioned_view(self) -> list:
        """The CURRENT epoch's member list (active + the just-dead —
        i.e. everyone the current epoch believed in;
        ``reaped`` corpses belong to already-committed past epochs)."""
        return sorted(r for r, m in self.members.items()
                      if m.status in ("active", "dead"))

    def _has_pending(self) -> bool:
        return bool(self._pending_leave or self._pending_join
                    or self._transition is not None
                    or any(m.status == "dead"
                           for m in self.members.values()))

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        fn = getattr(self, f"_op_{op}", None)
        CHECK(fn is not None, f"elastic coordinator: unknown op {op!r}")
        inj = fchaos.get()
        if inj is not None:
            delay = inj.coord_delay()
            if delay > 0:
                time.sleep(delay)
            if inj.coord_kill():
                self.simulate_kill()
                raise ConnectionError(
                    "chaos coord.kill: primary hard-stopped mid-op")
        # non-idempotent ops carry (member, op_seq): a blind client
        # retry (post-send socket death, chaos retransmit) answers from
        # the response cache instead of mutating twice
        key = None
        if "op_seq" in req:
            key = (int(req.get("member", -1)), op, int(req["op_seq"]))
            with self._lock:
                hit = self._op_dedup.get(key)
                if hit is not None:
                    self._dedup_hits += 1
            if hit is not None:
                tmetrics.counter("elastic.op_dedup_hits").inc()
                return hit
        self._tls.pending_seq = None
        resp = fn(req)
        self._sync_standby()
        if key is not None:
            with self._lock:
                self._op_dedup[key] = resp
                while len(self._op_dedup) > _OP_DEDUP_CAP:
                    self._op_dedup.popitem(last=False)
        return resp

    def _op_register(self, req: dict) -> dict:
        with self._lock:
            rank = int(req["member"])
            self._ap_register({"rank": rank})
            self._log("register", rank=rank)
            return {"epoch": self.epoch, "members": self._active()}

    def _ap_register(self, d: dict) -> None:
        rank = int(d["rank"])
        rec = self.members.get(rank)
        if rec is None or rec.status in ("left", "dead"):
            self.members[rank] = _MemberRec(rank, self._lease_s)
        else:
            rec.last_hb = time.monotonic()
        self._cv.notify_all()

    def _op_hb(self, req: dict) -> dict:
        # fleet rollups piggyback on the beats that already
        # flow — fold OUTSIDE the membership lock (the accumulator has
        # its own, and a slow decode must not stall the authority)
        blob = req.get("rollup")
        if blob:
            tfleet.ingest(blob)
        with self._lock:
            rec = self.members.get(int(req["member"]))
            if rec is not None and rec.status not in ("dead",):
                rec.last_hb = time.monotonic()
                self._log("hb", rank=rec.rank)
            return {"epoch": self.epoch, "pending": self._has_pending()}

    def _ap_hb(self, d: dict) -> None:
        rec = self.members.get(int(d["rank"]))
        if rec is not None and rec.status not in ("dead",):
            rec.last_hb = time.monotonic()

    def _op_leave(self, req: dict) -> dict:
        with self._lock:
            rank = int(req["member"])
            CHECK(rank != 0, "elastic: the coordinator rank (0) cannot "
                             "drain — it hosts the membership authority")
            rec = self.members.get(rank)
            CHECK(rec is not None and rec.status == "active",
                  f"elastic: leave from non-active member {rank}")
            if rank not in self._pending_leave:
                self._pending_leave.add(rank)
                self._log("leave", rank=rank)
            self._cv.notify_all()
            return {"epoch": self.epoch}

    def _ap_leave(self, d: dict) -> None:
        self._pending_leave.add(int(d["rank"]))
        self._cv.notify_all()

    def _op_join(self, req: dict) -> dict:
        with self._lock:
            rank = int(req["member"])
            rec = self.members.get(rank)
            staged_departing = (self._transition is not None
                                and rank in self._transition["departed"])
            CHECK(rec is None or rec.status == "left" or staged_departing,
                  f"elastic: join from member {rank} in state "
                  f"{rec.status if rec else '?'}")
            # a re-join racing its own drain's install is legal: the
            # drain is staged/committing, the join lands in the NEXT
            # transition's pending set either way
            if rank not in self._pending_join:
                self._pending_join.add(rank)
                self._log("join", rank=rank)
            self._cv.notify_all()
            return {"epoch": self.epoch}

    def _ap_join(self, d: dict) -> None:
        self._pending_join.add(int(d["rank"]))
        self._cv.notify_all()

    def _op_sync(self, req: dict) -> dict:
        """Lockstep sync rendezvous: a member's n-th call joins
        generation n (server-assigned — see _sync_counts); the FIRST
        complete rendezvous computes the answer (stage a transition or
        not), later arrivals read it. Waits are lease-aware: a member
        dying mid-rendezvous converts the sync into a death transition
        instead of a hang."""
        member = int(req["member"])
        timeout = float(req.get("timeout") or 300.0)
        deadline = time.monotonic() + timeout
        with self._lock:
            gen = self._sync_counts.get(member, 0) + 1
            self._sync_counts[member] = gen
            self._sync_arrived.setdefault(gen, set()).add(member)
            self._cv.notify_all()
            while True:
                if gen in self._sync_answer:
                    ans = self._sync_answer[gen]
                    # the last reader tidies the bookkeeping
                    self._sync_arrived[gen].discard(member)
                    if not self._sync_arrived[gen]:
                        del self._sync_arrived[gen]
                        del self._sync_answer[gen]
                    return {"transition": ans, "epoch": self.epoch}
                self._reap_expired()
                expected = set(self._active())
                if expected and expected <= self._sync_arrived[gen]:
                    t = None
                    if self._has_pending():
                        t = self._stage_transition(
                            self._transition["cause"]
                            if self._transition else "graceful",
                            sync_gen=gen)
                    self._sync_answer[gen] = t
                    self._cv.notify_all()
                    continue
                if time.monotonic() > deadline:
                    raise TransientError(
                        f"elastic sync rendezvous {gen} timed out "
                        f"(arrived {sorted(self._sync_arrived[gen])}, "
                        f"expected {sorted(expected)})")
                self._cv.wait(0.1)

    def _op_dead_check(self, req: dict) -> dict:
        """A member's collective deadline fired: block (briefly) until
        either a lease verdict arrives — some member is dead, a shrink
        transition is staged and returned — or every lease proves fresh
        (the deadline was a genuine divergence: transition None)."""
        timeout = float(req.get("timeout") or self._lease_s + 2.0)
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                self._reap_expired()
                if any(m.status == "dead" for m in self.members.values()):
                    t = self._stage_transition("death")
                    return {"transition": t, "epoch": self.epoch}
                if self._transition is not None:
                    return {"transition": self._transition,
                            "epoch": self.epoch}
                if time.monotonic() > deadline:
                    return {"transition": None, "epoch": self.epoch}
                self._cv.wait(0.1)

    def _op_cut(self, req: dict) -> dict:
        """Fence rendezvous: every old-view member that is ALIVE reports
        the stream SEQ it fenced at; they must agree (the lockstep
        window-stream cut). Dead members are excused — their fence is
        the point the survivors' deadline fired at."""
        member, seq = int(req["member"]), int(req["seq"])
        epoch = int(req["epoch"])
        timeout = float(req.get("timeout") or 300.0)
        deadline = time.monotonic() + timeout
        with self._lock:
            seqs = self._cut_seqs.setdefault(epoch, {})
            if member in seqs:
                CHECK(seqs[member] == seq,
                      f"elastic: member {member} re-cut at a different "
                      f"seq ({seqs[member]} vs {seq})")
            else:
                self._log("cut", epoch=epoch, member=member, seq=seq)
            seqs[member] = seq
            self._cv.notify_all()
            while True:
                self._reap_expired()
                t = self._transition
                CHECK(t is not None and t["epoch"] == epoch,
                      f"elastic: cut for unstaged epoch {epoch}")
                expected = {r for r in t["old_members"]
                            if self.members[r].status != "dead"}
                if expected <= set(seqs):
                    got = {seqs[r] for r in expected}
                    CHECK(len(got) == 1,
                          f"elastic: cut SEQs diverge across members: "
                          f"{ {r: seqs[r] for r in sorted(expected)} } — "
                          f"the fence must land at one lockstep stream "
                          f"position")
                    return {"cut_seq": seqs[member], "epoch": epoch}
                if time.monotonic() > deadline:
                    raise TransientError(
                        f"elastic cut rendezvous timed out (arrived "
                        f"{sorted(seqs)}, expected {sorted(expected)})")
                self._cv.wait(0.1)

    def _ap_cut(self, d: dict) -> None:
        self._cut_seqs.setdefault(
            int(d["epoch"]), {})[int(d["member"])] = int(d["seq"])
        self._cv.notify_all()

    def _op_manifest(self, req: dict) -> dict:
        with self._lock:
            epoch = int(req["epoch"])
            if epoch not in self._manifests:      # idempotent (retries)
                self._manifests[epoch] = req["manifest"]
                self._log("manifest", epoch=epoch,
                          manifest=req["manifest"])
                self._cv.notify_all()
            return {"ok": True}

    def _ap_manifest(self, d: dict) -> None:
        self._manifests.setdefault(int(d["epoch"]), d["manifest"])
        self._cv.notify_all()

    def _op_manifest_get(self, req: dict) -> dict:
        epoch = int(req["epoch"])
        deadline = time.monotonic() + float(req.get("timeout") or 300.0)
        with self._lock:
            while epoch not in self._manifests:
                if time.monotonic() > deadline:
                    raise TransientError(
                        f"elastic: manifest for epoch {epoch} never "
                        f"published")
                self._cv.wait(0.1)
            return {"manifest": self._manifests[epoch]}

    def _op_shard_put(self, req: dict) -> dict:
        key = (int(req["epoch"]), int(req["table_id"]), int(req["shard"]))
        with self._lock:
            dup = key in self._shards
            if dup:
                # at-most-once shard delivery: a retried PUT (transient
                # control fault, chaos membership site) answers from
                # the record instead of re-storing
                self._shard_dups += 1
                tmetrics.counter("elastic.shard_dedup_hits").inc()
            else:
                self._shards[key] = req["blob"]
                self._log("shard_put", key=list(key), blob=req["blob"])
                self._cv.notify_all()
            return {"ok": True, "dup": dup}

    def _ap_shard_put(self, d: dict) -> None:
        self._shards[tuple(d["key"])] = d["blob"]
        self._cv.notify_all()

    def _op_shard_get(self, req: dict) -> dict:
        key = (int(req["epoch"]), int(req["table_id"]), int(req["shard"]))
        deadline = time.monotonic() + float(req.get("timeout") or 300.0)
        with self._lock:
            while key not in self._shards:
                if time.monotonic() > deadline:
                    raise TransientError(
                        f"elastic: shard {key} never published")
                self._cv.wait(0.1)
            return {"blob": self._shards[key]}

    def _op_commit(self, req: dict) -> dict:
        """NEW-view rendezvous: when every member of the staged view has
        committed, the epoch becomes current and the shard store is
        freed."""
        member, epoch = int(req["member"]), int(req["epoch"])
        deadline = time.monotonic() + float(req.get("timeout") or 300.0)
        with self._lock:
            if self.epoch >= epoch:     # raced past the install: done
                return {"epoch": self.epoch, "members": self._active()}
            t = self._transition
            CHECK(t is not None and t["epoch"] == epoch,
                  f"elastic: commit for unstaged epoch {epoch} "
                  f"(current {self.epoch})")
            arrived = self._commits.setdefault(epoch, set())
            if member not in arrived:
                arrived.add(member)
                self._log("commit_arrive", epoch=epoch, member=member)
            self._cv.notify_all()
            while True:
                if self.epoch >= epoch:
                    return {"epoch": self.epoch,
                            "members": self._active()}
                if set(t["members"]) <= self._commits.get(epoch, set()):
                    self._install(t)
                    continue
                if time.monotonic() > deadline:
                    raise TransientError(
                        f"elastic commit rendezvous timed out "
                        f"(committed "
                        f"{sorted(self._commits.get(epoch, set()))}, "
                        f"expected {t['members']})")
                self._cv.wait(0.1)

    def _ap_commit_arrive(self, d: dict) -> None:
        self._commits.setdefault(
            int(d["epoch"]), set()).add(int(d["member"]))
        self._cv.notify_all()

    def _install(self, t: dict) -> None:
        """Make the staged transition current. Caller holds the lock."""
        self._log("install", t=dict(t))
        self._ap_install({"t": t})

    def _ap_install(self, d: dict) -> None:
        t = d["t"]
        for r in t["departed"]:
            rec = self.members.get(r)
            if rec is None:
                continue
            # dead members are REAPED at install: the committed epoch
            # excludes them, so they must stop registering as pending
            # state — otherwise every later sync re-stages a spurious
            # epoch and every group exchange re-raises membership
            rec.status = "reaped" if rec.status == "dead" else "left"
        for r in t["joined"]:
            rec = self.members.get(r)
            if rec is None:
                self.members[r] = _MemberRec(r, self._lease_s)
            else:
                rec.status = "active"
                rec.last_hb = time.monotonic()
            # re-align the joiner's sync generation with the rendezvous
            # that admitted it: its next sync joins the live members'
            # next generation
            gen = t.get("sync_gen")
            if gen is None:
                gen = max([self._sync_counts.get(m, 0)
                           for m in t["members"] if m != r] or [0])
            self._sync_counts[r] = gen
        self.epoch = t["epoch"]
        self._transition = None
        # free the move plane: committed shards are installed everywhere
        self._shards = {k: v for k, v in self._shards.items()
                        if k[0] > self.epoch}
        self._manifests = {e: m for e, m in self._manifests.items()
                          if e > self.epoch}
        self._cut_seqs.pop(self.epoch, None)
        self._commits.pop(self.epoch, None)
        # the policy control plane's rendezvous era resets
        # with the epoch: pull generations re-align so a re-admitted
        # member rendezvouses with the survivors from a common zero
        # (the sync-counter re-alignment argument; without this the
        # survivors' counters race ahead while a drained member is out
        # and every post-rejoin pull times out forever), and actions
        # staged under the OLD view are dropped as stale evidence —
        # their (epoch, id) dedup keys remain, so a retransmit cannot
        # resurrect them
        self._ppull_counts.clear()
        self._ppull_arrived.clear()
        self._ppull_answer.clear()
        self._policy_staged = []
        tmetrics.gauge("elastic.epoch").set(self.epoch)
        tmetrics.gauge("elastic.members").set(len(self._active()))
        self._cv.notify_all()
        Log.Info("elastic: epoch %d committed — members %s",
                 self.epoch, self._active())

    def _op_joiner_wait(self, req: dict) -> dict:
        """Joiner parks until a staged transition admits it AND its
        manifest is published (the owners finished their shard PUTs'
        inventory declaration)."""
        member = int(req["member"])
        deadline = time.monotonic() + float(req.get("timeout") or 300.0)
        with self._lock:
            while True:
                t = self._transition
                if (t is not None and member in t["joined"]
                        and t["epoch"] in self._manifests):
                    return {"transition": t,
                            "manifest": self._manifests[t["epoch"]]}
                if time.monotonic() > deadline:
                    raise TransientError(
                        f"elastic: joiner {member} admission never "
                        f"staged")
                self._cv.wait(0.1)

    def _op_xchg(self, req: dict) -> dict:
        """Group allgather-bytes rendezvous among the CURRENT view:
        blocks until every member posted for (epoch, key, idx), then
        answers each with all blobs in member order. Lease-aware: a
        member dying mid-exchange fails the round with a typed
        membership error instead of hanging the survivors."""
        member, epoch = int(req["member"]), int(req["epoch"])
        key = (epoch, req["key"], int(req["idx"]))
        timeout = float(req.get("timeout") or 300.0)
        deadline = time.monotonic() + timeout
        with self._lock:
            CHECK(epoch == self.epoch,
                  f"elastic: exchange for epoch {epoch} but current is "
                  f"{self.epoch} (stale member?)")
            slot = self._xchg.setdefault(key, {})
            slot[member] = req["blob"]
            self._cv.notify_all()
            while True:
                done = self._xchg_results.get(key)
                if done is not None:
                    blobs, members, unread = done
                    unread.discard(member)
                    if not unread:
                        self._xchg_results.pop(key, None)
                        self._xchg.pop(key, None)
                    return {"blobs": list(blobs), "members": list(members)}
                expected = self._active()
                if set(expected) <= set(slot):
                    self._xchg_results[key] = (
                        tuple(slot[r] for r in expected), tuple(expected),
                        set(expected))
                    self._cv.notify_all()
                    continue
                newly_dead = self._reap_expired()
                if newly_dead or any(
                        m.status == "dead"
                        for m in self.members.values()):
                    self._xchg.pop(key, None)
                    self._xchg_results.pop(key, None)
                    t = self._stage_transition("death")
                    raise MembershipChanged(
                        f"group exchange {req['key']!r}",
                        epoch=t["epoch"] if t else self.epoch,
                        members=t["members"] if t else self._active(),
                        departed=t["departed"] if t else (),
                        joined=t["joined"] if t else ())
                if time.monotonic() > deadline:
                    raise TransientError(
                        f"elastic group exchange {key} timed out "
                        f"(posted {sorted(slot)}, expected {expected})")
                self._cv.wait(0.05)

    def _op_gbar(self, req: dict) -> dict:
        """Group barrier = a degenerate exchange of empty blobs."""
        req = dict(req, blob=b"", key=("BAR", req.get("name", "")))
        self._op_xchg(req)
        return {"ok": True}

    def _op_state(self, req: dict) -> dict:
        with self._lock:
            self._reap_expired()
            return {
                "epoch": self.epoch,
                "members": self._active(),
                "statuses": {r: m.status
                             for r, m in sorted(self.members.items())},
                "pending": self._has_pending(),
                "staged": (dict(self._transition)
                           if self._transition else None),
                "shard_frames": len(self._shards),
                "shard_dedup_hits": self._shard_dups,
                "policy_staged": len(self._policy_staged),
                "policy_dedup_hits": self._policy_dups,
                "replicas": {r.rid: r.status
                             for r in self._replicas.values()},
                "standby": self.standby_state,
                "op_dedup_hits": self._dedup_hits,
            }

    # -- policy-plane control ops --------------------------------------------

    def _op_policy_put(self, req: dict) -> dict:
        """Stage one policy action (routing-map install / tune / drain
        request), AT-MOST-ONCE keyed by ``(epoch, action id)``: the
        SPMD ranks derive ids from content, so N ranks proposing the
        same correction — or a chaos-rehearsed duplicate delivery —
        stage it exactly once; a re-delivery after the action was
        pulled/installed answers from the seen-set instead of
        re-staging (the shard_put posture)."""
        with self._lock:
            action = dict(req["action"])
            key = (int(req.get("epoch", 0)), str(action["id"]))
            dup = key in self._policy_seen
            if dup:
                self._policy_dups += 1
                tmetrics.counter("policy.stage_dedup_hits").inc()
            else:
                self._policy_seen.add(key)
                # staged alongside its dedup key: a kill-vetoed batch
                # un-sees exactly the keys it staged under
                self._policy_staged.append((key, action))
                self._log("policy_put", key=list(key), action=action)
                self._cv.notify_all()
            return {"ok": True, "dup": dup,
                    "staged": len(self._policy_staged)}

    def _ap_policy_put(self, d: dict) -> None:
        key = tuple(d["key"])
        if key not in self._policy_seen:
            self._policy_seen.add(key)
            self._policy_staged.append((key, d["action"]))
        self._cv.notify_all()

    def _op_policy_pull(self, req: dict) -> dict:
        """Rendezvous drain of the staged policy actions: a member's
        n-th pull joins generation n (server-assigned, the sync
        pattern); when all ``world`` members arrived, the FIRST
        complete rendezvous snapshots the staged queue — sorted by
        action id, so every member applies the identical list in the
        identical order — and clears it; later arrivals read the same
        answer. This is what makes a policy install rank-agreed: every
        rank installs exactly this list at its own lockstep
        MV_PolicySync position.

        The answer also carries the AGREED kill-switch verdict:
        ``acting`` is True only when EVERY arrival declared itself
        armed — one disarmed rank vetoes the whole batch (each rank
        then discards the identical list instead of half of the world
        installing it, which would diverge the verb streams).

        A TIMED-OUT waiter withdraws its arrival and rolls its
        generation counter back, so (a) a later completer cannot count
        the ghost and consume the staged queue into an answer the
        ghost never reads, and (b) the member's retry re-joins the
        SAME generation its peers still expect it at."""
        member = int(req["member"])
        world = int(req.get("world", 1))
        armed = bool(req.get("armed", True))
        deadline = time.monotonic() + float(req.get("timeout") or 60.0)
        with self._lock:
            gen = self._ppull_counts.get(member, 0) + 1
            self._ppull_counts[member] = gen
            self._ppull_arrived.setdefault(gen, {})[member] = armed
            self._cv.notify_all()
            while True:
                if gen in self._ppull_answer:
                    acts, acting = self._ppull_answer[gen]
                    arr = self._ppull_arrived.get(gen, {})
                    arr.pop(member, None)
                    if not arr:
                        self._ppull_arrived.pop(gen, None)
                        del self._ppull_answer[gen]
                    return {"actions": list(acts), "acting": acting}
                # re-register each iteration: an epoch transition's
                # era reset (_install) may have cleared the slot — the
                # wait then times out typed instead of KeyError-ing
                arr = self._ppull_arrived.setdefault(gen, {})
                arr.setdefault(member, armed)
                if len(arr) >= world:
                    staged = sorted(self._policy_staged,
                                    key=lambda ka:
                                    str(ka[1].get("id", "")))
                    acting = all(arr.values())
                    # the drain is the rendezvous' one durable effect:
                    # logged by the exact keys it consumed so replay
                    # reproduces it without re-running the rendezvous
                    self._ap_policy_drain({"keys": [list(k) for
                                                    k, _a in staged],
                                           "acting": acting})
                    self._log("policy_drain",
                              keys=[list(k) for k, _a in staged],
                              acting=acting)
                    self._ppull_answer[gen] = (
                        [a for _k, a in staged], acting)
                    self._cv.notify_all()
                    continue
                if time.monotonic() > deadline:
                    arr.pop(member, None)
                    if not arr:
                        self._ppull_arrived.pop(gen, None)
                    if self._ppull_counts.get(member) == gen:
                        self._ppull_counts[member] = gen - 1
                    raise TransientError(
                        f"policy pull rendezvous {gen} timed out "
                        f"(arrived {sorted(arr)}, world {world})")
                self._cv.wait(0.1)

    def _ap_policy_drain(self, d: dict) -> None:
        keys = {tuple(k) for k in d["keys"]}
        self._policy_staged = [ka for ka in self._policy_staged
                               if ka[0] not in keys]
        if not d["acting"]:
            # a vetoed batch was never installed: forget its dedup
            # keys so the same correction can re-stage after the
            # world re-arms (the keys exist to stop duplicate
            # DELIVERIES of one proposal, not to wedge a discarded one)
            for k in keys:
                self._policy_seen.discard(k)
        self._cv.notify_all()

    # -- replica subscriptions (role=replica) -------------------------------

    def _reap_replicas(self, now: Optional[float] = None) -> list:
        """Mark lease-expired live replicas dead; returns newly dead
        rids. Caller holds the lock. Unlike member reaping this stages
        NO transition — replicas are not epoch members; the publisher's
        next fan-out tick evicts the subscription."""
        now = time.monotonic() if now is None else now
        dead = []
        for rec in self._replicas.values():
            if rec.expired(now):
                rec.status = "dead"
                rec.mailbox = []
                dead.append(rec.rid)
                Log.Error("elastic: replica %d lease expired (%.1fs) — "
                          "declared dead", rec.rid, rec.lease_s)
        if dead:
            tmetrics.counter("replica.lease_expirations").inc(len(dead))
            for rid in dead:
                tfleet.forget(f"replica:{rid}")
            self._log("replica_reap", rids=dead)
            self._cv.notify_all()
        return dead

    def _ap_replica_reap(self, d: dict) -> None:
        for rid in d["rids"]:
            rec = self._replicas.get(int(rid))
            if rec is not None and rec.status == "live":
                rec.status = "dead"
                rec.mailbox = []
                tfleet.forget(f"replica:{rec.rid}")
        self._cv.notify_all()

    def _op_replica_join(self, req: dict) -> dict:
        with self._lock:
            rid = self._next_rid
            d = {"rid": rid, "mode": str(req.get("mode", "relay")),
                 "token": str(req.get("token", "")),
                 "ring_bytes": int(req.get("ring_bytes", 0)),
                 "lease_s": float(req.get("lease_s", 5.0))}
            self._ap_replica_join(d)
            self._log("replica_join", **d)
            Log.Info("elastic: replica %d joined (mode=%s, lease %.1fs)",
                     rid, d["mode"], d["lease_s"])
            return {"rid": rid, "latest": self._replica_latest}

    def _ap_replica_join(self, d: dict) -> None:
        rid = int(d["rid"])
        rec = _ReplicaRec(rid, d["mode"], d["token"], d["ring_bytes"],
                          d["lease_s"])
        self._replicas[rid] = rec
        self._next_rid = max(self._next_rid, rid + 1)
        self._cv.notify_all()

    def _op_replica_hb(self, req: dict) -> dict:
        with self._lock:
            rec = self._replicas.get(int(req["rid"]))
            if rec is None or rec.status != "live":
                return {"evicted": True, "latest": self._replica_latest}
            rec.last_hb = time.monotonic()
            self._log("replica_hb", rid=rec.rid)
            resp = {"evicted": False, "latest": self._replica_latest,
                    "acked": rec.acked_version}
        # the reader's fleet rollup rides its lease beat;
        # folded outside the lock, and only for LIVE subscriptions — a
        # forgotten (evicted) member must not resurrect in /fleet
        blob = req.get("rollup")
        if blob:
            tfleet.ingest(blob)
        return resp

    def _ap_replica_hb(self, d: dict) -> None:
        rec = self._replicas.get(int(d["rid"]))
        if rec is not None and rec.status == "live":
            rec.last_hb = time.monotonic()

    def _op_replica_ack(self, req: dict) -> dict:
        with self._lock:
            rec = self._replicas.get(int(req["rid"]))
            if rec is None or rec.status != "live":
                return {"evicted": True}
            self._ap_replica_ack({"rid": rec.rid,
                                  "version": int(req["version"])})
            self._log("replica_ack", rid=rec.rid,
                      version=int(req["version"]))
            return {"evicted": False}

    def _ap_replica_ack(self, d: dict) -> None:
        rec = self._replicas.get(int(d["rid"]))
        if rec is None or rec.status != "live":
            return
        rec.last_hb = time.monotonic()
        rec.acked_version = max(rec.acked_version, int(d["version"]))
        rec.needs_base = False

    def _op_replica_roster(self, req: dict) -> dict:
        """Publisher-side poll: announce the newest published version,
        reap expired replica leases, and return the full subscription
        roster (dead/evicted included — /healthz names departures)."""
        blob = req.get("rollup")
        if blob:
            # the trainer-side publisher's own rollup rides its roster
            # poll — the one control message a replica-plane
            # trainer is guaranteed to send even outside elastic runs
            tfleet.ingest(blob)
        with self._lock:
            if "latest" in req and req["latest"] is not None:
                v = int(req["latest"])
                if v > self._replica_latest:
                    self._replica_latest = v
                    # the roster's one durable side effect (the version
                    # replica heartbeats answer lag from)
                    self._log("latest", version=v)
            self._reap_replicas()
            return {"replicas": [
                {"rid": r.rid, "mode": r.mode, "token": r.token,
                 "ring_bytes": r.ring_bytes, "status": r.status,
                 "acked": r.acked_version, "needs_base": r.needs_base,
                 "mailbox_depth": len(r.mailbox),
                 # seconds since the subscription's last fleet rollup
                 # landed (None until one has) — /healthz's stale-warn
                 "rollup_age_s": tfleet.rollup_age_s(f"replica:{r.rid}")}
                for r in sorted(self._replicas.values(),
                                key=lambda r: r.rid)]}

    def _ap_latest(self, d: dict) -> None:
        self._replica_latest = max(self._replica_latest,
                                   int(d["version"]))

    def _op_replica_evict(self, req: dict) -> dict:
        with self._lock:
            rec = self._replicas.get(int(req["rid"]))
            if rec is not None and rec.status != "evicted":
                self._ap_replica_evict({"rid": rec.rid})
                self._log("replica_evict", rid=rec.rid)
                Log.Info("elastic: replica %d subscription evicted",
                         rec.rid)
            return {"ok": True}

    def _ap_replica_evict(self, d: dict) -> None:
        rec = self._replicas.get(int(d["rid"]))
        if rec is not None and rec.status != "evicted":
            rec.status = "evicted"
            rec.mailbox = []
            tfleet.forget(f"replica:{rec.rid}")
        self._cv.notify_all()

    def _op_replica_put(self, req: dict) -> dict:
        """Relay-mode fan-out: park one (version, blob) in the
        replica's mailbox. Overflow drops the queue and flags a fresh
        base — a laggard must resync, never backpressure the
        trainer."""
        with self._lock:
            rec = self._replicas.get(int(req["rid"]))
            if rec is None or rec.status != "live":
                return {"evicted": True}
            # logged WITHOUT the blob: mailbox bytes are fan-out
            # transport state, not durable subscription state — a
            # successor re-bases the replica instead (rebase_clocks)
            self._log("replica_put", rid=rec.rid,
                      version=int(req["version"]))
            if len(rec.mailbox) >= _REPLICA_MAILBOX_CAP:
                rec.mailbox = []
                rec.needs_base = True
                tmetrics.counter("replica.mailbox_overflows").inc()
                return {"evicted": False, "overflow": True}
            rec.mailbox.append((int(req["version"]), req["blob"]))
            self._cv.notify_all()
            return {"evicted": False, "overflow": False}

    def _ap_replica_put(self, d: dict) -> None:
        rec = self._replicas.get(int(d["rid"]))
        if rec is not None and rec.status == "live":
            # the blob was not replicated: the replayed subscription
            # needs a fresh base from the successor's publisher
            rec.needs_base = True

    def _op_replica_fetch(self, req: dict) -> dict:
        """Relay-mode replica side: block until the mailbox holds a
        blob (a fetch is also a liveness signal — it refreshes the
        lease while parked). Times out typed like every rendezvous."""
        rid = int(req["rid"])
        deadline = time.monotonic() + float(req.get("timeout") or 60.0)
        with self._lock:
            while True:
                rec = self._replicas.get(rid)
                if rec is None or rec.status != "live":
                    return {"evicted": True}
                rec.last_hb = time.monotonic()
                if rec.mailbox:
                    version, blob = rec.mailbox.pop(0)
                    return {"evicted": False, "version": version,
                            "blob": blob}
                if time.monotonic() > deadline:
                    raise TransientError(
                        f"replica {rid} fetch: nothing published within "
                        f"the timeout")
                self._cv.wait(0.1)


#: ops safe to blind-retry after a POST-SEND failure (the request may
#: or may not have been served): pure reads, lease refreshes, and the
#: rendezvous reads whose server-side generations self-heal — against
#: a LIVE server a post-send socket death is vanishingly rare, and
#: against a dead primary the retry lands on the successor, whose
#: rendezvous counters all reset together (every member re-rendezvouses
#: from a common zero). ``replica_fetch`` is deliberately absent: a
#: popped-but-undelivered mailbox blob must not turn into a silent
#: version gap — its caller's own loop re-fetches.
_RETRYABLE_OPS = frozenset({
    "register", "hb", "state", "dead_check", "sync", "policy_pull",
    "manifest", "manifest_get", "shard_get", "joiner_wait",
    "replica_hb", "replica_ack", "replica_roster", "replica_evict"})

#: non-idempotent mutators: the client stamps a monotonically
#: increasing ``op_seq`` so the coordinator's (member, op, op_seq)
#: response cache makes a blind retry apply-once
_DEDUP_OPS = frozenset({
    "commit", "leave", "join", "cut", "shard_put", "policy_put",
    "replica_put"})

#: post-send retry budget per call (connect-phase failures are the
#: dialer's business and don't count against this)
_POST_SEND_RETRIES = 2


class MemberClient:
    """One member's RPC client to the authority. Fresh socket per call
    (control-plane rates are low; this keeps concurrent callers —
    heartbeat thread, engine thread, app thread — trivially isolated).
    Ops the chaos ``membership.*`` sites target retry on
    TransientError.

    Connects go through the shared
    :class:`~multiverso_tpu_torch.elastic.dialer.Dialer` over an ORDERED
    endpoint list (primary first, successors after): a dead primary is
    a failover, not an error. ``failover_gen`` bumps on every
    endpoint change so consumers (the publisher's fan-out tick) can
    reset per-endpoint state."""

    def __init__(self, host: str, port: int, member: int,
                 lease_s: float, endpoints=None):
        eps = (_dialer.parse_endpoints(endpoints) if endpoints
               else [(host, int(port))])
        self._dialer = _dialer.Dialer(eps, what=f"member{member}")
        self.member = int(member)
        self.lease_s = float(lease_s)
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._xchg_idx: Dict = {}
        self._xchg_lock = threading.Lock()
        self._seq_lock = threading.Lock()
        self._op_seq = 0

    @property
    def host(self) -> str:
        return self._dialer.active[0]

    @property
    def port(self) -> int:
        return self._dialer.active[1]

    @property
    def endpoints(self):
        return list(self._dialer.endpoints)

    @property
    def failover_gen(self) -> int:
        return self._dialer.failover_gen

    def _next_op_seq(self) -> int:
        with self._seq_lock:
            self._op_seq += 1
            return self._op_seq

    def call(self, op: str, timeout: Optional[float] = None,
             **kw) -> dict:
        """One RPC. ``timeout`` is forwarded as the SERVER-side
        rendezvous bound; the socket waits 10s past it so the server's
        typed answer (TransientError/MembershipChanged with diagnostic
        membership detail) always wins over a raw socket timeout.

        Connect-phase failures retry/fail over inside the dialer for
        EVERY op (the request was never delivered — always safe).
        Post-send socket deaths blind-retry only for ``_RETRYABLE_OPS``
        (idempotent) and ``_DEDUP_OPS`` (apply-once via op_seq), within
        ``_POST_SEND_RETRIES``."""
        req = dict(kw, op=op, member=self.member)
        bound = float(timeout if timeout is not None
                      else kw.get("timeout") or 300.0)
        req.setdefault("timeout", bound)
        if op in _DEDUP_OPS and "op_seq" not in req:
            req["op_seq"] = self._next_op_seq()
        budget = (_POST_SEND_RETRIES
                  if op in _RETRYABLE_OPS or op in _DEDUP_OPS else 0)
        attempt = 0
        while True:
            sock = self._dialer.dial(
                deadline_s=min(bound, self._dialer.deadline_s))
            try:
                with sock:
                    sock.settimeout(bound + 10.0)
                    _send_frame(sock, req)
                    resp = _recv_frame(sock)
                break
            except (ConnectionError, OSError):
                self._dialer.mark_failed()
                if attempt >= budget:
                    raise
                attempt += 1
                tmetrics.counter("failsafe.retries").inc()
                time.sleep(0.05 * attempt)
        err = resp.get("err") if isinstance(resp, dict) else None
        if err == "MembershipChanged":
            raise MembershipChanged(resp.get("msg", "coordinator"),
                                    epoch=resp.get("epoch", -1),
                                    members=resp.get("members", ()),
                                    departed=resp.get("departed", ()),
                                    joined=resp.get("joined", ()))
        if err == "TransientError":
            raise TransientError(resp["msg"])
        if err is not None:
            # formatted on the error path only: a reply may carry a shard
            # of hundreds of MB (the JAX package formats every reply)
            CHECK(False, f"elastic coordinator error: {resp}")
        return resp

    def call_retry(self, op: str, attempts: int = 3, **kw) -> dict:
        """RPC with transient retries — connection refused while the
        coordinator comes up, chaos-injected control faults."""
        last: Optional[Exception] = None
        for i in range(attempts):
            try:
                return self.call(op, **kw)
            except (TransientError, ConnectionError, OSError) as exc:
                last = exc
                tmetrics.counter("failsafe.retries").inc()
                time.sleep(0.05 * (1 + i))
        raise last  # type: ignore[misc]

    # -- heartbeats ---------------------------------------------------------

    def start_heartbeats(self) -> None:
        if self._hb_thread is not None:
            return
        period = max(0.05, self.lease_s / 3.0)

        def _beat():
            while not self._hb_stop.wait(period):
                try:
                    # this rank's fleet rollup rides the beat.
                    # Telemetry must never cost the lease — a rollup
                    # failure degrades to an empty blob.
                    try:
                        rollup = tfleet.encode_rollup(tfleet.build_rollup(
                            f"rank{self.member}", "trainer"))
                    except Exception:
                        rollup = b""
                    self.call("hb", rollup=rollup, timeout=5.0)
                except Exception:
                    # a missed beat is what the lease machinery exists
                    # to notice — nothing useful to do locally
                    pass

        self._hb_thread = threading.Thread(
            target=_beat, name=f"mv-elastic-hb-{self.member}",
            daemon=True)
        self._hb_thread.start()

    def stop_heartbeats(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None

    # -- group transport ----------------------------------------------------

    def group_exchange(self, epoch: int, blob: bytes, key,
                       timeout: float) -> list:
        """Allgather-bytes among the epoch's members (relayed). Round
        indices are scoped PER (epoch, key): lockstep members advance
        each key's index identically, and every epoch starts every key
        at round 0 on every member — a re-admitted member (whose
        counters froze while it was departed) therefore agrees with
        the survivors from the new epoch's first round."""
        with self._xchg_lock:
            k = (epoch, key)
            idx = self._xchg_idx.get(k, 0)
            self._xchg_idx[k] = idx + 1
        resp = self.call("xchg", epoch=epoch, key=repr(key), idx=idx,
                         blob=blob, timeout=timeout)
        return resp["blobs"]

    def group_barrier(self, epoch: int, name: str,
                      timeout: float) -> None:
        with self._xchg_lock:
            k = (epoch, "BAR", name)
            idx = self._xchg_idx.get(k, 0)
            self._xchg_idx[k] = idx + 1
        self.call("gbar", epoch=epoch, name=name, idx=idx,
                  timeout=timeout)
