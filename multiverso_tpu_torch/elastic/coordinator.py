"""Membership coordinator (the rank-0 authority) and the member client.

The port's own copy of the membership half of
``multiverso_tpu/elastic/coordinator.py``. ONE authority, hosted by boot
rank 0, owns an **epoch-numbered view**: the set of live members and the
shard->owner map. Every membership change is a staged transition applied
at a fenced stream cut, never an in-place mutation.

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

Each ``_op_*`` handler keeps its state mutation in an ``_ap_*`` method, as
in the JAX package. The replica plane's ``replica_*`` ops, the policy
plane's ``policy_*`` ops and the coordinator's standby replication are not
ported: such an op fails with an error that names the missing plane.
Non-idempotent ops carry a ``(member, op_seq)`` tag, so a blind client
retry applies once.
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


#: (member, op, op_seq) -> response cache depth for non-idempotent op
#: dedup — far above any in-flight retry window; evicted FIFO
_OP_DEDUP_CAP = 512


#: ops of planes this build does not have: op prefix -> plane
_UNPORTED_OPS = (("policy_", "policy"), ("replica_", "replica"))


class Coordinator:
    """The rank-0 membership authority. Thread-per-connection TCP server;
    all state under one lock and condition (rendezvous ops wait on it).
    Never issues collectives itself: it is pure control plane."""

    def __init__(self, host: str, port: int, lease_s: float,
                 serve: bool = True):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._lease_s = float(lease_s)
        self.epoch = 0
        self.members: Dict[int, _MemberRec] = {}
        self._pending_join: set = set()
        self._pending_leave: set = set()
        #: staged (not yet committed) transition, or None
        self._transition: Optional[dict] = None
        #: sync rendezvous bookkeeping. Generations are SERVER-assigned
        #: (a member's n-th sync call joins generation n): a re-admitted
        #: member's counter re-aligns to the admitting generation at
        #: install, so rejoined worlds rendezvous without the members
        #: agreeing on call counts out of band.
        self._sync_counts: Dict[int, int] = {}
        self._sync_arrived: Dict[int, set] = {}
        self._sync_answer: Dict[int, Optional[dict]] = {}
        #: cut rendezvous: epoch -> {member: seq}
        self._cut_seqs: Dict[int, Dict[int, int]] = {}
        #: shard store: (epoch, table, shard) -> blob; manifest: epoch ->
        self._shards: Dict[tuple, bytes] = {}
        self._manifests: Dict[int, dict] = {}
        self._shard_dups = 0
        #: commit rendezvous: epoch -> set of committed members
        self._commits: Dict[int, set] = {}
        #: group transport: (epoch, key, idx) -> {member: blob}; once
        #: complete the ordered blob list parks in _xchg_results until
        #: every participant has read it
        self._xchg: Dict[tuple, Dict[int, bytes]] = {}
        self._xchg_results: Dict[tuple, tuple] = {}
        #: the (member, op, op_seq) response cache that makes a retried
        #: non-idempotent op apply once
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
        """Bind and serve the op endpoint (separate from ``__init__``:
        the op-script tests drive an instance that never serves)."""
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    req = _recv_frame(self.request)
                    resp = outer._dispatch(req)
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
        try:
            if self._server is not None:
                self._server.shutdown()
                self._server.server_close()
        except Exception:       # pragma: no cover - teardown race
            pass

    def state_digest(self) -> str:
        """SHA-256 over the durable state, the JAX package's digest for
        the same state: excludes lease clocks, rendezvous generation
        bookkeeping and dedup counters. The policy and replica planes'
        fields sit at their empty values (those planes are not ported)."""
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
                [],         # policy: staged actions
                [],         # policy: seen action ids
                [],         # replica subscriptions
                1,          # replica: next id
                -1,         # replica: latest announced version
            )
        return hashlib.sha256(repr(obj).encode()).hexdigest()

    # -- state machine -------------------------------------------------------

    def _reap_expired(self, now: Optional[float] = None) -> list:
        """Mark lease-expired active members dead; returns the newly
        dead ranks. Caller holds the lock."""
        now = time.monotonic() if now is None else now
        dead = [rec.rank for rec in self.members.values()
                if rec.expired(now)]
        for rank in dead:
            Log.Error("elastic: member %d lease expired (%.1fs) — "
                      "declared dead", rank, self.members[rank].lease_s)
        if dead:
            tmetrics.counter("elastic.lease_expirations").inc(len(dead))
            self._ap_reap({"ranks": dead})
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
        op = str(req.get("op"))
        for prefix, plane in _UNPORTED_OPS:
            CHECK(not op.startswith(prefix),
                  f"elastic coordinator: op {op!r} belongs to the {plane} "
                  f"plane, which multiverso_tpu_torch does not have yet")
        fn = getattr(self, f"_op_{op}", None)
        CHECK(fn is not None, f"elastic coordinator: unknown op {op!r}")
        inj = fchaos.get()
        if inj is not None:
            delay = inj.coord_delay()
            if delay > 0:
                time.sleep(delay)
            if inj.coord_kill():
                # die the way kill -9 does: stop serving with no goodbye;
                # clients find out from refused connects
                self.stop()
                raise ConnectionError(
                    "chaos coord.kill: primary hard-stopped mid-op")
        # non-idempotent ops carry (member, op_seq): a blind client retry
        # answers from the response cache instead of mutating twice
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
        resp = fn(req)
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
        # fleet rollups piggyback on the beats that already flow: fold
        # OUTSIDE the membership lock (the accumulator has its own, and a
        # slow decode must not stall the authority)
        blob = req.get("rollup")
        if blob:
            tfleet.ingest(blob)
        with self._lock:
            self._ap_hb({"rank": int(req["member"])})
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
            self._ap_leave({"rank": rank})
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
            self._ap_join({"rank": rank})
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
            self._ap_cut({"epoch": epoch, "member": member, "seq": seq})
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
            # idempotent (retries): the first manifest of an epoch stays
            self._ap_manifest({"epoch": epoch, "manifest": req["manifest"]})
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
                self._ap_shard_put({"key": list(key), "blob": req["blob"]})
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
            self._ap_commit_arrive({"epoch": epoch, "member": member})
            while True:
                if self.epoch >= epoch:
                    return {"epoch": self.epoch,
                            "members": self._active()}
                if set(t["members"]) <= self._commits.get(epoch, set()):
                    self._ap_install({"t": t})
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

    def _ap_install(self, d: dict) -> None:
        """Make the staged transition current. Caller holds the lock."""
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
                # the policy and replica planes and the standby are not
                # ported: their fields read empty, as in a JAX world
                # that never used them
                "policy_staged": 0,
                "policy_dedup_hits": 0,
                "replicas": {},
                "standby": "solo",
                "op_dedup_hits": self._dedup_hits,
            }



#: ops safe to blind-retry after a POST-SEND failure (the request may or
#: may not have been served): pure reads, lease refreshes, and the
#: rendezvous reads whose server-side generations self-heal
_RETRYABLE_OPS = frozenset({
    "register", "hb", "state", "dead_check", "sync", "manifest",
    "manifest_get", "shard_get", "joiner_wait"})

#: non-idempotent mutators: the client stamps a monotonically increasing
#: ``op_seq`` so the coordinator's (member, op, op_seq) response cache
#: makes a blind retry apply once
_DEDUP_OPS = frozenset({"commit", "leave", "join", "cut", "shard_put"})

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
    endpoint list (primary first, successors after). ``failover_gen``
    bumps on every endpoint change."""

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
