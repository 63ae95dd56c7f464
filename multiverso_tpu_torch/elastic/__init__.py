"""Elastic plane: membership epochs, live drain and re-admit, resume from
the snapshot cut after a silent death.

The port's own copy of ``multiverso_tpu/elastic/__init__.py``. Membership
is a LIVE operation, the OSDI'14 parameter-server way:

* :mod:`coordinator` — the rank-0 membership authority: epoch-numbered
  views, join/leave staging, heartbeat leases, the shard-move relay and
  the post-transition group transport;
* :mod:`rebalance` — the re-partition math and the sealed shard-move
  frames built on the checkpoint frame;
* :mod:`dialer` — the ordered coordinator endpoint list with backoff;
* :mod:`standby` — the coordinator's op-log replication and the standby
  process that takes over on the primary's death (``-mv_standby``);
* this module — the member-side state machine gluing them to the Zoo,
  the engine and the failsafe layer.

**The cut.** Every membership change applies at ONE fenced window-stream
position: the engine barrier (``Zoo.CallOnEngine``) fences each member's
verb stream, the coordinator's cut rendezvous proves every member fenced
at the same exchange SEQ, and the capture (every table's checkpoint
frame) runs inside the fence. The engine then re-bases: SEQ 0, standing
caps dropped, the exchange stage retired, and the collective group
re-formed (``multihost.install_group``): a singleton group takes the
identity paths, a multi-member group the coordinator relay.

**Sync points.** Transitions apply at app-paced sync points
(``MV_ElasticSync``, or the final sync inside ``MV_ElasticLeave``) that
every member calls at the same loop position, the ``MV_SaveCheckpoint``
discipline. A no-op sync still refreshes the retained snapshot cut, which
bounds the rollback of the silent-death path.

**Silent death.** Members heartbeat the coordinator; a lease expiry
marks a member dead. The survivor's next collective failure (the shm
wire's dead-peer check, the tcp wire's reset, or the ``-mv_deadline_s``
deadline) consults the lease instead of going fatal: a dead peer turns
it into the typed :class:`~multiverso_tpu_torch.failsafe.errors.
MembershipChanged`, the engine rolls every table back to the retained cut
on the shrunk world, fails the in-flight verbs with the typed error
(their effects were rolled back) and goes on WITHOUT a restart. Workers
catch ``MembershipChanged`` and re-run from their last sync point. A
collective failure with every lease fresh stays fatal, loudly.

Scope: joiners are boot-world processes re-admitted after a drain; rank
0 (the coordinator's host) cannot drain. With ``-mv_standby`` rank 0 ships
the coordinator's op log to a standby process, and the death of the
coordinator is a failover: the standby replays the log and serves at the
next endpoint of ``-mv_coordinator``. One card per process: a rebuilt
table lands on the live table's device (``rebalance._devices_for``).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from multiverso_tpu_torch.failsafe import chaos
from multiverso_tpu_torch.failsafe import deadline as fdeadline
from multiverso_tpu_torch.failsafe.errors import MembershipChanged
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.telemetry import flight as tflight
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.configure import (GetFlag, MV_DEFINE_bool,
                                            MV_DEFINE_double,
                                            MV_DEFINE_string)
from multiverso_tpu_torch.utils.log import CHECK, Log

MV_DEFINE_bool("mv_elastic", False,
               "elastic membership plane: epoch-numbered views, live "
               "join/leave with shard rebalancing, silent-death "
               "detection via heartbeat leases")
MV_DEFINE_string("mv_elastic_addr", "",
                 "membership coordinator endpoint host:port (hosted by "
                 "boot rank 0). Empty: loopback with an ephemeral port "
                 "— single-process worlds only; multi-process worlds "
                 "must name a port every rank can reach")
MV_DEFINE_double("mv_elastic_lease_s", 0.0,
                 "heartbeat lease: a member silent for this long is "
                 "declared dead (0 = derive from -mv_deadline_s, "
                 "floor 1s — the lease must expire before the "
                 "collective deadline consults it)")
MV_DEFINE_string("mv_coordinator", "",
                 "ordered coordinator endpoint list "
                 "host:port[,host:port] — primary first, standby "
                 "successor endpoints after. Every client (members, "
                 "replica readers, the policy daemon) walks the list "
                 "with backoff on connect failure, which is how they "
                 "find the successor after a takeover. Overrides "
                 "-mv_elastic_addr when set")
MV_DEFINE_string("mv_standby", "",
                 "host:port of a standby coordinator's log-stream "
                 "listener (python -m multiverso_tpu_torch.elastic.standby "
                 "--listen ...). Rank 0 ships every coordinator "
                 "mutation there; on primary death the standby "
                 "replays the log and serves as successor")

#: rendezvous bound for control-plane waits (sync/cut/commit/joiner
#: pickup) — generous: these block on PEERS reaching their lockstep
#: sync points, not on local work
_CTL_TIMEOUT_S = 120.0


class _PlaneState:
    def __init__(self):
        self.enabled = False
        self.zoo = None
        self.client = None            # coordinator.MemberClient
        self.coordinator = None       # rank 0 only
        self.me = 0
        self.epoch = 0
        self.members: Tuple[int, ...] = ()
        self.departed = False
        #: retained snapshot cut: {"epoch", "seq", "window_epoch",
        #: "frames"} — what a silent-death transition restores from
        self.last_cut: Optional[dict] = None
        #: this world's transitions as this member saw them: cause,
        #: epoch, the seconds of each step (``*_s``) and the bytes the
        #: shard plane carried (``transitions()``)
        self.transitions: List[dict] = []
        self.lock = threading.RLock()


_state = _PlaneState()


def enabled() -> bool:
    return _state.enabled


def epoch() -> int:
    return _state.epoch


def members() -> Tuple[int, ...]:
    return _state.members


def is_departed() -> bool:
    return _state.departed


def coordinator_endpoint():
    """(host, port) of the live membership coordinator, or None when
    the plane is down — other planes reuse this endpoint instead of
    hosting a second authority."""
    st = _state
    if not st.enabled or st.client is None:
        return None
    return (st.client.host, st.client.port)


def coordinator_endpoints():
    """The ORDERED coordinator endpoint list (primary first, standby
    successors after), or None when the plane is down. Other planes (the
    policy daemon) build their own clients from this, so every client
    fails over along the same list."""
    st = _state
    if not st.enabled or st.client is None:
        return None
    return list(st.client.endpoints)


def transitions() -> List[dict]:
    """This world's transitions, oldest first, each ``{"cause", "epoch",
    "<step>_s": seconds, "bytes_shipped"}``. Steps: ``fence`` (the cut
    call until the engine fence runs), ``capture``, ``ship`` (shard PUTs
    and the manifest), ``download`` (a joiner's shard GETs), ``rebuild``,
    ``commit``. Local, never collective."""
    return [dict(r) for r in _state.transitions]


def _stamp(rec: dict, step: str, t0: float) -> float:
    """Add the seconds since ``t0`` to ``rec[step + "_s"]``; returns now."""
    now = time.perf_counter()
    rec[f"{step}_s"] = rec.get(f"{step}_s", 0.0) + now - t0
    return now


def ha_status() -> Optional[dict]:
    """Coordinator-HA view for /healthz, /fleet and the dashboard:
    standby replication state (rank 0 only — "solo" / "replicated" /
    "degraded"), this client's active endpoint and failover count.
    Never collective, never blocks."""
    st = _state
    if not st.enabled or st.client is None:
        return None
    out = {"endpoints": [f"{h}:{p}" for h, p in st.client.endpoints],
           "active_endpoint": f"{st.client.host}:{st.client.port}",
           "failover_gen": st.client.failover_gen}
    if st.coordinator is not None:
        out["standby"] = st.coordinator.standby_state
        out["op_dedup_hits"] = st.coordinator._dedup_hits
    return out


def _lease_s() -> float:
    lease = float(GetFlag("mv_elastic_lease_s"))
    if lease > 0:
        return lease
    dl = fdeadline.deadline_s()
    return max(1.0, 0.8 * dl) if dl > 0 else 10.0


# -- lifecycle (Zoo.Start / Zoo.Stop) ------------------------------------


def start_plane(zoo) -> bool:
    """Bring up the membership plane when ``-mv_elastic`` is set:
    rank 0 hosts the coordinator, every boot rank registers as an
    active member and starts heartbeating. Returns True when up."""
    st = _state
    if not bool(GetFlag("mv_elastic")):
        return False
    CHECK(zoo.server_engine is not None,
          "-mv_elastic needs the server engine (not -ma mode): every "
          "membership transition is an engine-stream cut")
    from multiverso_tpu_torch.elastic.coordinator import Coordinator, MemberClient
    from multiverso_tpu_torch.elastic import dialer as _dialer
    me = multihost.process_index()
    world = multihost.process_count()
    eps_spec = str(GetFlag("mv_coordinator"))
    addr = eps_spec.split(",")[0].strip() if eps_spec \
        else str(GetFlag("mv_elastic_addr"))
    lease = _lease_s()
    if addr:
        host, _, port_s = addr.rpartition(":")
        CHECK(host and port_s.isdigit(),
              f"coordinator endpoint must be host:port, got {addr!r}")
        host, port = host, int(port_s)
    else:
        CHECK(world <= 1,
              "-mv_elastic in a multi-process world needs an explicit "
              "-mv_elastic_addr every rank can reach")
        host, port = "127.0.0.1", 0
    with st.lock:
        st.zoo = zoo
        st.me = me
        if me == 0:
            # the standby attaches BEFORE the endpoint serves: a peer's
            # register racing the attach would be applied unlogged, and
            # the successor would not know that member (the JAX package
            # serves first)
            st.coordinator = Coordinator(host if addr else "127.0.0.1",
                                         port, lease, serve=False)
            standby = str(GetFlag("mv_standby"))
            if standby:
                st.coordinator.attach_standby(standby)
            st.coordinator.serve()
            port = st.coordinator.port
        endpoints = (_dialer.parse_endpoints(eps_spec) if eps_spec
                     else None)
        st.client = MemberClient(host if addr else "127.0.0.1", port,
                                 me, lease, endpoints=endpoints)
        st.client.call_retry("register", attempts=50)
        st.client.start_heartbeats()
        st.enabled = True
        st.departed = False
        st.epoch = 0
        st.members = tuple(range(world))
        st.last_cut = None
        st.transitions = []
    tmetrics.gauge("elastic.epoch").set(0)
    tmetrics.gauge("elastic.members").set(world)
    tmetrics.counter("elastic.transitions")         # eager, shows at 0
    tmetrics.counter("elastic.shards_moved")
    Log.Info("elastic: plane up — member %d of %d, lease %.1fs",
             me, world, lease)
    return True


def shutdown_plane() -> None:
    st = _state
    with st.lock:
        if st.client is not None:
            st.client.stop_heartbeats()
            st.client = None
        if st.coordinator is not None:
            st.coordinator.stop()
            st.coordinator = None
        st.enabled = False
        st.departed = False
        st.zoo = None
        st.last_cut = None
        st.epoch = 0
        st.members = ()
    multihost.install_group(None)


def guard_verbs() -> None:
    """Zoo.SendToServer hook: a departed member's verb must fail typed,
    not fork the world's state. One bool read when the plane is off."""
    st = _state
    if st.enabled and st.departed:
        raise MembershipChanged(
            "verb submission from a departed member", epoch=st.epoch,
            members=st.members, departed=(st.me,))


def state_report() -> Optional[dict]:
    """Local view for /healthz + dashboards (never collective)."""
    st = _state
    if not st.enabled:
        return None
    out = {"epoch": st.epoch, "members": list(st.members),
           "departed": st.departed,
           "cut_seq": (st.last_cut or {}).get("seq"),
           "cut_window_epoch": (st.last_cut or {}).get("window_epoch")}
    if st.coordinator is not None:
        try:
            out["authority"] = st.coordinator._op_state({})
        except Exception:       # pragma: no cover - teardown race
            pass
    return out


# -- the membership verbs ------------------------------------------------


def sync() -> int:
    """Elastic sync point: a LOCKSTEP rendezvous of every active member
    (call it at the same loop position on every rank — the
    MV_SaveCheckpoint discipline). Applies at most one staged
    membership transition; always refreshes the retained snapshot cut.
    Returns the membership epoch now in effect."""
    st = _state
    CHECK(st.enabled, "MV_ElasticSync without -mv_elastic")
    CHECK(not st.departed,
          "MV_ElasticSync from a departed member (MV_ElasticJoin "
          "re-admits it)")
    # deliberately NOT under the plane lock: the rendezvous and the
    # engine fence below can block for seconds, and the engine thread's
    # own death-transition path (engine_transition) takes the lock —
    # holding it here would deadlock a sync racing a silent death.
    # Plain call, NOT call_retry: sync generations are assigned per
    # arrival at the coordinator, so a blind re-send would count as a
    # second rendezvous arrival and desync the generations.
    resp = st.client.call("sync", timeout=_CTL_TIMEOUT_S)
    t = resp["transition"]
    if t is None:
        _refresh_cut()
        return st.epoch
    if t.get("dead"):
        # a silent death discovered AT the sync (the engine was idle,
        # so no collective deadline ever consulted the lease): the old
        # view contains a corpse no collective capture can include —
        # resume from the RETAINED cut exactly like the engine error
        # path, never through the graceful fence's collective capture
        return _apply_death_transition(t)
    return _apply_transition(t)


def leave() -> int:
    """Graceful drain: stage this member's departure, then run the
    final collective sync that applies it (every OTHER member reaches
    the same position via its own MV_ElasticSync). Returns the epoch
    this member departed at. The process stays alive and may
    MV_ElasticJoin later."""
    st = _state
    CHECK(st.enabled, "MV_ElasticLeave without -mv_elastic")
    CHECK(not st.departed, "MV_ElasticLeave from a departed member")
    _chaos_control_fault("leave")
    st.client.call_retry("leave", timeout=_CTL_TIMEOUT_S)
    return sync()


def join() -> int:
    """(Re)admission: stage the join, park until the live members reach
    a sync point and stage the transition, download this member's view
    of every table from the shard-move plane, rebuild on the new
    world's tables, and commit. Returns the epoch joined at."""
    st = _state
    CHECK(st.enabled, "MV_ElasticJoin without -mv_elastic")
    CHECK(st.departed, "MV_ElasticJoin from an active member")
    from multiverso_tpu_torch.elastic import rebalance
    from multiverso_tpu_torch.failsafe.errors import TransientError
    _chaos_control_fault("join")
    st.client.call_retry("join", timeout=_CTL_TIMEOUT_S)
    while True:
        try:
            resp = st.client.call("joiner_wait", timeout=_CTL_TIMEOUT_S)
            break
        except TransientError:
            # admission comes at the LIVE members' sync pace — keep
            # parking through the server's typed rendezvous timeouts
            continue
    t, manifest = resp["transition"], resp["manifest"]
    rec = {"cause": "join", "epoch": t["epoch"], "bytes_shipped": 0}
    t0 = time.perf_counter()
    nshards = len(t["members"])
    frames: List[bytes] = []
    for tid in range(manifest["num_tables"]):
        blobs = [st.client.call_retry(
                     "shard_get", epoch=t["epoch"], table_id=tid,
                     shard=s, timeout=_CTL_TIMEOUT_S)["blob"]
                 for s in range(nshards)]
        rec["bytes_shipped"] += sum(len(b) for b in blobs)
        frames.append(rebalance.join_shards(blobs))
    t0 = _stamp(rec, "download", t0)
    with st.lock:
        zoo = st.zoo
        # view first, then the isolated rebuild (same ordering argument
        # as the graceful fence: constructors bind the new identity)
        _install_view(t)
        with multihost.collective_isolation():
            rebalance.rebuild_world(zoo, frames, t["members"])
        st.last_cut = {"epoch": t["epoch"], "seq": 0,
                       "window_epoch": manifest.get("window_epoch", 0),
                       "frames": frames}
        _rebase_engine(zoo, t)
    t0 = _stamp(rec, "rebuild", t0)
    st.client.call_retry("commit", epoch=t["epoch"],
                         timeout=_CTL_TIMEOUT_S)
    _stamp(rec, "commit", t0)
    st.transitions.append(rec)
    Log.Info("elastic: joined at epoch %d (members %s)", t["epoch"],
             t["members"])
    return st.epoch


# -- failsafe integration ------------------------------------------------


def peer_loss(what: str,
              wait_s: Optional[float] = None) -> Optional[MembershipChanged]:
    """A collective failed: ask the authority whether a member is dead.
    Returns the typed MembershipChanged to raise in place of the failure
    (None: every lease is fresh — a genuine divergence, which stays
    fatal). Called from the engine's exchange path; rides the same lease
    the heartbeats feed. The coordinator waits up to ``wait_s`` for a
    verdict (default: past the lease, so a death that just happened is
    seen); a stalled wire's periodic probe passes a short wait."""
    st = _state
    if not st.enabled or st.departed:
        return None
    if wait_s is None:
        wait_s = st.client.lease_s + 5.0
    try:
        resp = st.client.call("dead_check", timeout=wait_s)
    except Exception as exc:
        Log.Error("elastic: dead_check failed (%r) — deadline stays "
                  "fatal", exc)
        return None
    t = resp.get("transition")
    if t is None or st.me not in t["members"]:
        return None
    return MembershipChanged(what, epoch=t["epoch"],
                             members=t["members"],
                             departed=t["departed"], joined=t["joined"])


def _restore_from_cut(t: dict, server) -> None:
    """The death-transition core, ON the engine thread with the stream
    quiet: mark the boot world broken, commit the shrink epoch, install
    the survivor view, roll every table back to the retained snapshot
    cut on the shrunk world (collective-isolated — the old view contains
    a corpse no capture round could include), re-base the stream."""
    st = _state
    cut = st.last_cut
    from multiverso_tpu_torch.elastic import rebalance
    rec = {"cause": "death", "epoch": t["epoch"], "bytes_shipped": 0}
    t0 = time.perf_counter()
    with st.lock:
        multihost.mark_boot_world_broken()
        st.client.call_retry("commit", epoch=t["epoch"],
                             timeout=_CTL_TIMEOUT_S)
        t0 = _stamp(rec, "commit", t0)
        _install_view(t)
        with multihost.collective_isolation():
            rebalance.rebuild_world(st.zoo, cut["frames"], t["members"])
        server._elastic_rebase(t["epoch"], "death")
        st.last_cut = dict(cut, epoch=t["epoch"], seq=0)
        _stamp(rec, "rebuild", t0)
        st.transitions.append(rec)
    Log.Error("elastic: resumed from snapshot cut (window_epoch %s) on "
              "the shrunk world %s — epoch %d", cut.get("window_epoch"),
              list(t["members"]), t["epoch"])


def engine_transition(server, exc: MembershipChanged) -> bool:
    """Silent-death epoch transition from the engine's error path (a
    collective deadline consulted the lease): resume from the retained
    cut. Returns False when the plane cannot transition (no cut
    retained, plane down) — the caller then falls back to the fatal
    path."""
    st = _state
    if not st.enabled or st.departed or st.zoo is None:
        return False
    if st.last_cut is None:
        Log.Error("elastic: membership changed but no snapshot cut "
                  "retained (no MV_ElasticSync ran) — cannot resume")
        return False
    _restore_from_cut({"epoch": exc.epoch,
                       "members": list(exc.members),
                       "departed": list(exc.departed),
                       "joined": list(exc.joined), "cause": "death"},
                      server)
    return True


def _apply_death_transition(t: dict) -> int:
    """A death staged at a SYNC (idle engine — the lease verdict came
    from the rendezvous, not a collective deadline): run the same
    retained-cut restore as the engine error path, fenced at the
    current stream position."""
    st = _state
    zoo = st.zoo
    CHECK(st.last_cut is not None,
          "elastic: death transition with no snapshot cut retained")
    from multiverso_tpu_torch.message import MsgType

    def _fence():
        _restore_from_cut(t, zoo.server_engine)
        return t["epoch"]

    return zoo.CallOnEngine(MsgType.Request_StoreLoad, _fence,
                            "elastic death transition",
                            timeout_s=_CTL_TIMEOUT_S)


# -- internals -----------------------------------------------------------


def _chaos_control_fault(kind: str) -> None:
    """membership.leave / membership.join chaos sites: rehearse a lost
    control RPC by DUPLICATING the staged op (the coordinator's
    idempotent/deduped ops must absorb the re-delivery) after a short
    fault delay, counting a retry."""
    cz = chaos.get()
    st = _state
    if cz is None or not cz.membership_fault(kind):
        return
    tmetrics.counter("failsafe.retries").inc()
    time.sleep(0.005)
    try:
        # the duplicate delivery: staging leave/join twice must be
        # absorbed (pending sets / shard dedup), like a verb retry
        st.client.call_retry(kind, timeout=_CTL_TIMEOUT_S)
    except Exception as exc:    # rehearsal must not add a failure mode
        Log.Error("elastic: chaos %s rehearsal duplicate failed: %r",
                  kind, exc)


def _refresh_cut() -> None:
    """Capture a fresh snapshot cut at the current (fenced) stream
    position — the rollback anchor for silent-death resume."""
    st = _state
    zoo = st.zoo
    if zoo is None or zoo.server_engine is None:
        return
    from multiverso_tpu_torch.elastic import rebalance
    from multiverso_tpu_torch.message import MsgType
    eng = zoo.server_engine

    def _cut():
        frames = rebalance.capture_cut(zoo.server_tables)
        return {"epoch": st.epoch, "seq": eng._mh_seq,
                "window_epoch": eng.window_epoch, "frames": frames}

    st.last_cut = zoo.CallOnEngine(MsgType.Request_StoreLoad, _cut,
                                   "elastic snapshot cut",
                                   timeout_s=_CTL_TIMEOUT_S)


def _install_view(t: dict) -> None:
    """Local view + collective-group install for an epoch transition.
    Caller holds the plane lock; the verb stream is fenced."""
    st = _state
    st.epoch = int(t["epoch"])
    st.members = tuple(sorted(t["members"]))
    st.departed = st.me not in st.members
    client = st.client
    ex = bar = None
    if not st.departed and len(st.members) > 1:
        ep = st.epoch
        ex = (lambda blob, key:
              client.group_exchange(ep, blob, key, _CTL_TIMEOUT_S))
        bar = (lambda name:
               client.group_barrier(ep, name, _CTL_TIMEOUT_S))
    multihost.install_group(
        multihost.Group(st.epoch, t["members"], ex, bar))
    tmetrics.gauge("elastic.epoch").set(st.epoch)
    tmetrics.gauge("elastic.members").set(len(st.members))
    tmetrics.counter("elastic.transitions").inc()


def _rebase_engine(zoo, t: dict) -> None:
    if zoo.server_engine is not None:
        zoo.server_engine._elastic_rebase(int(t["epoch"]),
                                          str(t.get("cause", "?")))


def _apply_transition(t: dict) -> int:
    """Graceful transition (drain/admit), from an OLD-view member's
    sync: fence the stream, cut-rendezvous, capture, ship shards to
    joiners, commit, install. The whole sequence runs as ONE engine-cut
    payload so the stream position cannot drift under it."""
    st = _state
    from multiverso_tpu_torch.elastic import rebalance
    zoo = st.zoo
    eng = zoo.server_engine
    new_members = sorted(t["members"])
    rec = {"cause": str(t.get("cause", "?")), "epoch": t["epoch"],
           "bytes_shipped": 0}
    t_call = time.perf_counter()

    def _fence():
        t0 = _stamp(rec, "fence", t_call)
        seq = eng._mh_seq
        st.client.call_retry("cut", epoch=t["epoch"], seq=seq,
                             timeout=_CTL_TIMEOUT_S)
        # the capture is local: every member holds a full replica, and
        # the head-marker exchange that fenced this barrier put every
        # member at the same stream position
        frames = rebalance.capture_cut(zoo.server_tables)
        t0 = _stamp(rec, "capture", t0)
        tflight.record("membership.cut", seq=seq,
                       epoch=eng.window_epoch, mepoch=t["epoch"],
                       detail=f"cause={t.get('cause')}")
        if t["joined"]:
            rec["bytes_shipped"] = _ship_shards(frames, t, seq)
            t0 = _stamp(rec, "ship", t0)
        # shard ownership delta (flight forensics + dashboards), shipped
        # or not — a drain reassigns every departed member's shards
        _note_moves(frames, t)
        # the NEW view installs BEFORE the rebuild so table constructors
        # bind the new world's identity (SparseMatrixTable snapshots
        # world size/rank at creation); the rebuild itself runs under
        # collective isolation — ctor-time agreement collectives were
        # already established at boot and have no matched peer round
        # inside the fence
        _install_view(t)
        leaving = st.me not in new_members
        if not leaving:
            # re-create THIS member's tables for the new world BEFORE the
            # commit rendezvous: the moment every new-view member
            # commits, the world must be ready to run. The leaver skips
            # it — its stale tables are never read again (guard_verbs)
            # and a re-admission replaces them from the shard plane.
            with multihost.collective_isolation():
                rebalance.rebuild_world(zoo, frames, new_members)
            t0 = _stamp(rec, "rebuild", t0)
            st.client.call_retry("commit", epoch=t["epoch"],
                                 timeout=_CTL_TIMEOUT_S)
            _stamp(rec, "commit", t0)
        st.last_cut = {"epoch": t["epoch"], "seq": 0,
                       "window_epoch": eng.window_epoch,
                       "frames": frames}
        eng._elastic_rebase(t["epoch"], str(t.get("cause", "?")))
        st.transitions.append(rec)
        return t["epoch"]

    from multiverso_tpu_torch.message import MsgType
    new_epoch = zoo.CallOnEngine(MsgType.Request_StoreLoad, _fence,
                                 "elastic epoch transition",
                                 timeout_s=_CTL_TIMEOUT_S)
    Log.Info("elastic: epoch %d in effect — members %s%s", new_epoch,
             new_members,
             " (this member departed)" if st.departed else "")
    return new_epoch


def _ship_shards(frames: List[bytes], t: dict, cut_seq: int) -> int:
    """Owner side of the move wire: split every table frame into the
    NEW view's shards, ship the ones assigned to this member, publish
    the manifest (lowest alive old member). Returns the bytes this
    member shipped."""
    st = _state
    from multiverso_tpu_torch.elastic import rebalance
    nshards = len(t["members"])
    old_alive = sorted(m for m in t["old_members"]
                       if m not in t["joined"]
                       and m not in t.get("dead", ()))
    shippers = rebalance.shard_shippers(nshards, old_alive)
    eng = st.zoo.server_engine
    shipped = 0
    for tid, frame in enumerate(frames):
        blobs = rebalance.split_frame(frame, nshards, epoch=t["epoch"])
        for s, blob in enumerate(blobs):
            if shippers[s] != st.me:
                continue
            st.client.call_retry("shard_put", epoch=t["epoch"],
                                 table_id=tid, shard=s, blob=blob,
                                 timeout=_CTL_TIMEOUT_S)
            tmetrics.counter("elastic.shards_moved").inc()
            shipped += len(blob)
    if st.me == old_alive[0]:
        st.client.call_retry(
            "manifest", epoch=t["epoch"],
            manifest={"num_tables": len(frames), "nshards": nshards,
                      "cut_seq": cut_seq,
                      "window_epoch": eng.window_epoch},
            timeout=_CTL_TIMEOUT_S)
    return shipped


def _note_moves(frames: List[bytes], t: dict) -> None:
    """flight ``shard.moved`` events for every ownership change of this
    transition (row-range granular, from the pure plan)."""
    from multiverso_tpu_torch.elastic import rebalance
    eng = _state.zoo.server_engine
    if not tflight.enabled():
        return
    for tid, table in enumerate(_state.zoo.server_tables):
        count = getattr(table, "num_rows", None) or getattr(
            table, "size", None) or 0
        for lo, hi, frm, to in rebalance.plan_moves(
                int(count), t["old_members"], t["members"]):
            tflight.record("shard.moved", seq=eng._mh_seq,
                           epoch=eng.window_epoch, mepoch=t["epoch"],
                           detail=f"t{tid}[{lo}:{hi}) {frm}->{to}")
