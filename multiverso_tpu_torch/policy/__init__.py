"""Policy plane: the self-driving runtime.

The port's own copy of ``multiverso_tpu/policy/``. The watchdog
(``telemetry/watchdog.py``) raises typed hysteresis alerts and the engine
can re-route, re-tune and drain at fenced cuts; this package is the wire
between them: a guarded control loop that converts SUSTAINED watchdog
alerts into typed, flight-recorded engine-cut actions. Off by default
behind ``-mv_policy``, which is also the runtime kill switch.

Roles (``engine.py`` carries the decision core and the guard stack):

* the **policy thread** (one per rank, concurrency domain ``policy`` in
  ``analysis/threads.py``'s inventory) consumes the watchdog's tick
  records and STAGES action proposals, at most once keyed ``(epoch,
  action id)``: locally in single-process worlds, at the coordinator's
  ``policy_put`` control op otherwise (the elastic coordinator when
  ``-mv_elastic`` is up, else a policy-only authority rank 0 hosts at
  ``-mv_policy_addr``).
* **actuation** happens at a fenced engine cut. Single-process worlds
  install straight from the policy thread. Multi-process worlds actuate
  ONLY at :func:`sync_point` (``MV_PolicySync``), an app-paced lockstep
  call that pulls the ONE agreed action list from the coordinator's
  rendezvous and installs it at every rank's identical stream position;
  elastic drains run their collective leave/sync legs here and nowhere
  else.

Surfaces: ``policy.*`` counters, ``policy.staged/route/tune/drain/revert``
flight events stamped ``(mepoch, SEQ)`` (aligned with their triggering
``alert.*`` events), the ``/actions`` ops endpoint, and a ``policy`` line
in ``/healthz``.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.policy import engine as _engine
from multiverso_tpu_torch.telemetry import flight as tflight
from multiverso_tpu_torch.telemetry import watchdog as twatchdog
from multiverso_tpu_torch.utils.configure import GetFlag
from multiverso_tpu_torch.utils.log import CHECK, Log


class _PlaneState:
    def __init__(self):
        self.engine: Optional[_engine.PolicyEngine] = None
        self.coordinator = None         # policy-only authority (rank 0,
        self.client = None              # non-elastic multi-proc worlds)
        self.lock = threading.Lock()


_state = _PlaneState()


def enabled() -> bool:
    """Plane up (regardless of the kill switch's current position)."""
    return _state.engine is not None


def peek() -> Optional[_engine.PolicyEngine]:
    return _state.engine


def start_plane(zoo) -> bool:
    """Bring up the policy plane when ``-mv_policy`` is set (Zoo.Start,
    after the watchdog and the elastic plane). Returns True when up."""
    st = _state
    if not bool(GetFlag("mv_policy")):
        return False
    CHECK(zoo.server_engine is not None,
          "-mv_policy needs the server engine (not -ma mode): every "
          "policy action installs at an engine cut")
    wd = twatchdog.peek()
    CHECK(wd is not None,
          "-mv_policy needs the watchdog armed (-mv_watchdog_s=N): "
          "the policy plane acts on its typed alerts")
    me = multihost.process_index()
    world = multihost.process_count()
    with st.lock:
        if st.engine is not None:
            return True
        if world > 1:
            from multiverso_tpu_torch import elastic
            from multiverso_tpu_torch.elastic.coordinator import (Coordinator,
                                                            MemberClient)
            lease = 10.0
            endpoints = None
            ep = elastic.coordinator_endpoint()
            if ep is not None:
                # the membership coordinator already runs on rank 0 —
                # the policy control ops ride the same authority (and
                # its ordered failover list: agreement must follow the
                # authority to its successor after a takeover)
                host, port = ep
                endpoints = elastic.coordinator_endpoints()
            else:
                addr = str(GetFlag("mv_policy_addr"))
                host, _, port_s = addr.rpartition(":")
                CHECK(addr and host and port_s.isdigit(),
                      "-mv_policy in a multi-process world needs "
                      "-mv_policy_addr host:port every rank can reach "
                      "(or -mv_elastic, whose coordinator it rides); "
                      f"got {addr!r}")
                port = int(port_s)
                if me == 0:
                    st.coordinator = Coordinator(host, port, lease)
                    port = st.coordinator.port
            st.client = MemberClient(host, port, me, lease,
                                     endpoints=endpoints)
            stager = _engine.CoordStager(st.client)
        else:
            stager = _engine.LocalStager()
        eng = _engine.PolicyEngine(stager, me=me, world=world)
        eng.start()
        wd.add_tick_listener(eng.on_watchdog_tick)
        st.engine = eng
    Log.Info("policy: plane up — rank %d of %d, rules=%s, cooldown "
             "%.1fs, kill switch -mv_policy", me, world,
             str(GetFlag("mv_policy_rules")),
             float(GetFlag("mv_policy_cooldown_s")))
    return True


def shutdown_plane() -> None:
    """Stop the policy thread + any hosted authority (Zoo.Stop,
    BEFORE the watchdog stops — no tick may land on a dead engine).
    Idempotent."""
    st = _state
    with st.lock:
        eng, st.engine = st.engine, None
        coord, st.coordinator = st.coordinator, None
        st.client = None
    if eng is not None:
        eng.stop()
    if coord is not None:
        coord.stop()


def sync_point(timeout: float = 60.0) -> List[dict]:
    """``MV_PolicySync``: the app-paced ACTUATION point of a
    multi-process world — every ACTIVE rank calls it at the same loop
    position (the MV_SaveCheckpoint / MV_ElasticSync discipline). Runs
    the engine's one actuation core: pull the agreed staged-action
    list from the coordinator rendezvous (which also agrees the
    kill-switch verdict — one disarmed rank vetoes the batch
    world-wide), install route/tune actions at this rank's fenced
    engine cut, and run at most one elastic drain (the drained rank's
    MV_ElasticLeave against the survivors' MV_ElasticSync). Returns
    the actions actuated. Single-process worlds flush the local stage
    queue the same way (the policy thread usually beat them to it).
    No-op ([]) while the plane is down — or on a DEPARTED elastic
    member, which is no longer part of any rendezvous."""
    eng = _state.engine
    if eng is None:
        return []
    from multiverso_tpu_torch import elastic
    if elastic.enabled() and elastic.is_departed():
        return []
    # world size from the CURRENT membership view: keep it in sync
    # with what the engine believes (a drain changes it mid-run)
    eng.world = max(1, multihost.world_size())
    return eng.actuate(timeout=timeout,
                       drain_runner=lambda a: _execute_drain(eng, a))


def _execute_drain(eng: _engine.PolicyEngine, action: dict) -> bool:
    """The collective leg of a drain action, on the calling (worker)
    thread: the sick rank leaves, every other rank syncs — one staged
    transition, applied at the members' lockstep positions. Re-checks
    the world guards against the CURRENT view (the action may have
    been staged before a membership change)."""
    from multiverso_tpu_torch import elastic
    if not elastic.enabled() or elastic.is_departed():
        Log.Error("policy: drain %s without a live elastic membership "
                  "— dropped", action["id"])
        eng._note(action, "dropped")
        return False
    members = elastic.members()
    rank = int(action["rank"])
    if rank not in members or rank == 0 or \
            len(members) - 1 < max(1, _engine._min_members()):
        Log.Error("policy: drain %s no longer legal for members %s — "
                  "dropped", action["id"], list(members))
        eng._note(action, "dropped")
        return False
    mep, seq = twatchdog.stream_pos()
    tflight.record("policy.drain", seq=seq, mepoch=mep,
                   detail=f"rule={action['rule']} id={action['id']} "
                          f"rank={rank}")
    eng.note_drain(action)
    if multihost.process_index() == rank:
        epoch = elastic.leave()
        Log.Info("policy: drained self (rank %d) at epoch %d — "
                 "MV_ElasticJoin re-admits", rank, epoch)
    else:
        elastic.sync()
    return True


def status_line() -> Optional[dict]:
    """The /healthz ``policy`` line (LOCAL, never collective): None
    while the plane is down."""
    eng = _state.engine
    if eng is None:
        return None
    last = eng.history[-1] if eng.history else None
    return {"armed": bool(_engine._enabled()),
            "evals": eng.evals,
            "installed": eng.n_installed,
            "reverted": eng.n_reverted,
            "drains": eng.n_drains,
            "last_action": (f"{last['status']}:{last['id']}"
                            if last else None)}


def actions_report() -> dict:
    """The ``/actions`` body. When the plane is down the body says so
    instead of claiming idleness."""
    eng = _state.engine
    if eng is None:
        return {"enabled": False, "actions": [],
                "note": "policy plane off — arm with -mv_policy=true "
                        "(+ -mv_watchdog_s=N for its eyes)"}
    return eng.report()
