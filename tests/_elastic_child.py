"""One fresh interpreter running an elastic or fleet script through ONE
package, for tests/test_torch_elastic_units.py and test_torch_fleet.py.

    python tests/_elastic_child.py MODE PKG OUTDIR

PKG is ``jax`` (``multiverso_tpu``) or ``torch`` (``multiverso_tpu_torch``).
Both packages' coordinators, dialers and fleet folds count into
process-wide metrics registries, so each run gets an interpreter of its
own (a leaked ``fleet.rollups`` count fails the JAX package's own
scrape-at-zero test in a shared pytest worker). The last line printed is
one JSON object with what the mode compares.

Modes:

* ``coord`` — one scripted op sequence sent to a ``Coordinator`` that
  never serves (ops go to ``_dispatch`` directly, rendezvous ops from one
  thread per member): register, hb, leave with a duplicate and from rank
  0 (refused), sync, cut, shard_put with a duplicate, manifest, commit,
  join staging with a duplicate, dead_check under an injected clock
  (``_reap_expired(now)``), the shrink's commit, xchg and gbar on the
  shrunk view, the policy ops (a put, its duplicate, a one-member pull),
  the replica ops (join, hb, roster with a version, a relay put and its
  fetch, ack, evict, an evicted member's hb, a reap under an injected
  clock), state. Prints every reply (errors as their type name) and
  ``state_digest()`` after each step.
* ``dialer`` — ``parse_endpoints`` over the flag's forms, and a dialer
  over a refused endpoint then a listening one: the endpoint it lands
  on, ``failover_gen``, the cursor after ``mark_failed``, and the typed
  error over refused endpoints only.
* ``ha`` — the coordinator's standby on one mixed op script (register,
  hb, shard_put, policy_put, replica_join/ack/roster, leave) sent by two
  member clients to a primary that ships its op log to an in-process
  ``StandbyServer``: every reply, the stored records (kinds and data),
  the live digest and the successor's after ``force_takeover``; then an
  acked op surviving ``simulate_kill``, 25 heartbeats compacted to one
  record, degrade-to-solo after the standby stops, the takeover lease's
  boundary at injected clocks, and ``rebase_clocks`` against a stale
  lease clock.
* ``policy`` — the policy plane's control ops on a ``Coordinator`` that
  never serves: policy_put with a duplicate delivery, a two-member
  policy_pull rendezvous armed on both, a vetoed pull (one member
  disarmed) that un-sees its keys, the re-stage after the veto, a pull
  that times out and withdraws, and an epoch install resetting the pull
  era; every reply and ``state_digest()`` after each step.
* ``kill9`` — the kill -9 drill of ``tests/test_failover.py``: a standby
  process and a primary process (``python -m <pkg>.elastic.standby``), a
  member client over both endpoints staging a policy action and hammering
  shard_puts, SIGKILL of the primary mid-hammer; what the successor
  answers (every acked blob, the statuses, the standby line, the
  re-delivered policy action's dup flag, the client's failover count)
  and what the two status files said.
* ``fleet`` — the seeded rollups (``_elastic_seed.fleet_rollups``) encoded by
  this package (written to ``OUTDIR/<pkg>_rollups.bin``); the other
  package's blobs decoded when present; the accumulator's report and
  watchdog sample at injected clocks; the three fleet rules' verdicts on
  the samples; ``status_lines`` of the module fold.
"""

import json
import os
import socket
import sys
import threading
import time

import numpy as np

from _elastic_seed import fleet_rollups

MODE, PKG, OUTDIR = sys.argv[1], sys.argv[2], sys.argv[3]
if PKG == "jax":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import multiverso_tpu as pkg  # noqa: F401
    from multiverso_tpu.elastic import coordinator, dialer, standby
    from multiverso_tpu.telemetry import fleet, metrics, watchdog
    from multiverso_tpu.utils.log import FatalError
else:
    import multiverso_tpu_torch as pkg  # noqa: F401
    from multiverso_tpu_torch.elastic import coordinator, dialer, standby
    from multiverso_tpu_torch.telemetry import fleet, metrics, watchdog
    from multiverso_tpu_torch.utils.log import FatalError


def _jsonable(v):
    if isinstance(v, bytes):
        return {"bytes": v.hex()}
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in sorted(v.items(),
                                                         key=lambda i:
                                                         str(i[0]))}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def _call(coord, req):
    try:
        return coord._dispatch(dict(req))
    except FatalError as exc:
        return {"raised": "FatalError", "check": "cannot drain" in str(exc)}
    except Exception as exc:
        return {"raised": type(exc).__name__}


def _together(coord, reqs):
    """Rendezvous ops: one thread per member, replies by member."""
    out = {}

    def run(req):
        out[req["member"]] = _call(coord, req)

    ts = [threading.Thread(target=run, args=(r,)) for r in reqs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return [out[r["member"]] for r in reqs]


def mode_coord():
    coord = coordinator.Coordinator("127.0.0.1", 0, 10.0, serve=False)
    steps = []

    def step(name, replies):
        steps.append({"step": name, "replies": _jsonable(replies),
                      "digest": coord.state_digest()})

    step("register", [_call(coord, {"op": "register", "member": r})
                      for r in range(3)])
    step("hb", [_call(coord, {"op": "hb", "member": 1})])
    step("leave", [_call(coord, {"op": "leave", "member": 2}),
                   _call(coord, {"op": "leave", "member": 2}),
                   _call(coord, {"op": "leave", "member": 0})])
    step("sync", _together(coord, [{"op": "sync", "member": r,
                                     "timeout": 20} for r in range(3)]))
    step("cut", _together(coord, [{"op": "cut", "member": r, "epoch": 1,
                                    "seq": 7, "timeout": 20, "op_seq": 1}
                                   for r in range(3)]))
    step("shard_put", [
        _call(coord, {"op": "shard_put", "member": 0, "epoch": 1,
                      "table_id": 0, "shard": 0, "blob": b"abc",
                      "op_seq": 2}),
        _call(coord, {"op": "shard_put", "member": 1, "epoch": 1,
                      "table_id": 0, "shard": 0, "blob": b"IGNORED",
                      "op_seq": 2}),
        _call(coord, {"op": "shard_put", "member": 0, "epoch": 1,
                      "table_id": 0, "shard": 0, "blob": b"abc",
                      "op_seq": 2}),          # a retried op: the cache
        _call(coord, {"op": "shard_get", "member": 1, "epoch": 1,
                      "table_id": 0, "shard": 0, "timeout": 5})])
    step("manifest", [
        _call(coord, {"op": "manifest", "member": 0, "epoch": 1,
                      "manifest": {"num_tables": 1, "nshards": 2}}),
        _call(coord, {"op": "manifest", "member": 1, "epoch": 1,
                      "manifest": {"num_tables": 9}}),
        _call(coord, {"op": "manifest_get", "member": 1, "epoch": 1,
                      "timeout": 5})])
    step("commit", _together(coord, [{"op": "commit", "member": r,
                                       "epoch": 1, "timeout": 20,
                                       "op_seq": 3} for r in (0, 1)]))
    step("join", [_call(coord, {"op": "join", "member": 2}),
                  _call(coord, {"op": "join", "member": 2}),
                  _call(coord, {"op": "join", "member": 1})])
    # the injected clock: member 1's lease is 11 s old, member 0's fresh
    now = time.monotonic()
    with coord._lock:
        coord.members[0].last_hb = now
        coord.members[1].last_hb = now - 11.0
        dead = coord._reap_expired(now)
    step("reap", [dead])
    step("dead_check", [_call(coord, {"op": "dead_check", "member": 0,
                                      "timeout": 2})])
    step("commit_death", [_call(coord, {"op": "commit", "member": 0,
                                        "epoch": 2, "timeout": 5,
                                        "op_seq": 4})])
    step("xchg", [_call(coord, {"op": "xchg", "member": 0, "epoch": 2,
                                "key": "K", "idx": 0, "blob": b"x0",
                                "timeout": 5}),
                  _call(coord, {"op": "gbar", "member": 0, "epoch": 2,
                                "name": "B", "idx": 0, "timeout": 5})])
    act = {"id": "tune:mv_apply_workers:4>6:g0", "kind": "tune",
           "rule": "apply_pool_sat", "flag": "mv_apply_workers",
           "frm": 4, "to": 6, "conflict": "tune:mv_apply_workers"}
    step("policy", [
        _call(coord, {"op": "policy_put", "member": 0, "epoch": 2,
                      "action": act}),
        _call(coord, {"op": "policy_put", "member": 0, "epoch": 2,
                      "action": act}),
        _call(coord, {"op": "policy_pull", "member": 0, "world": 1,
                      "timeout": 5})])
    step("replica", [
        _call(coord, {"op": "replica_join", "member": -1, "mode": "relay",
                      "token": "", "ring_bytes": 0, "lease_s": 5.0}),
        _call(coord, {"op": "replica_join", "member": -1, "mode": "tcp",
                      "token": "s@127.0.0.1:9", "ring_bytes": 0,
                      "lease_s": 5.0}),
        _call(coord, {"op": "replica_hb", "member": -1, "rid": 1}),
        _call(coord, {"op": "replica_roster", "member": 0, "latest": 7}),
        _call(coord, {"op": "replica_put", "member": 0, "rid": 1,
                      "version": 7, "blob": b"delta-7", "op_seq": 5}),
        _call(coord, {"op": "replica_fetch", "member": -1, "rid": 1,
                      "timeout": 5}),
        _call(coord, {"op": "replica_ack", "member": -1, "rid": 1,
                      "version": 7}),
        _call(coord, {"op": "replica_evict", "member": 0, "rid": 2}),
        _call(coord, {"op": "replica_hb", "member": -1, "rid": 2})])
    # the injected clock again: replica 1's lease is 6 s old
    now = time.monotonic()
    with coord._lock:
        coord._replicas[1].last_hb = now - 6.0
        rdead = coord._reap_replicas(now)
    step("replica_reap", [rdead, _call(coord, {"op": "replica_roster",
                                               "member": 0})])
    step("state", [_call(coord, {"op": "state", "member": 0})])
    return {"steps": steps}


def mode_dialer():
    out = {"parse": [
        dialer.parse_endpoints("127.0.0.1:5,h2:6"),
        dialer.parse_endpoints(("h", 7)),
        dialer.parse_endpoints([("a", 1), "b:2"]),
    ]}
    try:
        dialer.parse_endpoints("nohostport")
        out["bad"] = "accepted"
    except FatalError:
        out["bad"] = "FatalError"
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()                     # refused from here on
    live = socket.socket()
    live.bind(("127.0.0.1", 0))
    live.listen(8)
    live_port = live.getsockname()[1]
    d = dialer.Dialer([("127.0.0.1", dead_port), ("127.0.0.1", live_port)],
                      what="t", deadline_s=5.0)
    sock = d.dial()
    landed = sock.getpeername()[1] == live_port
    sock.close()
    out["landed_on_live"] = landed
    out["active_index"] = d.endpoints.index(d.active)
    out["failover_gen"] = d.failover_gen
    d.mark_failed()
    out["after_mark_failed"] = d.endpoints.index(d.active)
    sock = d.dial()              # from the dead endpoint, back to live
    sock.close()
    out["failover_gen_after"] = d.failover_gen
    lone = dialer.Dialer([("127.0.0.1", dead_port)], what="t",
                         deadline_s=0.3)
    try:
        lone.dial()
        out["unreachable"] = None
    except Exception as exc:
        out["unreachable"] = [type(exc).__name__,
                              isinstance(exc, _transient()),
                              [list(e) for e in exc.endpoints]
                              == [["127.0.0.1", dead_port]]]
    live.close()
    out["parse"] = [[list(e) for e in p] for p in out["parse"]]
    return out


def _records(srv):
    return [{"seq": r["seq"], "kind": r["kind"], "data": r["data"]}
            for r in srv.records()]


def mode_ha():
    StandbyServer = standby.StandbyServer
    out = {}

    def world(lease_s=30.0):
        srv = StandbyServer(("127.0.0.1", 0), ("127.0.0.1", 0),
                            lease_s=3600.0, coord_lease_s=lease_s)
        coord = coordinator.Coordinator("127.0.0.1", 0, lease_s)
        coord.attach_standby(f"127.0.0.1:{srv.port}")
        clients = [coordinator.MemberClient("127.0.0.1", coord.port, r,
                                            lease_s) for r in range(2)]
        return srv, coord, clients

    # (a) the mixed op script: live digest == replayed digest
    srv, coord, (c0, c1) = world()
    act = {"id": "route:t0:s0>s1:g0", "kind": "route",
           "rule": "shard_imbalance", "table": 0, "src": 0, "dst": 1,
           "conflict": "route:t0"}
    replies = [
        c0.call("register"), c1.call("register"), c0.call("hb"),
        c0.call("shard_put", epoch=1, table_id=0, shard=0,
                blob=b"row-bytes-0"),
        c1.call("shard_put", epoch=1, table_id=0, shard=1,
                blob=b"row-bytes-1"),
        c0.call("policy_put", epoch=0, action=act),
        c1.call("policy_put", epoch=0, action=act),       # the dup
        c0.call("replica_join", mode="relay", token="", ring_bytes=0,
                lease_s=5.0),
        c0.call("replica_join", mode="shm", token="sess-7",
                ring_bytes=1 << 20, lease_s=5.0),
        c1.call("replica_ack", rid=1, version=3),
        c0.call("replica_roster", latest=4),
        c1.call("replica_hb", rid=2),
        c0.call("replica_evict", rid=2),
        c1.call("leave"),
    ]
    live = coord.state_digest()
    time.sleep(0.2)
    recs = _records(srv)
    succ = srv.force_takeover("digest pin")
    out["script"] = {"replies": _jsonable(replies), "live": live,
                     "replayed": succ.state_digest(),
                     "records": _jsonable(recs),
                     "state": _jsonable(succ._op_state({})),
                     "takeover_ms_set": srv.takeover_ms is not None,
                     "again_is_same": srv.force_takeover("x") is succ}
    coord.stop()
    srv.stop()

    # (b) the acked op survives a kill with no goodbye
    srv, coord, (c0, c1) = world()
    c0.call("register")
    c0.call("shard_put", epoch=1, table_id=0, shard=0,
            blob=b"acked-before-death")
    coord.simulate_kill()
    succ = srv.force_takeover("primary died")
    got = succ._op_shard_get({"epoch": 1, "table_id": 0, "shard": 0,
                              "timeout": 1.0})
    with succ._lock:
        status = succ.members[0].status
    out["kill"] = {"blob": _jsonable(got["blob"]), "status": status,
                   "primary_standby": coord.standby_state}
    coord.stop()
    srv.stop()

    # (c) heartbeats compact to the newest per member
    srv, coord, (c0, c1) = world()
    c0.call("register")
    for _ in range(25):
        c0.call("hb")
    deadline = time.monotonic() + 5.0
    while srv.record_count() > 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    out["compact"] = {"count": srv.record_count(),
                      "kinds": [r["kind"] for r in srv.records()]}
    coord.stop()
    srv.stop()

    # (d) the standby dies: the primary degrades to solo and serves on
    srv, coord, (c0, c1) = world()
    c0.call("register")
    before = coord.standby_state
    srv.stop()
    deadline = time.monotonic() + 10.0
    while coord.standby_state == "replicated" and \
            time.monotonic() < deadline:
        try:
            c0.call("hb")
        except Exception:
            pass
        time.sleep(0.05)
    c0.call("shard_put", epoch=1, table_id=0, shard=0, blob=b"solo")
    out["degrade"] = {
        "before": before, "after": coord.standby_state,
        "state": c0.call("state")["standby"],
        "solo_get": _jsonable(c0.call("shard_get", epoch=1, table_id=0,
                                      shard=0, timeout=2.0)["blob"])}
    coord.stop()

    # (e) the takeover lease's boundary (injected clocks)
    lease = {}
    sb = StandbyServer(("127.0.0.1", 0), ("127.0.0.1", 0), lease_s=0.1,
                       coord_lease_s=30.0)
    lease["before_seen"] = sb._lease_expired(time.monotonic() + 3600.0)
    sb.stop()
    sb = StandbyServer(("127.0.0.1", 0), ("127.0.0.1", 0), lease_s=5.0,
                       coord_lease_s=30.0)
    t0 = time.monotonic()
    with sb._lock:
        sb._primary_seen = True
        sb._last_feed = t0
    lease["edges"] = [sb._lease_expired(t0 + 5.0 - 1e-3),
                      sb._lease_expired(t0 + 5.0),
                      sb._lease_expired(t0 + 5.0 + 1e-3)]
    sb.force_takeover("test")
    lease["after_takeover"] = sb._lease_expired(time.monotonic() + 3600.0)
    sb.stop()
    out["lease"] = lease

    # (f) rebase_clocks: a stale clock reaps without it, not with it
    regs = [{"seq": 1, "kind": "register", "data": {"rank": 0}},
            {"seq": 2, "kind": "register", "data": {"rank": 1}},
            {"seq": 3, "kind": "replica_join",
             "data": {"rid": 1, "mode": "relay", "token": "",
                      "ring_bytes": 0, "lease_s": 0.3}}]
    stale = time.monotonic() - 100.0
    reaps = []
    for rebase in (False, True):
        c = coordinator.Coordinator("127.0.0.1", 0, 0.3, serve=False)
        c.replay(regs)
        with c._lock:
            for rec in c.members.values():
                rec.last_hb = stale
            for rrec in c._replicas.values():
                rrec.last_hb = stale
        if rebase:
            c.rebase_clocks()
        with c._lock:
            reaps.append({"members": c._reap_expired(),
                          "replicas": c._reap_replicas(),
                          "needs_base": [r.needs_base for r in
                                         c._replicas.values()]})
    out["rebase"] = reaps
    return out


def mode_policy():
    coord = coordinator.Coordinator("127.0.0.1", 0, 10.0, serve=False)
    steps = []

    def step(name, replies):
        steps.append({"step": name, "replies": _jsonable(replies),
                      "digest": coord.state_digest()})

    def act(i, table=0):
        return {"id": f"route:t{table}:s0>s1:g{i}", "kind": "route",
                "rule": "shard_imbalance", "table": table, "src": 0,
                "dst": 1, "conflict": f"route:t{table}"}

    def pulls(armed, timeout=10):
        return _together(coord, [{"op": "policy_pull", "member": r,
                                  "world": 2, "armed": armed[r],
                                  "timeout": timeout} for r in (0, 1)])

    step("put", [_call(coord, {"op": "policy_put", "member": 0,
                               "epoch": 0, "action": act(0)}),
                 _call(coord, {"op": "policy_put", "member": 1,
                               "epoch": 0, "action": act(0)}),
                 _call(coord, {"op": "policy_put", "member": 1,
                               "epoch": 0, "action": act(1, 2)})])
    step("pull", pulls((True, True)))
    step("redeliver", [_call(coord, {"op": "policy_put", "member": 0,
                                     "epoch": 0, "action": act(0)})])
    step("put_veto", [_call(coord, {"op": "policy_put", "member": 0,
                                    "epoch": 0, "action": act(2)})])
    step("pull_veto", pulls((True, False)))
    step("restage", [_call(coord, {"op": "policy_put", "member": 1,
                                   "epoch": 0, "action": act(2)})])
    step("pull_lone", [_call(coord, {"op": "policy_pull", "member": 0,
                                     "world": 2, "timeout": 0.3})])
    step("pull_after", pulls((True, True)))
    # an epoch install resets the pull era and drops stale staged actions
    step("put_stale", [_call(coord, {"op": "policy_put", "member": 0,
                                     "epoch": 0, "action": act(3)})])
    with coord._lock:
        coord._ap_install({"t": {"epoch": 1, "members": [0, 1],
                                 "departed": [], "joined": [],
                                 "sync_gen": None}})
    step("install", [_call(coord, {"op": "state", "member": 0})])
    step("pull_new_era", pulls((True, True)))
    return {"steps": steps}


def _wait_status(path, role, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as fh:
                st = json.load(fh)
            if st.get("role") == role:
                return st
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"no {role!r} status in {path}")


def mode_kill9():
    import subprocess
    mod = ("multiverso_tpu" if PKG == "jax" else "multiverso_tpu_torch") \
        + ".elastic.standby"
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    succ_port = s.getsockname()[1]
    s.close()
    sb_status = os.path.join(OUTDIR, f"{PKG}_standby.json")
    pr_status = os.path.join(OUTDIR, f"{PKG}_primary.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def spawn(args):
        return subprocess.Popen([sys.executable, "-m", mod] + args,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.STDOUT, env=env)

    standby_p = spawn(["--listen", "127.0.0.1:0",
                       "--serve", f"127.0.0.1:{succ_port}",
                       "--lease", "1.0", "--coord-lease", "30",
                       "--status-file", sb_status])
    primary_p = None
    out = {}
    try:
        log_port = _wait_status(sb_status, "standby")["log_port"]
        primary_p = spawn(["--primary", "127.0.0.1:0",
                           "--standby", f"127.0.0.1:{log_port}",
                           "--coord-lease", "30",
                           "--status-file", pr_status])
        pst = _wait_status(pr_status, "primary")
        out["primary_status"] = {k: pst.get(k) for k in
                                 ("role", "standby", "cuda_initialized")}
        prim = pst["port"]
        client = coordinator.MemberClient(
            "127.0.0.1", prim, 0, 30.0,
            endpoints=[("127.0.0.1", prim), ("127.0.0.1", succ_port)])
        client.call("register")
        act = {"id": "route:t0:s0>s1:g0", "kind": "route",
               "rule": "shard_imbalance", "table": 0, "src": 0, "dst": 1,
               "conflict": "route:t0"}
        out["first_put_dup"] = client.call("policy_put", epoch=0,
                                           action=act)["dup"]
        acked, stop = [], threading.Event()

        def hammer():
            shard = 0
            while not stop.is_set():
                shard += 1
                blob = b"payload-%d" % shard
                try:
                    client.call_retry("shard_put", attempts=6, epoch=1,
                                      table_id=0, shard=shard, blob=blob)
                    acked.append((shard, blob))
                except Exception:
                    return
                time.sleep(0.01)

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        time.sleep(0.4)
        primary_p.kill()                    # kill -9, no goodbye
        primary_p.wait(10)
        sst = _wait_status(sb_status, "successor")
        out["successor_status"] = {
            "role": sst["role"], "port_is_serve": sst["port"] == succ_port,
            "records_ge_1": sst["records"] >= 1,
            "cuda_initialized": sst.get("cuda_initialized")}
        time.sleep(0.5)
        stop.set()
        t.join(30)
        out["acked_any"] = bool(acked)
        out["all_acked_present"] = all(
            client.call("shard_get", epoch=1, table_id=0, shard=sh,
                        timeout=5.0)["blob"] == blob for sh, blob in acked)
        st = client.call("state")
        out["status0"] = st["statuses"][0]
        out["standby"] = st["standby"]
        out["redelivered_dup"] = client.call("policy_put", epoch=0,
                                             action=act)["dup"]
        out["failed_over"] = client.failover_gen >= 1
    finally:
        for p in (standby_p, primary_p):
            if p is not None:
                p.kill()
                p.wait(10)
    return out


def _transient():
    if PKG == "jax":
        from multiverso_tpu.failsafe.errors import TransientError
    else:
        from multiverso_tpu_torch.failsafe.errors import TransientError
    return TransientError


def mode_fleet():
    rollups = fleet_rollups(fleet, metrics)
    blobs = [fleet.encode_rollup(r) for r in rollups]
    with open(os.path.join(OUTDIR, f"{PKG}_rollups.bin"), "wb") as f:
        for b in blobs:
            f.write(len(b).to_bytes(8, "little") + b)
    other = os.path.join(OUTDIR,
                         ("torch" if PKG == "jax" else "jax") +
                         "_rollups.bin")
    decoded = None
    if os.path.exists(other):
        decoded = []
        raw = open(other, "rb").read()
        pos = 0
        while pos < len(raw):
            n = int.from_bytes(raw[pos:pos + 8], "little")
            decoded.append(fleet.decode_rollup(raw[pos + 8:pos + 8 + n]))
            pos += 8 + n
    acc = fleet.FleetAccumulator()
    t0 = 1000.0
    reports, samples = [], []
    for i, b in enumerate(blobs):
        acc.ingest(b, now=t0 + (i // 4) * 2.0 + 0.01 * (i % 4))
        if i % 4 == 3:
            reports.append(acc.report(now=t0 + (i // 4) * 2.0 + 1.0))
            samples.append(acc.peek_sample(now=t0 + (i // 4) * 2.0 + 1.0))
    samples.append(acc.peek_sample(now=t0 + 60.0))     # every rollup stale
    rules = [watchdog.FleetP99BreachRule(threshold_s=0.05),
             watchdog.MemberQpsOutlierRule(min_peer_qps=1.0),
             watchdog.RollupStaleRule(stale_s=10.0)]
    verdicts = {}
    for rule in rules:
        verdicts[rule.name] = [
            "HOLD" if v is watchdog.HOLD else v
            for v in (rule.check(samples[:k])
                      for k in range(1, len(samples) + 1))]
    fleet.shutdown_plane()
    empty = fleet.status_lines()
    for b in blobs:
        fleet.ingest(b)
    lines = fleet.status_lines()
    fleet.shutdown_plane()
    return {"decoded": _jsonable(decoded), "reports": _jsonable(reports),
            "samples": _jsonable(samples), "verdicts": verdicts,
            "empty_lines": empty, "line_count": len(lines),
            "line_head": [ln.split(" qps=")[0] for ln in lines]}


if __name__ == "__main__":
    fn = {"coord": mode_coord, "dialer": mode_dialer, "ha": mode_ha,
          "policy": mode_policy, "kill9": mode_kill9,
          "fleet": mode_fleet}[MODE]
    print(json.dumps(fn(), sort_keys=True))
    sys.stdout.flush()
    os._exit(0)
