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
  shrunk view, state. Prints every reply (errors as their type name) and
  ``state_digest()`` after each step.
* ``dialer`` — ``parse_endpoints`` over the flag's forms, and a dialer
  over a refused endpoint then a listening one: the endpoint it lands
  on, ``failover_gen``, the cursor after ``mark_failed``, and the typed
  error over refused endpoints only.
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
    from multiverso_tpu.elastic import coordinator, dialer
    from multiverso_tpu.telemetry import fleet, metrics, watchdog
    from multiverso_tpu.utils.log import FatalError
else:
    import multiverso_tpu_torch as pkg  # noqa: F401
    from multiverso_tpu_torch.elastic import coordinator, dialer
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
    fn = {"coord": mode_coord, "dialer": mode_dialer,
          "fleet": mode_fleet}[MODE]
    print(json.dumps(fn(), sort_keys=True))
    sys.stdout.flush()
    os._exit(0)
