"""The policy plane live in a one-process world, held against the JAX
package's (``tests/test_policy.py`` ``TestLiveRouteInstall``).

(a) A route installs at the cross-stream cut: a sharded engine (two
    shards, four tables on the modulo map), a synthetic ``shard_imbalance``
    alert recorded through the real watchdog's stream stamp, two tick
    records into the live plane's ``PolicyEngine``. The routing report
    before and after, the action ids, the ``policy.*`` flight kinds and
    the report's counts equal the JAX world's on the same script; verbs
    of table 0 then ride stream 1; the route event shares the alert's
    membership epoch and lands at or after its SEQ; forensics reads the
    ring as stream-clean; ``MV_PolicyReport`` shows the install.
(b) The tune round trip: a ``mailbox_backlog`` tick raises
    ``-mv_pipeline_depth`` by one in both packages, ``policy.tune`` is in
    the ring, ``/healthz`` carries the armed ``policy`` line and
    ``/actions`` the install; a world without ``-mv_policy`` answers
    ``/actions`` with the same "off" document as the JAX package and names
    only the replica plane as not running.

Tolerance: equal records.
"""

import json
import urllib.request

import numpy as np

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401


def _rec(n, active=(), shards=None):
    sample = {"t": float(n)}
    if shards is not None:
        sample["shards"] = shards
    return {"ticks": n, "sample": sample, "fired": [],
            "active": list(active)}


def _get(port: int, path: str) -> dict:
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10).read())


def _route_world(mv, policy, flight, twd, forensics, MatrixTableOption, Zoo,
                 argv, tmp_path, tag) -> dict:
    flight._reset_for_tests()
    mv.MV_Init(argv + ["-mv_engine_shards=2", "-mv_watchdog_s=3600",
                       "-mv_policy=true", "-mv_policy_sustain=1",
                       "-mv_policy_cooldown_s=0"])
    try:
        tabs = [mv.MV_CreateTable(MatrixTableOption(num_rows=64,
                                                    num_cols=4))
                for _ in range(4)]
        ids = np.arange(64, dtype=np.int32)
        d = np.ones((64, 4), np.float32)
        for t in tabs:
            t.AddRows(ids, d)
        se = Zoo.Get().server_engine
        out = {"before": se.routing_report()}
        wd = twd.peek()
        wd.evaluate({"t": 1.0})
        mep, seq = twd.stream_pos()
        flight.record("alert.shard_imbalance", seq=seq, mepoch=mep,
                      detail="synthetic drill alert")
        eng = policy.peek()
        shards0 = [{"shard": 0, "apply_busy_s": 0.0,
                    "table_verbs": {0: 0, 2: 0}},
                   {"shard": 1, "apply_busy_s": 0.0,
                    "table_verbs": {1: 0, 3: 0}}]
        shards1 = [{"shard": 0, "apply_busy_s": 0.8,
                    "table_verbs": {0: 120, 2: 20}},
                   {"shard": 1, "apply_busy_s": 0.01,
                    "table_verbs": {1: 2, 3: 2}}]
        out["staged"] = [[a["id"] for a in eng.step(
            _rec(1, ["shard_imbalance"], shards0))],
            [a["id"] for a in eng.step(
                _rec(2, ["shard_imbalance"], shards1))]]
        out["after"] = se.routing_report()
        before = se._subs[1].table_verbs.get(0, 0)
        tabs[0].AddRows(ids, d)
        tabs[0].GetRows(ids)
        out["rerouted"] = se._subs[1].table_verbs.get(0, 0) > before
        evs = flight.events()
        out["policy_kinds"] = [e["kind"] for e in evs
                               if e["kind"].startswith("policy.")]
        act = next(e for e in evs if e["kind"] == "policy.route")
        alert = next(e for e in evs if e["kind"] == "alert.shard_imbalance")
        out["route_detail"] = act["detail"]
        out["aligned"] = (act["mepoch"] == alert["mepoch"] == 0
                          and alert["seq"] <= act["seq"])
        p0 = str(tmp_path / f"{tag}_flight_rank0.jsonl")
        p1 = str(tmp_path / f"{tag}_flight_rank1.jsonl")
        flight.dump(p0)
        flight.dump(p1)
        out["diverged"] = forensics.correlate([p0, p1])["diverged"]
        rep = mv.MV_PolicyReport()
        out["report"] = {k: rep[k] for k in ("installed", "staged",
                                             "reverted", "rejected")}
        out["statuses"] = [r["status"] for r in rep["actions"]]
        return json.loads(json.dumps(out))
    finally:
        mv.MV_ShutDown()


def test_route_installs_at_the_cut_verbs_follow_flight_aligns(tmp_path):
    import multiverso_tpu as jmv
    from multiverso_tpu import policy as jpolicy
    from multiverso_tpu.tables import MatrixTableOption as JOpt
    from multiverso_tpu.telemetry import flight as jflight
    from multiverso_tpu.telemetry import forensics as jfor
    from multiverso_tpu.telemetry import watchdog as jwd
    from multiverso_tpu.zoo import Zoo as JZoo
    want = _route_world(jmv, jpolicy, jflight, jwd, jfor, JOpt, JZoo, [],
                        tmp_path, "jax")

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import policy
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.telemetry import flight, forensics
    from multiverso_tpu_torch.telemetry import watchdog as twd
    from multiverso_tpu_torch.zoo import Zoo
    got = _route_world(mv, policy, flight, twd, forensics, MatrixTableOption,
                       Zoo, ["-mv_device=cpu"], tmp_path, "torch")
    assert got == want
    assert got["before"]["routing"] == {"0": 0, "1": 1, "2": 0, "3": 1}
    assert got["after"]["overrides"] == {"0": 1}
    assert got["after"]["routing"]["0"] == 1
    assert got["after"]["installs"] == 1
    assert got["staged"] == [[], ["route:t0:s0>s1:g0"]]
    assert got["rerouted"] and got["aligned"] and not got["diverged"]
    assert got["policy_kinds"] == ["policy.staged", "policy.route"]
    assert "id=route:t0:s0>s1:g0" in got["route_detail"]
    assert got["report"]["installed"] == 1 and "installed" in got["statuses"]


def _tune_world(mv, policy, flight, ops, GetFlag, argv) -> dict:
    out = {}
    flight._reset_for_tests()
    mv.MV_Init(argv + ["-mv_ops_port=0", "-mv_watchdog_s=3600",
                       "-mv_policy=true", "-mv_policy_sustain=1",
                       "-mv_policy_cooldown_s=0"])
    try:
        eng = policy.peek()
        depth0 = int(GetFlag("mv_pipeline_depth"))
        eng.step(_rec(1, ["mailbox_backlog"]))
        out["depth"] = [depth0, int(GetFlag("mv_pipeline_depth"))]
        out["tuned"] = "policy.tune" in [e["kind"] for e in flight.events()]
        hz = _get(ops.port(), "/healthz")
        out["policy_line"] = {k: hz["policy"][k] for k in
                              ("armed", "installed", "reverted", "drains",
                               "last_action")}
        body = _get(ops.port(), "/actions")
        out["actions"] = {k: body[k] for k in ("enabled", "armed",
                                               "installed", "world")}
        out["action_ids"] = [a["id"] for a in body["actions"]]
    finally:
        mv.MV_ShutDown()
    mv.MV_Init(argv + ["-mv_ops_port=0"])
    try:
        out["off"] = _get(ops.port(), "/actions")
        out["off_policy_line"] = "policy" in _get(ops.port(), "/healthz")
        out["off_healthz"] = _get(ops.port(), "/healthz")
    finally:
        mv.MV_ShutDown()
    return out


def test_tune_round_trip_healthz_and_actions_match_jax():
    import multiverso_tpu as jmv
    from multiverso_tpu import policy as jpolicy
    from multiverso_tpu.telemetry import flight as jflight
    from multiverso_tpu.telemetry import ops as jops
    from multiverso_tpu.utils.configure import GetFlag as jget
    want = _tune_world(jmv, jpolicy, jflight, jops, jget, [])

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import policy
    from multiverso_tpu_torch.telemetry import flight, ops
    from multiverso_tpu_torch.utils.configure import GetFlag
    got = _tune_world(mv, policy, flight, ops, GetFlag, ["-mv_device=cpu"])
    hz, jhz = got.pop("off_healthz"), want.pop("off_healthz")
    assert got == want
    assert got["depth"][1] == got["depth"][0] + 1 and got["tuned"]
    assert got["policy_line"]["armed"] is True
    assert got["policy_line"]["installed"] == 1
    assert got["actions"]["enabled"] and got["actions"]["installed"] == 1
    assert got["off"]["enabled"] is False and "mv_policy" in \
        got["off"]["note"]
    assert not got["off_policy_line"]
    # the JAX document has no not_running key; the port names only the
    # replica plane, the one JAX plane it does not run
    assert "not_running" not in jhz and hz["not_running"] == ["replica"]
