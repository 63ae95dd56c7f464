"""The port's policy engine and the coordinator's policy ops held against
the JAX package's.

(a) The same tick-record sequences fed to each package's
    ``PolicyEngine`` (a ``LocalStager`` and a fake applier that records
    installs and keeps its own routing report), one case for each of the
    JAX guard, flap and revert tests (``tests/test_policy.py`` ``TestGuards``,
    ``TestFlapChaos``, ``TestRevert``): sustain then cooldown, the kill
    switch watching, per-rule enables, the rails, the window budget inside
    one evaluation, the kill switch vetoing staged actions and the re-stage
    after re-arming, the single-process drain guard, strict flap
    alternation absorbed by sustain, at most one action per cooldown window
    under ``policy.flap``, the unimproved tune reverted and burned, the
    improved action kept, the route revert restoring the previous slot.
    Every evaluation's staged actions, the applier's installs, the action
    history's statuses and the report (less wall-clock stamps) are equal.
(b) The coordinator's policy ops (``tests/_elastic_child.py policy``, one
    interpreter a package): policy_put with a duplicate, a two-member pull
    rendezvous, a re-delivery after the pull, a vetoed pull that un-sees
    its keys, the re-stage, a pull that times out and withdraws, an epoch
    install resetting the pull era: equal replies and digests.
(c) The tuned flags reach the hot paths through their listener caches, and
    the apply pool rebuilds at the next window when ``-mv_apply_workers``
    changed (clamped at 2), as in the JAX package.

Tolerance: equal records.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


class FakeApplier:
    """Records installs, applies route overrides to its own routing
    report, echoes tune results (``tests/test_policy.py``'s)."""

    def __init__(self, live_slots=(0, 1), routing=None):
        self.calls = []
        self.routing = {"shard_cap": len(live_slots),
                        "live_slots": list(live_slots),
                        "installs": 0, "overrides": {},
                        "routing": dict(routing or {})}

    def routing_report(self):
        return self.routing

    def install_actions(self, actions):
        out = []
        for a in actions:
            self.calls.append(dict(a))
            if a["kind"] == "route":
                prev = self.routing["routing"].get(a["table"], a["src"])
                self.routing["routing"][a["table"]] = a["dst"]
                res = {"applied": [(a["table"], prev, a["dst"])]}
            else:
                res = {"frm": a.get("frm"), "to": a["to"]}
            out.append((dict(a), res))
        return out


def _rec(n, active=(), shards=None):
    sample = {"t": float(n)}
    if shards is not None:
        sample["shards"] = shards
    return {"ticks": n, "sample": sample, "fired": [],
            "active": list(active)}


_S0 = [{"shard": 0, "apply_busy_s": 0.0, "table_verbs": {0: 0, 2: 0}},
       {"shard": 1, "apply_busy_s": 0.0, "table_verbs": {1: 0, 3: 0}}]
_S1 = [{"shard": 0, "apply_busy_s": 1.0, "table_verbs": {0: 500, 2: 40}},
       {"shard": 1, "apply_busy_s": 0.02, "table_verbs": {1: 3, 3: 2}}]

_SAT, _MB = ["apply_pool_sat"], ["mailbox_backlog"]

#: case -> (engine flags, routing of the fake applier, script). Script
#: entries: ("step", n, active, shards), ("flag", name, value),
#: ("world", w), ("actuate",)
CASES = {
    "sustain_then_cooldown": (
        {"mv_policy_sustain": "2", "mv_policy_cooldown_s": "3600",
         "mv_policy_revert_after": "100"}, None,
        [("step", n, _SAT, None) for n in range(1, 10)]),
    "kill_switch_watches": (
        {"mv_policy_sustain": "1", "mv_policy_cooldown_s": "0"}, None,
        [("flag", "mv_policy", "false")]
        + [("step", n, _SAT, None) for n in range(1, 5)]
        + [("flag", "mv_policy", "true"), ("step", 5, _SAT, None)]),
    "per_rule_enable": (
        {"mv_policy_sustain": "1", "mv_policy_cooldown_s": "0",
         "mv_policy_rules": "shard_imbalance"}, None,
        [("step", n, _SAT, None) for n in range(1, 4)]),
    "rails": (
        {"mv_policy_sustain": "1", "mv_policy_cooldown_s": "0",
         "mv_apply_workers": "16", "mv_pipeline_depth": "8"}, None,
        [("step", 1, _SAT, None), ("step", 2, _MB, None)]),
    "window_budget": (
        {"mv_policy_sustain": "1", "mv_policy_cooldown_s": "0",
         "mv_policy_max_actions": "1", "mv_policy_window_s": "3600"}, None,
        [("step", 1, _SAT + _MB, None), ("step", 2, _SAT + _MB, None)]),
    "kill_vetoes_staged": (
        {"mv_policy_sustain": "1", "mv_policy_cooldown_s": "0"}, None,
        [("world", 2), ("step", 1, _SAT, None),
         ("flag", "mv_policy", "false"), ("world", 1), ("actuate",),
         ("flag", "mv_policy", "true"), ("step", 2, _SAT, None)]),
    "drain_single_process": (
        {"mv_policy_sustain": "1", "mv_policy_cooldown_s": "0"}, None,
        [("step", n, ["straggler"], None) for n in range(1, 6)]),
    "flap_alternation": (
        {"mv_policy_sustain": "2", "mv_policy_cooldown_s": "0",
         "chaos_spec": "policy.flap:1.0@1", "chaos_seed": "7"}, None,
        [("step", n, (), None) for n in range(1, 13)]),
    "flap_cooldown": (
        {"mv_policy_sustain": "2", "mv_policy_cooldown_s": "3600",
         "chaos_spec": "policy.flap:1.0@2", "chaos_seed": "7"}, None,
        [("step", n, (), None) for n in range(1, 17)]),
    "revert_unimproved": (
        {"mv_policy_sustain": "1", "mv_policy_cooldown_s": "0",
         "mv_policy_revert_after": "3", "mv_apply_workers": "4"}, None,
        [("step", n, _SAT, None) for n in range(1, 10)]
        + [("step", 10, (), None), ("step", 11, _SAT, None)]),
    "improved_kept": (
        {"mv_policy_sustain": "1", "mv_policy_cooldown_s": "0",
         "mv_policy_revert_after": "3"}, None,
        [("step", 1, _SAT, None)]
        + [("step", n, (), None) for n in range(2, 10)]),
    "route_revert": (
        {"mv_policy_sustain": "1", "mv_policy_cooldown_s": "0",
         "mv_policy_revert_after": "2"}, {0: 0, 1: 1, 2: 0, 3: 1},
        [("step", 1, ["shard_imbalance"], _S0),
         ("step", 2, ["shard_imbalance"], _S1)]
        + [("step", n, ["shard_imbalance"], _S1) for n in range(3, 6)]),
}


def _packages():
    import multiverso_tpu.sync.server  # noqa: F401  (the tuned flags)
    import multiverso_tpu_torch.sync.server  # noqa: F401
    from multiverso_tpu.policy import engine as jeng
    from multiverso_tpu.utils import configure as jcfg
    from multiverso_tpu_torch.policy import engine as teng
    from multiverso_tpu_torch.utils import configure as tcfg
    return {"jax": (jeng, jcfg), "torch": (teng, tcfg)}


def _strip(obj):
    """Drop wall-clock stamps; tuples -> lists (JSON-like equality)."""
    return json.loads(json.dumps(obj, default=list), object_hook=lambda d: {
        k: v for k, v in d.items() if k != "t"})


def _run_case(eng_mod, cfg, flags, routing, script) -> dict:
    cfg.SetCMDFlag("mv_policy", "true")
    try:
        for k, v in flags.items():
            cfg.SetCMDFlag(k, v)
        applier = FakeApplier(routing=routing)
        eng = eng_mod.PolicyEngine(eng_mod.LocalStager(), me=0, world=1,
                                   applier=applier)
        staged = []
        for op in script:
            if op[0] == "step":
                staged.append(eng.step(_rec(op[1], op[2], op[3])))
            elif op[0] == "flag":
                cfg.SetCMDFlag(op[1], op[2])
            elif op[0] == "world":
                eng.world = op[1]
            else:
                staged.append(("actuate", eng.actuate()))
        return _strip({"staged": staged, "calls": applier.calls,
                       "routing": applier.routing,
                       "history": list(eng.history),
                       "report": eng.report()})
    finally:
        cfg.ResetFlagsToDefaults()


def test_policy_engine_guards_flap_and_revert_match_jax():
    pk = _packages()
    for name, (flags, routing, script) in CASES.items():
        want = _run_case(*pk["jax"], flags, routing, script)
        got = _run_case(*pk["torch"], flags, routing, script)
        assert got == want, name
        calls = got["calls"]
        statuses = [h["status"] for h in got["history"]]
        # what each JAX test asserts, on the port's record
        if name == "sustain_then_cooldown":
            assert [c["flag"] for c in calls] == ["mv_apply_workers"]
        elif name in ("per_rule_enable", "rails", "drain_single_process",
                      "flap_alternation"):
            assert calls == [], name
        elif name == "kill_switch_watches":
            assert len(calls) == 1 and got["staged"][-1]
        elif name == "window_budget":
            assert len(got["staged"][0]) == 1 and len(calls) == 1
        elif name == "kill_vetoes_staged":
            assert len(calls) == 1 and "discarded-killed" in statuses
        elif name == "flap_cooldown":
            assert len(calls) == 1
        elif name == "revert_unimproved":
            reverts = [c for c in calls if c.get("revert_of")]
            assert len(reverts) == 1 and reverts[0]["to"] == 4
            assert len(calls) == 3          # install, revert, re-act
        elif name == "improved_kept":
            assert len(calls) == 1 and "improved" in statuses
        elif name == "route_revert":
            assert calls[0]["table"] == 0 and calls[0]["dst"] == 1
            assert calls[-1]["revert_of"] and calls[-1]["dst"] == 0
            assert got["routing"]["routing"]["0"] == 0


def _child(mode: str, pkg: str, outdir) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_elastic_child.py"), mode,
         pkg, str(outdir)], env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_coordinator_policy_ops_match_jax(tmp_path):
    got = _child("policy", "torch", tmp_path)
    want = _child("policy", "jax", tmp_path)
    assert [s["step"] for s in got["steps"]] == [
        "put", "pull", "redeliver", "put_veto", "pull_veto", "restage",
        "pull_lone", "pull_after", "put_stale", "install", "pull_new_era"]
    for g, w in zip(got["steps"], want["steps"]):
        assert g == w, (g["step"], g, w)
    steps = {s["step"]: s["replies"] for s in got["steps"]}
    assert [r["dup"] for r in steps["put"]] == [False, True, False]
    assert steps["pull"][0] == steps["pull"][1]
    assert len(steps["pull"][0]["actions"]) == 2
    assert steps["redeliver"][0]["dup"] is True      # the seen-set stays
    assert [r["acting"] for r in steps["pull_veto"]] == [False, False]
    assert steps["restage"][0]["dup"] is False       # the veto un-saw it
    assert steps["pull_lone"] == [{"raised": "TransientError"}]
    assert steps["pull_new_era"][0] == {"acting": True, "actions": []}


def test_tuned_flags_and_apply_pool_rebuild_match_jax():
    pk = _packages()
    from multiverso_tpu.sync import server as jsrv
    from multiverso_tpu_torch.sync import server as tsrv

    def run(srv_mod, cfg, **kw):
        out = []
        srv = srv_mod.Server(name="pooltest", **kw)
        try:
            cfg.SetCMDFlag("mv_apply_workers", 6)
            cfg.SetCMDFlag("mv_pipeline_depth", 5)
            out.append((srv_mod._apply_workers_flag(),
                        srv_mod._pipeline_depth_flag()))
            cfg.SetCMDFlag("mv_apply_workers", 4)
            p1 = srv._ensure_apply_pool()
            out.append(p1.workers)
            out.append(srv._ensure_apply_pool() is p1)
            cfg.SetCMDFlag("mv_apply_workers", 8)
            p2 = srv._ensure_apply_pool()
            out.append((p2 is p1, p2.workers))
            cfg.SetCMDFlag("mv_apply_workers", 1)
            out.append(srv._ensure_apply_pool().workers)
        finally:
            cfg.ResetFlagsToDefaults()
            pool = srv._apply_pool
            if pool is not None:
                pool.shutdown()
        out.append((srv_mod._apply_workers_flag(),
                    srv_mod._pipeline_depth_flag()))
        return out

    want = run(jsrv, pk["jax"][1])
    got = run(tsrv, pk["torch"][1])
    assert got == want == [(6, 5), 4, True, (False, 8), 2, (4, 2)]
