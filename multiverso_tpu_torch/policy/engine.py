"""Policy engine: guarded conversion of sustained alerts into actions.

The port's own copy of ``multiverso_tpu/policy/engine.py``: the decision
core of the self-driving runtime. One
:class:`PolicyEngine` per process consumes the watchdog's tick records
(the alert->action hand-off registered at plane start), converts
SUSTAINED alerts into typed action proposals through a stack of guards,
stages them at-most-once, and — in single-process worlds — installs
them at a fenced engine cut. Multi-process worlds split the roles: the
policy thread only STAGES (at the coordinator's ``policy_put``, keyed
``(epoch, action id)``), and the app-paced ``MV_PolicySync`` rendezvous
pulls the one agreed action list on every rank and installs it at each
rank's lockstep stream position — the same discipline every other cut
(checkpoint, publish, elastic transition) already demands.

The three closed loops:

=================  =====================================================
alert              action
=================  =====================================================
shard_imbalance    ``route`` — a table->shard routing-map override
                   (rebalance.plan_routing picks the hottest table of
                   the hottest engine stream and the coolest target
                   slot), installed via ShardedServer.install_routing
                   inside a cross-stream cut.
apply_pool_sat     ``tune`` — raise ``-mv_apply_workers`` one step
                   within the ``-mv_policy_workers_min/max`` rails (the
                   engine's apply pool rebuilds at the next window). The
                   port's watchdog never raises this alert (it reads a
                   native host-store pool the port does not have), so
                   this loop acts only on tick records that carry it.
mailbox_backlog    ``tune`` — raise ``-mv_pipeline_depth`` one step
                   within the ``-mv_policy_depth_min/max`` rails (the
                   exchange stage reads the cap per gate).
straggler          ``drain`` — escalation: the SICK rank (the alert is
                   a local proxy that fires on the culprit) proposes
                   its own guarded elastic drain; at the next
                   MV_PolicySync it runs MV_ElasticLeave while the
                   survivors run the matching MV_ElasticSync.
=================  =====================================================

Guards (every one a flag; ``-mv_policy`` itself is the runtime kill
switch, read through a listener cache on every evaluation):

* SUSTAIN — an alert must stay active ``-mv_policy_sustain``
  consecutive policy evaluations before it may act (drains need twice
  that: irreversible actions earn extra evidence).
* COOLDOWN — after an install, the triggering rule may not act again
  for ``-mv_policy_cooldown_s`` (chaos ``policy.flap`` + the regression
  test pin the no-amplification claim: alert flap never becomes action
  flap).
* WINDOW BUDGET — at most ``-mv_policy_max_actions`` installs per
  ``-mv_policy_window_s`` rolling window, across all rules.
* RAILS — tunables clamp to their min/max flags; a rule already at its
  rail proposes nothing.
* PER-RULE ENABLES — ``-mv_policy_rules`` ("all" or a comma list).
* REVERT — every installed route/tune is tracked: if the triggering
  alert is still active after ``-mv_policy_revert_after`` further
  evaluations, the inverse action is staged and the rule is BURNED
  (no new action) until its alert clears — the self-driving loop must
  never oscillate on a correction that did not help.

Every transition is a typed event: ``policy.*`` counters, a
``policy.staged`` / ``policy.route`` / ``policy.tune`` /
``policy.drain`` / ``policy.revert`` flight record stamped with
``(mepoch, head-stream SEQ)`` — the same keying the alert events carry,
so forensics aligns an action with its triggering alert — and a bounded
action history served at ``/actions``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional

from multiverso_tpu_torch.failsafe import chaos
from multiverso_tpu_torch.failsafe import deadline as fdeadline
from multiverso_tpu_torch.telemetry import flight as tflight
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import watchdog as twatchdog
from multiverso_tpu_torch.utils.configure import (GetFlag, MV_DEFINE_bool,
                                                  MV_DEFINE_double,
                                                  MV_DEFINE_int,
                                                  MV_DEFINE_string,
                                                  SetCMDFlag,
                                                  cached_bool_flag,
                                                  cached_float_flag,
                                                  cached_int_flag,
                                                  cached_str_flag)
from multiverso_tpu_torch.utils.log import Log

MV_DEFINE_bool("mv_policy", False,
               "policy plane (self-driving runtime): convert sustained "
               "watchdog alerts into guarded, flight-recorded engine-"
               "cut actions (hot-table re-routing, adaptive apply-"
               "workers/pipeline-depth, straggler drain escalation). "
               "Off by default; ALSO the runtime kill switch — setting "
               "it false mid-run (MV_SetFlag) stops all acting at the "
               "next evaluation while the plane keeps watching")
MV_DEFINE_string("mv_policy_addr", "",
                 "policy control authority endpoint host:port for "
                 "multi-process worlds WITHOUT -mv_elastic (rank 0 "
                 "hosts it; with -mv_elastic the policy ops ride the "
                 "membership coordinator instead). Single-process "
                 "worlds stage locally and ignore this")
MV_DEFINE_string("mv_policy_rules", "all",
                 "comma list of alert rules the policy may act on "
                 "(shard_imbalance, apply_pool_sat, mailbox_backlog, "
                 "straggler), or 'all'")
MV_DEFINE_double("mv_policy_cooldown_s", 10.0,
                 "minimum seconds between installed actions for one "
                 "rule — the anti-flap guard (chaos policy.flap "
                 "rehearses it)")
MV_DEFINE_double("mv_policy_window_s", 60.0,
                 "rolling window for -mv_policy_max_actions")
MV_DEFINE_int("mv_policy_max_actions", 4,
              "max actions installed per -mv_policy_window_s window, "
              "across all rules")
MV_DEFINE_int("mv_policy_sustain", 2,
              "consecutive policy evaluations an alert must stay "
              "active before it may act (drains require 2x)")
MV_DEFINE_int("mv_policy_revert_after", 6,
              "evaluations after an install before a still-active "
              "triggering alert stages the inverse action and burns "
              "the rule until it clears")
MV_DEFINE_int("mv_policy_workers_min", 1,
              "lower rail for adaptive -mv_apply_workers")
MV_DEFINE_int("mv_policy_workers_max", 16,
              "upper rail for adaptive -mv_apply_workers")
MV_DEFINE_int("mv_policy_depth_min", 1,
              "lower rail for adaptive -mv_pipeline_depth")
MV_DEFINE_int("mv_policy_depth_max", 8,
              "upper rail for adaptive -mv_pipeline_depth")
MV_DEFINE_int("mv_policy_min_members", 1,
              "a policy drain may never shrink the world below this "
              "many members")

_enabled = cached_bool_flag("mv_policy", False)
_rules_flag = cached_str_flag("mv_policy_rules", "all")
_cooldown_s = cached_float_flag("mv_policy_cooldown_s", 10.0)
_window_s = cached_float_flag("mv_policy_window_s", 60.0)
_max_actions = cached_int_flag("mv_policy_max_actions", 4)
_sustain = cached_int_flag("mv_policy_sustain", 2)
_revert_after = cached_int_flag("mv_policy_revert_after", 6)
_workers_min = cached_int_flag("mv_policy_workers_min", 1)
_workers_max = cached_int_flag("mv_policy_workers_max", 16)
_depth_min = cached_int_flag("mv_policy_depth_min", 1)
_depth_max = cached_int_flag("mv_policy_depth_max", 8)
_min_members = cached_int_flag("mv_policy_min_members", 1)

#: alert rules the policy knows how to act on
ACTABLE_RULES = ("shard_imbalance", "apply_pool_sat", "mailbox_backlog",
                 "straggler")

#: the rule whose verdict the chaos ``policy.flap`` site oscillates
#: (a tunable loop, so the rehearsal exercises a REAL decider)
FLAP_RULE = "mailbox_backlog"

#: the ``policy.*`` counter family, registered eagerly at plane start
#: (it scrapes at zero)
COUNTER_FAMILY = ("policy.evals", "policy.proposed", "policy.staged",
                  "policy.stage_dedup_hits", "policy.installed",
                  "policy.reverted", "policy.drains",
                  "policy.rejected")


def rule_enabled(rule: str) -> bool:
    spec = _rules_flag().strip()
    if spec in ("", "all"):
        return True
    return rule in {r.strip() for r in spec.split(",")}


def reduce_conflicts(actions: List[dict]) -> List[dict]:
    """Deterministic conflict reduction over one pulled action list:
    at most one action per ``conflict`` key (two ranks proposing
    different targets for one table, two drains in one window), FIRST
    in action-id sort order wins — every rank reduces the identical
    pulled list identically, so installs stay rank-agreed."""
    out: List[dict] = []
    seen = set()
    for a in sorted(actions, key=lambda a: str(a.get("id", ""))):
        key = a.get("conflict") or a.get("id")
        if key in seen:
            continue
        seen.add(key)
        out.append(a)
    return out


class LocalStager:
    """Single-process stager: the coordinator ``policy_put``/
    ``policy_pull`` contract (at-most-once by (epoch, id), drain-on-
    pull, persistent seen-set) without a socket."""

    def __init__(self):
        self._lock = threading.Lock()
        self._staged: List[dict] = []
        self._seen: set = set()
        self.dups = 0

    def put(self, action: dict, epoch: int = 0) -> bool:
        with self._lock:
            key = (int(epoch), str(action["id"]))
            if key in self._seen:
                self.dups += 1
                tmetrics.counter("policy.stage_dedup_hits").inc()
                return True
            self._seen.add(key)
            self._staged.append((key, dict(action)))
            return False

    def pull(self, world: int = 1, timeout: Optional[float] = None,
             armed: bool = True) -> tuple:
        with self._lock:
            staged = sorted(self._staged,
                            key=lambda ka: str(ka[1].get("id", "")))
            self._staged = []
            if not armed:
                # vetoed, never installed: forget the dedup keys so
                # the correction can re-stage after re-arming (the
                # coordinator op does the same)
                for k, _a in staged:
                    self._seen.discard(k)
            return [a for _k, a in staged], bool(armed)


class CoordStager:
    """Multi-process stager over the coordinator's policy control ops
    (elastic/coordinator.py): ``put`` retries transients (a chaos-
    duplicated delivery is absorbed by the (epoch, id) dedup), ``pull``
    is a plain call — arrivals are rendezvous generations, so a blind
    re-send would desync them (the elastic sync rule)."""

    def __init__(self, client):
        self.client = client

    def put(self, action: dict, epoch: int = 0) -> bool:
        resp = self.client.call_retry("policy_put", action=dict(action),
                                      epoch=int(epoch), timeout=10.0)
        return bool(resp.get("dup"))

    def pull(self, world: int, timeout: Optional[float] = None,
             armed: bool = True) -> tuple:
        resp = self.client.call("policy_pull", world=int(world),
                                armed=bool(armed),
                                timeout=float(timeout or 60.0))
        return (list(resp.get("actions", ())),
                bool(resp.get("acting", True)))


class EngineApplier:
    """Installs one route/tune batch at ONE fenced engine cut (a
    ``Request_StoreLoad`` payload — the cross-stream cut on a sharded
    engine): with every stream fenced, the routing map swaps and the
    tuned flags set at one consistent stream position, and the
    ``policy.*`` flight events are stamped with that position's
    ``(mepoch, SEQ)``.

    The cut message goes STRAIGHT to the engine mailbox instead of
    through ``Zoo.CallOnEngine``: a policy install is a control-plane
    swap, not a data-ordering point — buffered fire-and-forget Adds may
    legally flush at their own next ordering point (the count-capped
    write-combine buffer is program-structural, so every SPMD rank
    holds the same buffer state at its lockstep sync position and the
    streams stay agreed) — and skipping the flush keeps the ``policy``
    concurrency domain statically off the worker-table surfaces, which
    is what lets the concurrency-domain checkers hold it to its own
    state."""

    def routing_report(self) -> Optional[dict]:
        try:
            from multiverso_tpu_torch.zoo import Zoo
            eng = Zoo.Get().server_engine
            rr = getattr(eng, "routing_report", None)
            return rr() if rr is not None else None
        except Exception:
            return None

    def install_actions(self, actions: List[dict]) -> List[tuple]:
        from multiverso_tpu_torch.message import Message, MsgType
        from multiverso_tpu_torch.parallel import multihost
        from multiverso_tpu_torch.utils.waiter import Waiter
        from multiverso_tpu_torch.zoo import Zoo
        eng = Zoo.Get().server_engine

        def _payload():
            out = []
            for a in actions:
                if a["kind"] == "route":
                    install = getattr(eng, "install_routing", None)
                    if install is None:
                        Log.Error("policy: route action %s on an "
                                  "unsharded engine — skipped", a["id"])
                        res = {"applied": []}
                    else:
                        res = {"applied": install(
                            {int(a["table"]): int(a["dst"])})}
                else:               # tune
                    frm = GetFlag(a["flag"])
                    SetCMDFlag(a["flag"], a["to"])
                    res = {"frm": frm, "to": a["to"]}
                kind = "revert" if a.get("revert_of") else a["kind"]
                tflight.record(f"policy.{kind}", seq=eng._mh_seq,
                               epoch=eng.window_epoch,
                               mepoch=multihost.membership_epoch(),
                               detail=f"rule={a['rule']} id={a['id']}")
                out.append((dict(a), res))
            return out

        waiter = Waiter(1)
        msg = Message(msg_type=MsgType.Request_StoreLoad,
                      payload={"fn": _payload}, waiter=waiter)
        eng.Receive(msg)
        if not waiter.Wait(60.0):
            fdeadline.raise_deadline("policy action install",
                                     seconds=60.0)
        if isinstance(msg.result, Exception):
            raise msg.result
        return msg.result


class PolicyEngine:
    """The per-process policy evaluator + (optionally) its daemon
    thread. Tests drive :meth:`step` directly with synthetic watchdog
    tick records and a fake applier; the live plane feeds it through
    the watchdog tick listener."""

    def __init__(self, stager, me: int = 0, world: int = 1,
                 applier=None):
        self.stager = stager
        self.me = int(me)
        self.world = int(world)
        self.applier = applier if applier is not None else EngineApplier()
        self._lock = threading.Lock()
        self._ticks: Deque[dict] = collections.deque(maxlen=64)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.evals = 0
        #: installs agreed so far — the rank-agreed generation stamped
        #: into action ids so a repeat of the same correction after a
        #: revert is a NEW id, while N ranks proposing one correction
        #: still collide into one staged action
        self.installed_count = 0
        self._sustain: Dict[str, int] = {}
        self._burned: set = set()
        self._cool_until: Dict[str, float] = {}
        self._installs: Deque[float] = collections.deque()
        #: installed actions under revert watch:
        #: {"action", "res", "rule", "evals_left"}
        self._tracking: List[dict] = []
        #: insertion-ordered (dict keys): the trim below evicts the
        #: OLDEST proposals, so an in-flight action's id cannot be
        #: evicted right after it was added
        self._proposed_ids: Dict[str, None] = {}
        self._prev_shards: Optional[Dict[int, dict]] = None
        #: bounded action history, newest last (the /actions body)
        self.history: Deque[dict] = collections.deque(maxlen=128)
        #: per-ENGINE tallies for /actions + /healthz (the metrics
        #: counters are process-global and outlive worlds; a fresh
        #: world's report must start at zero)
        self.n_staged = 0
        self.n_installed = 0
        self.n_reverted = 0
        self.n_drains = 0
        self.n_rejected = 0
        self.n_dedup = 0
        for name in COUNTER_FAMILY:
            tmetrics.counter(name)

    # -- intake (watchdog thread) -------------------------------------------

    def on_watchdog_tick(self, rec: dict) -> None:
        """The alert->action hand-off: called by the watchdog after
        every evaluate. Enqueue-only — the policy thread does the
        work; the watchdog tick must stay cheap."""
        self._ticks.append(rec)
        self._wake.set()

    # -- daemon lifecycle ---------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="mv-policy", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(0.2)
            self._wake.clear()
            while True:
                try:
                    rec = self._ticks.popleft()
                except IndexError:
                    break
                try:
                    self.step(rec)
                except Exception as exc:    # the loop must never die
                    Log.Error("policy evaluation failed: %r", exc)

    def stop(self) -> None:
        """Stop + join BOUNDED (the watchdog.stop contract)."""
        self._stop.set()
        self._wake.set()
        if self._thread is None:
            return
        from multiverso_tpu_torch.failsafe.errors import DeadlineExceeded
        try:
            fdeadline.bounded(lambda: self._thread.join(timeout=5),
                              "policy thread join", fatal=False)
        except DeadlineExceeded as exc:
            Log.Error("policy stop timed out (%r) — abandoning its "
                      "daemon thread", exc)

    # -- one evaluation -----------------------------------------------------

    def step(self, rec: dict) -> List[dict]:
        """One policy evaluation over one watchdog tick record.
        Returns the actions staged this evaluation (guards applied)."""
        with self._lock:
            self.evals += 1
            tmetrics.counter("policy.evals").inc()
            active = set(rec.get("active", ()))
            cz = chaos.get()
            if cz is not None:
                flap = cz.policy_flap()
                if flap is True:
                    active.add(FLAP_RULE)
                elif flap is False:
                    active.discard(FLAP_RULE)
            for r in list(self._sustain):
                if r not in active:
                    self._sustain[r] = 0
            for r in active:
                self._sustain[r] = self._sustain.get(r, 0) + 1
            # a burned rule un-burns only when its alert CLEARS
            self._burned &= active
            shard_deltas = self._note_shards(rec)
            if not _enabled():
                # the kill switch: keep watching (sustain/burn state
                # stays warm), act on nothing, track nothing new
                return []
            reverts = self._judge_tracking(active)
            staged: List[dict] = []
            for a in reverts:
                if self._stage(a):
                    staged.append(a)
            for rule in sorted(active):
                a = self._decide(rule, rec, shard_deltas)
                if a is None:
                    continue
                tmetrics.counter("policy.proposed").inc()
                reason = self._guard(rule, a, pending=len(staged))
                if reason is not None:
                    tmetrics.counter("policy.rejected").inc()
                    self.n_rejected += 1
                    continue
                if self._stage(a):
                    staged.append(a)
        # single-process worlds: the policy thread is also the actuator
        # (no SPMD agreement to wait for). OUTSIDE the lock: the
        # install blocks on an engine cut. No drain_runner — drains
        # are structurally impossible single-process.
        if self.world <= 1 and staged:
            self.actuate()
        return staged

    def _note_shards(self, rec: dict) -> Optional[dict]:
        """Per-slot load/verb deltas between this tick's engine shard
        states and the previous tick's — the routing decider's input."""
        shards = (rec.get("sample") or {}).get("shards")
        if not shards:
            return None
        cur = {s["shard"]: s for s in shards}
        prev, self._prev_shards = self._prev_shards, cur
        if prev is None or len(cur) < 2:
            return None
        load = {}
        verbs: Dict[int, Dict[int, int]] = {}
        for slot, s in cur.items():
            p = prev.get(slot, {})
            load[slot] = max(0.0, s.get("apply_busy_s", 0.0)
                             - p.get("apply_busy_s", 0.0))
            pv = p.get("table_verbs", {})
            verbs[slot] = {t: max(0, n - pv.get(t, 0))
                           for t, n in s.get("table_verbs", {}).items()}
        return {"load": load, "verbs": verbs}

    # -- deciders -----------------------------------------------------------

    def _decide(self, rule: str, rec: dict,
                shard_deltas: Optional[dict]) -> Optional[dict]:
        if rule == "shard_imbalance":
            return self._decide_route(shard_deltas)
        if rule == "apply_pool_sat":
            return self._decide_tune("mv_apply_workers", 2,
                                     _workers_min(), _workers_max(),
                                     rule)
        if rule == "mailbox_backlog":
            return self._decide_tune("mv_pipeline_depth", 1,
                                     _depth_min(), _depth_max(), rule)
        if rule == "straggler":
            return self._decide_drain()
        return None

    def _decide_route(self, deltas: Optional[dict]) -> Optional[dict]:
        if deltas is None:
            return None
        report = self.applier.routing_report()
        if report is None:
            return None
        from multiverso_tpu_torch.elastic import rebalance
        plan = rebalance.plan_routing(deltas["load"], deltas["verbs"],
                                      report["routing"],
                                      report["live_slots"])
        if plan is None:
            return None
        tid, src, dst = plan
        gen = self.installed_count
        return {"id": f"route:t{tid}:s{src}>s{dst}:g{gen}",
                "kind": "route", "rule": "shard_imbalance",
                "table": tid, "src": src, "dst": dst,
                "conflict": f"route:t{tid}"}

    def _decide_tune(self, flag: str, step: int, lo: int, hi: int,
                     rule: str) -> Optional[dict]:
        try:
            cur = int(GetFlag(flag))
        except Exception:
            # the tuned flags are DEFINED in sync/server.py (zoo
            # imports it eagerly; offline test harnesses may not have)
            try:
                import multiverso_tpu_torch.sync.server  # noqa: F401
                cur = int(GetFlag(flag))
            except Exception:
                return None
        new = min(max(cur + step, lo), hi)
        if new == cur:
            return None         # already at the rail
        gen = self.installed_count
        return {"id": f"tune:{flag}:{cur}>{new}:g{gen}", "kind": "tune",
                "rule": rule, "flag": flag, "frm": cur, "to": new,
                "conflict": f"tune:{flag}"}

    def _decide_drain(self) -> Optional[dict]:
        """Straggler escalation: the SICK rank proposes its own drain
        (the alert is a local proxy firing on the culprit). Extra
        guards for an irreversible action: elastic plane live, not the
        authority rank, the shrunk world keeps >=
        -mv_policy_min_members, and DOUBLE the sustain evidence."""
        if self.world <= 1 or self.me == 0:
            return None
        if self._sustain.get("straggler", 0) < 2 * max(1, _sustain()):
            return None
        from multiverso_tpu_torch import elastic
        if not elastic.enabled() or elastic.is_departed():
            return None
        members = elastic.members()
        if self.me not in members:
            return None
        if len(members) - 1 < max(1, _min_members()):
            return None
        gen = self.installed_count
        return {"id": f"drain:r{self.me}:g{gen}", "kind": "drain",
                "rule": "straggler", "rank": self.me,
                "conflict": "drain"}

    # -- guards + staging ---------------------------------------------------

    def _guard(self, rule: str, action: dict,
               pending: int = 0) -> Optional[str]:
        """First failing guard's name, or None (clear to stage).
        ``pending`` counts actions already staged THIS evaluation, so
        one tick cannot blow through the window budget before any of
        its installs land. Caller holds the lock."""
        if not rule_enabled(rule):
            return "rule_disabled"
        if rule in self._burned:
            return "burned"
        if self._sustain.get(rule, 0) < max(1, _sustain()):
            return "sustain"
        if any(tr["rule"] == rule for tr in self._tracking):
            # one correction at a time: the previous action for this
            # rule has not been judged (improved vs revert) yet
            return "awaiting_verdict"
        now = time.monotonic()
        if now < self._cool_until.get(rule, 0.0):
            return "cooldown"
        horizon = now - max(1e-9, _window_s())
        while self._installs and self._installs[0] < horizon:
            self._installs.popleft()
        if len(self._installs) + pending >= max(1, _max_actions()):
            return "window_budget"
        if action["id"] in self._proposed_ids:
            return "already_proposed"
        return None

    def _stage(self, action: dict) -> bool:
        """Stage one action (at-most-once at the stager). Caller holds
        the lock. True when newly staged by THIS rank."""
        self._proposed_ids[action["id"]] = None
        if len(self._proposed_ids) > 512:
            for k in list(self._proposed_ids)[:256]:
                del self._proposed_ids[k]
        dup = self.stager.put(action, epoch=self._mepoch())
        mep, seq = twatchdog.stream_pos()
        tflight.record("policy.staged", seq=seq, mepoch=mep,
                       detail=f"rule={action['rule']} id={action['id']}"
                              f"{' dup' if dup else ''}")
        tmetrics.counter("policy.staged").inc()
        self.n_staged += 1
        if dup:
            self.n_dedup += 1
        self._note(action, "staged" if not dup else "staged-dup")
        return not dup

    @staticmethod
    def _mepoch() -> int:
        try:
            from multiverso_tpu_torch.parallel import multihost
            return int(multihost.membership_epoch())
        except Exception:
            return 0

    # -- revert tracking ----------------------------------------------------

    def _judge_tracking(self, active: set) -> List[dict]:
        """Age every installed action under watch; return the revert
        actions to stage (triggering alert still active after
        -mv_policy_revert_after evaluations). Caller holds the lock."""
        reverts: List[dict] = []
        for tr in list(self._tracking):
            if tr["rule"] not in active:
                # the triggering gauge improved: the action stands
                self._tracking.remove(tr)
                self._note(tr["action"], "improved")
                continue
            tr["evals_left"] -= 1
            if tr["evals_left"] > 0:
                continue
            self._tracking.remove(tr)
            rv = self._build_revert(tr)
            # burned either way: no NEW action for this rule until its
            # alert clears — a correction that did not help must not
            # loop
            self._burned.add(tr["rule"])
            if rv is not None:
                reverts.append(rv)
                self._note(tr["action"], "revert-staged")
            else:
                # nothing to invert (e.g. a route whose install was an
                # idempotent no-op) — say so instead of promising a
                # revert that never comes
                self._note(tr["action"], "unrevertible")
        return reverts

    @staticmethod
    def _build_revert(tr: dict) -> Optional[dict]:
        a, res = tr["action"], tr.get("res") or {}
        if a["kind"] == "route":
            applied = res.get("applied") or []
            if not applied:
                return None
            tid, prev, new = applied[0]
            return {"id": f"revert:{a['id']}", "kind": "route",
                    "rule": a["rule"], "table": tid, "src": new,
                    "dst": prev, "conflict": f"route:t{tid}",
                    "revert_of": a["id"]}
        if a["kind"] == "tune":
            frm = res.get("frm", a.get("frm"))
            if frm is None:
                return None
            return {"id": f"revert:{a['id']}", "kind": "tune",
                    "rule": a["rule"], "flag": a["flag"],
                    "frm": a.get("to"), "to": frm,
                    "conflict": f"tune:{a['flag']}",
                    "revert_of": a["id"]}
        return None                 # drains have no revert path

    # -- actuation ----------------------------------------------------------

    def actuate(self, timeout: Optional[float] = None,
                drain_runner=None) -> List[dict]:
        """Pull + actuate the AGREED staged-action list — the ONE
        actuation core (the policy thread's single-process path and
        MV_PolicySync both run exactly this, so a guard added here
        covers both). Sequence: pull (rendezvous in multi-process
        worlds, carrying this rank's kill-switch state), reduce
        conflicts deterministically, honour the AGREED kill verdict
        (any disarmed rank vetoes the whole batch — it is discarded on
        every rank rather than half-installed), install route/tune at
        the fenced cut, then at most ONE drain through
        ``drain_runner`` (only the app-paced sync point passes one —
        the policy thread must never run the collective drain legs)."""
        acts, acting = self.stager.pull(world=max(1, self.world),
                                        timeout=timeout,
                                        armed=bool(_enabled()))
        acts = reduce_conflicts(acts)
        if not acting:
            with self._lock:
                for a in acts:
                    # the proposal window forgets the id too (the
                    # stager un-saw its key): after re-arming, the
                    # same correction may stage again instead of
                    # wedging on "already_proposed"
                    self._proposed_ids.pop(a.get("id"), None)
                    self._note(a, "discarded-killed")
            if acts:
                Log.Info("policy: kill switch down on >=1 rank — %d "
                         "agreed action(s) discarded world-wide",
                         len(acts))
            return []
        drains = [a for a in acts if a["kind"] == "drain"]
        local = [a for a in acts if a["kind"] != "drain"]
        out = self.install_batch(local)
        for a in drains[:1]:
            if drain_runner is None:
                Log.Error("policy: drain action %s outside a policy "
                          "sync point — dropped", a["id"])
                self._note(a, "dropped")
            elif drain_runner(a):
                out.append(a)
        for a in drains[1:]:
            # a second drain would address a world the first just
            # changed — it re-proposes against the new view if real
            self._note(a, "dropped")
        return out

    def install_batch(self, actions: List[dict]) -> List[dict]:
        """Install one agreed route/tune batch at a fenced engine cut
        and book the guard state (cooldowns, window budget, revert
        tracking). Every rank of an SPMD world calls this with the
        IDENTICAL list, so the bookkeeping stays rank-agreed."""
        if not actions:
            return []
        results = self.applier.install_actions(actions)
        now = time.monotonic()
        with self._lock:
            for a, res in results:
                self._installs.append(now)
                self._cool_until[a["rule"]] = now + max(
                    0.0, _cooldown_s())
                self.installed_count += 1
                tmetrics.counter("policy.installed").inc()
                self.n_installed += 1
                if a.get("revert_of"):
                    tmetrics.counter("policy.reverted").inc()
                    self.n_reverted += 1
                    self._note(a, "reverted")
                else:
                    self._tracking.append(
                        {"action": a, "res": res, "rule": a["rule"],
                         "evals_left": max(1, _revert_after())})
                    self._note(a, "installed", res)
        return [a for a, _ in results]

    def note_drain(self, action: dict) -> None:
        """Bookkeeping for an executed drain (sync_point runs the
        collective part; this records the guard state)."""
        now = time.monotonic()
        with self._lock:
            self._installs.append(now)
            self._cool_until[action["rule"]] = now + max(
                0.0, _cooldown_s())
            self.installed_count += 1
            tmetrics.counter("policy.installed").inc()
            tmetrics.counter("policy.drains").inc()
            self.n_installed += 1
            self.n_drains += 1
            self._note(action, "drained")

    # -- surfaces -----------------------------------------------------------

    def _note(self, action: dict, status: str, res=None) -> None:
        rec = {"t": time.time(), "id": action.get("id"),
               "kind": action.get("kind"), "rule": action.get("rule"),
               "status": status}
        if res:
            rec["result"] = res
        self.history.append(rec)

    def report(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "armed": bool(_enabled()),
                "world": self.world,
                "evals": self.evals,
                "installed": self.n_installed,
                "reverted": self.n_reverted,
                "drains": self.n_drains,
                "staged": self.n_staged,
                "rejected": self.n_rejected,
                "stage_dedup_hits": self.n_dedup,
                "burned": sorted(self._burned),
                "tracking": [{"id": tr["action"]["id"],
                              "rule": tr["rule"],
                              "evals_left": tr["evals_left"]}
                             for tr in self._tracking],
                "guards": {
                    "rules": _rules_flag(),
                    "cooldown_s": _cooldown_s(),
                    "window_s": _window_s(),
                    "max_actions_per_window": _max_actions(),
                    "sustain_evals": _sustain(),
                    "revert_after_evals": _revert_after(),
                    "workers_rail": [_workers_min(), _workers_max()],
                    "depth_rail": [_depth_min(), _depth_max()],
                    "min_members": _min_members(),
                },
                "actions": list(self.history),
            }
