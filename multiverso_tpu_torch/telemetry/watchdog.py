"""Live watchdog plane: typed online alert rules over local instruments
(the port's counterpart of the JAX package's ``telemetry/watchdog.py``).

The reference ships a Dashboard people watch BY HAND; the PR 6/PR 8
planes are post-hoc (forensics and critpath explain a stall after rings
hit disk, /healthz flips only on actor death). Meanwhile the PR 9
components fail by *saturation*, not death: a shard stream falling
behind its siblings, the shm ring backpressuring, the native apply pool
degrading to inline slices, a mailbox growing without bound. This
module is the Borgmon-style answer — a ``-mv_watchdog_s`` daemon tick
(off by default, like ``-stats_interval_s``) evaluating TYPED rules
with fire/clear hysteresis over **local instruments only**:

* never collective — the tick thread reads in-process state (the
  metrics registry, engine probes, the accounting ledger, the shm
  wire's counters); a timer thread issuing allgathers would interleave
  with window exchanges and corrupt the SPMD stream (the PR 2 reporter
  rule). Cross-rank verdicts stay ``critpath``'s job; the watchdog
  names the LOCAL symptom on the rank that has it.
* hysteresis, not edge triggers — a rule FIRES only after
  ``fire_after`` consecutive breaching ticks and CLEARS only after
  ``clear_after`` consecutive healthy ones; ticks with insufficient
  evidence (idle engine, no new windows) HOLD the current state — an
  idle world is not evidence of health, and alerts must not flap.
* typed surfaces — a firing rule increments ``alert.<rule>``, records
  an ``alert.<rule>`` flight event (so postmortem rings carry the
  online verdicts), appears at the ``/alerts`` ops endpoint, and
  degrades ``/healthz`` to a distinct ``warn`` status (still 200 —
  503 stays death-only).

Rule set (docs/DESIGN.md §15 carries the JAX package's full table):

==================  ====================================================
rule                local symptom
==================  ====================================================
shard_imbalance     max/mean per-shard apply-seconds across live engine
                    streams exceeds a ratio (one stream lags siblings)
shm_backpressure    shm writer-stall seconds growing as a fraction of
                    the tick (readers lag this rank's ring)
apply_pool_sat      native host-store pool busy: most dispatches fell
                    back to inline slices (shards convoying)
mailbox_backlog     engine mailbox depth rising monotonically
snapshot_stale      newest serving snapshot older than the observed
                    publish cadence says it should be
memory_growth       accounting-ledger total rising monotonically
straggler           sustained local proxy: per-window apply seconds
                    over the floor and this rank barely waits in the
                    collective — ITS apply gates the stream (the
                    critpath drill's culprit); a live stamped binding
                    phase other than ``apply`` vetoes

fleet_p99_breach    the coordinator-side fleet-merged request p99
                    (``telemetry/fleet.py`` rollups) exceeds
                    ``-mv_fleet_p99_s`` (0 disables)
member_qps_outlier  one previously-serving fleet member's QPS fell far
                    below its peers' mean
rollup_stale        a member's fleet rollup stopped refreshing
                    (``-mv_fleet_stale_s``)
coordinator_failover  this process's coordinator client landed on
                    another endpoint of the ``-mv_coordinator`` list
==================  ====================================================

The three fleet rules read the coordinator-side accumulator's fold
(``fleet.peek_sample()``, merged into every tick's evidence) and HOLD on
every other process; the fold is local, filled by the members' pushed
heartbeats, so the tick stays collective-free.

``apply_pool_sat`` watches the JAX package's native host-store pool, which
the port does not have: its evidence never arrives and it HOLDs, so the
policy plane's ``-mv_apply_workers`` loop acts only on tick records that
carry the alert (``ROADMAP.md`` §3). Every evaluation ends with the tick
listeners (the policy plane's intake), called outside the lock. The JAX
package's ``replica_lag`` reads the replica plane, which is not ported; it
waits with it (``ROADMAP.md``).

Every ``alert.*`` counter is registered EAGERLY at
:func:`start_watchdog` (the PR 6 rule) so the whole rule family scrapes
at zero from the first ``/metrics`` read.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional

from multiverso_tpu_torch.telemetry import accounting
from multiverso_tpu_torch.telemetry import fleet as tfleet
from multiverso_tpu_torch.telemetry import flight as tflight
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.configure import GetFlag, MV_DEFINE_double
from multiverso_tpu_torch.utils.log import Log

MV_DEFINE_double("mv_watchdog_s", 0.0,
                 "watchdog tick interval: evaluate the typed online "
                 "alert rules (shard imbalance, shm backpressure, "
                 "apply-pool saturation, mailbox/memory growth, "
                 "snapshot staleness, straggler proxy) every N seconds "
                 "over LOCAL instruments only, with fire/clear "
                 "hysteresis; alerts surface at /alerts, in "
                 "alert.<rule> counters + flight events, and degrade "
                 "/healthz to 'warn' (0 = off)")

#: sentinel a rule returns when the tick carries insufficient evidence
#: (idle engine, counters unavailable): HOLD the current alert state —
#: neither a breach nor proof of health. The hysteresis counters do
#: not move, which is what keeps a finished burst's verdict readable
#: at /alerts instead of flapping clear the moment traffic stops.
HOLD = object()

#: bounded sample history every rule reads (slope rules look back a
#: few ticks; nothing needs more than this)
_HISTORY = 32


def stream_pos() -> tuple:
    """Best-effort ``(mepoch, head-stream exchange SEQ)`` stamp for
    alert/action flight events (round 20): forensics aligns a policy
    action with its triggering alert by exactly this pair, the same
    (mepoch, seq) keying the membership events ride. ``(0, -1)`` when
    no engine/world is live (synthetic-sample unit tests)."""
    mep, seq = 0, -1
    try:
        from multiverso_tpu_torch.parallel import multihost
        mep = int(multihost.membership_epoch())
        from multiverso_tpu_torch.zoo import Zoo
        eng = Zoo.Get().server_engine
        if eng is not None:
            seq = int(eng._mh_seq)
    except Exception:
        pass
    return mep, seq


class Rule:
    """One typed online alert rule. Subclasses implement
    :meth:`check` over the watchdog's sample history (newest last) and
    return ``None`` (healthy), a breach-detail string, or :data:`HOLD`
    (insufficient evidence — keep the current state)."""

    name = "rule"
    fire_after = 2
    clear_after = 3

    def check(self, history: List[dict]) -> object:
        raise NotImplementedError

    @staticmethod
    def _delta(history: List[dict], key: str, default=0.0) -> float:
        if len(history) < 2:
            return 0.0
        return (history[-1].get(key, default)
                - history[-2].get(key, default))


class ShardImbalanceRule(Rule):
    """max/mean of per-shard apply-second DELTAS across live engine
    streams: one stream doing several times its siblings' work means
    the table->shard routing (or one table's updater) is the hot spot
    — the host_scaling wall coming back by the side door."""

    name = "shard_imbalance"

    def __init__(self, ratio: float = 1.5, min_busy_s: float = 0.05):
        self.ratio = ratio
        self.min_busy_s = min_busy_s

    def check(self, history):
        if len(history) < 2:
            return HOLD
        prev = {s["shard"]: s.get("apply_busy_s", 0.0)
                for s in history[-2].get("shards", [])}
        cur = history[-1].get("shards", [])
        if len(cur) < 2:
            return None      # one stream: nothing to imbalance
        deltas = [max(0.0, s.get("apply_busy_s", 0.0)
                      - prev.get(s["shard"], 0.0)) for s in cur]
        peak = max(deltas)
        if peak < self.min_busy_s:
            return HOLD      # idle tick: no evidence either way
        mean = sum(deltas) / len(deltas)
        if mean > 0 and peak / mean >= self.ratio:
            hot = cur[deltas.index(peak)]["shard"]
            return (f"shard {hot} applied {peak:.3f}s this tick vs "
                    f"{mean:.3f}s mean over {len(deltas)} streams "
                    f"(ratio {peak / mean:.2f} >= {self.ratio})")
        return None


class ShmBackpressureRule(Rule):
    """shm WRITER-stall seconds growing as a fraction of the tick:
    this rank publishes faster than its readers ack — the ring (or a
    slow reader) is the bottleneck. Reader-side waits deliberately
    don't count (they are the peer's fault, named by critpath)."""

    name = "shm_backpressure"

    def __init__(self, stall_frac: float = 0.25):
        self.stall_frac = stall_frac

    def check(self, history):
        if len(history) < 2:
            return HOLD
        d_rounds = self._delta(history, "shm_rounds")
        if d_rounds <= 0:
            return HOLD      # no exchanges: no evidence
        d_stall = self._delta(history, "shm_writer_stall_s")
        dt = max(1e-9, self._delta(history, "t"))
        if d_stall / dt >= self.stall_frac:
            return (f"shm writer stalled {d_stall:.3f}s of a "
                    f"{dt:.3f}s tick ({100 * d_stall / dt:.0f}% >= "
                    f"{100 * self.stall_frac:.0f}%) over "
                    f"{int(d_rounds)} rounds")
        return None


class ApplyPoolSaturationRule(Rule):
    """Native host-store pool saturation: the majority of parallel-
    eligible applies this tick found the pool owned by another shard
    and ran inline — N shards convoying where the config expected pool
    parallelism (PR 9 made the fallback safe; this makes it VISIBLE)."""

    name = "apply_pool_sat"

    def __init__(self, busy_frac: float = 0.5, min_dispatches: int = 8):
        self.busy_frac = busy_frac
        self.min_dispatches = min_dispatches

    def check(self, history):
        if len(history) < 2:
            return HOLD
        d_busy = self._delta(history, "pool_inline_busy")
        d_par = self._delta(history, "pool_parallel")
        eligible = d_busy + d_par
        if eligible < self.min_dispatches:
            return HOLD
        if d_busy / eligible >= self.busy_frac:
            return (f"native pool busy for {int(d_busy)}/"
                    f"{int(eligible)} parallel-eligible applies this "
                    f"tick ({100 * d_busy / eligible:.0f}% >= "
                    f"{100 * self.busy_frac:.0f}%)")
        return None


class MailboxBacklogRule(Rule):
    """Engine mailbox depth rising across consecutive ticks past a
    floor: admission outruns the apply stream — the typed early
    warning ahead of a deadline expiry."""

    name = "mailbox_backlog"

    def __init__(self, window: int = 3, min_depth: int = 64):
        self.window = window
        self.min_depth = min_depth

    def check(self, history):
        if len(history) < self.window:
            return HOLD
        depths = [h.get("mailbox_depth", 0)
                  for h in history[-self.window:]]
        if depths[-1] < self.min_depth:
            return None
        if all(b > a for a, b in zip(depths, depths[1:])):
            return (f"mailbox depth rising {depths} over "
                    f"{self.window} ticks (>= {self.min_depth})")
        return None


class SnapshotStaleRule(Rule):
    """Newest serving snapshot older than the publish cadence says it
    should be: the cadence is ESTIMATED from the ticks where the
    publish counter moved (local observation, no clock agreement), and
    the alert needs >= 2 publishes — a world that never publishes has
    no cadence to violate."""

    name = "snapshot_stale"

    def __init__(self, ratio: float = 3.0, min_age_s: float = 1.0):
        self.ratio = ratio
        self.min_age_s = min_age_s

    def check(self, history):
        cur = history[-1]
        age = cur.get("snapshot_age_s")
        if age is None or cur.get("publishes", 0) < 2:
            return HOLD
        # publish instants observed by THIS watchdog: ticks where the
        # counter moved
        times = []
        for prev, nxt in zip(history, history[1:]):
            if nxt.get("publishes", 0) > prev.get("publishes", 0):
                times.append(nxt.get("t", 0.0))
        if len(times) < 2:
            return HOLD      # cadence not yet observable
        gaps = sorted(b - a for a, b in zip(times, times[1:]))
        cadence = gaps[len(gaps) // 2]
        bound = max(self.ratio * cadence, self.min_age_s)
        if age > bound:
            return (f"newest snapshot is {age:.2f}s old vs an observed "
                    f"publish cadence of {cadence:.2f}s (bound "
                    f"{bound:.2f}s)")
        return None


class MemoryGrowthRule(Rule):
    """Accounting-ledger total rising monotonically across the window
    AND by more than ``grow_frac`` overall: the typed early warning
    for unbounded retention (snapshots pinned forever, a cache that
    never evicts) before the OOM killer writes the postmortem. The
    sampled ``mem_total`` EXCLUDES the capacity-bounded flight/dedup
    estimates (collect_sample) — a fresh world's ring filling to its
    cap is expected, not a leak."""

    name = "memory_growth"

    def __init__(self, window: int = 4, grow_frac: float = 0.10,
                 floor_bytes: int = 1 << 20):
        self.window = window
        self.grow_frac = grow_frac
        self.floor_bytes = floor_bytes

    def check(self, history):
        if len(history) < self.window:
            return HOLD
        totals = [h.get("mem_total", 0) for h in history[-self.window:]]
        if totals[0] < self.floor_bytes:
            return HOLD
        if (all(b > a for a, b in zip(totals, totals[1:]))
                and (totals[-1] - totals[0]) / totals[0]
                >= self.grow_frac):
            return (f"ledger total grew {totals[0]} -> {totals[-1]} "
                    f"bytes (+{100 * (totals[-1] - totals[0]) / totals[0]:.0f}%) "
                    f"over {self.window} ticks")
        return None


class StragglerRule(Rule):
    """Sustained LOCAL straggler proxy (multi-process windows only):
    the binding phase reads ``apply``, per-window apply seconds sit
    over the floor, and this rank spends several times less time
    blocked in the collective than applying — i.e. peers wait for IT,
    it waits for nobody. The cross-rank verdict (which rank bound each
    window) stays critpath's; this is the live tripwire on the culprit
    rank. A uniformly apply-bound world fires on every rank — honest:
    the stream IS apply-gated everywhere (docs/DESIGN.md §15). The
    per-window floor is deliberately generous (20ms — an apply that
    slow gates any realistic window cadence) so ordinary busy applies
    under scheduler load never read as stragglers.

    Inputs are the engine's PLAIN attrs (apply_busy_s / xw_busy_s),
    which accumulate unconditionally — the rule keeps watching with
    ``-mv_phase_stamps=0`` or the flight recorder off. The stamped
    binding-phase gauge, when live, acts as a VETO (a window bound by
    decode/form/pack is not an apply straggler however slow its
    applies); when stamps are off it is simply absent and the
    apply-vs-collective-wait ratio carries the verdict alone."""

    name = "straggler"

    def __init__(self, min_windows: int = 3,
                 min_apply_per_window_s: float = 0.02,
                 xw_ratio: float = 3.0):
        self.min_windows = min_windows
        self.min_apply_per_window_s = min_apply_per_window_s
        self.xw_ratio = xw_ratio

    def check(self, history):
        if len(history) < 2:
            return HOLD
        d_ex = self._delta(history, "exchanges")
        if d_ex < self.min_windows:
            return HOLD      # single-process / idle: no stream to gate
        d_apply = self._delta(history, "apply_s")
        d_xw = self._delta(history, "exchange_wait_s")
        per_window = d_apply / d_ex
        binding = history[-1].get("binding_phase")
        if binding and binding != "apply":
            return None         # stamped verdict: something else gates
        if (per_window >= self.min_apply_per_window_s
                and d_apply >= self.xw_ratio * d_xw):
            return (f"local apply gates the stream: "
                    f"{1e3 * per_window:.1f}ms apply/window over "
                    f"{int(d_ex)} windows, {d_apply:.3f}s applying vs "
                    f"{d_xw:.3f}s waiting in the collective "
                    f"(binding_phase={binding or 'unstamped'})")
        return None


class FleetP99BreachRule(Rule):
    """COORDINATOR-side: the fleet-merged request p99 (folded from the
    rollups members pushed on their lease heartbeats) exceeds the
    ``-mv_fleet_p99_s`` budget. HOLDs on every rank that accumulated
    no rollups and while the flag is 0 (no budget, no verdict)."""

    name = "fleet_p99_breach"

    def __init__(self, threshold_s: Optional[float] = None):
        self.threshold_s = threshold_s      # None: read the flag live

    def check(self, history):
        cur = history[-1]
        p99 = cur.get("fleet_p99_s")
        if p99 is None:
            return HOLD      # no accumulator here / no rollups yet
        thr = self.threshold_s
        if thr is None:
            try:
                thr = float(GetFlag("mv_fleet_p99_s"))
            except Exception:
                thr = 0.0
        if thr <= 0:
            return HOLD      # unbudgeted: the rule is disarmed
        if p99 >= thr:
            return (f"fleet-merged request p99 {1e3 * p99:.2f}ms >= "
                    f"{1e3 * thr:.2f}ms budget across "
                    f"{int(cur.get('fleet_members', 0))} member(s)")
        return None


class MemberQpsOutlierRule(Rule):
    """COORDINATOR-side: one PREVIOUSLY-SERVING member's QPS fell far
    below its peers' mean — the live tripwire for a chaos-delayed or
    wedged member dragging the fleet tail. Members that never served a
    request (ops == 0 — e.g. a trainer rank in a replica-serving
    fleet) are not candidates: a role that serves nothing is not an
    outlier among roles that do. HOLDs while fewer than two members
    serve or the fleet is near-idle (an idle fleet's QPS spread is
    noise, not evidence)."""

    name = "member_qps_outlier"

    def __init__(self, frac: float = 0.25, min_peer_qps: float = 5.0):
        self.frac = frac
        self.min_peer_qps = min_peer_qps

    def check(self, history):
        cur = history[-1]
        qps = cur.get("fleet_member_qps")
        ops = cur.get("fleet_member_ops", {})
        if not qps:
            return HOLD
        serving = {m: q for m, q in qps.items() if ops.get(m, 0) > 0}
        if len(serving) < 2:
            return HOLD
        total = sum(serving.values())
        worst = min(serving, key=serving.get)
        peers_mean = (total - serving[worst]) / (len(serving) - 1)
        if peers_mean < self.min_peer_qps:
            return HOLD      # near-idle fleet: spread is noise
        if serving[worst] < self.frac * peers_mean:
            return (f"member {worst} serves {serving[worst]:.1f} qps "
                    f"vs a {peers_mean:.1f} qps peer mean over "
                    f"{len(serving) - 1} peer(s) "
                    f"(< {100 * self.frac:.0f}%)")
        return None


class RollupStaleRule(Rule):
    """COORDINATOR-side: a member's lease heartbeats still arrive (it
    is in the fold) but its fleet rollup stopped refreshing past
    ``-mv_fleet_stale_s`` — every number it contributes to /fleet is
    frozen. Named per member so the operator knows WHOSE telemetry to
    distrust."""

    name = "rollup_stale"

    def __init__(self, stale_s: Optional[float] = None):
        self.stale_s = stale_s              # None: read the flag live

    def check(self, history):
        cur = history[-1]
        ages = cur.get("fleet_rollup_ages_s")
        if not ages:
            return HOLD
        limit = (self.stale_s if self.stale_s is not None
                 else tfleet.stale_s())
        worst = max(ages, key=ages.get)
        if ages[worst] > limit:
            return (f"member {worst} rollup is {ages[worst]:.1f}s "
                    f"stale (> {limit:.1f}s) — its fleet numbers are "
                    f"frozen")
        return None


class CoordinatorFailoverRule(Rule):
    """This process's coordinator clients failed over to a different
    endpoint of the ordered ``-mv_coordinator`` list since the last
    tick — the primary died (or vanished long enough for the dialer to
    land on a successor). Fires on the FIRST tick that sees the
    counter move (fire_after=1: one failover is already the event, not
    noise needing corroboration), clears once the counter stops moving
    — so one takeover alerts exactly once."""

    name = "coordinator_failover"
    fire_after = 1
    clear_after = 1

    def check(self, history):
        if len(history) < 2:
            return HOLD
        d = self._delta(history, "coordinator_failovers")
        if d > 0:
            return (f"{int(d)} coordinator client failover(s) this "
                    f"tick — active endpoint index "
                    f"{int(history[-1].get('coordinator_endpoint', 0))}")
        return None


def default_rules() -> List[Rule]:
    return [ShardImbalanceRule(), ShmBackpressureRule(),
            ApplyPoolSaturationRule(), MailboxBacklogRule(),
            SnapshotStaleRule(), MemoryGrowthRule(), StragglerRule(),
            FleetP99BreachRule(), MemberQpsOutlierRule(),
            RollupStaleRule(), CoordinatorFailoverRule()]


def refresh_saturation_gauges() -> None:
    """Mirror the hot paths' plain-attribute tallies into typed gauges:
    per-shard stream load (``engine.shard<k>.*``). (The JAX package's
    ``native.pool.*`` gauges mirror its native host store's pool, which
    the port does not have.) Called by the watchdog tick and by
    the ops handler ahead of a /metrics render — NEVER from a verb
    path (the gauges' locks must not bill the blocking round)."""
    try:
        from multiverso_tpu_torch.zoo import Zoo
        eng = Zoo.Get().server_engine
        if eng is not None:
            for s in eng.shard_states():
                k = s["shard"]
                tmetrics.gauge(f"engine.shard{k}.windows").set(
                    float(s.get("window_epoch", 0)))
                tmetrics.gauge(f"engine.shard{k}.apply_s").set(
                    float(s.get("apply_busy_s", 0.0)))
                tmetrics.gauge(f"engine.shard{k}.mailbox_depth").set(
                    float(s.get("mailbox_depth", 0)))
    except Exception:           # engine torn down mid-refresh
        pass



def collect_sample() -> dict:
    """One watchdog tick's LOCAL evidence record. Pure probes: the
    metrics snapshot, engine plain attributes, the shm wire's tallies,
    the serving store's age, the ledger total. Every section is
    best-effort (teardown races read as absence, which rules HOLD
    on)."""
    sample: dict = {"t": time.perf_counter()}
    snap = tmetrics.snapshot()

    def _counter(name):
        rec = snap.get(name)
        return rec.get("value", 0.0) if rec else 0.0

    sample["exchanges"] = _counter("server.window.exchanges")
    sample["publishes"] = _counter("serving.publishes")
    sample["shm_writer_stall_s"] = _counter("shm_wire.writer_stall_s")
    sample["shm_rounds"] = _counter("shm_wire.exchanges")
    # the coordinator dialer's failover counter and active endpoint index
    # (CoordinatorFailoverRule watches the counter's delta)
    sample["coordinator_failovers"] = _counter("elastic.client_failovers")
    ep = snap.get("elastic.active_endpoint")
    if ep:
        sample["coordinator_endpoint"] = ep.get("value", 0.0)
    try:
        from multiverso_tpu_torch.zoo import Zoo
        eng = Zoo.Get().server_engine
        if eng is not None:
            shards = eng.shard_states()
            sample["shards"] = shards
            sample["mailbox_depth"] = sum(
                s.get("mailbox_depth", 0) for s in shards)
            # plain engine attrs, NOT the engine.phase.* histograms:
            # those are gated on -mv_phase_stamps AND the flight
            # recorder, and the straggler rule must keep watching when
            # either is off (the attrs accumulate unconditionally)
            sample["apply_s"] = sum(
                s.get("apply_busy_s", 0.0) for s in shards)
            sample["exchange_wait_s"] = sum(
                s.get("xw_busy_s", 0.0) for s in shards)
            sample["binding_phase"] = (
                getattr(eng, "last_binding_phase", "") or None)
    except Exception:
        pass
    # apply_pool_sat reads the JAX package's native host-store pool
    # (pool_inline_busy / pool_parallel); the port has no such pool, so
    # those keys stay absent and the rule HOLDs (its window apply pool's
    # one inline job a window is by design, not saturation)
    try:
        from multiverso_tpu_torch.serving import peek_plane
        plane = peek_plane()
        if plane is not None and plane.store.latest_version() is not None:
            sample["snapshot_age_s"] = plane.store.get(None).age_s()
    except Exception:
        pass
    # the fleet accumulator's fold: non-empty only on the process that
    # hosts the coordinator (everywhere else the fleet rules HOLD)
    try:
        sample.update(tfleet.peek_sample())
    except Exception:
        pass
    try:
        rep = accounting.refresh()
        # the growth rule watches components that CAN grow without
        # bound (tables, snapshots, buffers) — the flight ring and
        # dedup window are capacity-bounded by flags, and their
        # expected fill-to-cap would read as 4 ticks of monotonic
        # growth on every fresh world
        comps = rep.get("components", {})
        bounded = (comps.get("flight", {}).get("bytes_estimate", 0)
                   + comps.get("dedup", {}).get("bytes_estimate", 0))
        sample["mem_total"] = rep["total_bytes"] - bounded
    except Exception:
        pass
    return sample


class Watchdog:
    """Rule evaluator + (optionally) the daemon tick thread driving
    it. Tests drive :meth:`evaluate` directly with synthetic samples;
    the live tick feeds it :func:`collect_sample`."""

    def __init__(self, interval_s: float,
                 rules: Optional[List[Rule]] = None):
        self.interval_s = float(interval_s)
        self.rules = rules if rules is not None else default_rules()
        self._history: Deque[dict] = collections.deque(maxlen=_HISTORY)
        self._lock = threading.Lock()
        #: rule name -> {"active", "bad", "good", "since", "detail"}
        self._state: Dict[str, dict] = {
            r.name: {"active": False, "bad": 0, "good": 0,
                     "since": None, "detail": None}
            for r in self.rules}
        self.ticks = 0
        #: the alert->action hand-off: tick listeners called AFTER every
        #: evaluate (outside the lock) with one record ``{"ticks",
        #: "sample", "fired", "active"}``. The policy plane registers
        #: here; a listener enqueues for its own thread, must be cheap
        #: and never raise.
        self._tick_listeners: List = []
        self._t_ticks = tmetrics.counter("watchdog.ticks")
        # EAGER registration (the PR 6 rule): the whole alert family
        # scrapes at zero from the first /metrics read — the fleet
        # plane's always-on families ride the same moment
        for r in self.rules:
            tmetrics.counter(f"alert.{r.name}")
        tfleet.eager_register()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, sample: dict) -> List[str]:
        """Feed one sample; run every rule with hysteresis; return the
        names of rules that FIRED on this tick (transitions only)."""
        fired = []
        with self._lock:
            self._history.append(sample)
            history = list(self._history)
            self.ticks += 1
            self._t_ticks.inc()
            for rule in self.rules:
                st = self._state[rule.name]
                try:
                    verdict = rule.check(history)
                except Exception as exc:    # a buggy rule must not
                    Log.Error("watchdog rule %s failed: %r",
                              rule.name, exc)
                    verdict = HOLD
                if verdict is HOLD:
                    continue
                if verdict is None:
                    st["bad"] = 0
                    st["good"] += 1
                    if st["active"] and st["good"] >= rule.clear_after:
                        st["active"] = False
                        st["since"] = None
                        tflight.record(f"alert.{rule.name}",
                                       detail="cleared")
                        Log.Info("[watchdog] alert %s cleared",
                                 rule.name)
                    continue
                st["good"] = 0
                st["bad"] += 1
                st["detail"] = verdict
                if not st["active"] and st["bad"] >= rule.fire_after:
                    st["active"] = True
                    st["since"] = sample.get("t", time.perf_counter())
                    tmetrics.counter(f"alert.{rule.name}").inc()
                    # (mepoch, seq) stamped so the policy plane's
                    # action events align with their triggering alert
                    # in forensics (round 20)
                    mep, seq = stream_pos()
                    tflight.record(f"alert.{rule.name}", seq=seq,
                                   mepoch=mep,
                                   detail=str(verdict)[:200])
                    Log.Info("[watchdog] ALERT %s: %s", rule.name,
                             verdict)
                    fired.append(rule.name)
            active = [name for name, st in self._state.items()
                      if st["active"]]
            ticks = self.ticks
            listeners = list(self._tick_listeners)
        for fn in listeners:        # outside the lock: a listener may
            try:                    # itself read active_alerts()
                fn({"ticks": ticks, "sample": sample, "fired": fired,
                    "active": active})
            except Exception as exc:    # a buggy listener must not
                Log.Error("watchdog tick listener failed: %r", exc)
        return fired

    def tick(self) -> List[str]:
        """One live tick: refresh the ledger + saturation gauges, then
        evaluate the rules over a fresh sample."""
        refresh_saturation_gauges()
        return self.evaluate(collect_sample())

    def add_tick_listener(self, fn) -> None:
        """Register an alert->action hand-off listener (the policy
        plane's intake). Called after every evaluate with ``{"ticks",
        "sample", "fired", "active"}``; must be cheap and never raise."""
        with self._lock:
            self._tick_listeners.append(fn)

    # -- state surfaces -----------------------------------------------------

    def active_alerts(self) -> List[dict]:
        now = time.perf_counter()
        with self._lock:
            return [{"rule": name, "detail": st["detail"],
                     "for_s": (round(now - st["since"], 3)
                               if st["since"] is not None else None)}
                    for name, st in self._state.items() if st["active"]]

    def report(self) -> dict:
        with self._lock:
            rules = {name: {"active": st["active"], "bad": st["bad"],
                            "good": st["good"],
                            "last_detail": st["detail"]}
                     for name, st in self._state.items()}
            ticks = self.ticks
        return {"enabled": True, "interval_s": self.interval_s,
                "ticks": ticks, "alerts": self.active_alerts(),
                "rules": rules}

    # -- daemon lifecycle ---------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="mvt-watchdog",
                                        daemon=True)
        self._thread.start()

    # the tick's ledger refresh reads storage sizes on the host: no
    # device sync, no launch
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:    # the tick must never die
                Log.Error("watchdog tick failed: %r", exc)

    def stop(self) -> None:
        """Stop + join BOUNDED (the Zoo.Stop contract: a wedged probe
        must not hang shutdown; the daemon thread is abandoned on
        expiry)."""
        self._stop.set()
        if self._thread is None:
            return
        from multiverso_tpu_torch.failsafe import deadline as fdeadline
        from multiverso_tpu_torch.failsafe.errors import DeadlineExceeded
        try:
            fdeadline.bounded(lambda: self._thread.join(timeout=5),
                              "watchdog thread join", fatal=False)
        except DeadlineExceeded as exc:
            Log.Error("watchdog stop timed out (%r) — abandoning its "
                      "daemon thread", exc)
        if self._thread.is_alive():
            Log.Error("watchdog thread still alive after bounded join "
                      "— daemon thread abandoned")


_watchdog: Optional[Watchdog] = None
_wd_lock = threading.Lock()


def start_watchdog() -> bool:
    """Arm the watchdog when ``-mv_watchdog_s > 0`` (Zoo.Start, after
    the engine is up). Idempotent; False when off."""
    global _watchdog
    try:
        interval = float(GetFlag("mv_watchdog_s"))
    except Exception:
        interval = 0.0
    with _wd_lock:
        if interval <= 0 or _watchdog is not None:
            return _watchdog is not None
        _watchdog = Watchdog(interval)
        _watchdog.start()
        Log.Info("watchdog armed: tick %.3fs, %d rules", interval,
                 len(_watchdog.rules))
        return True


def stop_watchdog() -> None:
    """Stop + join the watchdog (Zoo.Stop). Idempotent."""
    global _watchdog
    with _wd_lock:
        wd, _watchdog = _watchdog, None
    if wd is not None:
        wd.stop()


def peek() -> Optional[Watchdog]:
    return _watchdog


def active_alerts() -> List[dict]:
    """The live watchdog's active alerts ([] when off) — the /healthz
    warn probe."""
    wd = _watchdog
    return wd.active_alerts() if wd is not None else []


def alerts_report() -> dict:
    """The ``/alerts`` body. When the watchdog is off the body says so
    instead of claiming health."""
    wd = _watchdog
    if wd is None:
        return {"enabled": False, "ticks": 0, "alerts": [],
                "rules": {},
                "note": "watchdog off — arm with -mv_watchdog_s=N"}
    return wd.report()
