"""Seeded fault injection (``-chaos_spec`` / ``-chaos_seed``): the port's
own copy of ``multiverso_tpu/failsafe/chaos.py``, with the same sites,
grammar, streams and counters, so a spec and seed valid in the JAX package
give the same fault schedule here.

Every failure mode the runtime guards against (lost, duplicated or late
deliveries, corrupted frames, transient verb faults, a shed or stalled
lookup, a slow apply, a slow, lossy or partitioned tcp link) can be
rehearsed on demand, DETERMINISTICALLY: each site owns an independent
``random.Random`` stream seeded from ``(chaos_seed << 32) ^ crc32(site)``
(never Python's salted ``hash``), and a decision is a pure function of
(site, call index). Every consult draws, even at probability 0, so arming
one site never reshuffles another's schedule, and two ranks running the
same verb program with the same seed fault the same lockstep positions.

Spec grammar (comma-separated)::

    site:probability[@param]

    mailbox.drop:P[@delay_s]   first delivery lost; redelivered after
                               2*delay_s (the transport's retransmit)
    mailbox.dup:P              message enqueued twice (same object; the
                               engine's admission drops the copy)
    mailbox.delay:P[@delay_s]  delivery deferred by delay_s
    wire.bitflip:P             one byte (never the kind byte) of an
                               outgoing window blob flipped: the CRC
                               trailer must catch it
    wire.truncate:P            outgoing blob cut by a few bytes
    verb.transient:P           engine rejects a tracked verb with
                               TransientError BEFORE applying
    verb.failack:P             engine APPLIES a tracked Add, then fails
                               its ack with TransientError: the retry
                               must hit the dedup window
    serving.overload:P         serving front-end sheds the lookup at
                               admission (ServingOverloaded)
    serving.delay:P[@delay_s]  serving dispatcher stalls a micro-batch
    apply.delay:P[@delay_s]    engine window apply stalled (a perf
                               fault: the verb stream stays lockstep)
    tcp.delay:P[@delay_s]      tcp wire: the exchange sleeps before
                               sending its frame train
    tcp.drop:P                 tcp wire: the final frame toward the
                               lowest peer is swallowed
    tcp.partition:P            tcp wire: every stream of the exchanged
                               channel is severed (ActorDied both ends)
    membership.leave:P         elastic leave: the staged op is
    membership.join:P          delivered twice (the coordinator's
                               idempotent staging must absorb it)
    coord.kill:P               the coordinator hard-stops mid-op
                               (one-shot latched; refused connects)
    coord.delay:P[@delay_s]    a coordinator op handler stalls
    policy.flap:P[@period]     the policy engine's alert verdict for
                               mailbox_backlog oscillates (period
                               evaluations breaching, then healthy)

Faults target table verbs (Get/Add), the serving read plane, the engine's
window apply, the host wires and the elastic control plane; control
messages (barrier pings, cuts,
FinishTrain) stay reliable.
"""

from __future__ import annotations

import random
import threading
import zlib
from typing import Dict, Optional, Tuple

from multiverso_tpu_torch.telemetry import metrics
from multiverso_tpu_torch.utils.configure import (GetFlag, MV_DEFINE_int,
                                            MV_DEFINE_string,
                                            register_flag_listener)
from multiverso_tpu_torch.utils.log import CHECK, Log

MV_DEFINE_string("chaos_spec", "",
                 "seeded fault-injection spec, e.g. 'mailbox.drop:0.05,"
                 "wire.bitflip:0.01,verb.transient:0.1' (empty = off)")
MV_DEFINE_int("chaos_seed", 0, "fault-schedule seed (chaos_spec)")

_SITES = ("mailbox.drop", "mailbox.dup", "mailbox.delay",
          "wire.bitflip", "wire.truncate",
          "verb.transient", "verb.failack",
          "serving.overload", "serving.delay",
          "membership.leave", "membership.join",
          "apply.delay", "policy.flap",
          "coord.kill", "coord.delay",
          "tcp.delay", "tcp.drop", "tcp.partition")
_DEFAULT_DELAY_S = 0.002


def parse_spec(spec: str) -> Dict[str, Tuple[float, float]]:
    """``site:prob[@param]`` list -> {site: (prob, param)}."""
    out: Dict[str, Tuple[float, float]] = {}
    for entry in str(spec).split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, _, rest = entry.partition(":")
        prob_s, _, param_s = rest.partition("@")
        CHECK(site in _SITES,
              f"-chaos_spec: unknown site {site!r} (know {_SITES})")
        try:
            prob = float(prob_s)
            param = float(param_s) if param_s else _DEFAULT_DELAY_S
        except ValueError:
            CHECK(False, f"-chaos_spec: bad entry {entry!r}")
        CHECK(0.0 <= prob <= 1.0,
              f"-chaos_spec: probability out of [0,1] in {entry!r}")
        out[site] = (prob, param)
    return out


class ChaosInjector:
    """One seeded injector instance (rebuilt when the flags change)."""

    def __init__(self, spec: Dict[str, Tuple[float, float]], seed: int):
        self.spec = dict(spec)
        self.seed = int(seed)
        # per-site independent streams, seeded WITHOUT str hash (which
        # PYTHONHASHSEED salts per process — determinism would die)
        self._rngs = {site: random.Random(
            (self.seed << 32) ^ zlib.crc32(site.encode()))
            for site in _SITES}
        #: policy.flap consult counter: the oscillation is a pure
        #: function of the call index (no rng draw — the site models a
        #: gauge hovering AT a threshold, which is deterministic by
        #: nature, not probabilistic)
        self._flap_calls = 0
        #: coord.kill latch: a world has ONE primary to kill — once the
        #: site fires, every later consult is False no matter the draws.
        #: Own lock: consults come from concurrent dispatch threads and
        #: exactly one may win the latch.
        self._kill_lock = threading.Lock()
        self._coord_killed = False
        # eager registration: an armed injector's sites show at zero in
        # MV_MetricsSnapshot() even before their first fault
        for site in self.spec:
            metrics.counter(f"chaos.{site}")

    def _fire(self, site: str) -> bool:
        prob = self.spec.get(site, (0.0, 0.0))[0]
        # ALWAYS draw, even at prob 0: a site's schedule must depend
        # only on (seed, call index), not on which other sites are in
        # the spec — so enabling a new site never reshuffles the others
        hit = self._rngs[site].random() < prob
        if hit:
            metrics.counter(f"chaos.{site}").inc()
        return hit

    def param(self, site: str) -> float:
        return self.spec.get(site, (0.0, _DEFAULT_DELAY_S))[1]

    # -- decision points (one call per site per event: deterministic) --

    def mailbox_action(self) -> Optional[str]:
        """Consulted once per verb Receive: drop / dup / delay / None."""
        action = None
        for site in ("mailbox.drop", "mailbox.dup", "mailbox.delay"):
            if self._fire(site) and action is None:
                action = site.split(".", 1)[1]
        return action

    def verb_action(self, tracked: bool) -> Optional[str]:
        """Consulted once per verb admission at the engine: transient /
        failack / None. Only TRACKED verbs are faulted (a fire-and-
        forget Add has no waiter to drive a retry — rejecting it would
        silently lose the update, which chaos must never do)."""
        action = None
        for site in ("verb.transient", "verb.failack"):
            if self._fire(site) and action is None and tracked:
                action = site.split(".", 1)[1]
        return action

    def serving_admission(self) -> bool:
        """Consulted once per serving-lookup admission: True = shed the
        request with ServingOverloaded. DETERMINISM CAVEAT (weaker than
        the verb sites'): serving draws come from CONCURRENT reader
        threads, so while the per-site OUTCOME SEQUENCE is still a pure
        function of (seed, site, index) — each draw is one atomic
        ``Random.random()`` under the GIL — WHICH caller observes draw
        i is scheduler-assigned. Serving faults are rehearsal probes of
        the typed shed/deadline paths, not lockstep SPMD events; chaos
        tests must assert aggregates (counters, typed-error handling),
        never per-caller schedules. The verb/mailbox/wire sites keep
        their strict reproducibility: they draw from single-threaded
        admission/exchange paths."""
        return self._fire("serving.overload")

    def serving_delay(self) -> float:
        """Consulted once per serving micro-batch: seconds to stall it
        (0.0 = no fault). Rehearses the per-request deadline path.
        Same determinism caveat as serving_admission — batches form
        from scheduler-dependent caller interleaving."""
        if self._fire("serving.delay"):
            return self.param("serving.delay")
        return 0.0

    def apply_delay(self) -> float:
        """Consulted once per engine window apply: seconds to stall the
        apply stage BEFORE it runs (0.0 = no fault). A PERF fault, not
        a correctness one — the verb stream stays lockstep; it models a
        straggling rank's slow apply, the straggler the critpath report
        must attribute when the spec is armed on one rank only. Drawn on
        the stream's apply thread, so the schedule keeps the strict
        (seed, site, call-index) reproducibility. The port consults it
        in the single-process window too, so a deadline drill can stall
        one process's engine."""
        if self._fire("apply.delay"):
            return self.param("apply.delay")
        return 0.0

    def policy_flap(self) -> Optional[bool]:
        """Consulted once per policy evaluation: None when the site is
        unarmed; else the injected alert verdict — True (breaching) for
        ``period`` consecutive evaluations, then False (healthy) for
        ``period``, repeating. A pure function of the call index (no
        rng), so every run's flap schedule is identical and the
        hysteresis/cooldown regression test is exact."""
        prob, period = self.spec.get("policy.flap", (0.0, 1.0))
        if prob <= 0.0:
            return None
        idx = self._flap_calls
        self._flap_calls += 1
        breach = (idx // max(1, int(period))) % 2 == 0
        if breach:
            metrics.counter("chaos.policy.flap").inc()
        return breach

    def coord_kill(self) -> bool:
        """Consulted once per coordinator op dispatch: True = the
        primary hard-stops NOW, mid-op (shipper abandoned, server dead,
        no answer to the caller). ONE-SHOT LATCHED: the draw still
        happens every consult (schedule independence, like every
        site), but at most one consult ever returns True — re-killing a
        successor would turn one drill into an unbounded outage."""
        hit = self._fire("coord.kill")
        if not hit:
            return False
        with self._kill_lock:
            if self._coord_killed:
                return False
            self._coord_killed = True
            return True

    def tcp_delay(self) -> float:
        """Consulted once per tcp-wire exchange: seconds to sleep
        before sending the frame train (0.0 = no fault) — a slow/
        congested link. Drawn on the caller's exchange thread, so the
        schedule keeps strict (seed, site, call-index)
        reproducibility."""
        if self._fire("tcp.delay"):
            return self.param("tcp.delay")
        return 0.0

    def tcp_drop(self) -> bool:
        """Consulted once per tcp-wire exchange: True = swallow the
        final outbound frame toward the lowest peer. That peer stalls
        on bytes that never arrive — its lease probe or deadline must
        convert the stall into a typed error, never a hang."""
        return self._fire("tcp.drop")

    def tcp_partition(self) -> bool:
        """Consulted once per tcp-wire exchange: True = sever every
        stream of the exchanged channel NOW (mid-exchange partition /
        peer kill -9 rehearsal — both sides must surface typed
        ActorDied from the EOF/RST)."""
        return self._fire("tcp.partition")

    def coord_delay(self) -> float:
        """Consulted once per coordinator op dispatch: seconds to stall
        the handler (0.0 = no fault). Single dispatch site per op, so
        the schedule keeps strict (seed, site, call-index)
        reproducibility per coordinator process."""
        if self._fire("coord.delay"):
            return self.param("coord.delay")
        return 0.0

    def membership_fault(self, kind: str) -> bool:
        """Consulted once per elastic ``leave``/``join`` control op:
        True = rehearse a lost-then-retransmitted control RPC (the
        elastic plane re-delivers the staged op; the coordinator's
        idempotent staging + shard dedup must absorb it). Control ops
        run on app threads at app-paced sync points — per-site outcome
        sequences stay seeded-deterministic like every other site."""
        return self._fire(f"membership.{kind}")

    def corrupt_blob(self, blob: bytes) -> Optional[bytes]:
        """Consulted once per outgoing window exchange blob: a
        corrupted copy (bitflip / truncate), or None. The flip never
        lands on byte 0 (the blob-kind tag has its own loud error) —
        everything else is the CRC trailer's job to catch."""
        flip = self._fire("wire.bitflip")
        trunc = self._fire("wire.truncate")
        if flip and len(blob) > 1:
            rng = self._rngs["wire.bitflip"]
            pos = 1 + rng.randrange(len(blob) - 1)
            bit = 1 << rng.randrange(8)
            out = bytearray(blob)
            out[pos] ^= bit
            return bytes(out)
        if trunc and len(blob) > 2:
            rng = self._rngs["wire.truncate"]
            return blob[:-(1 + rng.randrange(min(8, len(blob) - 1)))]
        return None


# -- module state: injector cache + redelivery timers ------------------

_lock = threading.Lock()
_cache: dict = {"spec": None, "seed": None, "inj": None}
_timers: list = []


def _invalidate(name) -> None:
    if name in (None, "chaos_spec", "chaos_seed"):
        with _lock:
            _cache["spec"] = None
            _cache["inj"] = None


register_flag_listener(_invalidate)


def get() -> Optional[ChaosInjector]:
    """The active injector, or None when ``-chaos_spec`` is empty.

    Called on every verb Receive/admission, so the steady-state path is
    ONE lockless dict read (atomic under the GIL; a reader racing an
    invalidation may use the outgoing injector for one message — flag
    changes are eventually consistent by design). The lock only guards
    the rebuild."""
    if _cache["spec"] is not None:
        return _cache["inj"]
    with _lock:
        if _cache["spec"] is not None:
            return _cache["inj"]
        try:
            spec_s = str(GetFlag("chaos_spec"))
            seed = int(GetFlag("chaos_seed"))
        except Exception:       # registry torn down
            return None
        spec = parse_spec(spec_s)
        _cache["spec"] = spec_s
        _cache["seed"] = seed
        _cache["inj"] = ChaosInjector(spec, seed) if spec else None
        if spec:
            Log.Info("chaos: injector armed (seed=%d, spec=%s)", seed,
                     spec_s)
        return _cache["inj"]


def schedule_redelivery(deliver, msg, action: str, delay_s: float) -> None:
    """Redeliver ``msg`` via ``deliver(msg)`` after ``delay_s`` (drop
    waits 2x — the retransmit took a full extra round trip). Timers are
    tracked so :func:`quiesce` can rendezvous with them."""
    wait = delay_s * (2.0 if action == "drop" else 1.0)

    def _redeliver():
        try:
            deliver(msg)
        except Exception as exc:  # e.g. actor died meanwhile
            Log.Error("chaos: redelivery failed: %r", exc)

    t = threading.Timer(wait, _redeliver)
    t.daemon = True
    with _lock:
        _timers.append(t)
    t.start()


def quiesce() -> None:
    """Block until every scheduled redelivery has fired — call before
    asserting convergence (or disabling chaos) so no delayed message is
    still in flight."""
    while True:
        with _lock:
            pending = [t for t in _timers if t.is_alive()]
            _timers[:] = pending
        if not pending:
            return
        for t in pending:
            # unbounded-ok: a Timer is bounded by its own (tiny) delay
            t.join()
