"""Server engines: async (one actor or sharded) and BSP sync.

Counterpart of the JAX package's ``sync/server.py`` in a single process
(reference src/server.cpp):

* ``Server`` — the async engine (server.cpp:23-58): applies every Get/Add
  as it arrives and always replies. Each dispatch drains a window of
  queued messages and applies it with two economies:

  - ADD COALESCING — all Adds to one table inside the window apply as ONE
    merged dispatch (``table.ProcessAddRun``) at the position of the
    table's first Add; a table may decline (non-linear updaters,
    validation doubts), and then each Add applies on its own. Legal under
    the async contract: a Get queued between two coalesced Adds observes
    more progress, never less.
  - GET DEDUP — identical queued Gets share one gather; extra repliers
    get copies.

  Any other message (FinishTrain, a ``Request_Barrier`` drain ping, a
  ``Request_StoreLoad`` checkpoint cut, a ``Request_Publish`` serving cut)
  is a window BARRIER: runs split at it and it runs in stream order, so an
  Add acknowledged before it never applies after it.

* ``ShardedServer`` — the async engine split into per-table-group engine
  actors (shards), each a full ``Server`` with its own thread, mailbox and
  window stream. Verbs route by ``table_id % shard_cap`` unless a routing
  override is installed; sub-shards spawn lazily at table registration.
  Barrier messages become CROSS-STREAM CUTS: every shard fences at the
  cut's position in its stream, the payload runs once with every stream
  fenced, then every shard releases.

* ``SyncServer`` — BSP (``-sync=true``): the vector-clock protocol of
  server.cpp:60-222. Adds from workers whose Get clock ran ahead of the
  global Get round are cached; Gets from workers with outstanding or
  uncounted Adds are cached; completing an Add round drains cached Gets
  and vice versa; ``Server_Finish_Train`` forces a worker's clocks to
  infinity and drains. Guarantee (server.cpp:60-67): every worker's i-th
  Get returns the same parameters, provided every worker issues the same
  number of Gets and Adds. No window, no coalescing, no batched envelopes.

``Server.GetServer`` picks one by ``-sync`` and ``-mv_engine_shards``
(``engine_shard_cap``), as the JAX package does.

Multi-process worlds (``parallel/multihost.py``): every process runs the
same verb sequence (the SPMD collective contract), and the async engine
runs the JAX package's WINDOWED protocol. Each drained window of verbs is
packed (``_mh_pack_window``, a byte budget), encoded with the flat codec
(``parallel/wire.py``: a SEQ stamp and a CRC seal) and exchanged in one
standing-cap all-gather (``multihost.capped_exchange``); the ranks agree on
the common verb prefix (a divergent verb stream fails a CHECK on every
rank), and every rank applies every rank's payloads of that prefix to its
own replica through the tables' parts verbs: a table's Adds of the window
as one cross-rank merged run at its first Add's position, its Gets grouped
before and after that run. Every non-verb message (a drain ping, a
checkpoint or publish cut, FinishTrain) is a window head preceded by a
head-marker exchange, whether or not the pipeline is busy when it arrives
(``Server._dispatch``), so a rank at a barrier while a peer exchanges
verbs fails loudly instead of deadlocking. An exchange thread (``_ExchangeStage``) owns the
collective stream and the actor thread applies: by default
(``-mv_pipeline``) up to ``-mv_pipeline_depth`` windows are exchanged
ahead of the apply (window N applies while window N+1 is exchanged), since
every port table's apply is local (``mh_apply_is_local``); barrier heads
fence the pipeline. ``-mv_pipeline=0`` bounds the stage at one window, so
each exchange waits until the previous window applied (no overlap). A
pipelined window that carries several tables applies them in parallel
(``-mv_apply_workers``, ``_ApplyPool``): one job a table, its ops in
window order, the last job inline on the actor thread, the engine's
counters summed after every job joined. A lossy-opted table's Add values
cross as int8 envelopes under ``-mv_compress``/``-mv_compress_lossy``
(``parallel/compress.py``), and every rank, the sender included, applies
the same decode. Any escape from the window stream (a divergence CHECK, a peer
lost past the process group's timeout, a corrupted frame past its
retries) replies the error to every waiter the stream holds and poisons
the engine. The BSP ``SyncServer`` exchanges each verb it applies as a
one-verb window: every rank's engine makes the same defer and drain
decisions, so the i-th applied verbs pair up. Every exchange of a shard
(its windows, its head markers, and so its cut fences) rides the wire
channel ``mh_channel`` (the shard's slot): a host wire (shm or tcp,
``multihost.maybe_install_wire``) offers a channel per shard, so an
explicit ``-mv_engine_shards=N`` runs N streams across processes; gloo is
one ordered collective stream, and there the engine runs one
(``engine_shard_cap``).

CUDA streams. Every engine thread issues its device work on its current
CUDA stream, which on a thread that never set one is the device's default
stream. So all shards share ONE stream and the card runs their work in the
order the host issued it: a table's Adds and Gets stay in stream order,
and a cut's payload, issued after every shard fenced, runs after every
shard's queued work. A Get's result reaches the caller through a
synchronising ``.cpu()`` fetch (so a reply never carries a tensor the
device has not finished), which also waits on the work other shards
queued ahead of it (kernels and copies). A stream per shard would need events at every cut, at every
routing move and against the app thread's direct device-plane calls.

The worker-side fast paths (``tables/base.py``) read two flags defined
here, where the first ``MV_Init`` parses them: ``-mv_write_combine`` and
``-mv_get_staleness``. An engine admits them through ``WRITE_COMBINE_OK``
and ``GET_CACHE_OK`` (the BSP ``SyncServer`` refuses both: its clocks
count Get and Add messages), and ``epoch_for_table`` is the Get cache's
staleness clock: the window epoch of the stream applying the table.
``add_messages`` counts the Add messages the engine received.

Telemetry as in the JAX engine, under its names (``telemetry/``): the
``server.*`` and ``engine.*`` counters, gauges and histograms (window
latency, codec seconds, exchanges, verbs, barrier splits, Add dispatches
and merged runs, wire bytes, the fence-cause taxonomy
``engine.fence.<cause>`` registered at zero, the ``engine.phase.<p>_s``
histograms, per-family apply seconds, the binding-phase gauges, the apply
pool's jobs, batched-verb sizes, the BSP staleness), the spans
``server.window`` / ``.exchange`` / ``.apply`` / ``.add_run`` /
``.get_group``, the ``SERVER_PROCESS_GET``/``_ADD`` Dashboard monitors,
and the flight events ``window.admitted``, ``window.exchanged`` (recorded
before the cross-rank CHECK, so a diverging window is in the ring),
``window.applied``, ``window.phases`` (``-mv_phase_stamps``: a window's
form/pack/encode/exchange/exchange_wait/decode/apply microseconds and its
exchange-done anchor, read by ``telemetry/critpath.py``), ``window.tables``
(per-(table, verb) apply microseconds), ``fence`` with its cause,
``barrier``, ``wire.crc_retry`` and ``engine.fatal`` (then the ring goes
to ``-mv_diag_dir``). The phases are HOST clocks: an apply that only
launches kernels returns before the card has run them, as a JAX dispatch
does, so ``apply`` is launch-and-queue time, not the kernels' device time;
a window's Get finalize (the synchronising device-to-host copy) is inside
its apply. No synchronisation is added for telemetry's sake.

Failsafe (``failsafe/``) as in the JAX engines. Every drained Get and Add
passes the admission gate ``_admit`` BEFORE it can become a window
position (the async drain, the windowed multi-process drain, each shard
of the sharded engine, the BSP ``SyncServer`` before its clocks): a
duplicate delivery of an admitted message is dropped by object identity,
a retried tracked Add whose ``(src, msg_id)`` is in the engine's dedup
window (``-mv_dedup_window``, one window per engine and per shard) is
answered from the recorded outcome, and an armed chaos injector may
reject a tracked verb with ``TransientError`` (``verb.transient``) or
apply an Add and fail its ack (``verb.failack``). ``apply.delay`` stalls
each window's apply (the single-process window too), ``wire.bitflip`` and
``wire.truncate`` corrupt the encoded window blob (the seal's CRC catches
it and ``wire.crc_retry`` re-exchanges). With ``-mv_deadline_s`` set the
window collectives run through ``deadline.bounded`` and the pipelined
engine's apply fence is bounded; expiry is fatal to the stream. The
counters ``failsafe.dedup_hits``, ``failsafe.retries``,
``failsafe.deadline_exceeded`` and the ``dedup.hit`` flight events count
it.

Not ported (ROADMAP.md): the device window transport
(``-window_transport`` resolves to ``host``; ``device`` fails a CHECK) and
the elastic membership events, with the lease consult of a bounded
collective.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Deque, Dict, List, Optional

import numpy as np

from multiverso_tpu_torch import elastic
from multiverso_tpu_torch.actor import Actor, ActorDied, actor_names
from multiverso_tpu_torch.failsafe import chaos
from multiverso_tpu_torch.failsafe import deadline as fdeadline
from multiverso_tpu_torch.failsafe.dedup import DedupWindow
from multiverso_tpu_torch.failsafe.errors import (MembershipChanged,
                                                  TransientError)
from multiverso_tpu_torch.message import Message, MsgType, copy_result
from multiverso_tpu_torch.parallel import compress, multihost, wire
from multiverso_tpu_torch.parallel.seal import WireCorruption
from multiverso_tpu_torch.telemetry import flight as tflight
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.updaters.base import AddOption, GetOption
from multiverso_tpu_torch.utils.configure import (GetFlag, MV_DEFINE_bool,
                                                  MV_DEFINE_int,
                                                  MV_DEFINE_string,
                                                  cached_bool_flag,
                                                  cached_int_flag)
from multiverso_tpu_torch.utils.dashboard import monitor_region
from multiverso_tpu_torch.utils.log import CHECK, Log
from multiverso_tpu_torch.utils.mt_queue import MtQueue

MV_DEFINE_bool("sync", False, "sync or async")
# declared but dead in the reference (server.cpp:21); kept for flag parity
MV_DEFINE_int("backup_worker_ratio", 0,
              "ratio% of backup workers (dead flag, parity)")
MV_DEFINE_bool("mv_pipeline", True,
               "pipelined windowed engine (multi-process worlds): apply "
               "window N while window N+1 is exchanged (false = each "
               "exchange waits until the previous window applied)")
MV_DEFINE_int("mv_pipeline_depth", 2,
              "pipelined engine depth: the most exchanged-but-unapplied "
              "windows before the exchange stage waits (-mv_pipeline=0 "
              "means 1)")
MV_DEFINE_int("mv_apply_workers", 4,
              "apply-stage worker pool: apply DIFFERENT tables' parts of "
              "one exchanged window concurrently (a table's ops stay in "
              "window order; only windows whose apply is local on every "
              "rank); <=1 = serial apply")
# read per window through listener caches (a SetFlag between two windows
# takes effect at the next one), as the JAX package's engine reads them
_pipeline_flag = cached_bool_flag("mv_pipeline", True)
_pipeline_depth_flag = cached_int_flag("mv_pipeline_depth", 2)
_apply_workers_flag = cached_int_flag("mv_apply_workers", 4)
MV_DEFINE_string("window_transport", "auto",
                 "windowed-engine Add-value transport: auto / host resolve "
                 "to the host exchange; device is not ported yet")
MV_DEFINE_int("mv_engine_shards", 0,
              "engine shards: per-table-group engine actors, each "
              "owning its own window stream, exchange stage and SEQ "
              "counter; tables route by table_id %% shards (rank-"
              "agreed, no negotiation). 0 = auto: single-process "
              "worlds use min(tables, cores/4) via lazy shard spawn, "
              "multi-process worlds stay at 1 unless set explicitly "
              "(>1 there needs a multi-channel wire's per-shard "
              "channels — -mv_wire=shm same-host, tcp cross-host — "
              "because gloo is one globally-ordered "
              "collective stream). 1 = today's single engine byte-for-"
              "byte. Clamped to 1 under -sync (the BSP vector clocks "
              "count verbs across ALL tables) and -mv_elastic (the "
              "epoch relay is single-channel).")
MV_DEFINE_int("mv_write_combine", 8,
              "worker-side write combining: coalesce up to N consecutive "
              "fire-and-forget Adds to one table into ONE request before "
              "the mailbox hop (0 = off, every Add its own message). A "
              "COUNT cap, not bytes: call sequences are lockstep across "
              "the ranks of a multi-process world, payload bytes are not")
MV_DEFINE_int("mv_get_staleness", 0,
              "worker-side Get cache: serve a repeated identical Get from "
              "the last fetched result while the engine stream applying "
              "the table has run at most N windows since the fill and "
              "this process wrote nothing to the table (0 = off, every "
              "Get exact). One-process worlds only: a hit removes a verb "
              "from the stream")

MV_DEFINE_bool("mv_phase_stamps", True,
               "per-window lifecycle phase stamping (form/pack/encode/"
               "exchange/decode/apply flight events + engine.phase.* "
               "histograms; false = window events only). No-op while "
               "-mv_flight_events=0 gates the recorder off. Multi-process "
               "windows stamp EVERY window; single-process windows observe "
               "the apply histogram every window but sample the flight "
               "events and per-table attribution 1-in-32")
_phase_stamps_flag = cached_bool_flag("mv_phase_stamps", True)

#: single-process sampling period of the full stamp (a power of two;
#: windows 1, 33, 65, ... stamp, so short runs still leave records)
_PH_SP_SAMPLE = 32

#: the window lifecycle phases (the order is the engine.binding_phase
#: gauge's encoding: an index into this tuple, -1 = none yet);
#: ``exchange_wait`` is the slice of ``exchange`` blocked inside the
#: collective, the part a straggling peer inflates
ENGINE_PHASES = ("form", "pack", "encode", "exchange", "exchange_wait",
                 "decode", "apply")

#: table families whose apply-seconds histograms register at zero
_TABLE_FAMILIES = ("matrix", "sparse", "array", "kv")

#: the fence-cause taxonomy: every stall of the pipelined exchange stage
#: counts in exactly one ``engine.fence.<cause>``. ``device_wire`` stays at
#: zero in the port (no device window transport).
FENCE_CAUSES = ("barrier", "nonlocal_table", "device_wire", "depth")


def _table_family(table) -> str:
    """Short family label of a server table for the apply attribution
    (``SparseMatrixServerTable`` -> ``sparse``, ``KVServerTable`` ->
    ``kv``; another class its lowercased name)."""
    name = type(table).__name__.lower()
    for fam in ("sparse", "kv", "array", "matrix"):
        if fam in name:
            return fam
    return name.replace("servertable", "").replace("table", "") or "table"


_INF = float("inf")

#: apply-stage poll while an exchange is in flight: the actor keeps
#: draining its mailbox (feeding the NEXT window) between polls
_PL_POLL_S = 0.002


def _fail_multi_members(env: Message) -> None:
    """on_reply of a Request_MultiVerb envelope: the only reply an envelope
    takes is a failure sweep (a dying engine) — forward it to every member
    so batch waiters raise instead of hanging."""
    if isinstance(env.result, Exception):
        for m in env.payload.get("members", ()):
            m.reply(env.result)


class VectorClock:
    """Per-worker progress clock (reference server.cpp:81-137).

    ``Update(i)`` ticks worker i; returns True when the tick completes a
    round (the global clock catches up to the max local clock).
    """

    def __init__(self, n: int):
        self._local: List[float] = [0] * n
        self._global = 0

    def Update(self, i: int) -> bool:
        self._local[i] += 1
        if self._global < min(self._local):
            self._global += 1
            if self._global == self._max_element():
                return True
        return False

    def FinishTrain(self, i: int) -> bool:
        self._local[i] = _INF
        m = min(self._local)
        if self._global < m:
            self._global = m
            if self._global == self._max_element():
                return True
        return False

    def _max_element(self) -> float:
        finite = [v for v in self._local if v != _INF]
        return max([self._global] + finite)

    def local_clock(self, i: int) -> float:
        return self._local[i]

    def global_clock(self) -> float:
        return self._global

    def staleness(self) -> float:
        """How far the fastest still-training worker runs ahead of the
        global round (0 when every worker is caught up or finished)."""
        finite = [v for v in self._local if v != _INF]
        return max(max(finite) - self._global, 0.0) if finite else 0.0

    def DebugString(self) -> str:
        local = " ".join("-1" if v == _INF else str(int(v))
                         for v in self._local)
        return f"global {self._global} local: {local}"


class _ApplyPool:
    """Daemon threads draining one queue of apply jobs (the JAX package's
    ``_ApplyPool``): a job wedged in a native call must not keep the
    process from exiting, so no ``concurrent.futures``. A job reports
    through its box: ``done`` set, and ``result`` or ``error``."""

    def __init__(self, workers: int, name: str):
        self._q: MtQueue = MtQueue()
        self.workers = max(1, workers)
        for i in range(self.workers):
            threading.Thread(target=self._loop, daemon=True,
                             name=f"mvt-apply-{name}-{i}").start()

    def submit(self, fn) -> dict:
        box = {"done": threading.Event()}
        self._q.Push((fn, box))
        return box

    def _loop(self) -> None:
        while True:
            ok, item = self._q.Pop()
            if not ok:
                return
            fn, box = item
            try:
                box["result"] = fn()
            except BaseException as exc:    # raised again by the waiter
                box["error"] = exc
            box["done"].set()

    def shutdown(self) -> None:
        self._q.Exit()


class _StageKilled(Exception):
    """The apply stage killed the exchange stage after a fatal engine
    error; the actor has already failed every waiter."""


class _ExchangeStage:
    """The exchange stage of the pipelined windowed engine (the JAX
    package's ``_ExchangeStage``, sync/server.py:355-626).

    One daemon thread owns the collective stream: every window exchange
    and head-marker exchange runs here, in stream order, so the collective
    sequence each rank issues does not depend on how the apply stage is
    scheduled. Items flow actor -> ``_in`` -> this thread ->
    ``out`` -> actor:

    * ``("verbs", [msgs])`` — admitted Get/Add messages join the pending
      deque; the thread packs a window from it, exchanges it, agrees on
      the cross-rank prefix and emits ``("window", mine, windows, prefix,
      descs0, local)`` (``local``: the window's apply is local on every
      rank); verbs past the prefix lead the next exchange;
    * ``("barrier", msg)`` — a non-verb head: every pending verb goes
      first, then the head-marker exchange, then ``("barrier", msg)``;
    * ``("stop", None)`` — exit.

    After a barrier, or a window whose apply is not local, the thread
    FENCES: no further collective until the actor reports that item
    applied (the decision comes from exchanged bytes, so every rank
    fences at the same items). ``-mv_pipeline_depth`` (1 under
    ``-mv_pipeline=0``) bounds the exchanged-but-unapplied items. Any
    escape parks the stage (``dead``) and emits ``("error", exc)``.
    """

    def __init__(self, srv: "Server"):
        self._srv = srv
        self._in: MtQueue = MtQueue()
        self.out: MtQueue = MtQueue()
        self._pending: Deque[Message] = collections.deque()
        self._emitted = 0
        self._applied = 0
        self._fence_at = 0
        #: why _fence_at was last raised (``engine.fence.<cause>``); a
        #: stall under the depth bound alone is classified ``depth``
        self._fence_cause = "barrier"
        self._cv = threading.Condition()
        self._killed = False
        self.dead: Optional[BaseException] = None
        #: overlap telemetry: start of the exchange in flight (0.0 = idle)
        #: and the stage's busy seconds
        self.busy_since = 0.0
        self.busy_s = 0.0
        #: when the current pending run started filling (0.0 = empty): a
        #: window's ``form`` phase
        self._pending_since = 0.0
        self._thread = threading.Thread(
            target=self._main, name=f"mvt-engine-exchange{srv.slot}",
            daemon=True)
        self._thread.start()

    def feed(self, m: Message) -> None:
        CHECK(m.msg_type is not MsgType.Request_MultiVerb,
              "unexpanded multi-verb envelope fed to the exchange stage "
              "(engine bug)")
        if m.msg_type in (MsgType.Request_Add, MsgType.Request_Get):
            self._in.Push(("verbs", [m]))
        else:
            self._in.Push(("barrier", m))

    def note_applied(self) -> None:
        """The actor finished one emitted item: lifts the depth bound and
        any fence waiting on it."""
        with self._cv:
            self._applied += 1
            self._cv.notify_all()

    def stop(self) -> None:
        self._in.Push(("stop", None))
        self._in.Exit()

    def poison(self) -> None:
        """After a fatal engine error: issue no further collective and
        never block on a fence the dead actor will not lift."""
        self._killed = True
        with self._cv:
            self._cv.notify_all()
        self._in.Exit()

    def depth(self) -> int:
        """Exchanged-but-unapplied items (diagnostics)."""
        return self._emitted - self._applied

    def pending_verbs(self) -> int:
        return len(self._pending)

    def _wait_applied(self, upto: int, what: str) -> None:
        """Block until the actor applied ``upto`` items, bounded by
        ``-mv_deadline_s`` (expiry is fatal: the stream is unsound)."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._applied >= upto or self._killed,
                fdeadline.timeout_or_none())
        if self._killed:
            raise _StageKilled()
        if not ok:
            fdeadline.raise_deadline(what, fatal=True)

    _GATE_WHAT = "pipelined engine apply fence (apply stage did not drain)"

    def _gate(self) -> None:
        """Before any new collective: the fence and the depth bound (read
        live, so a changed flag takes effect at the next window). A stall
        is classified (the fence's recorded cause, or ``depth`` when only
        the bound holds) and its seconds observed."""
        depth = (max(1, _pipeline_depth_flag()) if _pipeline_flag()
                 else 1)
        depth_target = self._emitted - depth + 1
        target = max(self._fence_at, depth_target)
        stall = self._applied < target      # advisory: classifies only
        t0 = time.perf_counter()
        self._wait_applied(target, self._GATE_WHAT)
        if stall:
            cause = (self._fence_cause if self._fence_at >= depth_target
                     else "depth")
            self._srv._note_fence(cause, time.perf_counter() - t0)

    def _main(self) -> None:
        try:
            self._loop()
        except _StageKilled as exc:
            self.dead = self.dead or exc
        except BaseException as exc:       # delivered to the apply stage
            self.dead = exc
            self.out.Push(("error", exc))

    def _loop(self) -> None:
        items: Deque = collections.deque()
        while not self._killed:
            while True:
                ok, it = self._in.TryPop()
                if not ok:
                    break
                items.append(it)
            if not items and not self._pending:
                ok, it = self._in.Pop()
                if not ok:
                    return
                items.append(it)
                continue
            # input order is admission order: only LEADING verb items may
            # join pending ahead of a queued barrier
            while items and items[0][0] == "verbs":
                if not self._pending:
                    self._pending_since = time.perf_counter()
                self._pending.extend(items.popleft()[1])
            if self._pending:
                self._exchange_one()
                continue
            kind, payload = items.popleft()
            if kind == "stop":
                return
            self._gate()
            self._srv._mh_check_barrier_head(payload)
            payload._mh_headed = True       # the apply stage runs it now
            self._emitted += 1
            self._fence_at = self._emitted
            self._fence_cause = "barrier"
            self.out.Push(("barrier", payload))

    def _exchange_one(self) -> None:
        srv = self._srv
        self._gate()
        verbs = list(self._pending)
        t0 = time.perf_counter()
        self.busy_since = t0
        # the window's phase record: filled here, closed by the apply
        # stage, emitted as ONE window.phases event
        ph = None
        if srv._phases_on():
            ph = {}
            if self._pending_since:
                ph["form"] = max(0.0, t0 - self._pending_since)
        try:
            # the window span opens here, parented to the head verb; the
            # apply stage parents its apply span to it
            with ttrace.span("server.window", cat="server",
                             parent=verbs[0].trace_ctx,
                             args={"pending": len(verbs)}) as win_ctx:
                tp = time.perf_counter()
                local, used = srv._mh_pack_window(verbs)
                if ph is not None:
                    ph["pack"] = time.perf_counter() - tp
                windows = srv._mh_exchange_decode(local, ph)
        finally:
            now = time.perf_counter()
            self.busy_since = 0.0
            self.busy_s += now - t0
            a0 = srv._apply_since
            if a0:
                # this exchange ended while an apply ran: the overlapped
                # stretch is recorded here
                srv._note_overlap(max(0.0, now - max(a0, t0)))
        prefix, descs0 = srv._mh_agree(windows)
        for _ in range(prefix):
            self._pending.popleft()
        self._emitted += 1
        # the next window's form clock starts at this cut
        self._pending_since = (time.perf_counter() if self._pending
                               else 0.0)
        is_local = srv._mh_window_is_local(descs0)
        if not is_local:
            self._fence_at = self._emitted
            self._fence_cause = "nonlocal_table"
        if ph is not None:
            ph["seq"] = srv._mh_seq - 1
            ph["mepoch"] = multihost.membership_epoch()
        self.out.Push(("window", used[:prefix], windows, prefix, descs0,
                       is_local, t0, win_ctx, ph))


class Server(Actor):
    """Async server engine (reference server.cpp:23-58)."""

    #: messages drained per window
    GET_PIPELINE_WINDOW = 16
    #: whether this engine flattens Request_MultiVerb envelopes; the BSP
    #: SyncServer counts MESSAGES into its clocks, so Zoo.SendToServerMulti
    #: delivers the members one at a time there
    MULTI_VERB_OK = True
    #: whether a non-verb message is a head-marked window head in a
    #: multi-process world (``_dispatch``); the BSP SyncServer exchanges
    #: one verb at a time on the actor thread and has no pipeline to race
    MH_BARRIER_HEADS = True
    #: whether the worker-side fast paths may run in front of this engine:
    #: the async contract (a Get may observe more progress, never less)
    #: admits both; the BSP SyncServer counts Get and Add MESSAGES into its
    #: clocks and refuses both
    WRITE_COMBINE_OK = True
    GET_CACHE_OK = True

    def __init__(self, name: str = actor_names.kServer):
        super().__init__(name)
        self.store_: List = []
        #: Add messages received (a batch's Add members included)
        self.add_messages = 0
        self._count_lock = threading.Lock()
        #: this engine's shard slot (0 unless it is a sub-shard), the wire
        #: channel its exchanges ride in a multi-process world, and the
        #: stream id its flight events carry
        self.slot = 0
        self.mh_channel = 0
        self.mh_stream = 0
        #: window Add runs applied as one merged dispatch
        self.add_runs_merged = 0
        #: the parallel window apply's pool (``-mv_apply_workers``); the
        #: ``engine.apply_pool.*`` counters count its jobs
        self._apply_pool: Optional[_ApplyPool] = None
        # -- the multi-process window stream (module docstring) --
        #: standing exchange capacities per window-head key; they evolve
        #: from exchanged data only, identically on every rank
        self._mh_caps: Dict = {}
        #: window-exchange sequence stamp, advanced on every successful
        #: exchange in lockstep on every rank
        self._mh_seq = 0
        self._ex_stage: Optional[_ExchangeStage] = None
        #: verbs applied through windows, window exchanges, and Add runs
        #: merged across positions and ranks
        self.mh_window_verbs = 0
        self.mh_window_exchanges = 0
        self.mh_add_run_merged = 0
        #: seconds inside the window exchanges' collectives and inside
        #: window applies
        self.xw_busy_s = 0.0
        self.apply_busy_s = 0.0
        #: windows applied on this stream (local windows and exchanged
        #: ones): the stream position a cut is taken at (``cut_epoch``)
        self.window_epoch = 0
        #: windows split by a non-verb barrier message
        self.window_barrier_splits = 0
        #: per-table verbs this stream processed and per-table apply
        #: seconds (multi-process windows): the watchdog's shard load
        self.table_verbs: Dict[int, int] = {}
        self.table_apply_s: Dict[int, float] = {}
        self._init_telemetry()
        self.RegisterHandler(MsgType.Request_Get, self._get_entry)
        self.RegisterHandler(MsgType.Request_Add, self._add_entry)
        self.RegisterHandler(MsgType.Request_MultiVerb, self._get_entry)
        self.RegisterHandler(MsgType.Server_Finish_Train,
                             self.ProcessFinishTrain)
        # drain ping: replies once the mailbox drained up to it — never
        # touches the BSP clocks, unlike FinishTrain
        self.RegisterHandler(MsgType.Request_Barrier, lambda m: m.reply(None))
        self.RegisterHandler(MsgType.Request_StoreLoad, self._store_load_entry)
        # the serving plane's publish (serving/snapshot.py): the SAME
        # handler as StoreLoad on purpose, so checkpoint saves and
        # publishes are one cut mechanism (Zoo.CallOnEngine) and cannot
        # drift; as a non-verb message it is a window barrier, a
        # cross-stream cut on the sharded engine (_CUT_TYPES) and a
        # head-marked barrier in the windowed multi-process engine
        self.RegisterHandler(MsgType.Request_Publish, self._store_load_entry)

    def _init_telemetry(self) -> None:
        """The JAX engine's instruments, registered at construction (the
        whole taxonomy scrapes at zero from the first read); handles are
        cached on the engine, never looked up per window."""
        self._t_window_s = tmetrics.histogram("server.window.latency_s")
        self._t_encode_s = tmetrics.histogram("server.wire.encode_s")
        self._t_decode_s = tmetrics.histogram("server.wire.decode_s")
        self._t_exchanges = tmetrics.counter("server.window.exchanges")
        self._t_verbs = tmetrics.counter("server.window.verbs")
        self._t_splits = tmetrics.counter("server.window.barrier_splits")
        self._t_dispatch = tmetrics.counter("server.add.dispatches")
        self._t_merged = tmetrics.counter("server.add.run_merged")
        # the device window transport's: zero in the port (not ported)
        tmetrics.counter("server.add.device_deferrals")
        tmetrics.counter("server.wire.device_bytes")
        self._t_host_bytes = tmetrics.counter("server.wire.host_bytes")
        self._t_budget = tmetrics.gauge("server.window.host_budget_bytes")
        #: the (src, msg_id) at-most-once window for tracked Adds and its
        #: hit counter; the other failsafe counters register at zero so a
        #: healthy run's snapshot shows them
        self._dedup = DedupWindow(int(GetFlag("mv_dedup_window")))
        self._t_dedup_hits = tmetrics.counter("failsafe.dedup_hits")
        tmetrics.counter("failsafe.deadline_exceeded")
        tmetrics.counter("failsafe.retries")
        tmetrics.counter("wire.crc_failures")
        self._t_overlap_pct = tmetrics.gauge("engine.overlap_pct")
        tmetrics.counter("worker.write_combine_hits")
        tmetrics.counter("worker.get_cache_hits")
        for cause in FENCE_CAUSES:
            tmetrics.counter(f"engine.fence.{cause}")
        self._t_fence_stall_s = tmetrics.histogram("engine.fence.stall_s")
        #: last classified fence cause and locally binding phase (the
        #: Dashboard [Ops] line, /perf)
        self.last_fence_cause = ""
        self._t_phase = {p: tmetrics.histogram(f"engine.phase.{p}_s")
                         for p in ENGINE_PHASES}
        self._d_window = tmetrics.digest("digest.engine.window_s")
        self._t_apply_fam = {
            fam: tmetrics.histogram(f"engine.apply.table_s.{fam}")
            for fam in _TABLE_FAMILIES}
        #: tid -> (family, histogram) of the apply attribution
        self._fam_cache: Dict[int, tuple] = {}
        self._t_binding = tmetrics.gauge("engine.binding_phase")
        self._t_binding.set(-1.0)
        self.last_binding_phase = ""
        self._t_binding_st = None
        self._t_pool_jobs = tmetrics.counter("engine.apply_pool.jobs")
        self._t_pool_inline = tmetrics.counter(
            "engine.apply_pool.inline_jobs")
        self._t_multi = tmetrics.counter("engine.multi_verb_batches")
        self._t_multi_size = tmetrics.histogram("engine.multi_verb_size")
        #: the single-process 1-in-N full-stamp sampling
        self._ph_tick = 0
        self._ph_stamp_this = False
        #: overlap telemetry: the apply interval in progress (0.0 = none)
        #: and the seconds the exchange and the apply ran together
        self._apply_since = 0.0
        self._overlap_s = 0.0
        self._overlap_lock = threading.Lock()

    def _dispatch(self, msg: Message) -> None:
        """In a multi-process world every non-verb message (a drain ping, a
        checkpoint or publish cut, FinishTrain) enters the window stream as
        a head-marked barrier on every rank, even when this rank's
        pipeline is idle. Dispatched directly when idle, it would strand a
        peer whose apply stage was still finishing its last window when
        the same message arrived: the peer drains it into its pipeline and
        waits in a head-marker exchange this rank never joins. The exchange
        stage marks the message ``_mh_headed`` once its marker exchange
        is done, and the apply stage's dispatch then runs its handler."""
        if (self.MH_BARRIER_HEADS and multihost.world_size() > 1
                and msg.msg_type not in (MsgType.Request_Get,
                                         MsgType.Request_Add,
                                         MsgType.Request_MultiVerb)
                and not getattr(msg, "_mh_headed", False)):
            self.note_dequeue(msg)
            self._mh_windows([msg])
            return
        super()._dispatch(msg)

    def _count_adds(self, msgs) -> None:
        n = sum(1 for m in msgs if m.msg_type is MsgType.Request_Add)
        if n:
            with self._count_lock:
                self.add_messages += n

    def Receive(self, msg: Message) -> None:
        self._count_adds((msg,))
        super().Receive(msg)

    def receive_multi(self, members) -> None:
        """Accept one batched verb submission: ONE mailbox hop carries the
        pre-built member messages in a Request_MultiVerb envelope."""
        self._count_adds(members)
        self._push_multi(members)

    def _push_multi(self, members) -> None:
        """Push one envelope straight to this actor's mailbox:
        ShardedServer.receive_multi has already split the batch per shard,
        and going back through its Receive would split it again forever."""
        Actor.Receive(self, Message(msg_type=MsgType.Request_MultiVerb,
                                    payload={"members": list(members)},
                                    on_reply=_fail_multi_members))

    def _expand_multi(self, batch: list) -> list:
        """Flatten envelopes into their member verbs in place of the
        envelope's drain position (submission order). Members carry no
        enqueue stamp: the envelope's one stamp accounts the hop."""
        out: list = []
        for m in batch:
            if m.msg_type is MsgType.Request_MultiVerb:
                self.note_dequeue(m)
                members = m.payload["members"]
                self._t_multi.inc()
                self._t_multi_size.observe(len(members))
                out.extend(members)
            else:
                out.append(m)
        return out

    def RegisterTable(self, server_table) -> int:
        table_id = len(self.store_)
        self.store_.append(server_table)
        server_table.table_id = table_id
        return table_id

    def cut_epoch(self) -> int:
        """Windows applied over every stream: the stream position a cut
        (a snapshot publish, a checkpoint) is taken at."""
        return self.window_epoch

    def epoch_for_table(self, table_id: int) -> int:
        """Window epoch of the stream applying ``table_id``'s verbs: the
        Get cache's staleness clock (the unsharded engine is one
        stream)."""
        return self.window_epoch

    def shard_states(self) -> List[dict]:
        """Per-shard live state (local, never collective): slot, actor
        name, mailbox depth and liveness, and the JAX engine's stream
        state /healthz, the Dashboard and the watchdog read."""
        thread = self._thread
        st = self._ex_stage
        return [{
            "slot": self.slot, "name": self.name,
            "mailbox_depth": self.mailbox.Size(),
            "alive": (self._poison is None and thread is not None
                      and thread.is_alive()),
            "shard": self.mh_stream, "actor": self.name,
            "poisoned": (repr(self._poison) if self._poison is not None
                         else None),
            "window_epoch": self.window_epoch,
            "window_exchanges": self.mh_window_exchanges,
            "apply_busy_s": round(self.apply_busy_s, 6),
            "xw_busy_s": round(self.xw_busy_s, 6),
            "window_verbs": self.mh_window_verbs,
            "table_verbs": dict(self.table_verbs),
            "table_apply_s": {t: round(v, 6)
                              for t, v in self.table_apply_s.items()},
            "stage": None if st is None else {
                "depth": st.depth(),
                "pending_verbs": st.pending_verbs(),
                "mid_exchange": bool(st.busy_since),
                "dead": repr(st.dead) if st.dead is not None else None,
            },
        }]

    # -- telemetry helpers (the JAX engine's, sync/server.py) ----------------

    def _flight_exchanged(self, descs, my_rank: int) -> None:
        """Flight event of one completed exchange: THIS rank's verbs over
        the agreed prefix, recorded BEFORE the cross-rank divergence
        CHECK, so a diverging window is in the ring when the CHECK aborts
        it (``telemetry/forensics.py`` aligns on it)."""
        if tflight.enabled():
            tflight.record("window.exchanged", seq=self._mh_seq - 1,
                           epoch=self.window_epoch,
                           mepoch=multihost.membership_epoch(),
                           stream=self.mh_stream,
                           detail=",".join(f"{k}{t}"
                                           for k, t in descs[my_rank]))

    def _note_fence(self, cause: str, stall_s: float) -> None:
        """One pipelined-stage stall: ``engine.fence.<cause>``, the stall
        histogram and a flight event (exchange stage thread)."""
        tmetrics.counter(f"engine.fence.{cause}").inc()
        self._t_fence_stall_s.observe(stall_s)
        self.last_fence_cause = cause
        tflight.record("fence", seq=self._mh_seq, epoch=self.window_epoch,
                       mepoch=multihost.membership_epoch(),
                       stream=self.mh_stream, detail=cause)

    def _note_overlap(self, s: float) -> None:
        """``s`` seconds the exchange and the apply ran together; refreshes
        the engine.overlap_pct gauge (the share of the stage's busy
        seconds)."""
        if s <= 0:
            return
        st = self._ex_stage
        with self._overlap_lock:
            self._overlap_s += s
            busy = st.busy_s if st is not None else 0.0
            if busy > 0:
                self._t_overlap_pct.set(
                    min(100.0, 100.0 * self._overlap_s / busy))

    def _phases_on(self) -> bool:
        """The phase-stamping gate: two cached flag reads."""
        return _phase_stamps_flag() and tflight.enabled()

    def _binding_stream_gauge(self):
        """This stream's binding-phase gauge (lazy: a sub-shard learns its
        stream id after construction; touched only when the phase
        changes)."""
        g = self._t_binding_st
        if g is None:
            g = self._t_binding_st = tmetrics.gauge(
                f"engine.stream{self.mh_stream}.binding_phase")
        return g

    def _set_binding(self, phase: str) -> None:
        if phase and phase != self.last_binding_phase:
            self.last_binding_phase = phase
            idx = float(ENGINE_PHASES.index(phase))
            self._t_binding.set(idx)
            self._binding_stream_gauge().set(idx)

    def _ph_emit(self, ph: dict, nverbs: int) -> None:
        """Emit one window's phase record: the ``window.phases`` flight
        event (durations in integer microseconds), the engine.phase.*_s
        histograms and the binding-phase gauges. ``xd`` re-anchors the
        exchange-done stamp to the event's own ``tm`` (its wall time is
        the event's ``t`` minus xd, the rendezvous critpath aligns clocks
        on) and ``ax`` is exchange-done to apply-start. A single-process
        window carries only ``a`` and seq -1 (no stream position)."""
        apply_s = ph.get("apply", 0.0)
        if "x" not in ph:
            if apply_s > 0.0:
                self._t_phase["apply"].observe(apply_s)
                self._d_window.observe(apply_s)
                self._set_binding("apply")
            tflight.record("window.phases", seq=ph.get("seq", -1),
                           epoch=self.window_epoch,
                           mepoch=ph.get("mepoch", 0),
                           stream=self.mh_stream,
                           detail=f"v={nverbs};a={int(apply_s * 1e6)}")
            return
        durs = {"form": ph.get("form", 0.0), "pack": ph.get("pack", 0.0),
                "encode": ph.get("encode", 0.0),
                "exchange": ph.get("x", 0.0),
                "exchange_wait": ph.get("xw", 0.0),
                "decode": ph.get("dec", 0.0),
                "apply": apply_s}
        for name, secs in durs.items():
            if secs > 0.0:
                self._t_phase[name].observe(secs)
        # the exchange already contains its wait
        self._d_window.observe(sum(durs.values()) - durs["exchange_wait"])
        cand = {k: v for k, v in durs.items() if k != "exchange"}
        self._set_binding(max(cand, key=cand.get)
                          if any(cand.values()) else "")
        parts = [f"v={nverbs}"]
        for tag, key in (("f", "form"), ("p", "pack"), ("e", "encode"),
                         ("x", "exchange"), ("xw", "exchange_wait"),
                         ("d", "decode"), ("a", "apply")):
            if durs[key] > 0.0:
                parts.append(f"{tag}={int(durs[key] * 1e6)}")
        x_done_m = ph.get("x_done_m", 0.0)
        if x_done_m:
            now_m = time.perf_counter()
            parts.append(f"xd={int((now_m - x_done_m) * 1e6)}")
            a_start = ph.get("a_start_m", 0.0)
            if a_start:
                parts.append(f"ax={int((a_start - x_done_m) * 1e6)}")
        tflight.record("window.phases", seq=ph.get("seq", -1),
                       epoch=self.window_epoch, mepoch=ph.get("mepoch", 0),
                       stream=self.mh_stream, detail=";".join(parts))

    def _ph_tables(self, tbl: dict, seq: int, mepoch: int) -> None:
        """Apply seconds per (table, verb): one ``window.tables`` flight
        event (``<family><tid>:<A|G>=<us>``) and the per-family
        engine.apply.table_s.* histograms."""
        parts = []
        items = tbl.items() if len(tbl) == 1 else sorted(tbl.items())
        for (tid, verb), secs in items:
            cached = self._fam_cache.get(tid)
            if cached is None:
                try:
                    fam = _table_family(self.store_[tid])
                except Exception:
                    fam = "table"
                hist = (self._t_apply_fam.get(fam)
                        or tmetrics.histogram(f"engine.apply.table_s.{fam}"))
                cached = self._fam_cache[tid] = (fam, hist)
            fam, hist = cached
            hist.observe(secs)
            parts.append(f"{fam}{tid}:{verb}={int(secs * 1e6)}")
        if parts:
            tflight.record("window.tables", seq=seq,
                           epoch=self.window_epoch, mepoch=mepoch,
                           stream=self.mh_stream, detail=";".join(parts))

    def _admit(self, msg: Message) -> bool:
        """The failsafe admission gate, applied to every drained message
        BEFORE it can become a window position (the JAX engine's
        ``_admit``).

        (1) At-most-once Adds: a duplicate delivery of an admitted message
        (a mailbox dup) is dropped by object identity, which needs no
        window slot, so it holds for fire-and-forget Adds and for Gets
        (a duplicate Get would tick a BSP clock twice); a retried tracked
        Add whose key is in the dedup window is answered from the record.
        Neither enters the verb stream, where an extra verb on one rank
        would fail the cross-rank CHECK.

        (2) Chaos: the armed injector may reject a tracked verb with
        ``TransientError`` before it applies, or mark an Add to apply and
        then fail its ack. Every verb draws in admission order, so two
        ranks with one seed fault the same lockstep positions."""
        if (msg.msg_type in (MsgType.Request_Add, MsgType.Request_Get)
                and getattr(msg, "_fs_admitted", False)):
            self._t_dedup_hits.inc()
            tflight.record("dedup.hit", epoch=self.window_epoch,
                           detail=f"obj src{msg.src}")
            return False
        if msg.msg_type is MsgType.Request_Add and msg.msg_id:
            key = (msg.src, msg.msg_id)
            tracked = msg.waiter is not None
            if tracked and self._dedup.seen(key):
                self._t_dedup_hits.inc()
                tflight.record("dedup.hit", epoch=self.window_epoch,
                               detail=f"retry src{msg.src}")
                ready, outcome = self._dedup.outcome(key)
                msg.reply(outcome if ready else TransientError(
                    "duplicate Add while the original is in flight"))
                return False
            failack = False
            cz = chaos.get()
            if cz is not None:
                action = cz.verb_action(tracked=tracked)
                if action == "transient":
                    msg.reply(TransientError("chaos: transient verb "
                                             "fault (pre-apply)"))
                    return False
                failack = action == "failack"
            msg._fs_admitted = True
            if tracked:
                # only tracked Adds take dedup slots: only they can be
                # retried, and a fire-and-forget burst must not evict a
                # pending retry's record
                self._dedup.record(key)
                self._fs_wrap_reply(msg, key, failack)
            return True
        if msg.msg_type is MsgType.Request_Get:
            cz = chaos.get()
            if (cz is not None
                    and cz.verb_action(tracked=msg.waiter is not None)
                    == "transient"):
                # a Get takes only the pre-serve fault (a retry re-serves
                # it); the draw advances either way, keeping the ranks'
                # schedules in lockstep
                msg.reply(TransientError("chaos: transient verb fault"))
                return False
            msg._fs_admitted = True
        return True

    def _fs_wrap_reply(self, msg: Message, key, failack: bool) -> None:
        """Shadow ``msg.reply`` so the apply outcome lands in the dedup
        window whichever engine path replies, and, under chaos
        ``failack``, the worker's ack becomes a ``TransientError`` while
        the record stays truthful: the retry is answered from it, never
        applied again."""
        orig = msg.reply
        dedup = self._dedup

        def _reply(result=None):
            dedup.set_outcome(key, result)
            if failack and not isinstance(result, Exception):
                orig(TransientError("chaos: ack failed after apply"))
            else:
                orig(result)

        msg.reply = _reply

    def _apply_delay(self) -> None:
        """Chaos ``apply.delay``: stall this window's apply (a perf fault;
        the stream stays lockstep). Consulted once per window."""
        cz = chaos.get()
        if cz is not None:
            delay = cz.apply_delay()
            if delay > 0.0:
                time.sleep(delay)

    def _get_entry(self, msg: Message) -> None:
        """Window handler for Request_Get, Request_Add and envelopes."""
        batch = [msg]
        while len(batch) < self.GET_PIPELINE_WINDOW:
            ok, nxt = self.mailbox.TryPop()
            if not ok:
                break
            batch.append(nxt)
        batch = self._expand_multi(batch)
        for m in batch:
            # drained messages bypass _dispatch: their queue wait is
            # observed here (once per message)
            self.note_dequeue(m)
        # the failsafe gate BEFORE windowing: a duplicate or a rejected
        # verb never becomes a stream position
        batch = [m for m in batch if self._admit(m)]
        if not batch:
            return
        if multihost.world_size() > 1:
            self._mh_windows(batch)
            return
        t0 = time.perf_counter()
        self._apply_delay()
        phases = self._phases_on()
        if phases:
            self._ph_tick += 1
            self._ph_stamp_this = (self._ph_tick
                                   & (_PH_SP_SAMPLE - 1)) == 1
        else:
            self._ph_stamp_this = False
        with ttrace.span("server.window", cat="server",
                         args={"verbs": len(batch)}):
            self._local_window(batch)
        self.window_epoch += 1
        tflight.record("window.applied", epoch=self.window_epoch,
                       stream=self.mh_stream, detail=f"{len(batch)}v")
        win_s = time.perf_counter() - t0
        self._t_window_s.observe(win_s)
        # a single-process window's whole body is apply
        self.apply_busy_s += win_s
        if phases:
            # the apply histogram sees every window, the flight record
            # the 1-in-N sample
            if self._ph_stamp_this:
                self._ph_emit({"apply": win_s}, len(batch))
            else:
                self._t_phase["apply"].observe(win_s)
        self._t_verbs.inc(sum(1 for m in batch if m.msg_type in
                              (MsgType.Request_Add, MsgType.Request_Get)))

    def _add_entry(self, msg: Message) -> None:
        """Request_Add enters the same window as Gets; SyncServer re-binds
        this to its strict clocked path."""
        self._get_entry(msg)

    def Stop(self) -> None:
        if self._ex_stage is not None:
            self._ex_stage.stop()
        super().Stop()
        # no join: the drain above applied every window, and the workers
        # are daemons
        pool, self._apply_pool = self._apply_pool, None
        if pool is not None:
            pool.shutdown()

    # -- elastic plane hooks (elastic/) ---------------------------------------

    def _elastic_rebase(self, mepoch: int, cause: str) -> None:
        """Epoch transition, ON the engine thread with the stream fenced:
        re-base the exchange stream for the new world — SEQ back to 0
        (every surviving member re-bases at the same cut), standing caps
        dropped (the world size changed, so the exchanged buffer shapes
        did), and the exchange stage retired (the next window builds a
        fresh one). A stage thread left inside an abandoned collective is
        never joined or reused."""
        st = self._ex_stage
        if st is not None:
            st.poison()
            st.dead = st.dead or _StageKilled()
            self._ex_stage = None
        self._mh_seq = 0
        self._mh_caps.clear()
        tflight.record("membership.epoch", seq=0, epoch=self.window_epoch,
                       mepoch=mepoch, stream=self.mh_stream,
                       detail=f"cause={cause}")
        Log.Info("engine: exchange stream re-based for membership epoch "
                 "%d (%s)", mepoch, cause)

    def _elastic_post_transition(self, pending) -> bool:
        """After a barrier dispatch that performed an epoch transition:
        when the new world has one member the collective protocol is
        gone — drain the remaining messages through the local window
        path and report True."""
        if multihost.world_size() > 1:
            return False
        batch = list(pending)
        pending.clear()
        if batch:
            self._local_window(batch)
            self.window_epoch += 1
            tflight.record("window.applied", epoch=self.window_epoch,
                           mepoch=multihost.membership_epoch(),
                           stream=self.mh_stream, detail=f"{len(batch)}v")
        return True

    @staticmethod
    def _bounded_collective(fn, what: str):
        """``deadline.bounded`` plus the membership-lease consult: a
        collective that failed (its deadline, a dead shm peer's
        ``ActorDied``, a reset tcp stream) asks the elastic authority
        whether a peer's lease expired BEFORE going fatal, and a dead peer
        turns the failure into the typed ``MembershipChanged`` the
        transition path handles. No elastic plane, or every lease fresh:
        the original error re-raises untouched (fatal)."""
        try:
            return fdeadline.bounded(fn, what)
        except MembershipChanged:
            raise
        except BaseException as exc:
            repl = elastic.peer_loss(what) if elastic.enabled() else None
            if repl is not None:
                raise repl from exc
            raise

    # -- the multi-process windowed protocol (module docstring) -------------

    #: byte budget of one exchange's packed payloads: verbs past it lead
    #: the next exchange
    MH_WINDOW_BYTES = 4 << 20
    #: re-exchanges after a frame fails its seal: every rank sees the same
    #: round corrupted and re-enters together; an asymmetric corruption
    #: desyncs the SEQ stamps and fails loudly
    MH_WIRE_RETRIES = 2

    def _mh_windows(self, batch) -> None:
        """Process drained messages through collective windows until none
        remains. Any escape aborts the stream mid-window, which leaves
        this rank's collective position unsound: every message the stream
        holds gets the error, and the engine poisons."""
        pending: Deque[Message] = collections.deque(batch)
        try:
            try:
                self._mh_pipelined(pending)
            except MembershipChanged as exc:
                # a peer's lease expired (the coordinator confirmed it
                # when the failed collective consulted it): not fatal
                # when the elastic plane can transition. The tables roll
                # back to the retained cut on the shrunk world, the
                # stream re-bases, and the drained messages fail TYPED
                # (their effects were rolled back with everything after
                # the cut), so workers re-run from their last sync point
                if self._ex_stage is not None:
                    st = self._ex_stage
                    st.poison()
                    st.dead = st.dead or exc
                    self._ex_stage = None
                if not elastic.engine_transition(self, exc):
                    raise       # no plane / no cut: the fatal path below
                for m in pending:
                    m.reply(exc)
                return
        except Exception as exc:
            if self._ex_stage is not None:
                self._ex_stage.poison()
            Log.Error("engine: multi-process window stream aborted: %r",
                      exc)
            # forensics: the abort is a ring event, then the ring goes to
            # -mv_diag_dir, BEFORE the waiters fail (a fast-exiting worker
            # must not beat the dump)
            tflight.record("engine.fatal", seq=self._mh_seq,
                           epoch=self.window_epoch,
                           mepoch=multihost.membership_epoch(),
                           stream=self.mh_stream,
                           detail=f"{type(exc).__name__}: {exc}"[:200])
            tflight.dump_failure(
                f"engine window stream abort ({type(exc).__name__})")
            for m in pending:
                m.reply(exc)
            exc.mv_fatal = True
            raise

    def _mh_pipelined(self, fed: Deque[Message]) -> None:
        """The apply stage: feed admitted messages to the exchange stage in
        admission order, keep draining the mailbox while exchanges are in
        flight (the next window forms meanwhile), and apply completed
        windows in emission (= SEQ) order. ``fed`` holds every message the
        pipeline owns, oldest first."""
        stage = self._ex_stage
        if stage is None or stage.dead is not None:
            stage = self._ex_stage = _ExchangeStage(self)
        for m in fed:
            stage.feed(m)
        deadline = fdeadline.timeout_or_none()
        stall_s = 0.0
        while fed:
            for _ in range(64):
                ok, m = self.mailbox.TryPop()
                if not ok:
                    break
                self.note_dequeue(m)
                for mm in self._expand_multi([m]):
                    if self._admit(mm):
                        fed.append(mm)
                        stage.feed(mm)
            ok, item = stage.out.TryPop()
            if not ok:
                ok, item = stage.out.Pop(timeout=_PL_POLL_S)
            if not ok:
                # an exchange in flight (or waiting for peers): the stage
                # bounds its own collective; this catches a stage that
                # died without emitting, a grace past the stage's deadline
                # so its richer error wins when both fire
                stall_s += _PL_POLL_S
                if deadline is not None and stall_s > deadline + 1.0:
                    fdeadline.raise_deadline(
                        "pipelined window flush (exchange stage stalled)",
                        fatal=True)
                continue
            stall_s = 0.0
            if item[0] == "error":
                raise item[1]
            try:
                if item[0] == "barrier":
                    CHECK(fed.popleft() is item[1],
                          "pipeline completion order desync (engine bug)")
                    self.window_barrier_splits += 1
                    self._t_splits.inc()
                    self._dispatch(item[1])
                    transitioned = self._ex_stage is not stage
                else:
                    # a window local on every rank (the stage's
                    # rank-agreed decision) may apply its tables in
                    # parallel
                    (_, mine, windows, prefix, descs0, is_local, t0,
                     win_ctx, ph) = item
                    self._pl_apply(mine, windows, prefix, descs0, win_ctx,
                                   ph, parallel_ok=is_local)
                    for m in mine:
                        CHECK(fed.popleft() is m,
                              "pipeline completion order desync (engine "
                              "bug)")
                    self._t_window_s.observe(time.perf_counter() - t0)
            finally:
                # always lift the fence, even before a fatal raise: the
                # stage must not hang waiting for it
                stage.note_applied()
            if item[0] == "barrier" and transitioned:
                # an elastic rebase retired the stage inside that barrier
                # dispatch (an epoch transition): the pipeline's remaining
                # messages re-anchor to the NEW world — a one-member world
                # drains them through the local window path, otherwise a
                # fresh stage (SEQ 0, the new world rank) takes over
                if self._elastic_post_transition(fed):
                    return
                stage = self._ex_stage = _ExchangeStage(self)
                for m in fed:
                    stage.feed(m)

    def _pl_apply(self, verbs, windows, prefix, descs0, win_ctx, ph,
                  parallel_ok: bool) -> None:
        """Apply one exchanged window on the actor thread, recording the
        apply interval for the overlap telemetry and closing the window's
        phase record (``ph`` came from the exchange stage)."""
        t0 = time.perf_counter()
        self._apply_since = t0
        if ph is not None:
            ph["a_start_m"] = t0
        try:
            with ttrace.span("server.window.apply", cat="server",
                             parent=win_ctx, args={"verbs": prefix}):
                self._mh_apply_window(verbs, windows, prefix, descs0,
                                      seq=(ph or {}).get("seq", -1),
                                      parallel_ok=parallel_ok)
        finally:
            now = time.perf_counter()
            self._apply_since = 0.0
            st = self._ex_stage
            b0 = st.busy_since if st is not None else 0.0
            if b0:
                # an exchange is still in flight as this apply ends
                self._note_overlap(max(0.0, now - max(b0, t0)))
            if ph is not None:
                ph["apply"] = now - t0
                self._ph_emit(ph, prefix)
            tflight.record("window.applied", seq=self._mh_seq,
                           epoch=self.window_epoch,
                           mepoch=multihost.membership_epoch(),
                           stream=self.mh_stream, detail=f"{prefix}v")

    def _mh_collective_window(self, msg: Message) -> None:
        """A one-verb window on the actor thread (the BSP engine): pack,
        exchange, agree, apply (serially)."""
        t_start = time.perf_counter()
        with ttrace.span("server.window", cat="server",
                         parent=msg.trace_ctx, args={"verbs": 1}):
            ph = {} if self._phases_on() else None
            tp = time.perf_counter()
            local, used = self._mh_pack_window([msg])
            if ph is not None:
                ph["pack"] = time.perf_counter() - tp
            windows = self._mh_exchange_decode(local, ph)
            prefix, descs0 = self._mh_agree(windows)
            seq = self._mh_seq - 1
            if ph is not None:
                ph["seq"] = seq
                ph["mepoch"] = multihost.membership_epoch()
                ph["a_start_m"] = time.perf_counter()
            self._mh_apply_window(used[:prefix], windows, prefix, descs0,
                                  seq=seq)
            if ph is not None:
                ph["apply"] = time.perf_counter() - ph["a_start_m"]
                self._ph_emit(ph, prefix)
            tflight.record("window.applied", seq=self._mh_seq,
                           epoch=self.window_epoch,
                           mepoch=multihost.membership_epoch(),
                           stream=self.mh_stream, detail=f"{prefix}v")
        self._t_window_s.observe(time.perf_counter() - t_start)

    def _mh_check_barrier_head(self, head: Message) -> None:
        """Exchange a head-kind marker for a non-verb window head: a rank at
        a barrier while a peer exchanges verbs (or another barrier) fails
        the CHECK on every rank instead of stranding the verb rank in an
        unmatched collective."""
        blob = wire.encode_head_barrier(int(head.msg_type))
        blobs = self._bounded_collective(
            lambda: multihost.capped_exchange(
                blob, self._mh_caps, "HEAD_B", channel=self.mh_channel),
            "window head-marker exchange")
        # the seq of the NEXT exchange (barriers do not advance it), so
        # forensics aligns a barrier against a diverged peer's verbs
        tflight.record("barrier", seq=self._mh_seq, epoch=self.window_epoch,
                       mepoch=multihost.membership_epoch(),
                       stream=self.mh_stream,
                       detail=MsgType(head.msg_type).name)
        kinds = [wire.decode_head_kind(b) for b in blobs]
        CHECK(all(k == kinds[0] for k in kinds),
              f"multi-process window heads diverge: {kinds} — every "
              f"process must reach the same barrier/verb at the same "
              f"stream position (the SPMD collective contract)")

    def _mh_pack_window(self, verbs):
        """``(local, used)``: the packed ``(kind, table, payload)`` records
        under the byte budget and the messages they came from (>= 1). An
        Add of a lossy-opted table carries its values as an int8 envelope
        under ``-mv_compress`` (``compress.pack_window_values``), counted
        at the envelope's size; the packed payload stays on the message, so
        a verb cut by the budget or the peers' prefix is not packed or
        counted again."""
        local, used, packed = [], [], 0
        for i, m in enumerate(verbs):
            kind = "A" if m.msg_type is MsgType.Request_Add else "G"
            if kind == "A":
                m.payload = compress.pack_window_values(m.table_id,
                                                        m.payload)
            nbytes = wire.payload_nbytes(m.payload)
            if packed + nbytes > self.MH_WINDOW_BYTES and i > 0:
                break
            packed += nbytes
            local.append((kind, m.table_id, m.payload))
            used.append(m)
        self._t_budget.set(packed)
        tflight.record("window.admitted", seq=self._mh_seq,
                       epoch=self.window_epoch,
                       mepoch=multihost.membership_epoch(),
                       stream=self.mh_stream,
                       detail=f"{len(used)}v/{packed}B")
        return local, used

    def _mh_exchange_decode(self, local, ph: Optional[dict] = None) -> list:
        """Encode, exchange and decode one window; every rank's verb list
        in rank order (this rank's own records verbatim, but for
        compressed values, which it decodes as its peers do, so every
        replica applies the same reconstruction). A frame failing its seal
        re-runs the whole collective exchange. ``ph`` accumulates the
        window's encode / exchange (its wall, and the seconds blocked in
        the collective, ``multihost.last_exchange_stats``) / decode
        seconds and keeps the successful exchange's done stamps, the
        cross-rank clock anchor."""
        my_rank = multihost.world_rank()
        last_exc = None
        for attempt in range(1 + self.MH_WIRE_RETRIES):
            t0 = time.perf_counter()
            blob = wire.encode_window(local, seq=self._mh_seq)
            enc_s = time.perf_counter() - t0
            self._t_encode_s.observe(enc_s)
            if ph is not None:
                ph["encode"] = ph.get("encode", 0.0) + enc_s
            cz = chaos.get()
            if cz is not None:
                bad = cz.corrupt_blob(blob)
                if bad is not None:
                    blob = bad
            self._t_host_bytes.inc(len(blob))
            tx = time.perf_counter()
            with ttrace.span("server.window.exchange", cat="server",
                             args={"bytes": len(blob)}):
                # the exchange's timing is per thread: read it on the
                # thread that ran the collective (a bounded call runs it
                # on the runner)
                blobs, xs = self._bounded_collective(
                    lambda b=blob: (multihost.capped_exchange(
                        b, self._mh_caps, (local[0][0], local[0][1]),
                        channel=self.mh_channel),
                        multihost.last_exchange_stats()),
                    "window exchange")
            self.xw_busy_s += xs["coll_s"]
            if ph is not None:
                ph["x"] = ph.get("x", 0.0) + time.perf_counter() - tx
                ph["xw"] = ph.get("xw", 0.0) + xs["coll_s"]
                ph["x_done_m"] = xs["done_m"]
                ph["x_done_w"] = xs["done_w"]
            t0 = time.perf_counter()
            try:
                windows = []
                for i, b in enumerate(blobs):
                    if i == my_rank:
                        windows.append(compress.materialize_window(local))
                        continue
                    head_kind, head_mt = wire.decode_head_kind(b)
                    CHECK(head_kind == "window",
                          f"multi-process window heads diverge: rank {i} "
                          f"is at a non-verb barrier (msg_type {head_mt}) "
                          f"while rank {my_rank} exchanges verbs — every "
                          f"process must reach the same stream position "
                          f"(the SPMD collective contract)")
                    peer_seq, decoded = wire.decode_window_seq(b)
                    CHECK(peer_seq == (self._mh_seq & 0xFFFFFFFF),
                          f"window exchange desynchronized: rank {i} is at "
                          f"exchange {peer_seq}, rank {my_rank} at "
                          f"{self._mh_seq}; the stream cannot be trusted")
                    windows.append(decoded)
            except WireCorruption as exc:
                last_exc = exc
                tflight.record("wire.crc_retry", seq=self._mh_seq,
                               epoch=self.window_epoch,
                               mepoch=multihost.membership_epoch(),
                               stream=self.mh_stream,
                               detail=f"attempt{attempt + 1}")
                Log.Error("window exchange frame corrupt (attempt %d/%d): "
                          "%r — re-exchanging", attempt + 1,
                          1 + self.MH_WIRE_RETRIES, exc)
                continue
            dec_s = time.perf_counter() - t0
            self._t_decode_s.observe(dec_s)
            if ph is not None:
                ph["dec"] = ph.get("dec", 0.0) + dec_s
            self._mh_seq += 1
            self.mh_window_exchanges += 1
            self._t_exchanges.inc()
            return windows
        raise last_exc

    def _mh_agree(self, windows):
        """``(prefix, descs0)``: the common verb prefix of every rank's
        window and its ``(kind, table)`` records; a divergence CHECK-fails
        identically on every rank, after the ``window.exchanged`` flight
        event recorded this rank's verbs."""
        prefix = min(len(w) for w in windows)
        descs = [[(k, t) for k, t, _ in w[:prefix]] for w in windows]
        self._flight_exchanged(descs, multihost.world_rank())
        CHECK(all(d == descs[0] for d in descs),
              f"multi-process verb streams diverge inside a window: "
              f"{descs} — every process must issue the same table-verb "
              f"sequence (the SPMD collective contract)")
        return prefix, descs[0]

    def _mh_window_is_local(self, descs0) -> bool:
        """Whether the window's apply runs on this process alone on every
        rank (the tables' rank-agreed ``mh_apply_is_local``): the pipelined
        engine overlaps only such windows with the next exchange."""
        for tid in {t for _, t in descs0}:
            try:
                if not self.store_[tid].mh_apply_is_local():
                    return False
            except IndexError:
                return False       # a bad table id: its verb fails alone
        return True

    def _mh_apply_window(self, verbs, windows, prefix, descs0,
                         seq: int = -1, parallel_ok: bool = False) -> None:
        """Apply an exchanged window's agreed prefix: a table's Adds as one
        run at its first Add's position, its Gets grouped before and after
        that run (no Get observes less than strict order would show it).
        Replies go to this rank's own messages; failures reply per
        position, identically on every rank. With ``parallel_ok`` (the
        window's apply is local on every rank) and more than one table,
        the tables apply concurrently on the ``-mv_apply_workers`` pool;
        otherwise the ops run in position order on this thread. ``seq``
        keys the per-table apply attribution (``window.tables``)."""
        t0 = time.perf_counter()
        my_rank = multihost.world_rank()
        self.mh_window_verbs += prefix
        self._t_verbs.inc(prefix)
        self._apply_delay()
        for _, tid in descs0:
            self.table_verbs[tid] = self.table_verbs.get(tid, 0) + 1
        tbl: Dict[tuple, float] = {}
        parts_at = [[w[i][2] for w in windows] for i in range(prefix)]
        ops = self._mh_window_ops(descs0)
        n_tables = len({tid for _, tid, _ in ops})
        if (parallel_ok and n_tables > 1
                and _apply_workers_flag() > 1):
            merged = self._mh_apply_parallel(ops, parts_at, verbs, my_rank,
                                             tbl)
        else:
            merged = self._mh_run_ops(ops, parts_at, verbs, my_rank, tbl)
        self.mh_add_run_merged += merged
        for (tid, _), secs in tbl.items():
            self.table_apply_s[tid] = self.table_apply_s.get(tid, 0.0) + secs
        if tbl and self._phases_on():
            self._ph_tables(tbl, seq, multihost.membership_epoch())
        self.apply_busy_s += time.perf_counter() - t0
        self.window_epoch += 1

    @staticmethod
    def _mh_window_ops(descs0) -> list:
        """The window's op list in first-position order, shared by the
        serial and the parallel apply: ``("A", tid, positions)`` once a
        table (its merged Add run), ``("G", tid, positions)`` once a
        (table, before/after its Add run) Get group. Within a table this is
        its serial order: the Gets before the run, the run, the Gets
        after."""
        add_pos: Dict[int, list] = {}
        for i, (kind, tid) in enumerate(descs0):
            if kind == "A":
                add_pos.setdefault(tid, []).append(i)
        groups: Dict[tuple, list] = {}
        ops = []
        for i, (kind, tid) in enumerate(descs0):
            if kind == "A":
                if add_pos[tid][0] == i:
                    ops.append(("A", tid, add_pos[tid]))
                continue
            seg = 0 if tid not in add_pos or i < add_pos[tid][0] else 1
            if (tid, seg) not in groups:
                groups[(tid, seg)] = []
                ops.append(("G", tid, groups[(tid, seg)]))
            groups[(tid, seg)].append(i)
        return ops

    def _mh_run_ops(self, ops, parts_at, verbs, my_rank: int,
                    tbl: dict) -> int:
        """Run window ops in the given order: the serial apply's body and
        each parallel job's. Returns the Add runs applied merged and adds
        each op's seconds to ``tbl[(table, "A"|"G")]`` (a pool job gets a
        private dict: pool jobs write no engine state, the caller sums
        after the join)."""
        merged = 0
        for kind, tid, positions in ops:
            tt = time.perf_counter()
            if kind == "A":
                with ttrace.span("server.window.add_run", cat="server",
                                 args={"table_id": tid,
                                       "positions": len(positions)}):
                    merged += self._mh_add_run(tid, positions, parts_at,
                                               verbs, my_rank)
            else:
                with ttrace.span("server.window.get_group", cat="server",
                                 args={"table_id": tid}):
                    self._mh_get_group(tid, positions, parts_at, verbs,
                                       my_rank)
            k = (tid, kind)
            tbl[k] = tbl.get(k, 0.0) + time.perf_counter() - tt
        return merged

    def _mh_job(self, ops, parts_at, verbs, my_rank: int) -> tuple:
        """One table's ops as a parallel job, issuing on the table's
        device (a pool thread's current CUDA device is otherwise the
        process default); returns ``(merged runs, its tbl)``."""
        tbl: dict = {}
        try:
            dev = getattr(self.store_[ops[0][1]], "device", None)
        except IndexError:
            dev = None      # a bad table id: its verbs fail in the ops
        if dev is None or dev.type != "cuda":
            return self._mh_run_ops(ops, parts_at, verbs, my_rank, tbl), tbl
        import torch
        with torch.cuda.device(dev):
            return self._mh_run_ops(ops, parts_at, verbs, my_rank, tbl), tbl

    def _ensure_apply_pool(self) -> _ApplyPool:
        """The pool at the live ``-mv_apply_workers`` size (2..16), rebuilt
        between windows when the flag changed (every earlier job has
        joined, so the retired pool's queue is empty)."""
        want = max(2, min(_apply_workers_flag(), 16))
        pool = self._apply_pool
        if pool is None or pool.workers != want:
            if pool is not None:
                pool.shutdown()
            pool = self._apply_pool = _ApplyPool(want, self.name)
        return pool

    def _mh_apply_parallel(self, ops, parts_at, verbs, my_rank: int,
                           tbl: dict) -> int:
        """The parallel apply: the op list regrouped into one job a table
        (its ops in their serial order), the jobs run concurrently, the
        last inline on this thread. Reached only for windows whose apply
        is local on every rank, where different tables share no state and
        issue no collective, so the cross-table order was never
        observable. A job's escape is raised again here; the wait is
        bounded by ``-mv_deadline_s``. Returns the merged Add runs."""
        jobs: Dict[int, list] = {}
        for op in ops:
            jobs.setdefault(op[1], []).append(op)
        job_lists = list(jobs.values())
        pool = self._ensure_apply_pool()
        boxes = [pool.submit(lambda j=j: self._mh_job(j, parts_at, verbs,
                                                      my_rank))
                 for j in job_lists[:-1]]
        self._t_pool_jobs.inc(len(boxes))
        self._t_pool_inline.inc()
        merged, own = self._mh_job(job_lists[-1], parts_at, verbs, my_rank)
        results = [own]
        limit = fdeadline.timeout_or_none()
        t0 = time.perf_counter()
        for box in boxes:
            left = (None if limit is None
                    else max(0.0, limit - (time.perf_counter() - t0)))
            if not box["done"].wait(left):
                fdeadline.raise_deadline("the parallel window apply (a "
                                         "table's apply job never finished)")
            if "error" in box:
                raise box["error"]
            merged += box["result"][0]
            results.append(box["result"][1])
        for local in results:
            for k, v in local.items():
                tbl[k] = tbl.get(k, 0.0) + v
        return merged

    def _mh_add_run(self, tid: int, positions, parts_at, verbs,
                    my_rank: int) -> int:
        """A table's window-worth of collective Adds: merged across
        positions and ranks when the table accepts, per position
        otherwise. Returns 1 when the run applied merged, else 0."""
        try:
            table = self.store_[tid]
        except IndexError as exc:
            for p in positions:
                verbs[p].reply(exc)
            return 0
        if len(positions) > 1:
            try:
                merged = table.ProcessAddRunParts(
                    [parts_at[p] for p in positions], my_rank)
            except Exception as exc:
                Log.Error("table %d merged parts Add failed: %r", tid, exc)
                for p in positions:
                    verbs[p].reply(exc)
                return 0
            if merged:
                self._t_dispatch.inc()
                self._t_merged.inc()
                for p in positions:
                    verbs[p].reply(None)
                return 1
        for p in positions:
            with monitor_region("SERVER_PROCESS_ADD"):
                try:
                    table.ProcessAddParts(parts_at[p], my_rank)
                    self._t_dispatch.inc()
                except Exception as exc:
                    Log.Error("table %d parts Add failed: %r", tid, exc)
                    verbs[p].reply(exc)
                    continue
            verbs[p].reply(None)
        return 0

    def _mh_get_group(self, tid: int, positions, parts_at, verbs,
                      my_rank: int) -> None:
        """A (table, segment)'s collective Gets: one window serve when the
        table offers it, per position otherwise."""
        try:
            table = self.store_[tid]
        except IndexError as exc:
            for p in positions:
                verbs[p].reply(exc)
            return
        results = None
        if len(positions) > 1:
            try:
                results = table.ProcessGetWindowParts(
                    [parts_at[p] for p in positions], my_rank)
            except Exception as exc:
                Log.Error("table %d window parts Get failed: %r", tid, exc)
                for p in positions:
                    verbs[p].reply(exc)
                return
        if results is not None:
            CHECK(len(results) == len(positions),
                  "ProcessGetWindowParts result count mismatch")
            for p, res in zip(positions, results):
                verbs[p].reply(res)
            return
        for p in positions:
            with monitor_region("SERVER_PROCESS_GET"):
                try:
                    result = table.ProcessGetParts(parts_at[p], my_rank)
                except Exception as exc:
                    Log.Error("table %d parts Get failed: %r", tid, exc)
                    verbs[p].reply(exc)
                    continue
            verbs[p].reply(result)

    def _local_window(self, batch) -> None:
        """Apply one drained window (module docstring)."""
        segments: list = [[]]
        for m in batch:
            if m.msg_type in (MsgType.Request_Add, MsgType.Request_Get):
                segments[-1].append(m)
                if m.table_id >= 0:
                    self.table_verbs[m.table_id] = (
                        self.table_verbs.get(m.table_id, 0) + 1)
            else:
                segments.append(m)       # barrier marker
                segments.append([])
        pending = []   # (finalize, [msgs]) in dispatch order
        seen: Dict[tuple, int] = {}
        # per-(table, verb) apply seconds, on the sampled windows only
        tbl = {} if self._ph_stamp_this else None
        for seg in segments:
            if not isinstance(seg, list):
                self.window_barrier_splits += 1
                self._t_splits.inc()
                tflight.record("barrier", epoch=self.window_epoch,
                               stream=self.mh_stream,
                               detail=MsgType(seg.msg_type).name)
                self._dispatch(seg)
                seen.clear()
                continue
            add_runs: Dict[int, list] = {}
            n_gets = 0
            for m in seg:
                if m.msg_type is MsgType.Request_Add:
                    add_runs.setdefault(m.table_id, []).append(m)
                else:
                    n_gets += 1
            applied = set()
            for m in seg:
                if m.msg_type is MsgType.Request_Add:
                    if m.table_id not in applied:
                        applied.add(m.table_id)
                        tt = time.perf_counter() if tbl is not None else 0.0
                        self._process_add_run(add_runs[m.table_id])
                        if tbl is not None:
                            k = (m.table_id, "A")
                            tbl[k] = (tbl.get(k, 0.0)
                                      + time.perf_counter() - tt)
                        # a Get queued after this Add must not join a
                        # gather dispatched before it
                        seen = {k: v for k, v in seen.items()
                                if k[0] != m.table_id}
                    continue
                key = self._get_dedup_key(m) if n_gets > 1 else None
                if key is not None and key in seen:
                    pending[seen[key]][1].append(m)
                    continue
                tt = time.perf_counter() if tbl is not None else 0.0
                with monitor_region("SERVER_PROCESS_GET"):
                    try:
                        table = self.store_[m.table_id]
                        finalize = table.ProcessGetAsync(**m.payload)
                        if finalize is None:
                            self.ProcessGet(m)
                        else:
                            if key is not None:
                                seen[key] = len(pending)
                            pending.append((finalize, [m]))
                    except Exception as exc:
                        # a failure (bad table id included) replies to
                        # THIS message only — escaping would abandon every
                        # pending finalize and hang its waiters
                        Log.Error("table ProcessGet dispatch failed: %r",
                                  exc)
                        m.reply(exc)
                if tbl is not None:
                    k = (m.table_id, "G")
                    tbl[k] = tbl.get(k, 0.0) + time.perf_counter() - tt
        for finalize, msgs in pending:
            tt = time.perf_counter() if tbl is not None else 0.0
            err = None
            try:
                result = finalize()
            except Exception as exc:
                Log.Error("table %d Get finalize failed: %r",
                          msgs[0].table_id, exc)
                err = exc
            if tbl is not None:
                k = (msgs[0].table_id, "G")
                tbl[k] = tbl.get(k, 0.0) + time.perf_counter() - tt
            if err is not None:
                for m in msgs:
                    m.reply(err)
                continue
            msgs[0].reply(result)
            for m in msgs[1:]:
                m.reply(copy_result(result))
        if tbl:
            self._ph_tables(tbl, -1, 0)

    def _process_add_run(self, msgs) -> None:
        """Apply a table's window-worth of Adds: merged when the table
        accepts (ProcessAddRun validates BEFORE mutating and returns False
        to decline), per message otherwise."""
        if len(msgs) > 1:
            try:
                table = self.store_[msgs[0].table_id]
                merged = table.ProcessAddRun([m.payload for m in msgs])
            except Exception as exc:
                Log.Error("table %d merged Add failed: %r",
                          msgs[0].table_id, exc)
                for m in msgs:
                    m.reply(exc)
                return
            if merged:
                self.add_runs_merged += 1
                self._t_dispatch.inc()
                self._t_merged.inc()
                for m in msgs:
                    m.reply(None)
                return
        for m in msgs:
            self.ProcessAdd(m)

    @staticmethod
    def _get_dedup_key(m: Message):
        """Hashable identity of a Get's request, or None when a payload
        part can't be keyed (those never dedup)."""
        parts = [m.table_id]
        for k in sorted(m.payload):
            v = m.payload[k]
            if isinstance(v, np.ndarray):
                parts.append((k, v.dtype.str, v.shape, v.tobytes()))
            elif v is None or isinstance(v, (bool, int, float, str, bytes)):
                parts.append((k, v))
            elif isinstance(v, (GetOption, AddOption)):
                parts.append((k, repr(v)))
            else:
                return None
        return tuple(parts)

    def ProcessGet(self, msg: Message) -> None:
        with monitor_region("SERVER_PROCESS_GET"):
            try:
                result = self.store_[msg.table_id].ProcessGet(**msg.payload)
            except Exception as exc:
                # replies to THIS message: a cached message drained inside
                # another worker's request (SyncServer) must not hang
                Log.Error("table %d ProcessGet failed: %r", msg.table_id,
                          exc)
                msg.reply(exc)
                return
            msg.reply(result)

    def ProcessAdd(self, msg: Message) -> None:
        with monitor_region("SERVER_PROCESS_ADD"):
            try:
                self.store_[msg.table_id].ProcessAdd(**msg.payload)
            except Exception as exc:
                Log.Error("table %d ProcessAdd failed: %r", msg.table_id,
                          exc)
                msg.reply(exc)
                return
            self._t_dispatch.inc()
            msg.reply(None)

    def ProcessFinishTrain(self, msg: Message) -> None:
        msg.reply(None)

    def _store_load_entry(self, msg: Message) -> None:
        """Engine-cut payload runner: run the message's fn at this stream
        position, reply its result."""
        try:
            msg.reply(msg.payload["fn"]())
        except Exception as exc:
            Log.Error("engine-cut payload fn failed: %r", exc)
            msg.reply(exc)

    @staticmethod
    def GetServer(num_workers: int) -> "Server":
        """Engine factory (reference server.cpp:224-232, extended with the
        sharded engine): ``-sync`` builds the BSP SyncServer; otherwise a
        resolved shard cap (``engine_shard_cap``) above 1 builds the
        ShardedServer, and 1 the plain Server."""
        transport = str(GetFlag("window_transport")).lower()
        CHECK(transport in ("auto", "host", "device"),
              f"-window_transport must be auto/host/device, got "
              f"{transport!r}")
        CHECK(transport != "device",
              "-window_transport=device is not ported yet: gloo moves no "
              "CUDA tensor, and the port's windows ride the host exchange "
              "(-window_transport=auto or host)")
        if GetFlag("sync"):
            Log.Debug("Create a sync server")
            return SyncServer(num_workers)
        cap = engine_shard_cap()
        if cap > 1:
            Log.Debug("Create a sharded async server (%d shard slots)", cap)
            return ShardedServer(cap)
        Log.Debug("Create an async server")
        return Server()


def requested_engine_channels() -> int:
    """The independent wire channels the engine wants for this world,
    asked before the wire is selected (``Zoo.Start``; the shm wire creates
    its channels' segments up front): the explicit ``-mv_engine_shards``
    value, or 1 when it is unset or 1, under ``-sync`` or under
    ``-mv_elastic``."""
    flag = int(GetFlag("mv_engine_shards"))
    if flag <= 1 or GetFlag("sync") or GetFlag("mv_elastic"):
        return 1
    return flag


def engine_shard_cap() -> int:
    """Resolved engine shard-slot count for a new engine (see the
    ``-mv_engine_shards`` help text): 1 under BSP (the vector clocks count
    verbs across all tables); 1 under ``-mv_elastic`` (the epoch relay is
    one ordered channel, and a transition re-bases one stream); in a
    multi-process world the explicit flag
    when the wire offers that many channels (a shard's stream rides its
    own channel), else 1, loudly (gloo is one ordered collective stream),
    and 1 when unset; in one process the flag when set, else auto,
    ``min(8, cores // 4)``. Lazy shard spawn bounds the live shards by the
    table count."""
    if GetFlag("sync"):
        return 1
    flag = int(GetFlag("mv_engine_shards"))
    if GetFlag("mv_elastic"):
        if flag > 1:
            Log.Info("engine: -mv_engine_shards=%d clamped to 1 under "
                     "-mv_elastic (the epoch relay is a single ordered "
                     "channel)", flag)
        return 1
    if multihost.world_size() > 1:
        if flag <= 1:
            return 1        # auto: multi-process worlds opt in explicitly
        channels = multihost.wire_channels()
        if channels < flag:
            Log.Error("engine: -mv_engine_shards=%d needs %d independent "
                      "exchange channels but the %s wire offers %d (gloo is "
                      "one ordered collective stream: same-host worlds "
                      "take -mv_wire=auto/shm, cross-host worlds "
                      "-mv_wire=auto/tcp) — clamped to 1", flag, flag,
                      multihost.wire_name(), channels)
            return 1
        return flag
    if flag >= 1:
        return flag
    return max(1, min(8, (os.cpu_count() or 4) // 4))


#: non-verb message types the sharded router turns into cross-stream
#: cuts; any other non-verb type dispatches on shard 0 alone
_CUT_TYPES = (MsgType.Request_StoreLoad, MsgType.Request_Publish,
              MsgType.Request_Barrier, MsgType.Server_Finish_Train)


class _CutFence:
    """One cross-stream cut rendezvous.

    Every sub-shard's stream carries a fence message at the cut's
    position; its dispatch parks the shard here (``hold``). The head
    shard (the router, shard 0) waits for every sub to arrive
    (``arrive_head``), runs the cut payload with every stream fenced, then
    ``release``s the subs. The waits poll for a dead shard, so a dead
    shard raises ``ActorDied`` on every waiter instead of hanging."""

    _POLL_S = 0.05

    def __init__(self, head: "Server", n_subs: int):
        self._head = head
        self._need = n_subs
        self._cv = threading.Condition()
        self._arrived = 0
        self._released = False
        self._abort: Optional[BaseException] = None

    def hold(self) -> None:
        """Sub-shard side: arrive, then block until the head releases the
        cut, aborts it, dies, or ``-mv_deadline_s`` expires."""
        deadline = fdeadline.timeout_or_none()
        t0 = time.perf_counter()
        with self._cv:
            self._arrived += 1
            self._cv.notify_all()
            while not self._released and self._abort is None:
                if self._head._poison is not None:
                    raise ActorDied(self._head.name, self._head._poison)
                self._cv.wait(self._POLL_S)
                if (deadline is not None
                        and time.perf_counter() - t0 > deadline):
                    fdeadline.raise_deadline(
                        "cross-stream cut (the head shard never ran the "
                        "cut payload)", fatal=True)
            if self._abort is not None:
                raise self._abort

    def arrive_head(self, subs) -> None:
        """Head side: block until every sub-shard fenced. A dead sub, or an
        expired ``-mv_deadline_s``, aborts the cut on every waiter."""
        deadline = fdeadline.timeout_or_none()
        t0 = time.perf_counter()
        with self._cv:
            while self._arrived < self._need:
                for sub in subs:
                    if sub._poison is not None:
                        exc = ActorDied(sub.name, sub._poison)
                        self._abort = exc
                        self._cv.notify_all()
                        raise exc
                self._cv.wait(self._POLL_S)
                if (deadline is not None
                        and time.perf_counter() - t0 > deadline):
                    try:
                        fdeadline.raise_deadline(
                            "cross-stream cut (a shard never fenced)",
                            fatal=True)
                    except BaseException as exc:
                        self._abort = exc
                        self._cv.notify_all()
                        raise

    def abort(self, exc: BaseException) -> None:
        with self._cv:
            self._abort = exc
            self._cv.notify_all()

    def release(self) -> None:
        with self._cv:
            self._released = True
            self._cv.notify_all()


class _EngineShard(Server):
    """Sub-shard ``slot`` of a :class:`ShardedServer`: a full engine actor
    (own thread, mailbox, window stream, exchange stage and SEQ counter)
    whose ``store_`` is the router's table list and whose exchanges ride
    wire channel ``slot``. Non-verb messages reach it only as cut
    fences."""

    def __init__(self, parent: "ShardedServer", slot: int):
        super().__init__(name=f"{actor_names.kServer}_shard{slot}")
        self.store_ = parent.store_     # one table list, router-owned
        self.slot = slot
        self.mh_channel = slot
        self.mh_stream = slot
        for mt in _CUT_TYPES:
            self.RegisterHandler(mt, self._fence_entry)

    def _fence_entry(self, msg: Message) -> None:
        """Cut-fence dispatch: park this shard's stream until the head
        releases the cut (an abort raises, and ``_dispatch`` replies it
        to the fence message)."""
        msg.payload["_mv_fence"].hold()
        msg.reply(None)


class ShardedServer(Server):
    """The sharded engine: this actor IS shard 0 and the router. Verbs
    route to a shard by ``table_id % shard_cap`` unless the routing map
    overrides it (``install_routing``, run at a cross-stream cut); each
    shard owns an independent window stream, so different tables' windows
    apply concurrently on the host. Sub-shards spawn lazily at table
    registration, so the live shard count is min(tables, slots).

    Barrier messages (``_CUT_TYPES``) become cross-stream cuts: every
    shard fences at the cut's position in its own stream, the payload runs
    once with every stream fenced, then every shard releases. Every verb
    admitted before the cut is applied before the payload runs and none
    after, on every shard."""

    def __init__(self, shard_cap: int):
        super().__init__()
        CHECK(shard_cap >= 2,
              f"ShardedServer needs >= 2 shard slots, got {shard_cap}")
        self._shard_cap = shard_cap
        self._subs: Dict[int, _EngineShard] = {}
        #: table -> slot overrides on top of ``table_id % shard_cap``,
        #: installed only inside a cut payload
        self._routing: Dict[int, int] = {}
        #: routing-map installs applied
        self.routing_installs = 0
        #: the routing freeze: a verb's route decision and its mailbox
        #: push are atomic against a cut's fence enqueue, or a verb routed
        #: under the old map could land behind the fence in the old stream
        #: while the cut moves its table — one table's verbs in two
        #: concurrently draining streams. Cuts close the gate (under
        #: _route_lock) before enqueueing their fences and reopen it when
        #: the last in-flight cut is done; verb pushes wait on the gate
        #: and route under the same lock.
        self._route_lock = threading.Lock()
        self._route_open = threading.Event()
        self._route_open.set()
        self._cuts_inflight = 0
        #: cross-stream cuts processed
        self.cut_count = 0
        for mt in _CUT_TYPES:
            self.RegisterHandler(mt, self._wrap_cut(self._handlers[mt]))

    def _slot_for(self, table_id: int) -> int:
        """Effective shard slot of ``table_id``: the routing override when
        one is installed, else the modulo default."""
        if table_id < 0:
            return 0
        slot = self._routing.get(table_id)
        return (table_id % self._shard_cap) if slot is None else slot

    def install_routing(self, mapping: Dict[int, int]) -> list:
        """Install table -> slot overrides. MUST run as a cross-stream cut
        payload (``Zoo.CallOnEngine``): with every stream fenced, every
        verb admitted before the cut applied under the old map and none
        after, so a table's stream moves at one consistent position.
        Targets must be live slots and known tables. Returns the
        ``[(table_id, prev_slot, new_slot), ...]`` that changed."""
        live = {0} | set(self._subs)
        applied = []
        for tid, slot in sorted(mapping.items()):
            tid, slot = int(tid), int(slot)
            CHECK(0 <= tid < len(self.store_),
                  f"install_routing: unknown table {tid}")
            CHECK(slot in live, f"install_routing: slot {slot} not live "
                                f"(live slots {sorted(live)})")
            prev = self._slot_for(tid)
            if prev == slot:
                continue
            self._routing[tid] = slot
            applied.append((tid, prev, slot))
        if applied:
            self.routing_installs += 1
        return applied

    def routing_report(self) -> dict:
        """Effective routing of every registered table and the live
        slots."""
        return {"shard_cap": self._shard_cap,
                "live_slots": sorted({0} | set(self._subs)),
                "installs": self.routing_installs,
                "overrides": dict(self._routing),
                "routing": {tid: self._slot_for(tid)
                            for tid in range(len(self.store_))}}

    def _wrap_cut(self, base):
        def entry(msg: Message) -> None:
            fence = getattr(msg, "_mv_cut", None)
            if fence is None:       # no subs were live at routing time
                return base(msg)
            try:
                fence.arrive_head(list(self._subs.values()))
                base(msg)
            finally:
                # release and reopen even when the rendezvous aborted: a
                # stuck freeze would park every verb push forever
                fence.release()
                self._cut_done()
        return entry

    def _cut_done(self) -> None:
        """One in-flight cut finished: reopen the routing gate when it was
        the last."""
        with self._route_lock:
            self._reopen_locked()

    def _reopen_locked(self) -> None:
        # mv-lint: ok(cross-domain-state): both callers (_cut_done and the cut's error path in Receive) hold _route_lock around this call — the checker reads the helper's writes as unlocked because the lock scope is the caller's
        self._cuts_inflight -= 1
        if self._cuts_inflight <= 0:
            self._cuts_inflight = 0
            self._route_open.set()

    def _wait_route_gate(self) -> None:
        """Block until no cut holds the routing gate closed; a dead router
        lets the caller through, so its push raises ActorDied instead of
        waiting forever."""
        while not self._route_open.wait(0.5) and self._poison is None:
            pass

    def _route_push(self, msg: Message) -> None:
        """Route one verb and push it to its stream, atomically against a
        cut's fence enqueue."""
        while True:
            self._wait_route_gate()
            with self._route_lock:
                if self._route_open.is_set() or self._poison is not None:
                    sub = self._subs.get(self._slot_for(msg.table_id))
                    Actor.Receive(sub or self, msg)
                    return

    def RegisterTable(self, server_table) -> int:
        table_id = super().RegisterTable(server_table)
        slot = table_id % self._shard_cap
        if slot and slot not in self._subs:
            sub = _EngineShard(self, slot)
            self._subs[slot] = sub
            sub.Start()
            Log.Debug("engine: shard %d spawned (table %d; %d/%d slots "
                      "live)", slot, table_id, 1 + len(self._subs),
                      self._shard_cap)
        return table_id

    def receive_multi(self, members) -> None:
        """Split one batch per shard stream: routing is by table, so the
        split keeps every TABLE's submission order, and each shard takes
        its part as one envelope."""
        if not self._subs:
            return super().receive_multi(members)
        self._count_adds(members)
        while True:
            self._wait_route_gate()
            with self._route_lock:
                if not (self._route_open.is_set()
                        or self._poison is not None):
                    continue
                groups: Dict[int, list] = {}
                for m in members:
                    groups.setdefault(self._slot_for(m.table_id),
                                      []).append(m)
                for slot, ms in groups.items():
                    (self._subs.get(slot) or self)._push_multi(ms)
                return

    def Receive(self, msg: Message) -> None:
        if msg.msg_type is MsgType.Request_MultiVerb:
            # a pre-wrapped envelope: split it per shard, or shard 0
            # would apply other shards' tables in its own stream
            self.receive_multi(msg.payload["members"])
            return
        if msg.msg_type in (MsgType.Request_Get, MsgType.Request_Add):
            self._count_adds((msg,))
            self._route_push(msg)
            return
        subs = list(self._subs.values())
        if not subs or msg.msg_type not in _CUT_TYPES:
            Actor.Receive(self, msg)
            return
        # CROSS-STREAM CUT: fence every sub-shard's stream, then send the
        # head message to shard 0, with the routing gate closed — a
        # concurrent verb pushed either before the fences (applied before
        # the payload runs) or after the cut releases (under the map the
        # payload installed)
        self.cut_count += 1  # mv-lint: ok(cross-domain-state): diagnostics-only tally; worker cuts and the policy thread's installs may race the GIL int add and at worst under-count a probe nothing gates on
        fence = _CutFence(self, len(subs))
        with self._route_lock:
            self._cuts_inflight += 1
            self._route_open.clear()
            try:
                for sub in subs:
                    # mv-lint: ok(lock-order): sub is an _EngineShard whose Receive IS Server.Receive (a count and a mailbox push, no _route_lock) — the by-name edge to ShardedServer.Receive cannot execute (a sub is never the router)
                    sub.Receive(Message(msg_type=msg.msg_type,
                                        payload={"_mv_fence": fence}))
                msg._mv_cut = fence
                Actor.Receive(self, msg)
            except BaseException as exc:
                # a dead shard refused its fence: free the fences already
                # queued and reopen the gate, then the caller sees it
                fence.abort(exc)
                self._reopen_locked()
                raise

    def epoch_for_table(self, table_id: int) -> int:
        """The window epoch of the shard applying ``table_id``: a busy
        neighbour shard does not age another table's cache entries."""
        sub = self._subs.get(self._slot_for(table_id))
        return (sub or self).window_epoch

    def cut_epoch(self) -> int:
        """Windows applied over the router's and every sub-shard's stream
        (read inside a cut, with every stream fenced)."""
        return self.window_epoch + sum(s.window_epoch
                                       for s in self._subs.values())

    def shard_states(self) -> List[dict]:
        out = super().shard_states()
        for slot in sorted(self._subs):
            out.extend(self._subs[slot].shard_states())
        return out

    def Stop(self) -> None:
        # shard 0 (the router) first: its drain may still dispatch a
        # queued cut, which needs the subs alive to fence
        super().Stop()
        for sub in self._subs.values():
            sub.Stop()


class SyncServer(Server):
    """BSP server (reference server.cpp:60-222). See module docstring."""

    #: the vector clocks count Get/Add MESSAGES per worker: a batched
    #: envelope would hide N ticks in one message, a combined Add N Add
    #: ticks, and a cached Get a Get tick
    MULTI_VERB_OK = False
    WRITE_COMBINE_OK = False
    GET_CACHE_OK = False
    MH_BARRIER_HEADS = False

    def __init__(self, num_workers: int):
        super().__init__()
        # a direct receive_multi could still land an envelope: flatten it
        # one member at a time through the clocked entries
        self.RegisterHandler(MsgType.Request_MultiVerb, self._multi_entry_bsp)
        self._num_workers = num_workers
        self._get_clocks = VectorClock(num_workers)
        self._add_clocks = VectorClock(num_workers)
        self._num_waited_add = [0] * num_workers
        self._add_cache: Deque[Message] = collections.deque()
        self._get_cache: Deque[Message] = collections.deque()
        #: the worst clock skew of the two vector clocks; a MAX-merge
        #: gauge (job-wide it is the worst rank's skew, not a sum)
        self._t_staleness = tmetrics.max_gauge("server.bsp.staleness")

    def _note_staleness(self) -> None:
        self._t_staleness.set(max(self._get_clocks.staleness(),
                                  self._add_clocks.staleness()))

    def _verb(self, msg: Message) -> None:
        """Apply one verb strictly. Across processes it is a one-verb
        collective window: every rank's engine makes the same defer and
        drain decisions from the same verb streams, so the ranks' i-th
        applied verbs pair up. A failed exchange leaves the stream unsound:
        every cached waiter gets the error and the engine poisons."""
        if multihost.world_size() <= 1:
            if msg.msg_type is MsgType.Request_Add:
                super().ProcessAdd(msg)
            else:
                super().ProcessGet(msg)
            return
        try:
            self._mh_collective_window(msg)
        except Exception as exc:
            Log.Error("engine: multi-process BSP stream aborted: %r", exc)
            tflight.record("engine.fatal", seq=self._mh_seq,
                           epoch=self.window_epoch,
                           mepoch=multihost.membership_epoch(),
                           stream=self.mh_stream,
                           detail=f"{type(exc).__name__}: {exc}"[:200])
            tflight.dump_failure(
                f"engine BSP stream abort ({type(exc).__name__})")
            for m in (msg, *self._add_cache, *self._get_cache):
                m.reply(exc)
            exc.mv_fatal = True
            raise

    def ProcessAdd(self, msg: Message) -> None:
        worker = msg.src
        # 1. Before add: cache a faster worker (server.cpp:141-147)
        if (self._get_clocks.local_clock(worker)
                > self._get_clocks.global_clock()):
            self._add_cache.append(msg)
            self._num_waited_add[worker] += 1
            self._note_staleness()
            return
        # 2. Process add
        self._verb(msg)
        # 3. After add: drain cached gets when the add round completes
        if self._add_clocks.Update(worker):
            CHECK(not self._add_cache, "add cache must be empty at round end")
            while self._get_cache:
                get_msg = self._get_cache.popleft()
                self._verb(get_msg)
                CHECK(not self._get_clocks.Update(get_msg.src),
                      "drained Get must not complete a round")
        self._note_staleness()

    def _multi_entry_bsp(self, msg: Message) -> None:
        """A batched envelope on the BSP engine: its members, strictly one
        at a time, through the clocked entries at the envelope's mailbox
        position."""
        for m in msg.payload["members"]:
            if m.msg_type is MsgType.Request_Add:
                self._add_entry(m)
            else:
                self._get_entry(m)

    def _get_entry(self, msg: Message) -> None:
        # no window under BSP: the defer/drain decisions depend on strict
        # one-at-a-time processing. The failsafe gate still runs BEFORE
        # the clocks see the verb: a duplicate must not tick a clock twice
        if not self._admit(msg):
            return
        self.ProcessGet(msg)

    def _add_entry(self, msg: Message) -> None:
        # no add coalescing under BSP either
        if not self._admit(msg):
            return
        self.ProcessAdd(msg)

    def ProcessGet(self, msg: Message) -> None:
        worker = msg.src
        # 1. Before get: wait for other workers' adds (server.cpp:164-171)
        if (self._add_clocks.local_clock(worker)
                > self._add_clocks.global_clock()
                or self._num_waited_add[worker] > 0):
            self._get_cache.append(msg)
            self._note_staleness()
            return
        # 2. Process get
        self._verb(msg)
        # 3. After get: drain cached adds when the get round completes
        if self._get_clocks.Update(worker):
            while self._add_cache:
                add_msg = self._add_cache.popleft()
                self._verb(add_msg)
                CHECK(not self._add_clocks.Update(add_msg.src),
                      "drained Add must not complete a round")
                self._num_waited_add[add_msg.src] -= 1
        self._note_staleness()

    def ProcessFinishTrain(self, msg: Message) -> None:
        """server.cpp:188-211: force the worker's clocks to infinity,
        drain the caches."""
        worker = msg.src
        if self._add_clocks.FinishTrain(worker):
            CHECK(not self._add_cache, "add cache must be empty")
            while self._get_cache:
                get_msg = self._get_cache.popleft()
                self._verb(get_msg)
                CHECK(not self._get_clocks.Update(get_msg.src), "")
        if self._get_clocks.FinishTrain(worker):
            CHECK(not self._get_cache, "get cache must be empty")
            while self._add_cache:
                add_msg = self._add_cache.popleft()
                self._verb(add_msg)
                CHECK(not self._add_clocks.Update(add_msg.src), "")
                self._num_waited_add[add_msg.src] -= 1
        msg.reply(None)
