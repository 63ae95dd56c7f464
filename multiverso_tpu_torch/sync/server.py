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
  ``Request_StoreLoad`` cut) is a window BARRIER: runs split at it and it
  runs in stream order, so an Add acknowledged before it never applies
  after it.

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
before and after that run. A non-verb window head (a drain ping, a
checkpoint cut, FinishTrain) is preceded by a head-marker exchange, so a
rank at a barrier while a peer exchanges verbs fails loudly instead of
deadlocking. An exchange thread (``_ExchangeStage``) owns the
collective stream and the actor thread applies: by default
(``-mv_pipeline``) window N applies while window N+1 is exchanged, since
every port table's apply is local (``mh_apply_is_local``); barrier heads
fence the pipeline. ``-mv_pipeline=0`` bounds the stage at one window, so
each exchange waits until the previous window applied (no overlap). Any
escape from the window stream (a divergence CHECK, a peer
lost past the process group's timeout, a corrupted frame past its
retries) replies the error to every waiter the stream holds and poisons
the engine. The BSP ``SyncServer`` exchanges each verb it applies as a
one-verb window: every rank's engine makes the same defer and drain
decisions, so the i-th applied verbs pair up. Multi-process worlds run
one engine stream (gloo is one ordered collective stream).

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

Not ported (ROADMAP.md): the apply pool, the device window transport
(``-window_transport`` resolves to ``host``; ``device`` fails a CHECK),
compressed windows, the shared-memory and TCP wires' per-shard channels,
the failsafe admission gate (dedup window, chaos) and deadlines,
worker-side write combining and the Get cache, and the telemetry hooks of
the JAX engine.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Deque, Dict, List, Optional

import numpy as np

from multiverso_tpu_torch.actor import Actor, ActorDied, actor_names
from multiverso_tpu_torch.message import Message, MsgType, copy_result
from multiverso_tpu_torch.parallel import multihost, wire
from multiverso_tpu_torch.parallel.seal import WireCorruption
from multiverso_tpu_torch.updaters.base import AddOption, GetOption
from multiverso_tpu_torch.utils.configure import (GetFlag, MV_DEFINE_bool,
                                                  MV_DEFINE_int,
                                                  MV_DEFINE_string)
from multiverso_tpu_torch.utils.log import CHECK, Log
from multiverso_tpu_torch.utils.mt_queue import MtQueue

MV_DEFINE_bool("sync", False, "sync or async")
MV_DEFINE_bool("mv_pipeline", True,
               "pipelined windowed engine (multi-process worlds): apply "
               "window N while window N+1 is exchanged (false = each "
               "exchange waits until the previous window applied)")
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

_INF = float("inf")

#: exchanged but not yet applied windows before the exchange stage waits,
#: under -mv_pipeline (without it: 1, no overlap)
PIPELINE_DEPTH = 2

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
      descs0, t0)``; verbs past the prefix lead the next exchange;
    * ``("barrier", msg)`` — a non-verb head: every pending verb goes
      first, then the head-marker exchange, then ``("barrier", msg)``;
    * ``("stop", None)`` — exit.

    After a barrier, or a window whose apply is not local, the thread
    FENCES: no further collective until the actor reports that item
    applied (the decision comes from exchanged bytes, so every rank
    fences at the same items). ``PIPELINE_DEPTH`` (1 under
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
        self._cv = threading.Condition()
        self._killed = False
        self._depth = PIPELINE_DEPTH if GetFlag("mv_pipeline") else 1
        self.dead: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._main,
                                        name="mvt-engine-exchange",
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

    def _gate(self) -> None:
        """Before any new collective: the fence and the depth bound."""
        target = max(self._fence_at, self._emitted - self._depth + 1)
        with self._cv:
            self._cv.wait_for(lambda: self._applied >= target
                              or self._killed)
        if self._killed:
            raise _StageKilled()

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
                self._pending.extend(items.popleft()[1])
            if self._pending:
                self._exchange_one()
                continue
            kind, payload = items.popleft()
            if kind == "stop":
                return
            self._gate()
            self._srv._mh_check_barrier_head(payload)
            self._emitted += 1
            self._fence_at = self._emitted
            self.out.Push(("barrier", payload))

    def _exchange_one(self) -> None:
        srv = self._srv
        self._gate()
        t0 = time.perf_counter()
        local, used = srv._mh_pack_window(list(self._pending))
        windows = srv._mh_exchange_decode(local)
        prefix, descs0 = srv._mh_agree(windows)
        for _ in range(prefix):
            self._pending.popleft()
        self._emitted += 1
        if not srv._mh_window_is_local(descs0):
            self._fence_at = self._emitted
        self.out.Push(("window", used[:prefix], windows, prefix, descs0,
                       t0))


class Server(Actor):
    """Async server engine (reference server.cpp:23-58)."""

    #: messages drained per window
    GET_PIPELINE_WINDOW = 16
    #: whether this engine flattens Request_MultiVerb envelopes; the BSP
    #: SyncServer counts MESSAGES into its clocks, so Zoo.SendToServerMulti
    #: delivers the members one at a time there
    MULTI_VERB_OK = True

    def __init__(self, name: str = actor_names.kServer):
        super().__init__(name)
        self.store_: List = []
        #: this engine's shard slot (0 unless it is a sub-shard)
        self.slot = 0
        #: window Add runs applied as one merged dispatch
        self.add_runs_merged = 0
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
        self.RegisterHandler(MsgType.Request_Get, self._get_entry)
        self.RegisterHandler(MsgType.Request_Add, self._add_entry)
        self.RegisterHandler(MsgType.Request_MultiVerb, self._get_entry)
        self.RegisterHandler(MsgType.Server_Finish_Train,
                             self.ProcessFinishTrain)
        # drain ping: replies once the mailbox drained up to it — never
        # touches the BSP clocks, unlike FinishTrain
        self.RegisterHandler(MsgType.Request_Barrier, lambda m: m.reply(None))
        self.RegisterHandler(MsgType.Request_StoreLoad, self._store_load_entry)

    def receive_multi(self, members) -> None:
        """Accept one batched verb submission: ONE mailbox hop carries the
        pre-built member messages in a Request_MultiVerb envelope. Pushes
        straight to this actor's mailbox: ShardedServer.receive_multi has
        already split the batch per shard, and going back through its
        Receive would split it again forever."""
        Actor.Receive(self, Message(msg_type=MsgType.Request_MultiVerb,
                                    payload={"members": list(members)},
                                    on_reply=_fail_multi_members))

    @staticmethod
    def _expand_multi(batch: list) -> list:
        """Flatten envelopes into their member verbs in place of the
        envelope's drain position (submission order)."""
        out: list = []
        for m in batch:
            if m.msg_type is MsgType.Request_MultiVerb:
                out.extend(m.payload["members"])
            else:
                out.append(m)
        return out

    def RegisterTable(self, server_table) -> int:
        table_id = len(self.store_)
        self.store_.append(server_table)
        server_table.table_id = table_id
        return table_id

    def shard_states(self) -> List[dict]:
        """Per-shard live state: slot, actor name, mailbox depth, alive."""
        thread = self._thread
        return [{"slot": self.slot, "name": self.name,
                 "mailbox_depth": self.mailbox.Size(),
                 "alive": (self._poison is None and thread is not None
                           and thread.is_alive())}]

    def _get_entry(self, msg: Message) -> None:
        """Window handler for Request_Get, Request_Add and envelopes."""
        batch = [msg]
        while len(batch) < self.GET_PIPELINE_WINDOW:
            ok, nxt = self.mailbox.TryPop()
            if not ok:
                break
            batch.append(nxt)
        batch = self._expand_multi(batch)
        if multihost.world_size() > 1:
            self._mh_windows(batch)
            return
        self._local_window(batch)

    def _add_entry(self, msg: Message) -> None:
        """Request_Add enters the same window as Gets; SyncServer re-binds
        this to its strict clocked path."""
        self._get_entry(msg)

    def Stop(self) -> None:
        if self._ex_stage is not None:
            self._ex_stage.stop()
        super().Stop()

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
            self._mh_pipelined(pending)
        except Exception as exc:
            if self._ex_stage is not None:
                self._ex_stage.poison()
            Log.Error("engine: multi-process window stream aborted: %r",
                      exc)
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
        while fed:
            for _ in range(64):
                ok, m = self.mailbox.TryPop()
                if not ok:
                    break
                for mm in self._expand_multi([m]):
                    fed.append(mm)
                    stage.feed(mm)
            ok, item = stage.out.TryPop()
            if not ok:
                ok, item = stage.out.Pop(timeout=_PL_POLL_S)
            if not ok:
                continue
            if item[0] == "error":
                raise item[1]
            try:
                if item[0] == "barrier":
                    CHECK(fed.popleft() is item[1],
                          "pipeline completion order desync (engine bug)")
                    self._dispatch(item[1])
                else:
                    _, mine, windows, prefix, descs0, t0 = item
                    self._mh_apply_window(mine, windows, prefix, descs0)
                    for m in mine:
                        CHECK(fed.popleft() is m,
                              "pipeline completion order desync (engine "
                              "bug)")
            finally:
                # always lift the fence, even before a fatal raise: the
                # stage must not hang waiting for it
                stage.note_applied()

    def _mh_collective_window(self, msg: Message) -> None:
        """A one-verb window on the actor thread (the BSP engine): pack,
        exchange, agree, apply."""
        local, used = self._mh_pack_window([msg])
        windows = self._mh_exchange_decode(local)
        prefix, descs0 = self._mh_agree(windows)
        self._mh_apply_window(used[:prefix], windows, prefix, descs0)

    def _mh_check_barrier_head(self, head: Message) -> None:
        """Exchange a head-kind marker for a non-verb window head: a rank at
        a barrier while a peer exchanges verbs (or another barrier) fails
        the CHECK on every rank instead of stranding the verb rank in an
        unmatched collective."""
        blobs = multihost.capped_exchange(
            wire.encode_head_barrier(int(head.msg_type)), self._mh_caps,
            "HEAD_B")
        kinds = [wire.decode_head_kind(b) for b in blobs]
        CHECK(all(k == kinds[0] for k in kinds),
              f"multi-process window heads diverge: {kinds} — every "
              f"process must reach the same barrier/verb at the same "
              f"stream position (the SPMD collective contract)")

    def _mh_pack_window(self, verbs):
        """``(local, used)``: the packed ``(kind, table, payload)`` records
        under the byte budget and the messages they came from (>= 1)."""
        local, used, packed = [], [], 0
        for i, m in enumerate(verbs):
            nbytes = wire.payload_nbytes(m.payload)
            if packed + nbytes > self.MH_WINDOW_BYTES and i > 0:
                break
            packed += nbytes
            local.append(("A" if m.msg_type is MsgType.Request_Add else "G",
                          m.table_id, m.payload))
            used.append(m)
        return local, used

    def _mh_exchange_decode(self, local) -> list:
        """Encode, exchange and decode one window; every rank's verb list
        in rank order (this rank's own records verbatim). A frame failing
        its seal re-runs the whole collective exchange."""
        my_rank = multihost.world_rank()
        last_exc = None
        for attempt in range(1 + self.MH_WIRE_RETRIES):
            blob = wire.encode_window(local, seq=self._mh_seq)
            t0 = time.perf_counter()
            blobs = multihost.capped_exchange(
                blob, self._mh_caps, (local[0][0], local[0][1]))
            self.xw_busy_s += time.perf_counter() - t0
            try:
                windows = []
                for i, b in enumerate(blobs):
                    if i == my_rank:
                        windows.append(local)
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
                Log.Error("window exchange frame corrupt (attempt %d/%d): "
                          "%r — re-exchanging", attempt + 1,
                          1 + self.MH_WIRE_RETRIES, exc)
                continue
            self._mh_seq += 1
            self.mh_window_exchanges += 1
            return windows
        raise last_exc

    @staticmethod
    def _mh_agree(windows):
        """``(prefix, descs0)``: the common verb prefix of every rank's
        window and its ``(kind, table)`` records; a divergence CHECK-fails
        identically on every rank."""
        prefix = min(len(w) for w in windows)
        descs = [[(k, t) for k, t, _ in w[:prefix]] for w in windows]
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

    def _mh_apply_window(self, verbs, windows, prefix, descs0) -> None:
        """Apply an exchanged window's agreed prefix in op order: a table's
        Adds as one run at its first Add's position, its Gets grouped
        before and after that run (no Get observes less than strict order
        would show it). Replies go to this rank's own messages; failures
        reply per position, identically on every rank."""
        t0 = time.perf_counter()
        my_rank = multihost.world_rank()
        self.mh_window_verbs += prefix
        add_pos: Dict[int, list] = {}
        for i, (kind, tid) in enumerate(descs0):
            if kind == "A":
                add_pos.setdefault(tid, []).append(i)
        parts_at = [[w[i][2] for w in windows] for i in range(prefix)]
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
        for kind, tid, positions in ops:
            if kind == "A":
                self._mh_add_run(tid, positions, parts_at, verbs, my_rank)
            else:
                self._mh_get_group(tid, positions, parts_at, verbs, my_rank)
        self.apply_busy_s += time.perf_counter() - t0

    def _mh_add_run(self, tid: int, positions, parts_at, verbs,
                    my_rank: int) -> None:
        """A table's window-worth of collective Adds: merged across
        positions and ranks when the table accepts, per position
        otherwise."""
        try:
            table = self.store_[tid]
        except IndexError as exc:
            for p in positions:
                verbs[p].reply(exc)
            return
        if len(positions) > 1:
            try:
                merged = table.ProcessAddRunParts(
                    [parts_at[p] for p in positions], my_rank)
            except Exception as exc:
                Log.Error("table %d merged parts Add failed: %r", tid, exc)
                for p in positions:
                    verbs[p].reply(exc)
                return
            if merged:
                self.mh_add_run_merged += 1
                for p in positions:
                    verbs[p].reply(None)
                return
        for p in positions:
            try:
                table.ProcessAddParts(parts_at[p], my_rank)
            except Exception as exc:
                Log.Error("table %d parts Add failed: %r", tid, exc)
                verbs[p].reply(exc)
                continue
            verbs[p].reply(None)

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
            else:
                segments.append(m)       # barrier marker
                segments.append([])
        pending = []   # (finalize, [msgs]) in dispatch order
        seen: Dict[tuple, int] = {}
        for seg in segments:
            if not isinstance(seg, list):
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
                        self._process_add_run(add_runs[m.table_id])
                        # a Get queued after this Add must not join a
                        # gather dispatched before it
                        seen = {k: v for k, v in seen.items()
                                if k[0] != m.table_id}
                    continue
                key = self._get_dedup_key(m) if n_gets > 1 else None
                if key is not None and key in seen:
                    pending[seen[key]][1].append(m)
                    continue
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
                    # a failure (bad table id included) replies to THIS
                    # message only — escaping would abandon every pending
                    # finalize and hang its waiters
                    Log.Error("table ProcessGet dispatch failed: %r", exc)
                    m.reply(exc)
        for finalize, msgs in pending:
            try:
                result = finalize()
            except Exception as exc:
                Log.Error("table %d Get finalize failed: %r",
                          msgs[0].table_id, exc)
                for m in msgs:
                    m.reply(exc)
                continue
            msgs[0].reply(result)
            for m in msgs[1:]:
                m.reply(copy_result(result))

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
        try:
            result = self.store_[msg.table_id].ProcessGet(**msg.payload)
        except Exception as exc:
            # replies to THIS message: a cached message drained inside
            # another worker's request (SyncServer) must not hang
            Log.Error("table %d ProcessGet failed: %r", msg.table_id, exc)
            msg.reply(exc)
            return
        msg.reply(result)

    def ProcessAdd(self, msg: Message) -> None:
        try:
            self.store_[msg.table_id].ProcessAdd(**msg.payload)
        except Exception as exc:
            Log.Error("table %d ProcessAdd failed: %r", msg.table_id, exc)
            msg.reply(exc)
            return
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


def engine_shard_cap() -> int:
    """Resolved engine shard-slot count for a new engine (see the
    ``-mv_engine_shards`` help text): 1 under BSP (the vector clocks count
    verbs across all tables) and in multi-process worlds (gloo is one
    ordered collective stream; per-shard streams need a multi-channel
    wire, not ported), the flag when set, else auto,
    ``min(8, cores // 4)``; lazy shard spawn bounds the live shards by
    the table count."""
    if GetFlag("sync"):
        return 1
    flag = int(GetFlag("mv_engine_shards"))
    if multihost.world_size() > 1:
        if flag > multihost.wire_channels():
            Log.Error("engine: -mv_engine_shards=%d needs %d independent "
                      "exchange channels but the gloo wire offers %d — "
                      "clamped to 1", flag, flag, multihost.wire_channels())
        return 1
    if flag >= 1:
        return flag
    return max(1, min(8, (os.cpu_count() or 4) // 4))


#: non-verb message types the sharded router turns into cross-stream
#: cuts; any other non-verb type dispatches on shard 0 alone
_CUT_TYPES = (MsgType.Request_StoreLoad, MsgType.Request_Barrier,
              MsgType.Server_Finish_Train)


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
        cut, aborts it, or dies."""
        with self._cv:
            self._arrived += 1
            self._cv.notify_all()
            while not self._released and self._abort is None:
                if self._head._poison is not None:
                    raise ActorDied(self._head.name, self._head._poison)
                self._cv.wait(self._POLL_S)
            if self._abort is not None:
                raise self._abort

    def arrive_head(self, subs) -> None:
        """Head side: block until every sub-shard fenced. A dead sub aborts
        the cut on every waiter."""
        with self._cv:
            while self._arrived < self._need:
                for sub in subs:
                    if sub._poison is not None:
                        exc = ActorDied(sub.name, sub._poison)
                        self._abort = exc
                        self._cv.notify_all()
                        raise exc
                self._cv.wait(self._POLL_S)

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
    (own thread, mailbox and window stream) whose ``store_`` is the
    router's table list. Non-verb messages reach it only as cut fences."""

    def __init__(self, parent: "ShardedServer", slot: int):
        super().__init__(name=f"{actor_names.kServer}_shard{slot}")
        self.store_ = parent.store_     # one table list, router-owned
        self.slot = slot
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
                    sub = self._subs.get(slot)
                    if sub is not None:
                        sub.receive_multi(ms)
                    else:
                        Server.receive_multi(self, ms)
                return

    def Receive(self, msg: Message) -> None:
        if msg.msg_type is MsgType.Request_MultiVerb:
            # a pre-wrapped envelope: split it per shard, or shard 0
            # would apply other shards' tables in its own stream
            self.receive_multi(msg.payload["members"])
            return
        if msg.msg_type in (MsgType.Request_Get, MsgType.Request_Add):
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
        self.cut_count += 1
        fence = _CutFence(self, len(subs))
        with self._route_lock:
            self._cuts_inflight += 1
            self._route_open.clear()
            try:
                for sub in subs:
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
    #: envelope would hide N ticks in one message
    MULTI_VERB_OK = False

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
        # one-at-a-time processing
        self.ProcessGet(msg)

    def _add_entry(self, msg: Message) -> None:
        # no add coalescing under BSP either
        self.ProcessAdd(msg)

    def ProcessGet(self, msg: Message) -> None:
        worker = msg.src
        # 1. Before get: wait for other workers' adds (server.cpp:164-171)
        if (self._add_clocks.local_clock(worker)
                > self._add_clocks.global_clock()
                or self._num_waited_add[worker] > 0):
            self._get_cache.append(msg)
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
