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

Not ported (ROADMAP.md): the multi-process windows and exchange stage,
the apply pool, the failsafe admission gate (dedup window, chaos) and
deadlines, worker-side write combining and the Get cache, and the
telemetry hooks of the JAX engine.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Deque, Dict, List, Optional

import numpy as np

from multiverso_tpu_torch.actor import Actor, ActorDied, actor_names
from multiverso_tpu_torch.message import Message, MsgType, copy_result
from multiverso_tpu_torch.updaters.base import AddOption, GetOption
from multiverso_tpu_torch.utils.configure import (GetFlag, MV_DEFINE_bool,
                                                  MV_DEFINE_int)
from multiverso_tpu_torch.utils.log import CHECK, Log

MV_DEFINE_bool("sync", False, "sync or async")
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
        self._local_window(self._expand_multi(batch))

    def _add_entry(self, msg: Message) -> None:
        """Request_Add enters the same window as Gets; SyncServer re-binds
        this to its strict clocked path."""
        self._get_entry(msg)

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
    verbs across all tables), the flag when set, else auto,
    ``min(8, cores // 4)``; lazy shard spawn bounds the live shards by
    the table count."""
    if GetFlag("sync"):
        return 1
    flag = int(GetFlag("mv_engine_shards"))
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

    def ProcessAdd(self, msg: Message) -> None:
        worker = msg.src
        # 1. Before add: cache a faster worker (server.cpp:141-147)
        if (self._get_clocks.local_clock(worker)
                > self._get_clocks.global_clock()):
            self._add_cache.append(msg)
            self._num_waited_add[worker] += 1
            return
        # 2. Process add
        super().ProcessAdd(msg)
        # 3. After add: drain cached gets when the add round completes
        if self._add_clocks.Update(worker):
            CHECK(not self._add_cache, "add cache must be empty at round end")
            while self._get_cache:
                get_msg = self._get_cache.popleft()
                super().ProcessGet(get_msg)
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
        super().ProcessGet(msg)
        # 3. After get: drain cached adds when the get round completes
        if self._get_clocks.Update(worker):
            while self._add_cache:
                add_msg = self._add_cache.popleft()
                super().ProcessAdd(add_msg)
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
                super().ProcessGet(get_msg)
                CHECK(not self._get_clocks.Update(get_msg.src), "")
        if self._get_clocks.FinishTrain(worker):
            CHECK(not self._get_cache, "get cache must be empty")
            while self._add_cache:
                add_msg = self._add_cache.popleft()
                super().ProcessAdd(add_msg)
                CHECK(not self._add_clocks.Update(add_msg.src), "")
                self._num_waited_add[add_msg.src] -= 1
        msg.reply(None)
