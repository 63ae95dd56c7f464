"""Zoo — the runtime singleton: device context, roles, engine lifecycle,
table registries.

Counterpart of ``multiverso_tpu/zoo.py`` (reference zoo.h + zoo.cpp):
``Start`` parses flags, resolves the device and starts the server engine
that ``Server.GetServer`` picks (async, sharded async or BSP), or none in
model-average mode (``-ma``); ``Stop`` drains and shuts down; the Zoo owns
the worker/server table registries, the in-process worker barrier and the
``MV_Aggregate`` rendezvous.

Multi-process worlds: ``Start`` brings up ``torch.distributed``
(``parallel/multihost.py``) before it resolves the device, so rank r takes
its own card (``cuda:(r % device_count)``); rank and size come from the
world. ``Barrier`` adds the cross-process barrier and ``Aggregate`` the
cross-process sum. Each process keeps a full replica of every table, and
the engine applies every rank's verbs of each exchanged window to it
(``sync/server.py``).

The planes the JAX ``Start`` brings up after the engine (reporter, ops,
ledger, watchdog, elastic, replica, policy) and worker-side write combining
are later work (``ROADMAP.md``).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

import numpy as np

from multiverso_tpu_torch.message import Message, MsgType
from multiverso_tpu_torch.node import ROLE_NAMES, Node, Role
from multiverso_tpu_torch.parallel import multihost
# imported for their flag registrations, which must precede Start()'s
# ParseCMDFlags
import multiverso_tpu_torch.updaters.base  # noqa: F401
from multiverso_tpu_torch.parallel.allreduce import RendezvousAllreduce
from multiverso_tpu_torch.parallel.mesh import DeviceContext
from multiverso_tpu_torch.sync.server import Server
from multiverso_tpu_torch.utils.configure import (GetFlag, MV_DEFINE_bool,
                                                  MV_DEFINE_int,
                                                  MV_DEFINE_string,
                                                  ParseCMDFlags)
from multiverso_tpu_torch.utils.log import CHECK, Log
from multiverso_tpu_torch.utils.waiter import Waiter

MV_DEFINE_string("ps_role", "default", "none / worker / server / default")
MV_DEFINE_bool("ma", False, "model-average mode: no parameter server")
MV_DEFINE_int("num_workers", 1, "number of in-process worker streams")

_thread_local = threading.local()


class Zoo:
    _instance: Optional["Zoo"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self.started = False
        self.device_ctx: Optional[DeviceContext] = None
        self.node = Node()
        self.num_workers = 1
        self.server_engine = None
        self.worker_tables: List[Any] = []
        self.server_tables: List[Any] = []
        self._barrier: Optional[threading.Barrier] = None
        self._allreduce: Optional[RendezvousAllreduce] = None
        self._ma_mode = False
        self._multihost = False

    @classmethod
    def Get(cls) -> "Zoo":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Zoo()
            return cls._instance

    # -- lifecycle (reference zoo.cpp:41-113) --------------------------------

    def Start(self, argv: Optional[List[str]] = None,
              devices=None) -> List[str]:
        CHECK(not self.started, "Zoo already started")
        rest = ParseCMDFlags(argv or [])
        # the world before the device: a rank's card follows its rank
        self._multihost = multihost.maybe_initialize()
        # the device rule next: a world with no usable device never
        # starts, in any mode
        self.device_ctx = DeviceContext.create(devices)
        self._ma_mode = bool(GetFlag("ma"))
        role = ROLE_NAMES.get(str(GetFlag("ps_role")).lower(), Role.ALL)
        self.num_workers = max(1, int(GetFlag("num_workers")))
        self.node = Node(rank=multihost.process_index(), role=role,
                         worker_id=0 if role & Role.WORKER else -1,
                         server_id=0 if role & Role.SERVER else -1)
        self._barrier = threading.Barrier(self.num_workers)
        # MV_Aggregate's cross-process leg: the rendezvous's last thread
        # sums the thread sum across processes (reference MPI_Allreduce)
        self._allreduce = RendezvousAllreduce(
            self.num_workers, cross_reduce=(multihost.host_allreduce_sum
                                            if self._multihost else None))
        if not self._ma_mode:
            self.server_engine = Server.GetServer(self.num_workers)
            self.server_engine.Start()
        self.started = True
        Log.Debug("Zoo started on %s, rank %d of %d: %d worker(s), engine "
                  "%s", self.device_ctx.device, self.rank, self.size,
                  self.num_workers,
                  type(self.server_engine).__name__)
        return rest

    def Stop(self) -> None:
        if not self.started:
            return
        if self.server_engine is not None:
            try:
                self.FinishTrain()
            except RuntimeError as exc:
                # a dead engine must not abandon the rest of the shutdown
                Log.Error("Zoo.Stop: engine drain failed (%r) — continuing "
                          "shutdown", exc)
            self.server_engine.Stop()
            self.server_engine = None
        self.worker_tables.clear()
        self.server_tables.clear()
        self.started = False

    def FinishTrain(self) -> None:
        """Send Server_Finish_Train for every worker (reference
        zoo.cpp:152-162) and wait for the engine to drain to it: a
        SyncServer drains its caches there."""
        if self.server_engine is None:
            return
        waiters = []
        for wid in range(self.num_workers):
            w = Waiter(1)
            self.server_engine.Receive(Message(
                msg_type=MsgType.Server_Finish_Train, src=wid, waiter=w))
            waiters.append(w)
        for w in waiters:
            w.Wait()

    # -- identity (reference zoo.h:40-66) ------------------------------------

    @property
    def rank(self) -> int:
        return self.node.rank

    @property
    def size(self) -> int:
        return multihost.world_size() if self._multihost else 1

    @property
    def num_servers(self) -> int:
        if self._ma_mode:
            return 0
        return 1 if self.device_ctx is None else self.device_ctx.num_servers

    def current_worker_id(self) -> int:
        return getattr(_thread_local, "worker_id", 0)

    def worker_context(self, worker_id: int):
        """Bind the calling thread to a worker id for a ``with`` block
        (thread workers stand in for the reference's MPI rank workers)."""
        zoo = self

        class _Ctx:
            def __enter__(self):
                self._prev = getattr(_thread_local, "worker_id", None)
                CHECK(0 <= worker_id < zoo.num_workers,
                      f"worker_id {worker_id} out of range")
                _thread_local.worker_id = worker_id
                return zoo

            def __exit__(self, *exc):
                if self._prev is None:
                    del _thread_local.worker_id
                else:
                    _thread_local.worker_id = self._prev

        return _Ctx()

    # -- table registries (reference zoo.h:68-73) ---------------------------

    def RegisterServerTable(self, server_table) -> int:
        CHECK(self.server_engine is not None,
              "cannot create tables in -ma mode (reference zoo.cpp:49)")
        table_id = self.server_engine.RegisterTable(server_table)
        self.server_tables.append(server_table)
        return table_id

    def RegisterWorkerTable(self, worker_table) -> int:
        self.worker_tables.append(worker_table)
        return len(self.worker_tables) - 1

    def SendToServer(self, msg: Message) -> None:
        CHECK(self.server_engine is not None, "no server engine (ma mode?)")
        self.server_engine.Receive(msg)

    def SendToServerMulti(self, members) -> None:
        """Ship a batched verb submission in ONE engine mailbox hop. An
        engine that can't flatten envelopes (the BSP SyncServer counts
        Get/Add MESSAGES into its clocks, ``MULTI_VERB_OK`` False) receives
        the members one at a time instead: same stream order, unbatched."""
        CHECK(self.server_engine is not None, "no server engine (ma mode?)")
        eng = self.server_engine
        if not eng.MULTI_VERB_OK:
            for m in members:
                eng.Receive(m)
            return
        eng.receive_multi(members)

    def CallOnEngine(self, msg_type: MsgType, fn, what: str):
        """Run ``fn()`` on the engine thread at the current stream
        position — the consistent-cut mechanism: the engine treats any
        non-verb message as a window barrier (a cross-stream cut on the
        sharded engine), so every Add admitted before this call is applied
        first and none after. Returns ``fn``'s result; its failure
        re-raises here."""
        CHECK(self.server_engine is not None,
              f"{what} needs a server engine (not -ma mode)")
        return self._round_trip(msg_type, {"fn": fn})

    def DrainServer(self) -> None:
        """Round-trip a barrier ping through the engine: returns only after
        every request enqueued before it, fire-and-forget Adds included,
        has applied (on every shard). No-op without an engine (-ma)."""
        if self.server_engine is not None:
            self._round_trip(MsgType.Request_Barrier, {})

    def _round_trip(self, msg_type: MsgType, payload: dict):
        """Send one non-verb message, wait for its reply, re-raise an
        engine-side failure."""
        waiter = Waiter(1)
        msg = Message(msg_type=msg_type, payload=payload, waiter=waiter)
        self.SendToServer(msg)
        waiter.Wait()
        if isinstance(msg.result, Exception):
            raise msg.result
        return msg.result

    def Barrier(self) -> None:
        """Worker barrier (reference zoo.cpp:164-177): every in-process
        worker thread, then, in a multi-process world, every process (one
        cross-process barrier a rendezvous, issued by one thread of each
        process; a failure there breaks the thread barrier so the other
        threads raise too)."""
        CHECK(self._barrier is not None, "Zoo not started")
        idx = self._barrier.wait()
        if self._multihost:
            if idx == 0:
                try:
                    multihost.host_barrier("mv_barrier")
                except BaseException:
                    self._barrier.abort()
                    raise
            self._barrier.wait()     # hold the threads until it ends

    def Aggregate(self, data: np.ndarray) -> np.ndarray:
        """In-place elementwise-sum allreduce across the worker threads
        (reference MV_Aggregate, src/multiverso.cpp:53-56)."""
        CHECK(self._allreduce is not None, "Zoo not started")
        np.copyto(data, self._allreduce.allreduce(data))
        return data

    @classmethod
    def _reset(cls) -> None:
        with cls._instance_lock:
            if cls._instance is not None and cls._instance.started:
                cls._instance.Stop()
            cls._instance = None
