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
world. The host wire (shm same-host, tcp cross-host) is installed next,
before the engine, with the channels the engine asks for, then the device
wire (``parallel/device_wire.py``: the deferred Add values' transport,
decided rank-agreed), and ``Stop`` closes both after the engine. ``Barrier`` adds the cross-process barrier and ``Aggregate`` the
cross-process sum. Each process keeps a full replica of every table, and
the engine applies every rank's verbs of each exchanged window to it
(``sync/server.py``).

``Stop`` takes the serving plane down after the engine (``serving/``).

Telemetry (``telemetry/``) in the JAX order: ``Start`` stamps the trace
dump's process label, then after the engine starts the
``-stats_interval_s`` reporter, the ``-mv_ops_port`` endpoint, the byte
ledger and the ``-mv_watchdog_s`` watchdog; ``Stop`` stops the reporter,
the endpoint, the watchdog and the ledger FIRST (bounded joins, so
back-to-back worlds leak no thread and no port, whether or not the engine
drain below succeeds), and with ``-mv_diag_dir`` set it leaves the
diagnostics (flight ring, metrics sidecar, span trace) on disk last.
``Barrier`` observes ``zoo.barrier_wait_s``.

Elastic membership (``elastic/``, ``-mv_elastic``): the plane starts
after the engine (rank 0 hosts the coordinator, every rank registers and
heartbeats) and stops after the engine drain in ``Stop``, which then
clears the fleet fold. ``size`` and the id maps follow the CURRENT view
(an id past it raises ``MembershipChanged``), and a departed member's
verbs fail typed (``elastic.guard_verbs``). The policy plane
(``policy/``, ``-mv_policy``) starts last, after the watchdog whose tick
listener feeds it and the elastic coordinator it may ride, and stops
before the watchdog. The replica fan-out (``replica/``,
``-mv_replica_fanout``) starts after the elastic plane, whose coordinator
it rides when ``-mv_elastic`` is up, and stops after the engine (no
publish cut can arrive) and before the elastic and serving planes it
reads.

Failsafe (``failsafe/``) as in the JAX Zoo: with ``-mv_deadline_s`` set
the FinishTrain drain, ``DrainServer``'s ping, a cut's wait
(``CallOnEngine``), the worker barrier and the cross-process barrier
(through ``deadline.bounded``) raise ``DeadlineExceeded`` with the
diagnostic bundle instead of hanging; ``Stop`` waits for every chaos
redelivery (``chaos.quiesce``) before the mailboxes go down.

Write combining (``tables/base.py``): every global ordering point ships
the tables' combine buffers first (``flush_combined_adds``): a non-verb
message (a drain ping, a checkpoint or publish cut, ``CallOnEngine``),
``FinishTrain``, a tracked batch and ``Barrier``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

import numpy as np

from multiverso_tpu_torch import elastic
from multiverso_tpu_torch import policy
from multiverso_tpu_torch import replica
from multiverso_tpu_torch.failsafe.errors import MembershipChanged
from multiverso_tpu_torch.message import Message, MsgType
from multiverso_tpu_torch.node import ROLE_NAMES, Node, Role
from multiverso_tpu_torch.parallel import device_wire, multihost
# imported for their flag registrations, which must precede Start()'s
# ParseCMDFlags
import multiverso_tpu_torch.failsafe  # noqa: F401
from multiverso_tpu_torch.failsafe import chaos as fchaos
from multiverso_tpu_torch.failsafe import deadline as fdeadline
import multiverso_tpu_torch.telemetry  # noqa: F401
import multiverso_tpu_torch.updaters.base  # noqa: F401
import multiverso_tpu_torch.utils.io  # noqa: F401
from multiverso_tpu_torch import serving
from multiverso_tpu_torch.parallel.allreduce import RendezvousAllreduce
from multiverso_tpu_torch.parallel.mesh import DeviceContext
from multiverso_tpu_torch.sync.server import (Server,
                                              requested_engine_channels,
                                              window_transport_mode)
from multiverso_tpu_torch.telemetry import accounting as taccounting
from multiverso_tpu_torch.telemetry import export as texport
from multiverso_tpu_torch.telemetry import fleet as tfleet
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import ops as tops
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.telemetry import watchdog as twatchdog
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
        # lock-free once the singleton exists: a telemetry sampler (the
        # watchdog tick, an ops scrape) reading the Zoo while _reset holds
        # the lock through Stop must not wait for that Stop, which is
        # joining the sampler's thread
        inst = cls._instance
        if inst is not None:
            return inst
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
        if self._multihost:
            # the host wire before the engine exists: its channels are
            # what let a sharded engine exchange across processes
            multihost.maybe_install_wire(requested_engine_channels())
            # the device wire next, rank-agreed: the deferred Add values'
            # card-to-card transport (ipc, or its plain version on the CPU)
            device_wire.install(self.device_ctx.device,
                                window_transport_mode())
        self._ma_mode = bool(GetFlag("ma"))
        role = ROLE_NAMES.get(str(GetFlag("ps_role")).lower(), Role.ALL)
        self.num_workers = max(1, int(GetFlag("num_workers")))
        # the trace dump's process label, stamped where the identity is
        # known (a dump caller must not have to look it up)
        ttrace.set_process_label(
            f"multiverso rank {multihost.process_index()}")
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
        texport.start_reporter()     # -stats_interval_s
        tops.start_ops()             # -mv_ops_port
        # the mem.* families register at zero every world; the watchdog's
        # tick thread arms only when -mv_watchdog_s > 0 (both local only)
        taccounting.start_ledger()
        twatchdog.start_watchdog()
        # the membership plane LAST (it needs the engine up): rank 0
        # hosts the coordinator, every rank registers and heartbeats
        self.started = True
        try:
            elastic.start_plane(self)
            # the replica fan-out after the elastic plane, so its
            # subscriptions can ride the membership coordinator; rank 0
            # owns the fan-out thread, every rank reads one cached flag
            replica.start_plane(self)
            # the policy plane LAST: it needs the watchdog's tick listener
            # and, across processes, the elastic coordinator endpoint (or
            # its own -mv_policy_addr authority) already up
            policy.start_plane(self)
        except BaseException:
            self.Stop()
            raise
        Log.Debug("Zoo started on %s, rank %d of %d: %d worker(s), engine "
                  "%s", self.device_ctx.device, self.rank, self.size,
                  self.num_workers,
                  type(self.server_engine).__name__)
        return rest

    def Stop(self) -> None:
        if not self.started:
            return
        # the samplers down FIRST, bounded, before anything that can fail:
        # back-to-back worlds must not leak their threads or the ops port
        texport.stop_reporter()
        tops.stop_ops()
        # the policy plane down BEFORE the watchdog that feeds it (no tick
        # may land on a stopped engine) and before the engine it cuts
        policy.shutdown_plane()
        twatchdog.stop_watchdog()
        taccounting.stop_ledger()
        # no chaos redelivery may land in a mailbox that is going down
        fchaos.quiesce()
        if self.server_engine is not None:
            try:
                self.FinishTrain()
            except RuntimeError as exc:
                # a dead engine must not abandon the rest of the shutdown
                Log.Error("Zoo.Stop: engine drain failed (%r) — continuing "
                          "shutdown", exc)
            self.server_engine.Stop()
            self.server_engine = None
        # the replica fan-out down after the engine (no publish cut can
        # arrive) and BEFORE the elastic and serving planes it reads: the
        # fan-out thread stops, the subscription wires close, and a hosted
        # subscription coordinator dies with it (parked readers notice
        # through their heartbeats)
        replica.shutdown_plane()
        # the membership plane down AFTER the engine drain (the drain's
        # flushes route under the CURRENT view); heartbeats stop and the
        # boot-world group is restored for the next MV_Init
        elastic.shutdown_plane()
        # the wire outlives the engine (its drain above exchanged on it)
        # and dies with the world: the next world selects its own
        multihost.close_wire()
        device_wire.close()
        # the serving plane after the engine (no more publish can arrive):
        # it drops every snapshot and stops its dispatcher, so a later
        # MV_Init world starts from a fresh plane
        serving.shutdown_plane()
        # the fleet fold last among the telemetry planes: whatever pushed
        # rollups into it is down, and the next world starts empty
        tfleet.shutdown_plane()
        # one-flag postmortem: with -mv_diag_dir set every world leaves its
        # flight ring, metrics sidecar and span trace on disk
        try:
            tops.dump_diagnostics()
        except Exception as exc:   # diagnostics must never break Stop
            Log.Error("Zoo.Stop: diagnostics dump failed: %r", exc)
        self.worker_tables.clear()
        self.server_tables.clear()
        self.started = False

    def FinishTrain(self) -> None:
        """Send Server_Finish_Train for every worker (reference
        zoo.cpp:152-162) and wait for the engine to drain to it: a
        SyncServer drains its caches there. Bounded by ``-mv_deadline_s``:
        a wedged engine raises ``DeadlineExceeded`` instead of hanging the
        drain."""
        if self.server_engine is None:
            return
        self.flush_combined_adds()
        waiters = []
        for wid in range(self.num_workers):
            w = Waiter(1)
            self.server_engine.Receive(Message(
                msg_type=MsgType.Server_Finish_Train, src=wid, waiter=w))
            waiters.append(w)
        for w in waiters:
            if not w.Wait(fdeadline.timeout_or_none()):
                fdeadline.raise_deadline("engine FinishTrain drain")

    # -- identity (reference zoo.h:40-66) ------------------------------------

    @property
    def rank(self) -> int:
        return self.node.rank

    @property
    def size(self) -> int:
        """Member count of the CURRENT world: the boot process count until
        an elastic epoch transition shrinks or regrows it."""
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

    def worker_id_to_rank(self, worker_id: int) -> int:
        """The boot rank hosting global worker ``worker_id`` under the
        current view: ids partition contiguously, ``num_workers`` a
        member."""
        return self._id_to_member(worker_id, self.num_workers, "worker")

    def server_id_to_rank(self, server_id: int) -> int:
        return self._id_to_member(
            server_id, max(1, self.num_servers // max(1, self.size)),
            "server")

    def _id_to_member(self, global_id: int, per_member: int,
                      what: str) -> int:
        """Global worker/server id -> the hosting member's boot rank under
        the CURRENT epoch view (member i hosts ids [i*per_member,
        (i+1)*per_member)). An id the view no longer hosts (the world
        shrank) raises the typed MembershipChanged under the elastic
        plane, and fails a CHECK otherwise."""
        CHECK(global_id >= 0, f"{what} id must be >= 0, got {global_id}")
        CHECK(per_member > 0, f"no {what}s in this world")
        group = multihost.current_group()
        view = (group.members if group is not None
                else tuple(range(multihost.process_count()
                                 if self._multihost else 1)))
        member_pos = global_id // per_member
        if member_pos >= len(view):
            if elastic.enabled():
                raise MembershipChanged(
                    f"{what}_id_to_rank({global_id}) — the id maps past "
                    f"the current view", epoch=elastic.epoch(),
                    members=view)
            CHECK(False, f"{what} id {global_id} out of range for "
                         f"{len(view)} member(s) x {per_member}")
        return view[member_pos]

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
        # a DEPARTED elastic member's verb fails typed instead of forking
        # the world's state (one bool read when the plane is off)
        elastic.guard_verbs()
        if msg.msg_type not in (MsgType.Request_Get, MsgType.Request_Add):
            # a non-verb message is an ordering point: a cut or a drain
            # must include every fire-and-forget Add issued before it
            self.flush_combined_adds()
        self.server_engine.Receive(msg)

    def SendToServerMulti(self, members, tracked: bool = True) -> None:
        """Ship a batched verb submission in ONE engine mailbox hop; a
        tracked batch is an ordering point (the combine buffers ship
        first). An engine that can't flatten envelopes (the BSP SyncServer
        counts Get/Add MESSAGES into its clocks, ``MULTI_VERB_OK`` False)
        receives the members one at a time instead: same stream order,
        unbatched."""
        CHECK(self.server_engine is not None, "no server engine (ma mode?)")
        elastic.guard_verbs()
        if tracked:
            self.flush_combined_adds()
        eng = self.server_engine
        if not eng.MULTI_VERB_OK:
            for m in members:
                eng.Receive(m)
            return
        eng.receive_multi(members)

    def CallOnEngine(self, msg_type: MsgType, fn, what: str,
                     timeout_s: Optional[float] = None):
        """Run ``fn()`` on the engine thread at the current stream
        position — the consistent-cut mechanism: the engine treats any
        non-verb message as a window barrier (a cross-stream cut on the
        sharded engine), so every Add admitted before this call is applied
        first and none after. Checkpoint saves, serving publishes and
        elastic membership transitions all ride it. Returns ``fn``'s
        result; its failure re-raises here. Bounded by ``timeout_s``, else
        ``-mv_deadline_s``."""
        CHECK(self.server_engine is not None,
              f"{what} needs a server engine (not -ma mode)")
        return self._round_trip(msg_type, {"fn": fn}, what, timeout_s)

    def flush_combined_adds(self) -> None:
        """Ship every table's combine buffer (cheap when none holds an
        Add): a buffered fire-and-forget Add is never missing where the
        serial message stream would have shown it."""
        for t in self.worker_tables:
            t.FlushCombined()

    def DrainServer(self) -> None:
        """Round-trip a barrier ping through the engine: returns only after
        every request enqueued before it, fire-and-forget Adds included,
        has applied (on every shard). No-op without an engine (-ma)."""
        if self.server_engine is not None:
            self._round_trip(MsgType.Request_Barrier, {},
                             "engine barrier ping (DrainServer)")

    def _round_trip(self, msg_type: MsgType, payload: dict, what: str,
                    timeout_s: Optional[float] = None):
        """Send one non-verb message, wait for its reply (bounded by
        ``timeout_s``, else ``-mv_deadline_s``), re-raise an engine-side
        failure."""
        waiter = Waiter(1)
        msg = Message(msg_type=msg_type, payload=payload, waiter=waiter)
        self.SendToServer(msg)
        limit = timeout_s if timeout_s is not None \
            else fdeadline.timeout_or_none()
        if not waiter.Wait(limit):
            fdeadline.raise_deadline(what, limit)
        if isinstance(msg.result, Exception):
            raise msg.result
        return msg.result

    def _barrier_wait(self, leg: str) -> int:
        """One in-process barrier rendezvous, bounded by
        ``-mv_deadline_s``: a worker thread that never arrives raises
        ``DeadlineExceeded`` on every waiting thread (the barrier stays
        broken). Unset, the wait blocks and a broken barrier raises
        ``BrokenBarrierError`` as before."""
        timeout = fdeadline.timeout_or_none()
        try:
            return self._barrier.wait(timeout)
        except threading.BrokenBarrierError:
            if timeout is None:
                raise
            fdeadline.raise_deadline(f"worker barrier ({leg})")

    def Barrier(self) -> None:
        """Worker barrier (reference zoo.cpp:164-177): every in-process
        worker thread, then, in a multi-process world, every process (one
        cross-process barrier a rendezvous, issued by one thread of each
        process through ``deadline.bounded``; a failure there breaks the
        thread barrier so the other threads raise too)."""
        CHECK(self._barrier is not None, "Zoo not started")
        if self.server_engine is not None:
            # after a barrier every worker's earlier pushes are in the
            # engine stream
            self.flush_combined_adds()
        t0 = time.perf_counter()
        idx = self._barrier_wait("enter")
        if self._multihost:
            if idx == 0:
                try:
                    fdeadline.bounded(
                        lambda: multihost.host_barrier("mv_barrier"),
                        "cross-host barrier")
                except BaseException:
                    self._barrier.abort()
                    raise
            self._barrier_wait("exit")   # hold the threads until it ends
        # how long this thread sat in the barrier (straggler skew shows
        # as a wide distribution)
        tmetrics.histogram("zoo.barrier_wait_s").observe(
            time.perf_counter() - t0)

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
