"""Table interfaces: worker side (async handles) and server side (the
device-resident store).

Counterpart of ``multiverso_tpu/tables/base.py`` (reference
table_interface.h, src/table.cpp):

* ``WorkerTable`` allocates per-request msg ids, keeps a Waiter per
  in-flight request, and offers ``Wait(GetAsync/AddAsync)``; untracked
  fire-and-forget Adds allocate nothing.
* ``ServerTable`` declares ``ProcessAdd``/``ProcessGet``, the engine's
  two-phase Get and merged-Add hooks, the multi-process parts verbs
  (``ProcessAddParts``, ``ProcessGetParts``, ``ProcessAddRunParts``,
  ``ProcessGetWindowParts``) and the Store/Load contract.
* ``MultiCall``/``submit_multi`` batch N verbs into ONE engine mailbox
  hop; ``CreateTable`` builds both halves and registers them.

Requests go to the single engine actor, which serializes application onto
the store. Worker-side write combining and the staleness-bounded Get cache
of the JAX package are later work: they change no result for the linear
updaters, only the number of mailbox hops.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from multiverso_tpu_torch.message import Message, MsgType, next_msg_id
from multiverso_tpu_torch.updaters.base import AddOption, GetOption
from multiverso_tpu_torch.utils.log import CHECK
from multiverso_tpu_torch.utils.waiter import Waiter


@dataclass
class TableOption:
    """Base table creation record (reference CreateTableOption structs)."""

    dtype: Any = np.float32
    #: opt-in compression of row Adds on their way to the device: "sparse"
    #: (exact: (index, value) pairs when more than half the payload is
    #: zero, the dense payload otherwise) or "1bit" (lossy: sign bits and
    #: two means a row, with per-row error feedback). The payload crosses
    #: to the device compressed and is rebuilt there. None = off. A table
    #: type without a compressed wire leaves ``_supports_compress`` False
    #: and ``CreateTable`` refuses the option.
    compress: Any = None
    _supports_compress = False


class ServerTable:
    """Server half: owns the device store (table_interface.h:61-79)."""

    def ProcessAdd(self, **payload) -> None:
        raise NotImplementedError

    def ProcessGet(self, **payload) -> Any:
        raise NotImplementedError

    def ProcessGetAsync(self, **payload):
        """Two-phase Get: dispatch the device work now and return a
        zero-arg finalize producing the host result, or None when the
        table can't split the phases (the engine then calls ProcessGet).
        A window's Gets dispatch first and finalize after, so their
        device work queues back to back."""
        return None

    def ProcessAddRun(self, payloads) -> bool:
        """Apply a window's queued Adds to this table as ONE merged
        dispatch; True when handled, False to decline. CONTRACT: validate
        everything BEFORE mutating state."""
        return False

    # -- the multi-process window protocol (sync/server.py): the engine
    # exchanges a window of verbs between the processes and hands every
    # rank's payloads down, so each process applies identical merged data
    # to its replica and serves its own Gets from it. The hooks issue no
    # collective of their own. DETERMINISM CONTRACT: given identical
    # ``parts``, every rank makes identical mutate-or-raise decisions, or
    # the replicas diverge. The defaults apply THIS rank's payload alone,
    # which only a table without replicated state may keep.

    def ProcessAddParts(self, parts, my_rank: int) -> None:
        """Apply ONE logical collective Add given every rank's payload dict
        in rank order (``parts[my_rank]`` is this rank's own)."""
        self.ProcessAdd(**parts[my_rank])

    @staticmethod
    def _norm_parts_options(parts) -> list:
        """Every rank's Add option in rank order, ``None`` normalized to
        the default: a rank that spelled the default as None is not
        divergent."""
        return [p.get("option") or AddOption() for p in parts]

    @classmethod
    def _check_parts_options(cls, parts) -> list:
        """Normalized options, CHECK-failing when the ranks truly diverge
        (the SPMD collective contract)."""
        opts = cls._norm_parts_options(parts)
        CHECK(all(o == opts[0] for o in opts),
              f"collective Add options diverge across processes: {opts}")
        return opts

    def ProcessGetParts(self, parts, my_rank: int):
        """Serve ONE logical collective Get for THIS rank given every
        rank's payload dict in rank order; returns this rank's result."""
        return self.ProcessGet(**parts[my_rank])

    def ProcessAddRunParts(self, positions, my_rank: int) -> bool:
        """Cross-rank add coalescing: ``positions`` lists, per window
        position, every rank's payload dict. Apply them all as merged
        dispatches and return True, or False to decline (the engine then
        runs ProcessAddParts per position). Validate before mutating."""
        return False

    def ProcessGetWindowParts(self, positions, my_rank: int):
        """Serve a window segment's Gets to this table in one shot: a list
        of this rank's results (an Exception entry fails that position
        only), or None to decline (ProcessGetParts per position). This
        default dispatches every position's own Get first
        (``ProcessGetAsync``; ``ProcessGetParts`` where the table cannot
        split the phases) and finalizes after, so the device work of the
        segment queues back to back, as in a single-process window."""
        pending = []
        for parts in positions:
            try:
                fin = self.ProcessGetAsync(**parts[my_rank])
                if fin is None:
                    res = self.ProcessGetParts(parts, my_rank)
                    fin = lambda res=res: res  # noqa: E731
                pending.append(fin)
            except Exception as exc:
                pending.append(exc)
        out = []
        for fin in pending:
            if isinstance(fin, Exception):
                out.append(fin)
                continue
            try:
                out.append(fin())
            except Exception as exc:
                out.append(exc)
        return out

    def mh_apply_is_local(self) -> bool:
        """True when every parts apply and serve of this table runs on
        this process alone, with no collective: the pipelined engine may
        then apply window N while window N+1 is exchanged. Every port
        table applies to its own replica; a table whose apply issues a
        collective must answer False (rank-agreed), and the engine then
        fences its windows."""
        return True

    def Store(self, stream) -> None:
        raise NotImplementedError

    def Load(self, stream) -> None:
        raise NotImplementedError


class MultiCall:
    """Handle for one batched verb submission: one counting Waiter covers
    every tracked member; results land in submission order. ``Wait``
    raises the first member error unless ``return_exceptions``."""

    __slots__ = ("_waiter", "_results", "_n")

    def __init__(self, n_tracked: int, n_members: int):
        self._waiter = Waiter(n_tracked) if n_tracked else None
        self._results: list = [None] * n_members
        self._n = n_members

    def _member_cb(self, idx: int):
        def _on_reply(msg) -> None:
            self._results[idx] = msg.result
        return _on_reply

    def Wait(self, return_exceptions: bool = False) -> list:
        if self._waiter is not None:
            self._waiter.Wait()
        if not return_exceptions:
            for r in self._results:
                if isinstance(r, Exception):
                    raise r
        return list(self._results)


class WorkerTable:
    """Worker half: request construction + waiter bookkeeping."""

    def __init__(self):
        from multiverso_tpu_torch.zoo import Zoo
        self._zoo = Zoo.Get()
        self.table_id: int = -1
        self._lock = threading.Lock()
        self._waiters: Dict[int, Waiter] = {}
        self._results: Dict[int, Any] = {}

    def _submit(self, msg_type: MsgType, payload: Dict[str, Any],
                worker_id: int, track: bool = True) -> int:
        """Build + enqueue a request message; returns its msg_id
        (reference table.cpp:41-82). ``track=False`` is fire-and-forget:
        no Waiter or result slot; per-table FIFO order at the engine
        mailbox still makes a later tracked Get observe the push."""
        msg_id = next_msg_id()
        msg = Message(msg_type=msg_type, table_id=self.table_id,
                      msg_id=msg_id, src=worker_id, payload=payload)
        if track:
            waiter = Waiter(1)
            with self._lock:
                self._waiters[msg_id] = waiter
            msg.waiter = waiter
            msg.on_reply = self._on_reply
        self._zoo.SendToServer(msg)
        return msg_id

    def _on_reply(self, msg: Message) -> None:
        with self._lock:
            if msg.msg_id in self._waiters:
                self._results[msg.msg_id] = msg.result

    def Wait(self, msg_id: int) -> Any:
        """Block until the request's reply arrived; return its result or
        raise the server-side failure (reference table.cpp:84-95)."""
        with self._lock:
            waiter = self._waiters.get(msg_id)
        CHECK(waiter is not None, f"unknown msg_id {msg_id}")
        waiter.Wait()
        with self._lock:
            self._waiters.pop(msg_id, None)
            result = self._results.pop(msg_id, None)
        if isinstance(result, Exception):
            raise result
        return result

    def GetAsync(self, payload: Dict[str, Any],
                 option: Optional[GetOption] = None) -> int:
        opt = option or GetOption(worker_id=self._zoo.current_worker_id())
        payload = dict(payload, option=opt)
        return self._submit(MsgType.Request_Get, payload, opt.worker_id)

    def AddAsync(self, payload: Dict[str, Any],
                 option: Optional[AddOption] = None,
                 track: bool = True) -> int:
        opt = option or AddOption(worker_id=self._zoo.current_worker_id())
        payload = dict(payload, option=opt)
        return self._submit(MsgType.Request_Add, payload, opt.worker_id,
                            track=track)

    # -- batched verbs --------------------------------------------------------

    def _multi_member(self, kind: str, payload: Dict[str, Any], option,
                      call: MultiCall, idx: int, track: bool) -> Message:
        CHECK(kind in ("A", "G"), f"multi member kind {kind!r}")
        if kind == "A":
            opt = option or AddOption(
                worker_id=self._zoo.current_worker_id())
            msg_type = MsgType.Request_Add
        else:
            opt = option or GetOption(
                worker_id=self._zoo.current_worker_id())
            msg_type = MsgType.Request_Get
            track = True        # a Get's whole point is its result
        return Message(
            msg_type=msg_type, table_id=self.table_id, msg_id=next_msg_id(),
            src=opt.worker_id, payload=dict(payload, option=opt),
            waiter=call._waiter if track else None,
            on_reply=call._member_cb(idx) if track else None)

    def MultiAddAsync(self, payloads, option=None,
                      track: bool = True) -> MultiCall:
        """N Adds to THIS table in one batch (one mailbox hop); per-table
        op order is submission order."""
        return submit_multi([(self, "A", p) for p in payloads],
                            option=option, track=track)

    def MultiGetAsync(self, payloads, option=None) -> MultiCall:
        """N Gets to THIS table in one batch; ``Wait`` returns the results
        in submission order."""
        return submit_multi([(self, "G", p) for p in payloads],
                            option=option)

    def MultiAdd(self, payloads, option=None) -> None:
        self.MultiAddAsync(payloads, option=option).Wait()

    def MultiGet(self, payloads, option=None) -> list:
        return self.MultiGetAsync(payloads, option=option).Wait()


def submit_multi(records, option=None, track: bool = True) -> MultiCall:
    """Cross-table batched submission: ``records`` is a list of
    ``(worker_table, kind, payload)`` with ``kind`` ``'A'``/``'G'``. All
    records ship in ONE engine mailbox envelope and enter the verb stream
    in list order. Gets are always tracked; ``track=False`` makes the Adds
    fire-and-forget."""
    from multiverso_tpu_torch.zoo import Zoo
    n_tracked = sum(1 for _, kind, _ in records if kind == "G" or track)
    call = MultiCall(n_tracked, len(records))
    members = [table._multi_member(kind, payload, option, call, idx, track)
               for idx, (table, kind, payload) in enumerate(records)]
    if members:
        Zoo.Get().SendToServerMulti(members)
    return call


def CreateTable(option: TableOption):
    """Instantiate the server + worker halves and wire them to the engine
    (reference table_factory.h:16-27)."""
    from multiverso_tpu_torch.zoo import Zoo
    CHECK(option.compress is None or option._supports_compress,
          f"table type {type(option).__name__} has no compressed wire "
          f"(compress={option.compress!r})")
    zoo = Zoo.Get()
    CHECK(zoo.started, "MV_CreateTable needs a started world (MV_Init)")
    server_table = option.make_server(zoo)
    table_id = zoo.RegisterServerTable(server_table)
    worker_table = option.make_worker(zoo)
    worker_table.table_id = table_id
    zoo.RegisterWorkerTable(worker_table)
    return worker_table
