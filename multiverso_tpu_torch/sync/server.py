"""The async server engine (reference src/server.cpp:23-58).

Counterpart of the JAX package's ``sync/server.py`` ``Server``, single
process: the engine actor applies every Get/Add as it arrives and always
replies. Each dispatch drains a window of queued messages and applies it
with two economies:

* ADD COALESCING — all Adds to one table inside the window apply as ONE
  merged dispatch (``table.ProcessAddRun``) at the position of the table's
  first Add; a table may decline (non-linear updaters, validation doubts),
  and then each Add applies on its own. Legal under the async contract: a
  Get queued between two coalesced Adds observes more progress, never
  less.
* GET DEDUP — identical queued Gets share one gather; extra repliers get
  copies.

Any other message (FinishTrain here; checkpoint loads in a later slice)
is a window BARRIER: runs split at it and it runs in stream order, so an
Add acknowledged before it never applies after it.

Device work runs on the engine thread's current CUDA stream; a Get's
result reaches the caller through a synchronising ``.cpu()`` fetch, so a
reply never carries a tensor the device has not finished.

Later PRs: the sharded engine, the BSP ``SyncServer``, the multi-process
windows and exchange stage, and the failsafe (at-most-once dedup window,
chaos) and telemetry hooks of the JAX engine.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from multiverso_tpu_torch.actor import Actor, actor_names
from multiverso_tpu_torch.message import Message, MsgType, copy_result
from multiverso_tpu_torch.updaters.base import AddOption, GetOption
from multiverso_tpu_torch.utils.log import Log


def _fail_multi_members(env: Message) -> None:
    """on_reply of a Request_MultiVerb envelope: the only reply an envelope
    takes is a failure sweep (a dying engine) — forward it to every member
    so batch waiters raise instead of hanging."""
    if isinstance(env.result, Exception):
        for m in env.payload.get("members", ()):
            m.reply(env.result)


class Server(Actor):
    """Async server engine (reference server.cpp:23-58)."""

    #: messages drained per window
    GET_PIPELINE_WINDOW = 16

    def __init__(self, name: str = actor_names.kServer):
        super().__init__(name)
        self.store_: List = []
        #: window Add runs applied as one merged dispatch
        self.add_runs_merged = 0
        self.RegisterHandler(MsgType.Request_Get, self._get_entry)
        self.RegisterHandler(MsgType.Request_Add, self._get_entry)
        self.RegisterHandler(MsgType.Request_MultiVerb, self._get_entry)
        self.RegisterHandler(MsgType.Server_Finish_Train,
                             self.ProcessFinishTrain)

    def receive_multi(self, members) -> None:
        """Accept one batched verb submission: ONE mailbox hop carries the
        pre-built member messages in a Request_MultiVerb envelope."""
        self.Receive(Message(msg_type=MsgType.Request_MultiVerb,
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

    def _get_entry(self, msg: Message) -> None:
        """Window handler for Request_Get, Request_Add and envelopes."""
        batch = [msg]
        while len(batch) < self.GET_PIPELINE_WINDOW:
            ok, nxt = self.mailbox.TryPop()
            if not ok:
                break
            batch.append(nxt)
        self._local_window(self._expand_multi(batch))

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

    @staticmethod
    def GetServer(num_workers: int) -> "Server":
        """Engine factory (reference server.cpp:224-232). This slice has
        the async engine only, which is the JAX package's
        ``-mv_engine_shards=1`` engine."""
        return Server()
