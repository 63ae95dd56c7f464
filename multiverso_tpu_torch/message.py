"""Control-plane messages (the port's own copy of
``multiverso_tpu/message.py``, reference message.h).

A message carries (src, type, table_id, msg_id) plus a payload dict and an
in-process reply channel. ``MsgType`` numeric values mirror the reference
(message.h:13-24) and the JAX package.
"""

from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

from multiverso_tpu_torch.utils.waiter import Waiter


class MsgType(enum.IntEnum):
    Request_Get = 1
    Request_Add = 2
    Server_Finish_Train = 4
    # batched verb envelope: payload["members"] holds N pre-built
    # Request_Get/Request_Add messages that enter the engine window in
    # list order through ONE mailbox hop (sync/server.py _expand_multi)
    Request_MultiVerb = 5
    # engine drain ping: replies once every message queued before it has
    # applied (Zoo.DrainServer); never touches the BSP clocks
    Request_Barrier = 33
    # payload["fn"] runs on the engine thread at the message's stream
    # position: the consistent-cut mechanism (Zoo.CallOnEngine)
    Request_StoreLoad = 35
    # the serving plane's snapshot cut: payload["fn"] captures every table
    # at the message's stream position (serving/snapshot.py publish), the
    # same handler and barrier as Request_StoreLoad
    Request_Publish = 36
    Default = 0


def to_server(t: MsgType) -> bool:
    """A request bound for a server (reference message.h:20-31 ranges)."""
    return 0 < int(t) < 32


def to_worker(t: MsgType) -> bool:
    """A reply bound for a worker."""
    return -32 < int(t) < 0


def to_controller(t: MsgType) -> bool:
    """A control message bound for the controller."""
    return int(t) > 32


def copy_result(result):
    """Fresh buffers for a result served to more than one owner (a deduped
    Get's extra repliers): callers own and may mutate their arrays."""
    if isinstance(result, np.ndarray):
        return result.copy()
    if isinstance(result, tuple):
        return tuple(copy_result(r) for r in result)
    if isinstance(result, list):
        return [copy_result(r) for r in result]
    return result


_msg_id_counter = itertools.count(1)
_msg_id_lock = threading.Lock()


def next_msg_id() -> int:
    with _msg_id_lock:
        return next(_msg_id_counter)


#: shared first-reply-wins gate (see Message.reply)
_reply_lock = threading.Lock()


@dataclass
class Message:
    msg_type: MsgType = MsgType.Default
    table_id: int = -1
    msg_id: int = 0
    src: int = 0          # worker_id of the requester
    payload: Dict[str, Any] = field(default_factory=dict)
    # in-process reply channel: the engine stores the result and notifies
    # the waiter (reference worker.cpp:81-91, collapsed)
    waiter: Optional[Waiter] = None
    result: Any = None
    on_reply: Optional[Callable[["Message"], None]] = None
    #: telemetry (telemetry/trace.py): the sender's span context; the
    #: actor that dequeues this message parents its dispatch span here, so
    #: one span tree follows the verb across the mailbox hop
    trace_ctx: Any = None
    #: telemetry: enqueue stamp (time.perf_counter seconds), set by
    #: Actor.Receive and zeroed once the queue wait has been observed
    _enq_t: float = 0.0
    _replied: bool = False

    def reply(self, result: Any = None) -> None:
        """First reply wins: a later reply (an engine-level error after a
        successful table reply, or the dying actor's sweep racing the
        engine) can neither rewrite the result nor over-notify."""
        with _reply_lock:
            if self._replied:
                return
            self._replied = True
            self.result = result
        if self.on_reply is not None:
            self.on_reply(self)
        if self.waiter is not None:
            self.waiter.Notify()
