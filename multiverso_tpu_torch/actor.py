"""Actor runtime: one thread + mailbox + per-MsgType handler map (the
port's own copy of ``multiverso_tpu/actor.py``, reference actor.h:18-57).

Only the server engine is an actor: it serializes Get/Add application onto
the device-resident store, the single-writer discipline the reference's
server mailbox provided.

Telemetry as in the JAX actor: the ``actor.<name>.mailbox_depth`` gauge,
the ``actor.<name>.queue_wait_s`` histogram, the ``actor.<name>.messages``
and ``actor.<name>.deaths`` counters, the ``actor.<name>.dispatch`` span
parented to the message's ``trace_ctx``, and the ``actor.poison`` flight
event when the loop thread dies.

Failsafe as in the JAX actor: ``Receive`` raises ``ActorDied`` once the
loop thread died; an armed chaos injector (``failsafe/chaos.py``) may
drop, duplicate or delay a table verb at its first delivery; ``Stop``
joins for ``-mv_deadline_s`` (or ``DEFAULT_SHUTDOWN_JOIN_S``) and logs a
stuck actor instead of hanging.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Dict, Optional

from multiverso_tpu_torch.failsafe import chaos
from multiverso_tpu_torch.failsafe.deadline import (DEFAULT_SHUTDOWN_JOIN_S,
                                                    deadline_s)
from multiverso_tpu_torch.failsafe.errors import ActorDied  # noqa: F401
from multiverso_tpu_torch.message import Message, MsgType
from multiverso_tpu_torch.telemetry import flight, metrics, trace
from multiverso_tpu_torch.utils.log import CHECK, Log
from multiverso_tpu_torch.utils.mt_queue import MtQueue


class actor_names:
    """reference actor.h:60-66."""

    kServer = "server"


class Actor:
    def __init__(self, name: str):
        self.name = name
        self.mailbox: MtQueue[Message] = MtQueue()
        self._handlers: Dict[MsgType, Callable[[Message], None]] = {}
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        #: the original exception once the loop thread died; Receive then
        #: raises ActorDied instead of enqueueing into a dead thread
        self._poison: Optional[BaseException] = None
        self._current_msg: Optional[Message] = None
        # mailbox backlog and how long messages sat in it (the actor-side
        # half of a verb's latency; the other half is the dispatch span)
        self._m_depth = metrics.gauge(f"actor.{name}.mailbox_depth")
        self._m_qwait = metrics.histogram(f"actor.{name}.queue_wait_s")
        self._m_received = metrics.counter(f"actor.{name}.messages")
        self._span_name = f"actor.{name}.dispatch"

    def RegisterHandler(self, msg_type: MsgType,
                        handler: Callable[[Message], None]) -> None:
        self._handlers[msg_type] = handler

    def Start(self) -> None:
        self._thread = threading.Thread(target=self._main,
                                        name=f"mvt-{self.name}", daemon=True)
        self._thread.start()
        CHECK(self._started.wait(60.0),
              f"actor {self.name} thread failed to start in 60s")

    def Stop(self) -> None:
        """Drain + join, bounded by ``-mv_deadline_s`` (or
        ``DEFAULT_SHUTDOWN_JOIN_S`` when unset): a stuck actor is logged
        with its queue depth instead of hanging MV_ShutDown."""
        self.mailbox.Exit()
        if self._thread is not None:
            self._thread.join(deadline_s() or DEFAULT_SHUTDOWN_JOIN_S)
            if self._thread.is_alive():
                Log.Error("actor %s stuck at shutdown (mailbox depth %d) — "
                          "abandoning its daemon thread", self.name,
                          self.mailbox.Size())
            self._thread = None

    def Receive(self, msg: Message) -> None:
        """Push into the mailbox (reference actor.h:45-47); raises
        ``ActorDied`` when the loop thread is dead. An armed chaos
        injector may drop (redeliver later), duplicate or delay a table
        verb here, one decision per first delivery."""
        if self._poison is not None:
            raise ActorDied(self.name, self._poison) from self._poison
        cz = chaos.get()
        if (cz is not None
                and msg.msg_type in (MsgType.Request_Get,
                                     MsgType.Request_Add)
                and not getattr(msg, "_fs_chaos_done", False)):
            # redeliveries and dups do not roll the dice again: the
            # schedules stay lockstep across ranks running one program
            msg._fs_chaos_done = True
            action = cz.mailbox_action()
            if action == "dup":
                self._push(msg)       # the same object twice: the
                self._push(msg)       # engine's admission drops the copy
                return
            if action in ("drop", "delay"):
                chaos.schedule_redelivery(self._push, msg, action,
                                          cz.param(f"mailbox.{action}"))
                return
        self._push(msg)

    def _push(self, msg: Message) -> None:
        msg._enq_t = time.perf_counter()
        self.mailbox.Push(msg)
        self._m_received.inc()
        self._m_depth.set(self.mailbox.Size())
        if self._poison is not None:
            # lost the race with a dying loop thread: fail what is queued
            self._fail_pending(self._poison)

    def note_dequeue(self, msg: Message) -> None:
        """Telemetry at the moment a message leaves the mailbox: its queue
        wait, the refreshed depth gauge and the end of its flow arrow.
        Once per message (an engine drains a window with TryPop and then
        passes the head back through ``_dispatch``)."""
        if msg._enq_t:
            self._m_qwait.observe(time.perf_counter() - msg._enq_t)
            msg._enq_t = 0.0
            self._m_depth.set(self.mailbox.Size())
            trace.flow_end(msg.trace_ctx)

    def _dispatch(self, msg: Message) -> None:
        """Route one message through its handler; a failure replies to
        the caller's Wait() instead of killing the loop, unless it carries
        ``mv_fatal``: then the loop dies and every queued waiter fails."""
        self.note_dequeue(msg)
        handler = self._handlers.get(msg.msg_type)
        if handler is None:
            Log.Error("actor %s: unhandled message type %s", self.name,
                      msg.msg_type)
            return
        # the span's args are built only when tracing is on: this is the
        # one span entry on the per-message path
        with trace.span(self._span_name, cat="actor",
                        parent=msg.trace_ctx,
                        args=({"msg_type": int(msg.msg_type)}
                              if trace.enabled() else None)):
            try:
                handler(msg)
            except Exception as exc:
                if getattr(exc, "mv_fatal", False):
                    # the handler left the actor unsound (a multi-process
                    # window stream desynced): the loop dies and poisons
                    raise
                Log.Error("actor %s: handler for %s raised: %r", self.name,
                          msg.msg_type, exc)
                msg.reply(exc)

    def _fail_pending(self, original: BaseException) -> None:
        died = ActorDied(self.name, original)
        died.__cause__ = original
        cur = self._current_msg
        if cur is not None:
            cur.reply(died)
        while True:
            ok, m = self.mailbox.TryPop()
            if not ok:
                return
            m.reply(died)

    def _main(self) -> None:
        self._started.set()
        try:
            while True:
                ok, msg = self.mailbox.Pop()
                if not ok:
                    break
                self._current_msg = msg
                self._dispatch(msg)
                self._current_msg = None
        except BaseException as exc:
            self._poison = exc
            metrics.counter(f"actor.{self.name}.deaths").inc()
            flight.record("actor.poison",
                          detail=f"{self.name}: {type(exc).__name__}")
            Log.Error("actor %s: loop thread died, poisoning mailbox:\n%s",
                      self.name, traceback.format_exc())
            self.mailbox.Exit()
            self._fail_pending(exc)
