"""Actor runtime: one thread + mailbox + per-MsgType handler map (the
port's own copy of ``multiverso_tpu/actor.py``, reference actor.h:18-57).

Only the server engine is an actor: it serializes Get/Add application onto
the device-resident store, the single-writer discipline the reference's
server mailbox provided.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, Dict, Optional

from multiverso_tpu_torch.message import Message, MsgType
from multiverso_tpu_torch.utils.log import CHECK, Log
from multiverso_tpu_torch.utils.mt_queue import MtQueue

#: how long Stop waits for the loop thread before abandoning it (logged)
SHUTDOWN_JOIN_S = 60.0


class ActorDied(RuntimeError):
    """The actor's loop thread died; queued and future requests fail with
    this instead of hanging."""

    def __init__(self, name: str, original: BaseException):
        super().__init__(f"actor {name} died: {original!r}")
        self.original = original


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
        """Drain + join, bounded: a stuck actor is logged with its queue
        depth instead of hanging MV_ShutDown."""
        self.mailbox.Exit()
        if self._thread is not None:
            self._thread.join(SHUTDOWN_JOIN_S)
            if self._thread.is_alive():
                Log.Error("actor %s stuck at shutdown (mailbox depth %d) — "
                          "abandoning its daemon thread", self.name,
                          self.mailbox.Size())
            self._thread = None

    def Receive(self, msg: Message) -> None:
        """Push into the mailbox (reference actor.h:45-47); raises
        ``ActorDied`` when the loop thread is dead."""
        if self._poison is not None:
            raise ActorDied(self.name, self._poison) from self._poison
        self.mailbox.Push(msg)
        if self._poison is not None:
            # lost the race with a dying loop thread: fail what is queued
            self._fail_pending(self._poison)

    def _dispatch(self, msg: Message) -> None:
        """Route one message through its handler; a failure replies to
        the caller's Wait() instead of killing the loop, unless it carries
        ``mv_fatal``: then the loop dies and every queued waiter fails."""
        handler = self._handlers.get(msg.msg_type)
        if handler is None:
            Log.Error("actor %s: unhandled message type %s", self.name,
                      msg.msg_type)
            return
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
            Log.Error("actor %s: loop thread died, poisoning mailbox:\n%s",
                      self.name, traceback.format_exc())
            self.mailbox.Exit()
            self._fail_pending(exc)
