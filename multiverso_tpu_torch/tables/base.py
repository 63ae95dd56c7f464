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
the store. Two worker-side fast paths sit in front of it, as in the JAX
package:

* WRITE COMBINING (``-mv_write_combine``, 8 by default): up to N
  consecutive fire-and-forget Adds to one table, with one option, wait in
  the table's buffer and ship as ONE merged Add (the table's
  ``_combine_fire_forget``). The cap counts members, never bytes, so the
  ranks of a multi-process world flush at the same call positions. Every
  ordering point flushes first: a tracked verb on any table, a
  non-combinable push to the table, an untracked batch touching it, and
  the Zoo's barrier, drain, cut and shutdown paths (``Zoo.SendToServer``).
* THE GET CACHE (``-mv_get_staleness``, 0 = off): a repeated identical Get
  is served from the last fetched result while the engine stream that
  applies the table has run at most N windows since the fill and this
  process wrote nothing to the table (read-your-writes). One process and
  the async engines only: a hit removes a verb from the stream.

Telemetry as in the JAX package: per-table ``table.<label><id>.{get,add}.
{count,bytes}`` counters, the ``worker.write_combine_hits`` and
``worker.get_cache_hits`` counters, the ``digest.worker.rtt_s`` digest of a
batch's round trip, the ``WORKER_TABLE_SYNC_GET``/``_ADD`` Dashboard
monitors, and the worker span whose context rides the message across the
mailbox hop. A server table's ``ledger_bytes`` is the byte ledger's probe
(``telemetry/accounting.py``).

Failsafe as in the JAX package (``failsafe/``): a tracked request keeps
its ``(msg_type, payload, src)`` until ``Wait``; ``Wait`` is bounded by
``-mv_deadline_s`` (expiry drops every bookkeeping slot of the request and
raises ``DeadlineExceeded`` with the diagnostic bundle) and retries a
``TransientError`` reply up to ``-mv_max_retries`` times with exponential
backoff and jitter, resending the request under its ORIGINAL msg_id: the
engine's dedup window makes the retry at-most-once. ``MultiCall.Wait`` is
bounded too; its members do not retry (the failure surfaces per member).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from multiverso_tpu_torch.failsafe import deadline as fdeadline
from multiverso_tpu_torch.failsafe.errors import TransientError
from multiverso_tpu_torch.message import (Message, MsgType, copy_result,
                                          next_msg_id)
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.parallel.wire import payload_nbytes
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.updaters.base import AddOption, GetOption
from multiverso_tpu_torch.utils.configure import cached_int_flag
from multiverso_tpu_torch.utils.dashboard import monitor_region
from multiverso_tpu_torch.utils.log import CHECK, Log
from multiverso_tpu_torch.utils.waiter import Waiter

#: retry backoff: base * 2**attempt plus uniform jitter of one base (the
#: transients here are engine-side or momentary, not WAN outages)
_RETRY_BACKOFF_BASE_S = 0.02

#: listener-refreshed (Wait runs once per tracked verb); the flag is
#: defined in failsafe/deadline.py
_max_retries_flag = cached_int_flag("mv_max_retries", 3)
#: the worker fast paths' flags (defined in sync/server.py), read once per
#: fire-and-forget Add and once per Get through listener caches, as the
#: JAX package's tables/base.py reads them
_write_combine_flag = cached_int_flag("mv_write_combine", 8)
_get_staleness_flag = cached_int_flag("mv_get_staleness", 0)

#: distinct request keys the Get cache keeps per table (training loops
#: reuse a handful of request shapes; the oldest entry goes first)
_GET_CACHE_ENTRIES = 64


def _result_nbytes(result) -> int:
    """Host bytes a cached result holds: arrays by ``nbytes``, one
    container level deep."""
    if isinstance(result, np.ndarray):
        return int(result.nbytes)
    if isinstance(result, (tuple, list)):
        return sum(_result_nbytes(r) for r in result)
    return 0


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

    #: the replica plane's publish journal (``replica/delta.py``),
    #: attached at RegisterTable when this rank fans out, None otherwise
    #: (one attribute read an apply). CONTRACT: every APPLIED Add marks
    #: it, after the data update (a rejected Add never dirties it): the
    #: matrix families through the ``_note_add_parts`` hook, kv at its
    #: applies, array at its apply. ``publish_journal_kind`` picks the
    #: granularity: "rows" (a row bitmap), "keys" (the write-set of
    #: touched keys), "all" (a whole-table flag)
    _pub_journal = None
    publish_journal_kind = "all"

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

    # -- the device window transport (sync/server.py, parallel/
    # device_wire.py; the JAX package's tables/base.py:236-275). When the
    # engine defers an Add's values to the device wire, the window carries
    # only their dtype and shape (``flat.DeferredArray``) and every rank
    # routes that position through ``ProcessAddPartsDevice`` (the deferral
    # is visible in the exchanged metadata, so the decision is lockstep).
    # A table opts in per payload with ``device_wire_add_ok``.

    def device_wire_add_ok(self, payload) -> bool:
        """True when this table can apply ``payload`` as an Add whose
        ``values`` bytes never cross the host wire. Default False: the
        engine never defers for a table that does not opt in, so
        ``ProcessAddPartsDevice`` stays unreachable for it."""
        return False

    def ProcessAddPartsDevice(self, parts, my_rank: int) -> None:
        """Apply ONE collective Add whose values ride the device wire:
        ``parts`` is every rank's payload in rank order, a deferred value a
        ``DeferredArray`` located in its writer's staging slot (this rank's
        own also keeps its array in ``.local``); the values come through
        ``device_wire.current().gather``. Only reachable after
        ``device_wire_add_ok`` accepted the payload at pack time."""
        raise NotImplementedError(
            "device-wire Add routed to a table without "
            "ProcessAddPartsDevice (device_wire_add_ok must stay False "
            "for such tables)")

    def ProcessAddRunPartsDevice(self, positions, my_rank: int) -> bool:
        """Merged device-wire run: a window's deferred collective Adds
        (``positions``: per window position, every rank's payload) in ONE
        apply, returning True, or False to decline (per-position
        ``ProcessAddPartsDevice`` then runs). The ``ProcessAddRunParts``
        contract: linear updaters, validate before mutating, and every rank
        reaches the same decision from the exchanged metadata."""
        return False

    def mh_apply_is_local(self) -> bool:
        """True when every parts apply and serve of this table runs on
        this process alone, with no collective: the pipelined engine may
        then apply window N while window N+1 is exchanged. Every port
        table applies to its own replica; a table whose apply issues a
        collective must answer False (rank-agreed), and the engine then
        fences its windows."""
        return True

    def mh_prepare_local_apply(self) -> None:
        """Called at table registration by a sharded multi-process engine,
        a lockstep position before any verb reaches the table: build any
        host mirror the table's applies use (a CPU matrix table's native
        store), so the first window finds it. Default: nothing to build."""

    # -- the serving plane (serving/snapshot.py): called ON the engine thread
    # inside the publish cut, so every Add admitted before the cut is in
    # and none after. CONTRACT: the returned TableSnapshot is IMMUTABLE and
    # self-contained (it outlives later training, and the port's updates
    # write storage in place, so it aliases no live buffer), and its values
    # equal what a training Get at this stream position returns.

    def serving_export(self):
        """A ``serving.snapshot.TableSnapshot`` of this table at the current
        stream position, or None (the family is not servable)."""
        return None

    # -- the byte ledger (telemetry/accounting.py): a sampling probe, called
    # from the ops handler, the watchdog tick or a Dashboard render. It
    # NEVER syncs the device, launches a kernel, or makes a host copy: no
    # ``.item()``, ``.cpu()`` or ``torch.cuda.synchronize()``, only the
    # storage sizes the tensors already know. Keys: ``device_bytes`` (the
    # table's tensors on its device: the STORAGE bytes, padded rows and
    # columns included), ``host_mirror_bytes`` (host copies of device
    # state: a CPU matrix table's native store) and ``host_bytes``
    # (host-authoritative state: numpy arrays; tensors of a table on the
    # CPU are its device).

    def ledger_bytes(self) -> Dict[str, int]:
        """Byte placement of this table's live state: every tensor reached
        from ``state`` (the data and the updater's aux state) counts its
        storage once, every numpy array its ``nbytes`` as host bytes."""
        out = {"device_bytes": 0, "host_mirror_bytes": 0, "host_bytes": 0}
        ledger_walk(vars(self).get("state"), out, set())
        return out

    def Store(self, stream) -> None:
        raise NotImplementedError

    def Load(self, stream) -> None:
        raise NotImplementedError


def ledger_walk(obj, out: Dict[str, int], seen: set) -> None:
    """Add the bytes of every tensor (storage bytes, each storage once) and
    numpy array reached through dicts, lists and tuples in ``obj`` to
    ``out``. Reads sizes only."""
    import torch
    if isinstance(obj, torch.Tensor):
        st = obj.untyped_storage()
        key = (str(obj.device), st.data_ptr())
        if key not in seen:
            seen.add(key)
            out["device_bytes"] += int(st.nbytes())
    elif isinstance(obj, np.ndarray):
        out["host_bytes"] += int(obj.nbytes)
    elif isinstance(obj, dict):
        for v in obj.values():
            ledger_walk(v, out, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            ledger_walk(v, out, seen)


class MultiCall:
    """Handle for one batched verb submission: one counting Waiter covers
    every tracked member; results land in submission order. ``Wait``
    raises the first member error unless ``return_exceptions``."""

    __slots__ = ("_waiter", "_results", "_n", "_t0")

    def __init__(self, n_tracked: int, n_members: int):
        self._waiter = Waiter(n_tracked) if n_tracked else None
        self._results: list = [None] * n_members
        self._n = n_members
        #: submission stamp for the round-trip digest (digest.worker.rtt_s),
        #: observed once, at the first Wait that sees every reply
        self._t0 = time.perf_counter() if n_tracked else None

    def _member_cb(self, idx: int):
        def _on_reply(msg) -> None:
            self._results[idx] = msg.result
        return _on_reply

    def Wait(self, deadline: Optional[float] = None,
             return_exceptions: bool = False) -> list:
        """Block until every tracked member replied; the member results in
        submission order (None for untracked members). Bounded by
        ``deadline`` seconds when given, else ``-mv_deadline_s``."""
        if self._waiter is not None:
            timeout = (float(deadline) if deadline is not None
                       else fdeadline.timeout_or_none())
            if not self._waiter.Wait(timeout):
                fdeadline.raise_deadline(
                    f"multi-verb batch replies ({self._n} members)")
            if self._t0 is not None:
                tmetrics.digest("digest.worker.rtt_s").observe(
                    time.perf_counter() - self._t0)
                self._t0 = None
        if not return_exceptions:
            for r in self._results:
                if isinstance(r, Exception):
                    raise r
        return list(self._results)


class WorkerTable:
    """Worker half: request construction + waiter bookkeeping."""

    #: short telemetry family tag (array / matrix / sparse_matrix / kv):
    #: per-table instrument names read like "table.matrix0.add.count"
    telemetry_label = "table"

    def __init__(self):
        from multiverso_tpu_torch.zoo import Zoo
        self._zoo = Zoo.Get()
        self.table_id: int = -1
        self._lock = threading.Lock()
        self._waiters: Dict[int, Waiter] = {}
        self._results: Dict[int, Any] = {}
        #: tracked requests' (msg_type, payload, src), kept until Wait so
        #: a TransientError reply can resend the SAME request under the
        #: SAME msg_id (the engine dedup window's retry identity)
        self._inflight: Dict[int, tuple] = {}
        # -- write combining (-mv_write_combine) --
        #: buffered fire-and-forget Add payloads awaiting one combined
        #: mailbox hop, their shared option and the worker whose run it is
        #: (an option or worker change flushes first)
        self._wc_buf: list = []
        self._wc_option: Optional[AddOption] = None
        self._wc_src: int = 0
        # -- the staleness-bounded Get cache (-mv_get_staleness) --
        #: request key -> (the table's stream epoch at the fill, this
        #: table's write epoch at the fill, the pristine result), oldest
        #: first
        self._gc_cache: Dict[Any, tuple] = {}
        #: results parked for cache-served pseudo handles (negative ids)
        self._gc_results: Dict[int, Any] = {}
        self._gc_next_hit = -1
        #: msg_id -> (key, epochs at submit) of in-flight Gets whose reply
        #: (re)fills the cache
        self._gc_fill: Dict[int, tuple] = {}
        #: bumped by every Add this process issues to the table (tracked,
        #: fire-and-forget, buffered or batched): a cached read never
        #: survives the owner's own write
        self._write_epoch = 0
        self._gc_enabled: Optional[bool] = None      # fixed per world
        #: the first buffered member's span context: the combined message
        #: belongs to the Adds' trace, not to the verb that flushed it
        self._wc_ctx = None
        self._tele: Optional[Dict[str, Any]] = None

    def _tele_verbs(self) -> Dict[str, Any]:
        """Per-table per-verb count/byte counters, fetched lazily (the
        table id is assigned after construction)."""
        if self._tele is None:
            base = f"table.{self.telemetry_label}{self.table_id}"
            self._tele = {
                "get_n": tmetrics.counter(f"{base}.get.count"),
                "get_b": tmetrics.counter(f"{base}.get.bytes"),
                "add_n": tmetrics.counter(f"{base}.add.count"),
                "add_b": tmetrics.counter(f"{base}.add.bytes"),
            }
        return self._tele

    def _submit(self, msg_type: MsgType, payload: Dict[str, Any],
                worker_id: int, track: bool = True) -> int:
        """Build + enqueue a request message; returns its msg_id
        (reference table.cpp:41-82). ``track=False`` is fire-and-forget:
        no Waiter or result slot; per-table FIFO order at the engine
        mailbox still makes a later tracked Get observe the push. A
        tracked verb is an ordering point: every table's combine buffer
        ships first, so its reply shows at least the progress the serial
        message stream would have."""
        if track:
            self._zoo.flush_combined_adds()
        msg_id = next_msg_id()
        msg = Message(msg_type=msg_type, table_id=self.table_id,
                      msg_id=msg_id, src=worker_id, payload=payload)
        if track:
            waiter = Waiter(1)
            with self._lock:
                self._waiters[msg_id] = waiter
                self._inflight[msg_id] = (msg_type, payload, worker_id)
            msg.waiter = waiter
            msg.on_reply = self._on_reply
        # the worker span's context crosses the mailbox hop (the engine
        # parents its dispatch span here), with its flow arrow
        msg.trace_ctx = ttrace.current_ctx()
        ttrace.flow_start(msg.trace_ctx)
        self._zoo.SendToServer(msg)
        return msg_id

    def _on_reply(self, msg: Message) -> None:
        with self._lock:
            # a reply to an abandoned request (its deadline dropped the
            # slots) must not repopulate _results: nothing would pop it
            if msg.msg_id in self._waiters:
                self._results[msg.msg_id] = msg.result

    def _resubmit(self, msg_id: int) -> Waiter:
        """Resend a tracked request under its ORIGINAL msg_id after a
        TransientError: the engine's (src, msg_id) dedup window is what
        makes the retry at-most-once for Adds."""
        with self._lock:
            msg_type, payload, src = self._inflight[msg_id]
            waiter = Waiter(1)
            self._waiters[msg_id] = waiter
            self._results.pop(msg_id, None)
        msg = Message(msg_type=msg_type, table_id=self.table_id,
                      msg_id=msg_id, src=src, payload=payload,
                      waiter=waiter, on_reply=self._on_reply)
        msg.trace_ctx = ttrace.current_ctx()
        ttrace.flow_start(msg.trace_ctx)
        self._zoo.SendToServer(msg)
        return waiter

    def Wait(self, msg_id: int) -> Any:
        """Block until the request's reply arrived; return its result or
        raise the server-side failure (reference table.cpp:84-95). A
        negative id is a Get served from the cache: its parked copy is the
        result. Bounded by ``-mv_deadline_s`` (expiry abandons the
        request: every slot is dropped, a late reply is ignored); a
        ``TransientError`` reply is retried up to ``-mv_max_retries``
        times with exponential backoff and jitter."""
        if msg_id < 0:
            with self._lock:
                return self._gc_results.pop(msg_id)
        with self._lock:
            waiter = self._waiters.get(msg_id)
        CHECK(waiter is not None, f"unknown msg_id {msg_id}")
        max_retries = _max_retries_flag()
        attempt = 0
        while True:
            if not waiter.Wait(fdeadline.timeout_or_none()):
                try:
                    # the bundle first (it reports THIS request), then
                    # abandon it: an app catching DeadlineExceeded per
                    # request must not leak a waiter and a pinned payload
                    fdeadline.raise_deadline(
                        f"table {self.table_id} reply to msg_id {msg_id}")
                finally:
                    with self._lock:
                        self._waiters.pop(msg_id, None)
                        self._inflight.pop(msg_id, None)
                        self._results.pop(msg_id, None)
                        self._gc_fill.pop(msg_id, None)
            with self._lock:
                result = self._results.pop(msg_id, None)
            if isinstance(result, TransientError) and attempt < max_retries:
                attempt += 1
                tmetrics.counter("failsafe.retries").inc()
                backoff = _RETRY_BACKOFF_BASE_S * (2 ** (attempt - 1))
                backoff += random.random() * _RETRY_BACKOFF_BASE_S
                Log.Debug("table %d msg_id %d transient (%r): retry %d/%d "
                          "in %.3fs", self.table_id, msg_id, result,
                          attempt, max_retries, backoff)
                time.sleep(backoff)
                waiter = self._resubmit(msg_id)
                continue
            break
        with self._lock:
            self._waiters.pop(msg_id, None)
            self._inflight.pop(msg_id, None)
            fill = self._gc_fill.pop(msg_id, None)
        if isinstance(result, Exception):
            raise result
        if fill is not None:
            self._gc_store(fill[0], result, fill[1], fill[2])
        return result

    def _bump_write_epoch(self) -> None:
        """Read-your-writes: every Add invalidates the table's cached Gets
        (under the lock: worker threads share the table)."""
        with self._lock:
            self._write_epoch += 1

    def GetAsync(self, payload: Dict[str, Any],
                 option: Optional[GetOption] = None) -> int:
        with monitor_region("WORKER_TABLE_SYNC_GET"):
            opt = option or GetOption(
                worker_id=self._zoo.current_worker_id())
            payload = dict(payload, option=opt)
            tele = self._tele_verbs()
            tele["get_n"].inc()
            tele["get_b"].inc(payload_nbytes(payload))
            hit, key = self._gc_probe(payload)
            if hit is not None:
                return hit
            with ttrace.span("worker.get", cat="worker",
                             args={"table_id": self.table_id}):
                handle = self._submit(MsgType.Request_Get, payload,
                                      opt.worker_id)
            if key is not None:
                # a miss under an active bound: the reply fills the
                # entry, dated by BOTH clocks as they stand at submit (the
                # engine serves the Get at this window or later, and a
                # concurrent worker's Add between submit and Wait must
                # invalidate it)
                eng = self._zoo.server_engine
                with self._lock:
                    self._gc_fill[handle] = (
                        key, eng.epoch_for_table(self.table_id),
                        self._write_epoch)
            return handle

    def AddAsync(self, payload: Dict[str, Any],
                 option: Optional[AddOption] = None,
                 track: bool = True) -> int:
        with monitor_region("WORKER_TABLE_SYNC_ADD"):
            opt = option or AddOption(
                worker_id=self._zoo.current_worker_id())
            payload = dict(payload, option=opt)
            tele = self._tele_verbs()
            tele["add_n"].inc()
            tele["add_b"].inc(payload_nbytes(payload))
            self._bump_write_epoch()
            with ttrace.span("worker.add", cat="worker",
                             args={"table_id": self.table_id}):
                if not track:
                    if self._wc_try_buffer(payload, opt):
                        return 0
                    # a non-combinable push: the buffered Adds still go
                    # first (per-table FIFO)
                    self.FlushCombined()
                return self._submit(MsgType.Request_Add, payload,
                                    opt.worker_id, track=track)

    # -- batched verbs --------------------------------------------------------

    def _multi_member(self, kind: str, payload: Dict[str, Any], option,
                      call: MultiCall, idx: int, track: bool) -> Message:
        CHECK(kind in ("A", "G"), f"multi member kind {kind!r}")
        tele = self._tele_verbs()
        if kind == "A":
            opt = option or AddOption(
                worker_id=self._zoo.current_worker_id())
            msg_type = MsgType.Request_Add
            self._bump_write_epoch()    # as a single Add would
        else:
            opt = option or GetOption(
                worker_id=self._zoo.current_worker_id())
            msg_type = MsgType.Request_Get
            track = True        # a Get's whole point is its result
        payload = dict(payload, option=opt)
        verb = "add" if kind == "A" else "get"
        tele[f"{verb}_n"].inc()
        tele[f"{verb}_b"].inc(payload_nbytes(payload))
        msg = Message(
            msg_type=msg_type, table_id=self.table_id, msg_id=next_msg_id(),
            src=opt.worker_id, payload=payload,
            waiter=call._waiter if track else None,
            on_reply=call._member_cb(idx) if track else None)
        msg.trace_ctx = ttrace.current_ctx()
        return msg

    def MultiAddAsync(self, payloads, option=None,
                      track: bool = True) -> MultiCall:
        """N Adds to THIS table in one batch (one mailbox hop); per-table
        op order is submission order."""
        return submit_multi([(self, "A", p) for p in payloads],
                            option=option, track=track)

    def MultiGetAsync(self, payloads, option=None) -> MultiCall:
        """N Gets to THIS table in one batch; ``Wait`` returns the results
        in submission order. Bypasses the Get cache (the batch is one
        round trip already)."""
        return submit_multi([(self, "G", p) for p in payloads],
                            option=option)

    def MultiAdd(self, payloads, option=None) -> None:
        # unbounded-ok: MultiCall.Wait honors -mv_deadline_s internally
        self.MultiAddAsync(payloads, option=option).Wait()

    def MultiGet(self, payloads, option=None) -> list:
        # unbounded-ok: MultiCall.Wait honors -mv_deadline_s internally
        return self.MultiGetAsync(payloads, option=option).Wait()

    # -- write combining ------------------------------------------------------

    def _combinable_fire_forget(self, payload: Dict[str, Any]) -> bool:
        """True when ``payload`` (an Add's, option included) may join the
        combine buffer. Default False: a table opts in with a merge whose
        ONE apply equals applying the members in order (concatenated row
        or key batches do; whole-table sums only under linear updaters,
        which the worker half cannot see)."""
        return False

    def _combine_fire_forget(self, payloads: list) -> Dict[str, Any]:
        """Merge buffered payloads (each accepted by
        ``_combinable_fire_forget``, one option) into ONE payload, keeping
        member order wherever it is observable (key first-sight order,
        the duplicate-row pre-combine's summation order)."""
        raise NotImplementedError

    def _wc_try_buffer(self, payload: Dict[str, Any],
                       opt: AddOption) -> bool:
        """Buffer one fire-and-forget Add; False when the payload or the
        world wants the per-message path (the cap is off, the table
        declines, or the engine counts Add messages: BSP)."""
        cap = _write_combine_flag()
        if cap <= 0 or not self._combinable_fire_forget(payload):
            return False
        eng = self._zoo.server_engine
        if eng is None or not eng.WRITE_COMBINE_OK:
            return False
        with self._lock:
            if self._wc_buf and self._wc_option != opt:
                # mv-lint: ok(lock-order): the flushed message is a Request_Add, and Zoo.SendToServer calls flush_combined_adds (FlushCombined, which takes _lock) only for a non-verb message — the by-name chain back to _lock cannot execute from here
                self._flush_wc_locked()
            if self._wc_buf:
                tmetrics.counter("worker.write_combine_hits").inc()
            else:
                self._wc_ctx = ttrace.current_ctx()
            self._wc_buf.append(payload)
            self._wc_option = opt
            self._wc_src = opt.worker_id
            if len(self._wc_buf) >= cap:
                self._flush_wc_locked()
        return True

    def FlushCombined(self) -> None:
        """Ship this table's combine buffer (a no-op when empty)."""
        with self._lock:
            self._flush_wc_locked()

    def _flush_wc_locked(self) -> None:
        if not self._wc_buf:
            return
        bufs, opt, src = self._wc_buf, self._wc_option, self._wc_src
        ctx = self._wc_ctx
        self._wc_buf, self._wc_option, self._wc_ctx = [], None, None
        payload = bufs[0] if len(bufs) == 1 else \
            self._combine_fire_forget(bufs)
        payload["option"] = opt
        msg = Message(msg_type=MsgType.Request_Add, table_id=self.table_id,
                      msg_id=next_msg_id(), src=src, payload=payload)
        msg.trace_ctx = ctx
        ttrace.flow_start(msg.trace_ctx)
        self._zoo.SendToServer(msg)

    # -- the staleness-bounded Get cache --------------------------------------

    def _gc_ok(self) -> bool:
        """Cache eligibility, fixed per world: an engine that admits it
        (not BSP, whose clocks count Get messages) in a one-process world
        (a hit on one rank and a miss on another would diverge the
        lockstep verb streams)."""
        ok = self._gc_enabled
        if ok is None:
            eng = self._zoo.server_engine
            ok = (eng is not None and eng.GET_CACHE_OK
                  and multihost.world_size() <= 1)
            self._gc_enabled = ok
        return ok

    def _gc_key(self, payload: Dict[str, Any]):
        """Hashable request identity (option included), or None when a
        part cannot be keyed: such Gets never cache."""
        parts = [self.table_id]
        for k in sorted(payload):
            v = payload[k]
            if isinstance(v, np.ndarray):
                parts.append((k, v.dtype.str, v.shape, v.tobytes()))
            elif v is None or isinstance(v, (bool, int, float, str, bytes)):
                parts.append((k, v))
            elif isinstance(v, (GetOption, AddOption)):
                parts.append((k, repr(v)))
            else:
                return None
        return tuple(parts)

    def _gc_probe(self, payload: Dict[str, Any]):
        """``(pseudo_handle, None)`` on a hit within the staleness bound,
        ``(None, key)`` on a cacheable miss, ``(None, None)`` when the
        cache is off or the request cannot be keyed."""
        staleness = _get_staleness_flag()
        if staleness <= 0 or not self._gc_ok():
            return None, None
        key = self._gc_key(payload)
        if key is None:
            return None, None
        eng = self._zoo.server_engine
        with self._lock:
            ent = self._gc_cache.get(key)
            if ent is not None:
                fill_epoch, fill_wep, result = ent
                # the clock is the stream applying THIS table's verbs: a
                # busy neighbour shard does not age the entry
                if (fill_wep == self._write_epoch
                        and (eng.epoch_for_table(self.table_id)
                             - fill_epoch) <= staleness):
                    tmetrics.counter("worker.get_cache_hits").inc()
                    self._gc_next_hit -= 1
                    hid = self._gc_next_hit
                    self._gc_results[hid] = copy_result(result)
                    return hid, None
                del self._gc_cache[key]
        return None, key

    def _gc_store(self, key, result, fill_epoch: int,
                  fill_wep: int) -> None:
        with self._lock:
            if len(self._gc_cache) >= _GET_CACHE_ENTRIES:
                self._gc_cache.pop(next(iter(self._gc_cache)))
            self._gc_cache[key] = (fill_epoch, fill_wep,
                                   copy_result(result))

    def worker_ledger_bytes(self) -> Dict[str, int]:
        """Host bytes the worker half holds: the combine buffer awaiting
        its mailbox hop and the Get cache's parked copies."""
        with self._lock:
            wc = sum(payload_nbytes(p) for p in self._wc_buf)
            gc = sum(_result_nbytes(ent[2])
                     for ent in self._gc_cache.values())
            gc += sum(_result_nbytes(r) for r in self._gc_results.values())
        return {"write_combine_bytes": int(wc), "get_cache_bytes": int(gc)}


def submit_multi(records, option=None, track: bool = True) -> MultiCall:
    """Cross-table batched submission: ``records`` is a list of
    ``(worker_table, kind, payload)`` with ``kind`` ``'A'``/``'G'``. All
    records ship in ONE engine mailbox envelope and enter the verb stream
    in list order. Gets are always tracked; ``track=False`` makes the Adds
    fire-and-forget. An untracked batch still keeps per-table FIFO: each
    member table's buffered Adds ship ahead of it (a tracked batch flushes
    every table in ``Zoo.SendToServerMulti``)."""
    from multiverso_tpu_torch.zoo import Zoo
    n_tracked = sum(1 for _, kind, _ in records if kind == "G" or track)
    if n_tracked == 0:
        for table in {id(t): t for t, _, _ in records}.values():
            table.FlushCombined()
    call = MultiCall(n_tracked, len(records))
    members = [table._multi_member(kind, payload, option, call, idx, track)
               for idx, (table, kind, payload) in enumerate(records)]
    if members:
        Zoo.Get().SendToServerMulti(members, tracked=n_tracked > 0)
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
    # the creation record rides the server half: an elastic epoch
    # transition re-runs make_server and restores the state from the cut
    # frame (elastic/rebalance.rebuild_world)
    server_table._mv_option = option
    table_id = zoo.RegisterServerTable(server_table)
    worker_table = option.make_worker(zoo)
    worker_table.table_id = table_id
    zoo.RegisterWorkerTable(worker_table)
    return worker_table
