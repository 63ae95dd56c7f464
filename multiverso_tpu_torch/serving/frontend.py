"""Serving front-end: micro-batched, deadline-bounded, load-shedding
lookups against published snapshots (the port's counterpart of
``multiverso_tpu/serving/frontend.py``).

Lookups NEVER touch the engine's verb stream. Concurrent callers enqueue
into one admission queue; a dispatcher thread drains it, groups the
requests by (version, table) and serves each group with ONE union read of
the snapshot (on a device-resident snapshot: one ``<kGather>`` launch over
the union of the group's ids); each caller's rows are sliced out of the
union by ``searchsorted`` (fresh arrays: callers own what they get).

* **deadline**: ``lookup(..., deadline=s)`` bounds the wait of one
  request (default ``-mv_deadline_s``); expiry raises
  ``DeadlineExceeded``.
* **load shedding**: an admission that finds ``-mv_serving_max_inflight``
  requests queued raises a typed ``ServingOverloaded`` at once instead of
  queueing without bound.
* **coalescing**: ``-mv_serving_batch_window_s`` holds the dispatcher that
  long after the first queued lookup, so concurrent callers share a read.
* **one bad caller fails alone**: ids are validated (integers, in range)
  at admission, before the request can join a batch, so an id out of
  range never reaches a kernel; a failed read fails only its group.

Telemetry as in the JAX front-end: the ``serving.lookups``,
``serving.shed`` and ``serving.dispatches`` counters, the
``serving.batch_size`` and ``serving.latency_s`` histograms, the
``digest.serving.latency_s`` digest, the ``serving.snapshot_age_s`` gauge
and the ``serving.shed``/``serving.dispatch`` flight events: the one count
of its work (a measurement reads their difference across its window).

Chaos as in the JAX front-end (``failsafe/chaos.py``): ``serving.overload``
sheds a lookup at admission (``ServingOverloaded``, a ``serving.shed``
flight event with detail ``chaos``) and ``serving.delay`` stalls a
micro-batch before it is served (the per-request deadline path).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.failsafe import chaos
from multiverso_tpu_torch.failsafe import deadline as fdeadline
from multiverso_tpu_torch.failsafe.errors import ServingOverloaded
from multiverso_tpu_torch.telemetry import flight as tflight
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.configure import (cached_float_flag,
                                                  cached_int_flag)
from multiverso_tpu_torch.utils.log import Log
from multiverso_tpu_torch.utils.mt_queue import MtQueue
from multiverso_tpu_torch.utils.waiter import Waiter

#: dispatcher idle poll: shutdown never waits on a quiet queue longer than
#: this (the queue's Exit wakes it at once anyway)
_IDLE_POLL_S = 0.2

#: read per lookup and per micro-batch through listener caches, as the
#: JAX package's front-end reads them (flags defined in serving/__init__)
_max_inflight_flag = cached_int_flag("mv_serving_max_inflight", 4096)
_batch_window_flag = cached_float_flag("mv_serving_batch_window_s", 0.0)

#: shared first-fill-wins gate (the guarded region is two stores)
_fill_lock = threading.Lock()


class LookupTicket:
    """Future of one admitted lookup. ``Wait`` is the only blocking point
    of the read path, and it is deadline-bounded."""

    __slots__ = ("_waiter", "_result", "_done", "enq_t")

    def __init__(self):
        self._waiter = Waiter(1)
        self._result: Any = None
        self._done = False
        self.enq_t = time.perf_counter()

    def _fill(self, result: Any) -> None:
        # first fill wins: a group's error sweep may reach tickets the same
        # serve already filled, and stop()'s sweep may race an admission
        with _fill_lock:
            if self._done:
                return
            self._done = True
            self._result = result
        self._waiter.Notify()

    def Wait(self, deadline: Optional[float] = None) -> np.ndarray:
        timeout = (float(deadline) if deadline is not None
                   else fdeadline.timeout_or_none())
        if not self._waiter.Wait(timeout):
            fdeadline.raise_deadline("serving lookup", seconds=timeout)
        if isinstance(self._result, Exception):
            raise self._result
        return self._result


class ServingFrontend:
    def __init__(self, store):
        self._store = store
        self._q: MtQueue = MtQueue()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        #: inline-combiner gate: whoever holds it may drain and serve the
        #: queued batch on its own thread
        self._combine_lock = threading.Lock()
        self._stopped = False
        #: test hook: while set, the dispatcher parks before its pop, so
        #: admissions pile up and then coalesce into ONE batch
        self._hold_for_tests: Optional[threading.Event] = None
        self._t_lookups = tmetrics.counter("serving.lookups")
        self._t_shed = tmetrics.counter("serving.shed")
        self._t_dispatch = tmetrics.counter("serving.dispatches")
        self._t_batch = tmetrics.histogram("serving.batch_size")
        self._t_latency = tmetrics.histogram("serving.latency_s")
        self._d_latency = tmetrics.digest("digest.serving.latency_s")
        self._t_age = tmetrics.gauge("serving.snapshot_age_s")

    # -- caller side ---------------------------------------------------------

    def lookup_async(self, table_id: int, ids, *,
                     version: Optional[int] = None) -> LookupTicket:
        """Admit one lookup; returns its ticket. ``ids=None`` reads the
        whole table. Raises ``ServingOverloaded`` when the admission queue
        is full (the request was NOT enqueued), and the id validation and
        missing-version errors at once."""
        if self._stopped:
            raise ServingOverloaded("serving plane is shut down")
        cz = chaos.get()
        if cz is not None and cz.serving_admission():
            self._t_shed.inc()
            tflight.record("serving.shed", detail="chaos")
            raise ServingOverloaded("chaos: serving admission shed")
        max_inflight = max(1, _max_inflight_flag())
        if self._q.Size() >= max_inflight:
            self._t_shed.inc()
            tflight.record("serving.shed", detail="overload")
            raise ServingOverloaded(
                f"serving admission queue full ({max_inflight} in "
                f"flight): shed; retry with backpressure or raise "
                f"-mv_serving_max_inflight")
        # resolve and validate BEFORE admission: a bad request fails its
        # caller only, never the batch it would have joined
        snap = self._store.get(version)
        ts = snap.tables.get(table_id)
        if ts is None:
            raise KeyError(
                f"table {table_id} has no serving snapshot in version "
                f"{snap.version} (a family without serving_export?)")
        if ids is not None:
            ids = np.asarray(ids).ravel()
            if not np.issubdtype(ids.dtype, np.integer):
                raise ValueError(
                    f"serving lookup ids must be integers, got dtype "
                    f"{ids.dtype}")
            if (ids.dtype == np.uint64 and ids.size
                    and int(ids.max()) > np.iinfo(np.int64).max):
                raise ValueError(
                    f"serving lookup id {int(ids.max())} is above the "
                    f"int64 maximum")
            ts.validate_ids(ids)
            # one id dtype for every caller: a group's union would promote
            # int64 with uint64 to float64 (wrong keys above 2**53, no
            # integer index at all for a row read)
            ids = ids.astype(np.int64, copy=False)
        ticket = LookupTicket()
        self._t_lookups.inc()
        self._q.Push((snap, table_id, ids, ticket))
        if self._stopped:
            # lost the race with stop(): its drain may have run before
            # this push landed (fills are idempotent)
            self._fail_queued(ServingOverloaded(
                "serving plane shut down while this lookup was queued"))
        self._ensure_thread()
        return ticket

    def lookup(self, table_id: int, ids, *, version: Optional[int] = None,
               deadline: Optional[float] = None) -> np.ndarray:
        ticket = self.lookup_async(table_id, ids, version=version)
        # inline combiner: an unbounded caller that wins the combine lock
        # drains whatever has queued (its own request included) and serves
        # it on its own thread, saving the dispatcher's two thread handoffs
        # at low concurrency; under load most callers lose the lock and
        # ride the winner's (or the dispatcher's) read. A bounded caller
        # always rides the dispatcher, whose wait the deadline covers, and
        # the test hold disables the path.
        bounded = (deadline is not None
                   or fdeadline.timeout_or_none() is not None)
        if (not bounded and self._hold_for_tests is None
                and self._combine_lock.acquire(blocking=False)):
            try:
                batch = self._drain()
                if batch:
                    self._serve_guarded(batch)
            finally:
                self._combine_lock.release()
        return ticket.Wait(deadline)

    # -- dispatcher ------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None:
            return
        with self._thread_lock:
            if self._thread is None and not self._stopped:
                t = threading.Thread(target=self._loop,
                                     name="mvt-serving-frontend",
                                     daemon=True)
                self._thread = t
                t.start()

    def stop(self) -> None:
        with self._thread_lock:
            self._stopped = True
            t = self._thread
        self._q.Exit()
        if t is not None:
            t.join(fdeadline.deadline_s() or 5.0)
            if t.is_alive():
                Log.Error("serving front-end dispatcher stuck at shutdown "
                          "(queue depth %d): abandoning its daemon thread",
                          self._q.Size())
        # a lookup admitted concurrently with shutdown must raise typed,
        # never block its caller forever
        self._fail_queued(ServingOverloaded(
            "serving plane shut down while this lookup was queued"))

    def _fail_queued(self, exc: Exception) -> None:
        for item in self._drain():
            item[3]._fill(exc)

    def _drain(self) -> list:
        batch = []
        while True:
            ok, item = self._q.TryPop()
            if not ok:
                return batch
            batch.append(item)

    def _loop(self) -> None:
        while True:
            hold = self._hold_for_tests
            if hold is not None:
                hold.wait(5.0)
            ok, first = self._q.Pop(timeout=_IDLE_POLL_S)
            if not ok:
                if self._stopped:
                    return
                continue
            window = _batch_window_flag()
            if window > 0:
                time.sleep(window)      # let concurrent callers join
            self._serve_guarded([first] + self._drain())

    def _serve_guarded(self, batch: List[tuple]) -> None:
        try:
            self._serve_batch(batch)
        except Exception as exc:       # fail the batch, keep serving
            Log.Error("serving batch failed: %r", exc)
            for _, _, _, ticket in batch:
                ticket._fill(exc)

    def _serve_batch(self, batch: List[tuple]) -> None:
        cz = chaos.get()
        if cz is not None:
            delay = cz.serving_delay()
            if delay > 0:
                time.sleep(delay)
        self._t_batch.observe(len(batch))
        tflight.record("serving.dispatch", detail=f"{len(batch)}req")
        groups: Dict[Tuple[int, int], List[tuple]] = {}
        for item in batch:
            snap, table_id, _, _ = item
            groups.setdefault((snap.version, table_id), []).append(item)
        for (_, table_id), items in groups.items():
            ts = items[0][0].tables[table_id]
            id_items = [it for it in items if it[2] is not None]
            try:
                if id_items:
                    union = np.unique(np.concatenate(
                        [it[2] for it in id_items]))
                    rows_u = ts.lookup_union(union)     # ONE read
                    self._t_dispatch.inc()
                for _, _, ids, ticket in items:
                    if ids is None:
                        ticket._fill(ts.full())
                        self._t_dispatch.inc()   # a full read is a read
                    else:
                        # fancy indexing copies: each caller owns its rows
                        ticket._fill(rows_u[np.searchsorted(union, ids)])
            except Exception as exc:
                # fills are first-wins: served tickets keep their results
                for _, _, _, ticket in items:
                    ticket._fill(exc)
        now = time.perf_counter()
        for _, _, _, ticket in batch:
            self._t_latency.observe(now - ticket.enq_t)
            self._d_latency.observe(now - ticket.enq_t)
        latest = (self._store.get(None) if self._store.live_versions()
                  else None)
        if latest is not None:
            self._t_age.set(latest.age_s())
