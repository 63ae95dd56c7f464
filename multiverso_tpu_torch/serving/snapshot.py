"""Consistent versioned snapshots: the publish cut and the table captures
(the port's counterpart of ``multiverso_tpu/serving/snapshot.py``).

**The cut.** ``publish()`` sends ONE ``Request_Publish`` message through
the engine mailbox (``Zoo.CallOnEngine``). The engine treats every non-verb
message as a window barrier (sync/server.py): windows split around it, the
sharded engine fences every shard stream at it, and the windowed
multi-process engine dispatches it at the same stream position on every
rank. The capture therefore runs on the engine thread with every Add
admitted before the cut applied and none after, on every rank and for
every table at once. ``MV_SaveCheckpoint`` rides the same mechanism
(checkpoint.py), so the two cuts cannot drift.

**Immutable by copy.** The port's tables update their storage IN PLACE
(the row kernels, ``index_add_``), so a snapshot holding a reference to a
table's live storage would serve rows that later Adds changed. Every
capture therefore copies:

* ``device`` residence (a MatrixTable on one process whose updater keeps
  no aux state) takes ONE ``clone()`` of the padded storage on the table's
  device; a lookup gathers its rows from that copy through
  ``ops.gather_rows`` (``<kGather>`` on the card) and only those rows
  cross to the host;
* ``host`` residence materialises the logical table in host memory
  (copy-on-publish numpy), through the reads a training Get uses (the
  updater's ``access()`` applied), so a served row equals what ``GetRows``
  at the cut returns.

Both the clone and the gathers run on the device's default stream (the
engine thread issues the clone, the front-end's threads the gathers), so
a gather on a snapshot runs after its clone with no event between them.

``-mv_serving_residence`` picks per table: ``host``; ``device`` (where
legal: one process and no aux state, else host); ``auto`` (device for a
table on a CUDA device where legal, host otherwise). A multi-process world
always serves from host copies: a serving thread must issue nothing that
could interleave with the engine's collectives. Each ``MatrixSnapshot``
records the residence it took (``residence``).

The capture ends with the replica plane's hook (``replica.note_publish``):
at this fenced stream position it drains the tables' publish journals and
kicks the fan-out thread, which reads a device-resident snapshot through
its stored gather, as a lookup does. A failure of the hook is logged and
never fails the publish.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from multiverso_tpu_torch.message import MsgType
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.configure import GetFlag
from multiverso_tpu_torch.utils.log import CHECK, Log


def residence_mode() -> str:
    mode = str(GetFlag("mv_serving_residence")).lower()
    CHECK(mode in ("auto", "host", "device"),
          f"-mv_serving_residence must be auto/host/device, got {mode!r}")
    return mode


class TableSnapshot:
    """One table's immutable published state. Subclasses implement the
    union read; the front-end slices each caller's rows out of it.
    ``dispatches`` counts the union reads issued (the coalescing tests
    assert ONE per batch however many callers rode it); the count rides a
    lock, since the dispatcher and inline combiners serve concurrently."""

    #: "host" or "device": where the snapshot's values live
    residence = "host"

    def __init__(self):
        self.dispatches = 0
        self._disp_lock = threading.Lock()

    def _count_dispatch(self) -> None:
        with self._disp_lock:
            self.dispatches += 1

    def nbytes(self) -> int:
        raise NotImplementedError

    def lookup_union(self, union_ids: np.ndarray) -> np.ndarray:
        """Values for a sorted unique id vector, in ONE read."""
        raise NotImplementedError

    def full(self) -> np.ndarray:
        """The whole logical table (a fresh copy the caller owns)."""
        raise NotImplementedError

    def validate_ids(self, ids: np.ndarray) -> None:
        """Raise on out-of-domain ids BEFORE the request joins a batch
        (one bad caller must not fail the shared read, and an id out of
        range must never reach a kernel)."""


class MatrixSnapshot(TableSnapshot):
    """Row-addressed snapshot (matrix and sparse-matrix families)."""

    def __init__(self, num_rows: int, num_cols: int, *, rows=None,
                 dev=None):
        super().__init__()
        self.num_rows = num_rows
        self.num_cols = num_cols
        self._rows = rows      # host residence: (num_rows, num_cols) numpy
        self._dev = dev        # device residence: (storage copy, gather)
        self.residence = "host" if dev is None else "device"

    @classmethod
    def host(cls, rows: np.ndarray):
        rows = np.ascontiguousarray(rows)
        return cls(rows.shape[0], rows.shape[1], rows=rows)

    @classmethod
    def device(cls, data, gather, num_rows: int, num_cols: int):
        """``data`` is the one-clone immutable storage; ``gather(data,
        ids)`` reads logical rows ``ids`` (int numpy) of it into host
        memory as an (n, num_cols) numpy array (the table's row gather on
        a storage argument, ``<kGather>`` on the card, then the copy to
        the host). The read stays behind this stored callable, as in the
        JAX package: the threads that serve a snapshot (the front-end's,
        the replica fan-out's) reach the card only through it."""
        return cls(num_rows, num_cols, dev=(data, gather))

    def nbytes(self) -> int:
        if self._rows is not None:
            return int(self._rows.nbytes)
        data = self._dev[0]
        return int(data.numel() * data.element_size())

    def validate_ids(self, ids: np.ndarray) -> None:
        if ids.size == 0:
            raise ValueError("empty row id set")
        if int(ids.min()) < 0 or int(ids.max()) >= self.num_rows:
            raise ValueError(f"row id out of range [0, {self.num_rows})")

    def lookup_union(self, union_ids: np.ndarray) -> np.ndarray:
        self._count_dispatch()
        if self._rows is not None:
            return self._rows[union_ids]
        data, gather = self._dev
        return gather(data, union_ids)

    def full(self) -> np.ndarray:
        if self._rows is not None:
            self._count_dispatch()
            return self._rows.copy()
        # lookup_union counts the one gather it issues; np.array copies,
        # so the caller owns what it gets (a CPU tensor's numpy view shares
        # the tensor's buffer)
        return np.array(self.lookup_union(
            np.arange(self.num_rows, dtype=np.int32)))


class VectorSnapshot(TableSnapshot):
    """Whole-vector snapshot (array family): lookups index elements."""

    def __init__(self, values: np.ndarray):
        super().__init__()
        self._values = np.ascontiguousarray(values)

    def nbytes(self) -> int:
        return int(self._values.nbytes)

    def validate_ids(self, ids: np.ndarray) -> None:
        if ids.size == 0:
            raise ValueError("empty id set")
        if int(ids.min()) < 0 or int(ids.max()) >= self._values.size:
            raise ValueError(f"index out of range [0, {self._values.size})")

    def lookup_union(self, union_ids: np.ndarray) -> np.ndarray:
        self._count_dispatch()
        return self._values[union_ids]

    def full(self) -> np.ndarray:
        self._count_dispatch()
        return self._values.copy()


class KVSnapshot(TableSnapshot):
    """Key-addressed snapshot: sorted int64 keys and aligned values; absent
    keys read 0 (the live table's Get contract)."""

    def __init__(self, keys: np.ndarray, values: np.ndarray):
        super().__init__()
        order = np.argsort(keys, kind="stable")
        self._keys = np.ascontiguousarray(keys[order])
        self._values = np.ascontiguousarray(values[order])

    def nbytes(self) -> int:
        return int(self._keys.nbytes + self._values.nbytes)

    def validate_ids(self, ids: np.ndarray) -> None:
        if ids.size == 0:
            raise ValueError("empty key set")

    def lookup_union(self, union_keys: np.ndarray) -> np.ndarray:
        self._count_dispatch()
        if not len(self._keys):
            return np.zeros(len(union_keys), self._values.dtype)
        pos = np.searchsorted(self._keys, union_keys)
        pos_c = np.minimum(pos, len(self._keys) - 1)
        hit = self._keys[pos_c] == union_keys
        out = np.where(hit, self._values[pos_c], 0)
        return out.astype(self._values.dtype, copy=False)

    def full(self) -> np.ndarray:
        """The value vector in sorted-key order (``items()`` pairs it with
        the keys)."""
        self._count_dispatch()
        return self._values.copy()

    def items(self):
        """(sorted keys, aligned values): both immutable views."""
        return self._keys, self._values


@dataclass
class Snapshot:
    """One published version: every exported table at one cut."""

    version: int
    created_wall: float
    window_epoch: int
    tables: Dict[int, TableSnapshot] = field(default_factory=dict)
    #: host seconds of each table's export on the engine thread
    export_s: Dict[int, float] = field(default_factory=dict)

    def age_s(self) -> float:
        return max(0.0, time.time() - self.created_wall)

    def nbytes(self) -> int:
        return sum(t.nbytes() for t in self.tables.values())


def _capture_all(engine, store) -> Snapshot:
    """Runs ON the engine thread inside the publish barrier: every table's
    export at one stream position is one consistent cut."""
    t_start = time.perf_counter()
    tables: Dict[int, TableSnapshot] = {}
    export_s: Dict[int, float] = {}
    for tid, table in enumerate(engine.store_):
        t0 = time.perf_counter()
        ts = table.serving_export()
        if ts is not None:
            tables[tid] = ts
            export_s[tid] = time.perf_counter() - t0
    snap = Snapshot(version=store.alloc_version(), created_wall=time.time(),
                    # the cut's stream position: windows applied over
                    # every engine shard stream
                    window_epoch=engine.cut_epoch(), tables=tables,
                    export_s=export_s)
    store.install(snap)
    # the replica plane's fan-out hook: the tables' publish journals drain
    # AT this fenced stream position (every Add admitted before the cut
    # marked its journal before this drain, none after: the deltas'
    # soundness) and the fan-out thread is kicked. Local numpy only; one
    # attribute read when the plane is off
    try:
        from multiverso_tpu_torch import replica as _replica
        _replica.note_publish(engine, snap)
    except Exception as exc:    # the fan-out never fails a publish
        Log.Error("replica fan-out publish hook failed: %r", exc)
    tmetrics.gauge("serving.snapshot_bytes").set(snap.nbytes())
    tmetrics.gauge("serving.snapshot_age_s").set(0.0)
    tmetrics.histogram("serving.publish_s").observe(
        time.perf_counter() - t_start)
    Log.Debug("serving: published snapshot v%d (%d tables, %d bytes)",
              snap.version, len(tables), snap.nbytes())
    return snap


def publish(zoo=None) -> int:
    """Publish a consistent versioned snapshot of every live table of
    ``zoo`` (default: the running world); returns the new version.
    COLLECTIVE in a multi-process world: every process calls it at the
    same verb-stream position, like ``MV_Barrier``."""
    from multiverso_tpu_torch.serving import get_plane
    from multiverso_tpu_torch.zoo import Zoo
    zoo = zoo or Zoo.Get()
    plane = get_plane()

    def _cut():
        return _capture_all(zoo.server_engine, plane.store).version

    return zoo.CallOnEngine(MsgType.Request_Publish, _cut,
                            "snapshot publish (MV_PublishSnapshot)")
