"""MatrixTable — 2-D dense matrix, row Get/Add on one device.

Counterpart of ``multiverso_tpu/tables/matrix_table.py`` (reference
matrix_table.h/.cpp): whole-table or row-set ``Get``/``Add``, the updater
applied per touched row, optional row initialization, ``Store``/``Load``.

Storage layout, as in the JAX package: each server shard holds
``block_rows`` logical rows plus one TRASH row at its tail (this slice has
one shard, so the trash row is row ``num_rows``). Pad lanes (id -1) and,
later, foreign lanes map to the trash row before any kernel sees them
(``_local_lanes``); its content is don't-care and never read back.

Column padding is the port's own: storage columns round up to a multiple
of 4 floats (``COL_ALIGN``), so every row starts on a 16-byte boundary and
the row kernels move whole ``float4``s (a 1,000,000 x 50 table stores 52
columns: 4% more bytes than logical). The JAX package pads to the TPU's
128-lane tile instead. Pad columns hold zeros forever: every updater is
identity on a zero delta.

Row verbs send exact-size batches: PyTorch runs eagerly, so the JAX
package's power-of-two batch buckets (which bound XLA's compiled shapes)
would only move pad lanes.

The row path (``_update_rows``): the add and sgd updaters (``fusable``,
aux-free) run the whole server-side Add as ONE fused read-modify-write
kernel; every other updater gathers the rows and their aux rows, applies
``updater.update``, and scatters rows and row-shaped aux back with the
scatter kernel. Duplicate ids inside one Add are pre-combined on the host
(``_combine_duplicate_rows``): scatter order on duplicates is undefined,
on the card as on the TPU.

Compressed row Adds (``compress="sparse"|"1bit"``, the JAX package's
wire): the worker half compresses a row batch on the host
(``_compressed_payload``: the sparse filter's (index, value) pairs, or
the 1-bit sign bits and two means a row with per-row error feedback);
the payload crosses to the device compressed, in the JAX package's
bucket-padded layout, and ``_consume_compressed_on_device`` rebuilds the
dense rows there with tensor code (a scatter into zeros, or a
shift-and-mask unpack and a select) before the normal row update. The
JAX rebuild is XLA, not Pallas, so no kernel of its own.

Multi-process worlds: every process keeps a full replica of the table on
its own device. The engine exchanges each window of verbs between the
processes and hands every rank's payloads to the parts verbs
(``ProcessAddParts``, ``ProcessAddRunParts``, ``ProcessGetParts``,
``ProcessGetWindowParts``): an Add concatenates every rank's rows in rank
order, pre-combines duplicates on the host (``_combine_duplicate_rows``,
never ``index_add_``, whose CUDA atomics sum in an undefined order) and
applies them through the same row path, so the replicas stay bitwise
equal; a Get reads this rank's rows from its own replica. The device
plane's writes follow the same rule as collectives of the application
thread (``device_apply_rows_many``: with a device wire the deltas move
card to card and merge on the device); its reads stay local. A compressed
row push crosses the processes compressed, inside the window, and every
rank rebuilds it (``_mh_add_compressed_parts``); a device write to a
compressed table is dense, as in the JAX package. A row Add whose values
rode the device window transport (``parallel/device_wire.py``) applies
through ``ProcessAddPartsDevice`` / ``ProcessAddRunPartsDevice``: the
ranks' values come card to card, merge on the device
(``_merge_device_rows``: ``ops.dedup_rows(deterministic=True)``, bitwise
the host merge) and apply through the same row path.

A table on the CPU (``-mv_device=cpu``) with the add or sgd updater, no
compression and float32 data rides the repo's native host store
(``native.NativeHostStore``, ``native/src/host_store.cc``) for its host
verbs, as a JAX table on the CPU backend does: a threaded C++ row store
of the LOGICAL rows (no pad columns, no trash row) that applies Adds
and serves Gets off the interpreter lock, on the library's worker pool.
Exactly one side holds the truth at a time. The mirror is built lazily
from ``raw()`` at the first host verb; reading ``state`` copies a dirty
mirror back into the storage tensor; any write to the storage outside
the host verbs (the device plane, the device wire's applies, a load)
drops the mirror, which the next host verb rebuilds. A table on the card
never rides it.

The store is updated IN PLACE (the JAX package donates its buffers
instead). So every Get returns a fresh buffer — a gather output or, for
the whole table, a copy — and never a view of live storage, and the device
plane (``device_fetch_rows``/``device_apply_rows``) bypasses the engine:
the caller owns the table while using it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import ops
from multiverso_tpu_torch.parallel import device_wire, multihost
from multiverso_tpu_torch.parallel.flat import DeferredArray
from multiverso_tpu_torch.parallel.mesh import ceil_block_rows, next_bucket
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import sketch as tsketch
from multiverso_tpu_torch.tables.base import (ServerTable, TableOption,
                                              WorkerTable, ledger_walk)
from multiverso_tpu_torch.updaters.base import (AddOption, CreateUpdater,
                                                GetOption, Updater)
from multiverso_tpu_torch.utils.log import CHECK
from multiverso_tpu_torch.utils.quantization import (RowOneBitsFilter,
                                                     SparseFilter)

#: storage columns round up to this many floats (16-byte rows)
COL_ALIGN = 4


def padded_cols(num_cols: int) -> int:
    """Storage column count for ``num_cols`` logical float32 columns."""
    return -(-num_cols // COL_ALIGN) * COL_ALIGN


def _combine_duplicate_rows(ids: np.ndarray, deltas: np.ndarray,
                            num_cols: int, dtype):
    """Host pre-combine of duplicate row ids by SUM (the JAX package's
    function, same summation order: singletons assign, duplicates
    ``np.add.at`` in submission order)."""
    ids = np.asarray(ids, np.int32).ravel()
    deltas = np.asarray(deltas, dtype).reshape(len(ids), num_cols)
    uniq, inverse = np.unique(ids, return_inverse=True)
    if len(uniq) == len(ids):
        return ids, deltas
    combined = np.zeros((len(uniq), num_cols), dtype)
    counts = np.bincount(inverse, minlength=len(uniq))
    dup_pos = counts[inverse] > 1
    combined[inverse[~dup_pos]] = deltas[~dup_pos]
    np.add.at(combined, inverse[dup_pos], deltas[dup_pos])
    return uniq.astype(np.int32), combined


def device_apply_rows_many(items, option: Optional[AddOption] = None,
                           ride=None):
    """``device_apply_rows`` of several (server table, row ids, deltas)
    items as ONE write: the WordEmbedding device plane's four tables a
    block, the LR sparse window's one table.

    One process: each item applies on its own (the fused update kernel
    for the add and sgd updaters); ``ride`` is returned as it was given.
    Several processes: COLLECTIVE. Every rank's (ids, deltas) of every
    item and its ``ride`` (a float or device scalar the caller wants
    summed over the ranks, such as a window's loss) meet with the option,
    which must agree on every rank; each table concatenates the ranks'
    batches in rank order, pre-combines duplicate ids in that order (never
    ``index_add_``, whose CUDA atomics sum in an undefined order) and
    applies the merge through the row path, so the replicas stay bitwise
    equal. With a device wire (``multihost.device_writes``) the deltas
    stay on the card: the ids, the option and the ride cross one tagged
    round, the deltas move card to card (``multihost.collective_write``)
    and merge on the device (``_merge_device_rows``, bitwise the host
    merge). Without one they come to the host in one copy, travel in one
    tagged all-gather and merge on the host (``_combine_duplicate_rows``).
    Returns the ranks' rides (float32-rounded when a device scalar)
    summed in float64 in rank order (None without a ride)."""
    option = option or AddOption()
    opt = option.as_tensors()
    prepped = []
    for srv, row_ids, deltas in items:
        ids = np.asarray(row_ids, np.int32).ravel()
        srv._check_ids(ids)
        prepped.append((srv, ids, deltas))
    if multihost.world_size() <= 1:
        for srv, ids, deltas in prepped:
            srv._apply_rows_local(ids, deltas, opt)
        return ride
    if multihost.device_writes():
        return _apply_rows_on_device(prepped, option, opt, ride)
    host, ride = multihost.host_payloads([d for _, _, d in prepped], ride)
    arrays = []
    for (srv, ids, _), d in zip(prepped, host):
        arrays += [ids, d.reshape(len(ids), srv.num_cols)]
    if ride is not None:
        arrays.append(np.array([ride], np.float64))
    merged = multihost.merge_collective_add(option, *arrays,
                                            key="matrix_apply")
    t0 = time.perf_counter()
    combined = [_combine_duplicate_rows(merged[2 * i], merged[2 * i + 1],
                                        srv.num_cols, srv.dtype)
                for i, (srv, _, _) in enumerate(prepped)]
    t1 = time.perf_counter()
    multihost.STATS["merge_s"] += t1 - t0
    for (srv, _, _), (ids, deltas) in zip(prepped, combined):
        srv._update_rows(ids, deltas, opt)
    multihost.note("apply", time.perf_counter() - t1)
    if ride is None:
        return None
    total = 0.0
    for r in merged[-1]:
        total += float(r)
    return total


def _apply_rows_on_device(prepped, option, opt, ride):
    """``device_apply_rows_many``'s device route: every rank's deltas of
    each item, in rank order, merge on the device and apply through the
    row path (``<kAdd>``/``<kSub>`` for the add and sgd updaters)."""
    deltas = []
    for srv, ids, d in prepped:
        d = torch.as_tensor(d, dtype=torch.float32).to(srv.device)
        CHECK(d.numel() == ids.size * srv.num_cols,
              "device_apply_rows: delta size mismatch")
        deltas.append(d.reshape(-1))
    metas, parts, rides = multihost.collective_write(
        "matrix_apply", [ids for _, ids, _ in prepped], option, deltas,
        prepped[0][0].device, ride)
    t0 = time.perf_counter()
    merged = []
    for i, (srv, _, _) in enumerate(prepped):
        values = [p[i] for p in parts]
        merged.append(srv._merge_device_rows(
            np.concatenate([m[i] for m in metas]),
            torch.cat(values) if len(values) > 1 else values[0]))
    t1 = time.perf_counter()
    multihost.note("dmerge", t1 - t0)
    for (srv, _, _), (ids, d) in zip(prepped, merged):
        srv._update_rows_padded(ids, d, opt)
    multihost.note("apply", time.perf_counter() - t1)
    if ride is None:
        return None
    total = 0.0
    for r in rides:
        total += r
    return total


@dataclass
class MatrixTableOption(TableOption):
    num_rows: int = 0
    num_cols: int = 0
    _supports_compress = True
    updater_type: Optional[str] = None
    initializer: Optional[Callable[[Tuple[int, int]], np.ndarray]] = None

    def make_server(self, zoo):
        return MatrixServerTable(self.num_rows, self.num_cols, self.dtype, zoo,
                                 self.updater_type, self.initializer,
                                 compress=self.compress)

    def make_worker(self, zoo):
        return MatrixWorkerTable(self.num_rows, self.num_cols, self.dtype,
                                 compress=self.compress)


class MatrixServerTable(ServerTable):
    #: the replica plane journals a row-addressed table by rows
    publish_journal_kind = "rows"

    def __init__(self, num_rows: int, num_cols: int, dtype, zoo,
                 updater_type: Optional[str] = None,
                 initializer: Optional[Callable] = None,
                 compress: Optional[str] = None):
        CHECK(num_rows > 0 and num_cols > 0, "matrix dims must be positive")
        CHECK(compress in (None, "sparse", "1bit"),
              f"unknown compress mode {compress!r}")
        self.compress = compress
        #: compressed Adds' wire accounting: the bytes their rows would
        #: have moved dense, and the bytes that crossed to the device
        self.wire_stats = {"dense_bytes": 0, "payload_bytes": 0}
        #: the -mv_row_sketch access sketch (lazily created when armed)
        self._row_sketch = None
        self._row_sketch_notes = 0
        self.dtype = np.dtype(dtype)
        CHECK(self.dtype == np.float32,
              f"matrix tables hold float32 in this port (the row kernels' "
              f"type); got {self.dtype}")
        self.num_rows = num_rows
        self.num_cols = num_cols
        self._zoo = zoo
        self._ctx = zoo.device_ctx
        self.device = self._ctx.device
        self.num_servers = self._ctx.num_servers
        self.block_rows = ceil_block_rows(num_rows, self.num_servers)
        self.shard_rows = self.block_rows + 1
        self.padded_rows = self.num_servers * self.shard_rows
        self.store_cols = padded_cols(num_cols)
        self.updater = CreateUpdater(updater_type)
        shape = (self.padded_rows, self.store_cols)
        if initializer is not None:
            init = np.asarray(initializer((num_rows, num_cols)), self.dtype)
            data = self._ctx.place(self._to_storage(init))
        else:
            data = torch.zeros(shape, dtype=torch.float32, device=self.device)
        aux = self.updater.init_aux(shape, torch.float32, zoo.num_workers,
                                    device=self.device)
        # the native host store (module docstring): eligibility is fixed
        # at creation, the store itself built at the first host verb
        self._nat_store = None
        self._nat_dirty = False
        self._native_host_ok = (
            self.updater.fusable and self.updater.combine_scale is not None
            and not aux and compress is None and self.device.type == "cpu")
        self.state = {"data": data, "aux": aux}
        # fused path: the aux-free elementwise updaters (add, sgd) run the
        # server-side Add as ONE read-modify-write kernel with their sign
        self._fuse = self.updater.fusable and not aux
        if self._fuse:
            CHECK(self.updater.combine_scale in (1.0, -1.0),
                  "a fusable updater's combine_scale must be +1 or -1")
            self._sign = int(self.updater.combine_scale)
        # merged engine Adds are sound for exactly the LINEAR aux-free
        # updaters: a window's batches apply as one duplicate-summed Add
        self._merge_adds = (self._fuse
                            and self.updater.combine_scale is not None)
        self._has_access = type(self.updater).access is not Updater.access

    # -- the native host store (CPU tables) ---------------------------------

    @property
    def state(self):
        """The {'data', 'aux'} tensors. Reading it first copies any Adds
        the native store holds back into the storage tensor (in place),
        so every consumer outside the host verbs sees the current data."""
        if self._nat_dirty:
            full = self._nat_store.get_all()
            self._state["data"].copy_(torch.from_numpy(
                self._to_storage(full)))
            # cleared only after the copy landed
            # mv-lint: ok(cross-domain-state): one plane per table: the device plane's writer is the application thread while the engine takes no verb of this table (the caller owns the table), as the JAX package's state property
            self._nat_dirty = False
        return self._state

    @state.setter
    def state(self, value) -> None:
        # mv-lint: ok(cross-domain-state): one plane per table: a device-plane write runs on the application thread while the engine takes no verb of this table (the caller owns the table), as the JAX package's state setter
        self._state = value
        self._drop_mirror()

    def _drop_mirror(self) -> None:
        """A write outside the host verbs made the storage tensor the
        truth: the mirror is stale (the next host verb rebuilds it)."""
        if self._nat_store is not None:
            # mv-lint: ok(cross-domain-state): same one-plane-per-table argument as the state getter
            self._nat_store = None
            self._nat_dirty = False

    def _host_store(self):
        """The live native store, or None when this table cannot ride it
        (not on the CPU, an aux or non-linear updater, compression, or no
        C++ toolchain)."""
        if not self._native_host_ok:
            return None
        if self._nat_store is None:
            from multiverso_tpu_torch import native
            store = native.NativeHostStore.create(
                self.num_rows, self.num_cols,
                float(self.updater.combine_scale))
            if store is None:
                self._native_host_ok = False    # no toolchain: stay torch
                return None
            store.load(self.raw())
            self._nat_store = store
        return self._nat_store

    def mh_prepare_local_apply(self) -> None:
        """Registration hook of a multi-process engine (tables/base.py):
        build the store at this lockstep position, as the JAX package
        does, so the first window already applies through it."""
        if self._native_host_ok:
            self._host_store()

    def ledger_bytes(self):
        """Byte ledger probe (tables/base.py contract): the storage
        tensors read through ``_state`` (the ``state`` property would
        copy a dirty mirror back, which a sampling thread must never
        do), and the native store's logical rows x cols floats as host
        mirror bytes."""
        out = {"device_bytes": 0, "host_mirror_bytes": 0, "host_bytes": 0}
        ledger_walk(self._state, out, set())
        nat = self._nat_store
        if nat is not None:
            out["host_mirror_bytes"] = int(nat.rows) * int(nat.cols) * 4
        return out

    def _apply_rows_host(self, ids: np.ndarray, deltas, opt) -> None:
        """A host verb's row Add (unique validated ids): the native store
        when live, else the row path."""
        nat = self._host_store()
        if nat is not None:
            nat.add_rows(ids, deltas)
            self._nat_dirty = True
            return
        self._update_rows(ids, deltas, opt)

    def _apply_full_host(self, values, opt) -> None:
        """A host verb's whole-table Add: the native store when live,
        else through the updater on the storage tensor."""
        nat = self._host_store()
        if nat is not None:
            nat.add_all(np.asarray(values, self.dtype).reshape(
                self.num_rows, self.num_cols))
            self._nat_dirty = True
            return
        self._update_full(values, opt)

    # -- storage layout (shard blocks + trash rows, padded cols) -------------

    def _to_storage(self, full: np.ndarray) -> np.ndarray:
        """(num_rows, num_cols) logical -> (padded_rows, store_cols)."""
        out = np.zeros((self.num_servers, self.shard_rows, self.store_cols),
                       full.dtype)
        padded = np.zeros((self.num_servers * self.block_rows, self.num_cols),
                          full.dtype)
        padded[: self.num_rows] = full
        out[:, : self.block_rows, : self.num_cols] = padded.reshape(
            self.num_servers, self.block_rows, self.num_cols)
        return out.reshape(self.padded_rows, self.store_cols)

    def _logical(self, storage: torch.Tensor) -> torch.Tensor:
        """(..., padded_rows, store_cols) storage -> (..., num_rows,
        num_cols), on the storage's device: a view where the strides
        allow one (always, with one server shard), else a copy."""
        lead = tuple(storage.shape[:-2])
        blocks = storage.reshape(lead + (self.num_servers, self.shard_rows,
                                         self.store_cols))[
            ..., : self.block_rows, : self.num_cols]
        return blocks.reshape(lead + (-1, self.num_cols))[
            ..., : self.num_rows, :]

    def aux_to_logical(self, leaf: torch.Tensor) -> np.ndarray:
        """(padded_rows, cols) or (workers, padded_rows, cols) storage ->
        logical row layout."""
        return self._ctx.fetch(self._logical(leaf))

    def aux_from_logical(self, arr: np.ndarray) -> np.ndarray:
        if arr.ndim == 2:
            return self._to_storage(arr)
        return np.stack([self._to_storage(a) for a in arr])

    # -- lanes, ids and deltas -------------------------------------------------

    def _local_lanes(self, ids: np.ndarray):
        """Map global row ids to this shard's rows: lanes owned elsewhere
        and -1 pad lanes go to the trash row. Returns (mine, safe int32)."""
        ids = np.asarray(ids, np.int64)
        shard_of = np.where(ids >= 0, ids // self.block_rows, -1)
        mine = shard_of == 0
        safe = np.where(mine, ids, self.block_rows)
        return mine, safe.astype(np.int32)

    def _lanes_tensor(self, ids: np.ndarray):
        mine, safe = self._local_lanes(ids)
        return mine, torch.from_numpy(safe).to(self.device)

    def _device_deltas(self, deltas, n: int) -> torch.Tensor:
        """(n, num_cols) host or device deltas -> contiguous float32
        (n, store_cols) on the table's device, pad columns zero."""
        d = torch.as_tensor(deltas, dtype=torch.float32).reshape(
            n, self.num_cols).to(self.device)
        if self.store_cols != self.num_cols:
            d = torch.nn.functional.pad(d, (0, self.store_cols - self.num_cols))
        return d.contiguous()

    def _check_ids(self, ids: np.ndarray) -> None:
        CHECK(ids.size > 0, "empty row id set")
        CHECK(int(ids.min()) >= 0 and int(ids.max()) < self.num_rows,
              "row id out of range")

    # -- row programs ----------------------------------------------------------

    def _gather_aux(self, ids_t: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for name, leaf in self.state["aux"].items():
            if leaf.dim() == 2:          # shared state, shaped like data
                out[name] = ops.gather_rows(leaf, ids_t)
            else:                        # per-worker state
                out[name] = leaf.index_select(1, ids_t.long())
        return out

    def _scatter_aux(self, new_aux: Dict[str, torch.Tensor],
                     ids_t: torch.Tensor) -> None:
        for name, leaf in self.state["aux"].items():
            new = new_aux[name].contiguous()
            if leaf.dim() == 2:
                # row-shaped aux (momentum smooth) rides the scatter kernel
                ops.scatter_set_rows(leaf, ids_t, new)
            else:
                leaf.index_copy_(1, ids_t.long(), new)

    def _update_rows(self, ids: np.ndarray, deltas, opt) -> None:
        """Apply ``deltas`` to rows ``ids`` (pad lanes -1 allowed; live
        ids unique) through the updater, in place."""
        self._update_rows_padded(ids, self._device_deltas(deltas, len(ids)),
                                 opt)

    def _update_rows_padded(self, ids: np.ndarray, d: torch.Tensor,
                            opt) -> None:
        """``_update_rows`` of deltas already on the device at the storage
        width (``_device_deltas``)."""
        _, ids_t = self._lanes_tensor(ids)
        data = self.state["data"]
        self._drop_mirror()
        if self._fuse:
            ops.update_rows(data, ids_t, d, self._sign)
            return
        rows = ops.gather_rows(data, ids_t)
        new_rows, new_aux = self.updater.update(rows, self._gather_aux(ids_t),
                                                d, opt)
        # trash lanes computed garbage from the trash row; it goes straight
        # back to the trash row, never to live data
        ops.scatter_set_rows(data, ids_t, new_rows.contiguous())
        self._scatter_aux(new_aux, ids_t)

    def _update_gather_rows(self, ids: np.ndarray, deltas, opt) -> torch.Tensor:
        """The Add+Get round: update rows ``ids`` and return their
        post-update logical rows (non-mine lanes zero), reading each row
        once."""
        mine, ids_t = self._lanes_tensor(ids)
        d = self._device_deltas(deltas, len(ids))
        data = self.state["data"]
        self._drop_mirror()
        if self._fuse:
            _, rows = ops.update_gather_rows(data, ids_t, d, self._sign)
        else:
            rows_in = ops.gather_rows(data, ids_t)
            rows, new_aux = self.updater.update(
                rows_in, self._gather_aux(ids_t), d, opt)
            rows = rows.contiguous()
            ops.scatter_set_rows(data, ids_t, rows)
            self._scatter_aux(new_aux, ids_t)
        return self._finish_rows(rows, mine, ids_t)

    def _gather_rows(self, ids: np.ndarray) -> torch.Tensor:
        """Logical rows for ``ids`` as a fresh device tensor (pad and
        foreign lanes read 0)."""
        mine, ids_t = self._lanes_tensor(ids)
        return self._finish_rows(ops.gather_rows(self.state["data"], ids_t),
                                 mine, ids_t)

    def _finish_rows(self, rows: torch.Tensor, mine: np.ndarray,
                     ids_t: torch.Tensor) -> torch.Tensor:
        if self._has_access:
            rows = self.updater.access(rows, self._gather_aux(ids_t), None)
        if self.store_cols != self.num_cols:
            rows = rows[:, : self.num_cols].contiguous()
        if not mine.all():
            rows = rows * torch.from_numpy(mine).to(self.device)[:, None]
        return rows

    # -- server verbs ------------------------------------------------------------

    def ProcessAddRun(self, payloads) -> bool:
        """Engine add-coalescing: a window's row-set Adds apply as ONE
        dispatch — concatenate the batches, find the unique ids and the
        inverse map on the host, sum each id's deltas on the device
        (``index_add_``, the JAX package's ``segment_sum``) and run one
        fused update over the unique rows. Sound exactly for LINEAR
        updaters (combine_scale set, AddOption scalars ignored). Declines
        whole-table Adds and anything failing validation, so the per-
        message path reports precise errors."""
        if not self._merge_adds:
            return False
        ids_list, deltas_list = [], []
        for p in payloads:
            row_ids = p.get("row_ids")
            if row_ids is None or p.get("compressed") is not None:
                return False
            ids = np.asarray(row_ids, np.int32).ravel()
            if (ids.size == 0 or int(ids.min()) < 0
                    or int(ids.max()) >= self.num_rows):
                return False
            values = np.asarray(p.get("values"), self.dtype)
            if values.size != ids.size * self.num_cols:
                return False
            ids_list.append(ids)
            deltas_list.append(values.reshape(len(ids), self.num_cols))
        if self._host_store() is not None:
            self._add_run_native(ids_list, deltas_list)
        else:
            self._add_run_device(ids_list, deltas_list)
        # the per-payload bookkeeping in message order, as the per-message
        # path fires it
        for p, ids in zip(payloads, ids_list):
            self._note_add_parts(p.get("option") or AddOption(), [ids])
        return True

    def _add_run_native(self, ids_list, deltas_list) -> None:
        """A merged run on the native store, as the JAX package applies
        it: payloads of one id set (one worker hammering, replicated
        pushes) sum their deltas in message order and apply once;
        otherwise each payload pre-combines its duplicates and applies
        on its own (a linear updater sums across applies)."""
        nat = self._nat_store
        first = ids_list[0]
        if len(ids_list) > 1 and all(
                a.shape == first.shape and np.array_equal(a, first)
                for a in ids_list[1:]):
            total = deltas_list[0].astype(self.dtype, copy=True)
            for d in deltas_list[1:]:
                total += d
            nat.add_rows(*_combine_duplicate_rows(first, total,
                                                  self.num_cols, self.dtype))
        else:
            for a, d in zip(ids_list, deltas_list):
                nat.add_rows(*_combine_duplicate_rows(a, d, self.num_cols,
                                                      self.dtype))
        self._nat_dirty = True

    def _add_run_device(self, ids_list, deltas_list) -> None:
        """A merged run on the storage tensor: the unique ids, each id's
        deltas summed with ``index_add_``, one fused update."""
        uniq, inv = np.unique(np.concatenate(ids_list), return_inverse=True)
        flat = self._device_deltas(np.concatenate(deltas_list), len(inv))
        combined = torch.zeros((len(uniq), self.store_cols),
                               dtype=torch.float32, device=self.device)
        combined.index_add_(0, torch.from_numpy(inv.astype(np.int64)).to(
            self.device), flat)
        _, ids_t = self._lanes_tensor(uniq.astype(np.int32))
        ops.update_rows(self.state["data"], ids_t, combined, self._sign)

    def _check_compressed_ids(self, comp: dict) -> np.ndarray:
        """A compressed payload's row ids, validated: in range and unique
        (the worker combines duplicates before it compresses)."""
        ids = np.asarray(comp["row_ids"], np.int32).ravel()
        self._check_ids(ids)
        CHECK(len(np.unique(ids)) == len(ids),
              "a compressed payload's row ids must be unique")
        return ids

    def _consume_compressed_on_device(self, comp: dict, opt) -> None:
        """Rebuild ONE compressed payload's rows on the device and apply
        them through the normal row update."""
        ids = self._check_compressed_ids(comp)
        self._update_rows(ids, self._rebuild_compressed(comp, len(ids)), opt)

    def _rebuild_compressed(self, comp: dict, n: int) -> torch.Tensor:
        """ONE compressed payload of ``n`` (validated) rows, rebuilt as
        dense (n, num_cols) deltas on the device with tensor code, and
        counted in ``wire_stats``. The payload crosses in the JAX
        package's layout: sparse (index, value) pairs padded to a bucket
        with an out-of-range index, or sign bits for the bucket-padded
        lanes and two means a row (pad lanes zero). Pad entries land in a
        sink slot or in pad lanes, never in live rows."""
        cols = self.num_cols
        bucket = next_bucket(n)
        if comp["kind"] == "sparse":
            idx = np.asarray(comp["idx"], np.int32)
            nb = next_bucket(max(len(idx), 1))
            idx_p = np.full(nb, bucket * cols, np.int32)
            idx_p[: len(idx)] = idx
            val_p = np.zeros(nb, self.dtype)
            val_p[: len(idx)] = comp["val"]
            wire = (idx_p, val_p)
            idx_t, val_t = (torch.from_numpy(a).to(self.device) for a in wire)
            # a scatter into zeros; every index past the n live rows
            # (the pad index included) goes to the sink slot n * cols
            flat = torch.zeros(n * cols + 1, dtype=torch.float32,
                               device=self.device)
            flat.scatter_(0, idx_t.long().clamp_(0, n * cols), val_t)
            deltas = flat[: n * cols].view(n, cols)
        else:
            packed = np.asarray(comp["packed"], np.uint8)
            CHECK(packed.size * 8 >= bucket * cols,
                  "1bit payload shorter than the padded lane count")
            pos = np.zeros(bucket, np.float32)
            pos[:n] = comp["pos"]
            neg = np.zeros(bucket, np.float32)
            neg[:n] = comp["neg"]
            wire = (packed, pos, neg)
            packed_t, pos_t, neg_t = (torch.from_numpy(a).to(self.device)
                                      for a in wire)
            shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                                  device=self.device)
            bits = (packed_t[:, None] >> shifts) & 1
            lanes = bits.reshape(-1)[: n * cols].view(n, cols).bool()
            deltas = torch.where(lanes, pos_t[:n, None], neg_t[:n, None])
        self._note_wire(n * cols * self.dtype.itemsize,
                        sum(a.nbytes for a in wire))
        return deltas

    def _note_wire(self, dense_bytes: int, payload_bytes: int) -> None:
        """One compressed payload's wire economics: the table's own
        ``wire_stats`` and the ``wire.compress.*`` counters."""
        self.wire_stats["dense_bytes"] += dense_bytes
        self.wire_stats["payload_bytes"] += payload_bytes
        tmetrics.counter("wire.compress.dense_bytes").inc(dense_bytes)
        tmetrics.counter("wire.compress.payload_bytes").inc(payload_bytes)

    def ProcessAdd(self, values: Optional[np.ndarray] = None,
                   option: Optional[AddOption] = None,
                   row_ids: Optional[np.ndarray] = None,
                   compressed: Optional[dict] = None) -> None:
        option = option or AddOption()
        opt = option.as_tensors()
        if compressed is not None:
            self._consume_compressed_on_device(compressed, opt)
            self._note_add_parts(option, [np.asarray(
                compressed["row_ids"], np.int32).ravel()])
            return
        if row_ids is None:
            self._apply_full_host(values, opt)
            self._note_add_parts(option, [None])
            return
        ids = np.asarray(row_ids, np.int32).ravel()
        deltas = np.asarray(values, self.dtype).reshape(len(ids),
                                                        self.num_cols)
        self._check_ids(ids)
        ids, deltas = _combine_duplicate_rows(ids, deltas, self.num_cols,
                                              self.dtype)
        self._apply_rows_host(ids, deltas, opt)
        self._note_add_parts(option, [ids])

    def _update_full(self, values, opt) -> None:
        """A whole-table Add through the updater."""
        values = np.asarray(values, self.dtype).reshape(self.num_rows,
                                                        self.num_cols)
        delta = self._ctx.place(self._to_storage(values))
        new_data, new_aux = self.updater.update(
            self.state["data"], self.state["aux"], delta, opt)
        self.state = {"data": new_data.contiguous(), "aux": new_aux}

    def _note_add_parts(self, option: AddOption, parts) -> None:
        """Hook after an applied Add: every rank's id set (None = whole
        table) in rank order, fired by every Add path (blocking, merged
        run, compressed, the parts verbs) but the device plane's. It marks
        the replica plane's publish journal; SparseMatrixServerTable keeps
        its freshness bits here too (and calls up). It fires after the data
        update, so a rejected Add never reaches it."""
        journal = self._pub_journal
        if journal is not None:
            for part_ids in parts:
                journal.mark_rows(part_ids)

    # -- multi-process parts verbs (tables/base.py contract) -------------------

    def _prep_add_parts(self, parts):
        """Validate one collective Add's per-rank payloads -> (option, kind,
        per-rank values or (ids, deltas)); kind is 'whole' or 'rows'.
        Compressed payloads go to ``_mh_add_compressed_parts``."""
        opts = self._check_parts_options(parts)
        whole = [p.get("row_ids") is None for p in parts]
        CHECK(all(whole) or not any(whole),
              "collective Add mixes whole-table and row payloads across "
              "processes")
        if all(whole):
            return opts[0], "whole", [
                np.asarray(p["values"], self.dtype).reshape(
                    self.num_rows, self.num_cols) for p in parts]
        prepped = []
        for p in parts:
            ids = np.asarray(p["row_ids"], np.int32).ravel()
            self._check_ids(ids)
            prepped.append((ids, np.asarray(p["values"], self.dtype).reshape(
                len(ids), self.num_cols)))
        return opts[0], "rows", prepped

    def ProcessAddParts(self, parts, my_rank: int) -> None:
        """One collective Add: every rank's rows in rank order, duplicates
        pre-combined on the host, one row update (whole-table payloads sum
        in rank order first; compressed ones: ``_mh_add_compressed_parts``)."""
        if any(p.get("compressed") is not None for p in parts):
            self._mh_add_compressed_parts(parts)
            return
        option, kind, prepped = self._prep_add_parts(parts)
        opt = option.as_tensors()
        if kind == "whole":
            summed = prepped[0].copy()
            for v in prepped[1:]:
                summed += v
            self._apply_full_host(summed, opt)
            self._note_add_parts(option, [None] * len(parts))
            return
        ids, deltas = _combine_duplicate_rows(
            np.concatenate([i for i, _ in prepped]),
            np.concatenate([d for _, d in prepped]), self.num_cols,
            self.dtype)
        self._apply_rows_host(ids, deltas, opt)
        self._note_add_parts(option, [i for i, _ in prepped])

    def _mh_add_compressed_parts(self, parts) -> None:
        """One collective Add in which at least one rank shipped a
        COMPRESSED payload (the ranks may mix: the sparse filter falls back
        to a dense payload per rank by density). The window exchange moved
        the compressed bytes, which is what the mode exists to shrink; every
        rank rebuilds them here, as the JAX package does
        (``_mh_add_compressed_parts``).

        Linear updaters (add, sgd): every rank's part is rebuilt on the
        device (``_rebuild_compressed``; a dense part pre-combines its
        duplicates on the host) and summed in rank order into the union
        batch of the ranks' ids, which one row update applies: the fused
        ``<kAdd>``/``<kSub>`` on the card. The same unique ids, rank-order
        sums and kernel as the uncompressed merge, so the exact sparse
        wire stays bitwise equal to it. Non-linear updaters decompress on
        the host, merge in rank order and apply once, as an uncompressed
        collective Add does. Every part is validated before any
        mutation, so a bad part fails the position on every rank."""
        option = self._check_parts_options(parts)[0]
        opt = option.as_tensors()
        if self.updater.combine_scale is None:
            host = [self._decompress_payload(p) for p in parts]
            ids, deltas = _combine_duplicate_rows(
                np.concatenate([i for i, _ in host]),
                np.concatenate([d for _, d in host]), self.num_cols,
                self.dtype)
            self._update_rows(ids, deltas, opt)
            self._note_add_parts(option, [i for i, _ in host])
            return
        rank_ids = []
        for p in parts:
            comp = p.get("compressed")
            if comp is None:
                ids = np.asarray(p["row_ids"], np.int32).ravel()
                self._check_ids(ids)
            else:
                ids = self._check_compressed_ids(comp)
            rank_ids.append(ids)
        union = np.unique(np.concatenate(rank_ids)).astype(np.int32)
        combined = torch.zeros((len(union), self.num_cols),
                               dtype=torch.float32, device=self.device)
        for p, ids in zip(parts, rank_ids):
            comp = p.get("compressed")
            if comp is None:
                ids, block = _combine_duplicate_rows(
                    ids, p["values"], self.num_cols, self.dtype)
                block = torch.from_numpy(np.ascontiguousarray(block)).to(
                    self.device)
            else:
                block = self._rebuild_compressed(comp, len(ids))
            # unique ids within a part: one add a row, in rank order
            inv = torch.from_numpy(np.searchsorted(union, ids).astype(
                np.int64)).to(self.device)
            combined.index_add_(0, inv, block)
        self._update_rows(union, combined, opt)
        self._note_add_parts(option, rank_ids)

    def _decompress_payload(self, p):
        """A rank's Add payload -> host (ids, deltas), compressed or not
        (the JAX package's ``_decompress_payload``)."""
        comp = p.get("compressed")
        if comp is None:
            ids = np.asarray(p["row_ids"], np.int32).ravel()
            self._check_ids(ids)
            return ids, np.asarray(p["values"], self.dtype).reshape(
                len(ids), self.num_cols)
        ids = self._check_compressed_ids(comp)
        if comp["kind"] == "sparse":
            deltas = SparseFilter().decompress(
                True, comp["idx"], comp["val"], len(ids) * self.num_cols,
                self.dtype).reshape(len(ids), self.num_cols)
        else:
            lanes = np.unpackbits(comp["packed"])[: len(ids) * self.num_cols]
            lanes = lanes.astype(bool).reshape(len(ids), self.num_cols)
            deltas = np.where(lanes, comp["pos"][:, None],
                              comp["neg"][:, None]).astype(self.dtype)
        return ids, deltas

    def ProcessAddRunParts(self, positions, my_rank: int) -> bool:
        """A window's collective row Adds (all positions, all ranks) as ONE
        row update: linear aux-free updaters only (the ProcessAddRun
        contract); declines whole-table, compressed and doubtful payloads so
        the per-position path reports precise errors."""
        if not self._merge_adds:
            return False
        all_ids, all_deltas, noted = [], [], []
        for parts in positions:
            opts = self._norm_parts_options(parts)
            if not all(o == opts[0] for o in opts):
                return False
            rank_ids = []
            for p in parts:
                row_ids = p.get("row_ids")
                if row_ids is None or p.get("compressed") is not None:
                    return False
                ids = np.asarray(row_ids, np.int32).ravel()
                if (ids.size == 0 or int(ids.min()) < 0
                        or int(ids.max()) >= self.num_rows):
                    return False
                values = np.asarray(p.get("values"), self.dtype)
                if values.size != ids.size * self.num_cols:
                    return False
                all_ids.append(ids)
                all_deltas.append(values.reshape(len(ids), self.num_cols))
                rank_ids.append(ids)
            noted.append((opts[0], rank_ids))
        ids, deltas = _combine_duplicate_rows(
            np.concatenate(all_ids), np.concatenate(all_deltas),
            self.num_cols, self.dtype)
        self._apply_rows_host(ids, deltas, AddOption().as_tensors())
        # bookkeeping per position in window order, as per-position
        # applies would fire it (the engine serves no Get inside a run)
        for option, rank_ids in noted:
            self._note_add_parts(option, rank_ids)
        return True

    # -- the device window transport (tables/base.py contract; the JAX
    # package's matrix_table.py:1117-1230) -----------------------------------

    def device_wire_add_ok(self, payload) -> bool:
        """Row-set Adds of a plain dense delta can ride the device wire: the
        ids (small) cross the host exchange, the delta block moves card to
        card. Whole-table payloads decline, and a COMPRESSED table declines
        entirely: compression already shrank the host bytes, and its dense
        fallback is decided per rank."""
        return (self.compress is None
                and payload.get("row_ids") is not None
                and payload.get("compressed") is None
                and isinstance(payload.get("values"), np.ndarray))

    def _merge_device_rows(self, ids: np.ndarray, values: torch.Tensor):
        """The device merge of one collective batch: ``ids`` every part's
        row ids concatenated (host), ``values`` their deltas as one flat
        tensor on the table's device, in the same order. Returns (row ids,
        deltas at the storage width on the device), bitwise what
        ``_combine_duplicate_rows`` gives: duplicates summed on the device
        in submission order (``ops.dedup_rows(deterministic=True)``: a
        stable sort and a segment sum over the lanes, with the pad columns
        the sum runs over more than one column), and a lone id keeps its
        own delta bits (the host merge assigns it, so a -0.0 stays
        -0.0)."""
        d = self._device_deltas(values, len(ids))
        uniq, first, counts = np.unique(ids, return_index=True,
                                        return_counts=True)
        if len(uniq) == len(ids):
            return ids, d
        _, out = ops.dedup_rows(torch.from_numpy(ids).to(self.device), d,
                                deterministic=True)
        out = out[: len(uniq)]
        lone = np.flatnonzero(counts == 1)
        if lone.size:
            out.index_copy_(0, torch.from_numpy(lone).to(self.device),
                            d.index_select(0, torch.from_numpy(
                                first[lone]).to(self.device)))
        return uniq.astype(np.int32), out

    def _device_part(self, p) -> Optional[np.ndarray]:
        """A deferred run's part -> its validated row ids, or None to
        decline (the per-position path then reports precise errors)."""
        row_ids = p.get("row_ids")
        if row_ids is None or p.get("compressed") is not None:
            return None
        ids = np.asarray(row_ids, np.int32).ravel()
        if (ids.size == 0 or int(ids.min()) < 0
                or int(ids.max()) >= self.num_rows):
            return None
        v = p.get("values")
        if (not isinstance(v, (DeferredArray, np.ndarray))
                or v.size != ids.size * self.num_cols):
            return None
        return ids

    def ProcessAddPartsDevice(self, parts, my_rank: int) -> None:
        """One collective row Add whose values ride the device wire. Every
        rank validates every rank's metadata (ids and the declared value
        shapes), so a failure raises identically everywhere; the batch is
        every rank's values in rank order (this rank's from its own slot,
        the peers' copied out of theirs), merged on the device and applied
        through the row path: ``<kAdd>``/``<kSub>`` for the add and sgd
        updaters, ``<kGather>``, the updater and ``<kSet>`` for the
        others."""
        opts = self._check_parts_options(parts)
        rank_ids = []
        for p in parts:
            ids = np.asarray(p["row_ids"], np.int32).ravel()
            self._check_ids(ids)
            CHECK(np.size(p["values"]) == ids.size * self.num_cols,
                  "device-wire Add size mismatch")
            rank_ids.append(ids)
        values = device_wire.current().gather([p["values"] for p in parts],
                                              self.device)
        ids, deltas = self._merge_device_rows(np.concatenate(rank_ids),
                                              values)
        self._update_rows_padded(ids, deltas, opts[0].as_tensors())
        self._note_add_parts(opts[0], rank_ids)

    def ProcessAddRunPartsDevice(self, positions, my_rank: int) -> bool:
        """A window's deferred row Adds (all positions, all ranks) as ONE
        device merge and row update, concatenated position by position and
        rank by rank as the host-wire run concatenates them: linear
        aux-free updaters only; declines on any doubt. The bookkeeping
        fires per position in window order after the apply."""
        if not self._merge_adds:
            return False
        all_ids, values, noted = [], [], []
        for parts in positions:
            opts = self._norm_parts_options(parts)
            if not all(o == opts[0] for o in opts):
                return False
            rank_ids = []
            for p in parts:
                ids = self._device_part(p)
                if ids is None:
                    return False
                all_ids.append(ids)
                values.append(p["values"])
                rank_ids.append(ids)
            noted.append((opts[0], rank_ids))
        flat = device_wire.current().gather(values, self.device)
        ids, deltas = self._merge_device_rows(np.concatenate(all_ids), flat)
        self._update_rows_padded(ids, deltas, AddOption().as_tensors())
        for option, rank_ids in noted:
            self._note_add_parts(option, rank_ids)
        return True

    def ProcessGet(self, option: Optional[GetOption] = None,
                   row_ids: Optional[np.ndarray] = None):
        return self.ProcessGetAsync(option, row_ids)()

    def ProcessGetAsync(self, option: Optional[GetOption] = None,
                        row_ids=None):
        """Dispatch the gather now, fetch in finalize: a window's Gets
        queue their device work back to back and the engine pays the
        device->host waits after. The whole-table read snapshots the
        storage first, because a later Add of the same window updates
        it in place; the snapshot is made in the logical layout, so the
        fetch writes the reply once. The native store serves at once (its
        read is a synchronous copy with nothing to overlap)."""
        nat = self._host_store()
        if nat is not None:
            if row_ids is None:
                out = nat.get_all()
            else:
                ids = np.asarray(row_ids, np.int32).ravel()
                self._check_ids(ids)
                self._note_row_access(ids)
                out = nat.get_rows(ids)
            return lambda: out
        if row_ids is None:
            # a clone, never .contiguous(): with one shard and no pad
            # columns the logical view is the live storage itself
            data = self._logical(self.updater.access(
                self.state["data"], self.state["aux"], None)).clone(
                    memory_format=torch.contiguous_format)
            return lambda: self._ctx.fetch(data)
        ids = np.asarray(row_ids, np.int32).ravel()
        self._check_ids(ids)
        # the -mv_row_sketch hook: every engine row Get (one process or
        # the parts paths, which funnel here) notes its host ids once
        self._note_row_access(ids)
        rows = self._gather_rows(ids)
        return lambda: self._ctx.fetch(rows)

    def _note_row_access(self, ids) -> None:
        """Feed one Get's host row ids to the ``-mv_row_sketch`` access
        sketch (``telemetry/sketch.py``; off = one cached int read). The
        device-plane verbs hold their ids on the caller's side and do not
        note (as in the JAX package)."""
        fam = ("sparse" if "sparse" in type(self).__name__.lower()
               else "matrix")
        tsketch.note_table_access(self, ids, fam)

    # -- device plane (public) ---------------------------------------------------
    # For callers that keep the rows on the device (the WordEmbedding
    # communicator's -device_plane path, the LR device plane): host-plane
    # validation, no host round trip of the row data in one process. These
    # bypass the engine — the caller owns the table while using them.
    # Multi-process, reads stay local (every row is on every replica) and
    # writes are COLLECTIVE: every rank calls them in lockstep with its own
    # batch, the batches meet in one all-gather and every rank applies the
    # rank-order merge (``device_apply_rows_many``).

    def device_rows(self) -> torch.Tensor:
        """The live logical rows, (num_rows, num_cols) on the table's
        device, as a VIEW of the storage: a caller that computes on the
        table's state in place (``binding/param_manager.py``
        ``DeviceTableParams``) reads the row path's writes through it.
        Re-take it after a host-plane Add or a Load."""
        rows = self._logical(self.state["data"])
        CHECK(rows.untyped_storage().data_ptr()
              == self.state["data"].untyped_storage().data_ptr(),
              "device_rows: the logical rows are not a view of the storage")
        self._drop_mirror()
        return rows

    def device_fetch_rows(self, row_ids) -> torch.Tensor:
        """Rows for ``row_ids`` as a fresh device tensor (n, num_cols),
        read from this rank's replica (no collective)."""
        ids = np.asarray(row_ids, np.int32).ravel()
        self._check_ids(ids)
        return self._gather_rows(ids)

    def device_apply_rows(self, row_ids, deltas,
                          option: Optional[AddOption] = None, ride=None):
        """Apply a (device or host) delta batch to ``row_ids`` in place,
        with ProcessAdd's validation and duplicate pre-combine; collective
        in a multi-process world (``device_apply_rows_many``, which also
        says what ``ride`` is)."""
        return device_apply_rows_many([(self, row_ids, deltas)], option,
                                      ride=ride)

    def device_update_gather_rows(self, row_ids, deltas,
                                  option: Optional[AddOption] = None
                                  ) -> torch.Tensor:
        """The fused PS round on the device plane: apply ``deltas`` to the
        UNIQUE rows ``row_ids`` and return their post-update rows. In a
        multi-process world the write is the collective
        ``device_apply_rows`` and the rows are read back after it, so a
        rank sees every rank's deltas."""
        ids = np.asarray(row_ids, np.int32).ravel()
        self._check_ids(ids)
        CHECK(len(np.unique(ids)) == len(ids),
              "device_update_gather_rows takes unique row ids")
        if multihost.world_size() > 1:
            self.device_apply_rows(ids, deltas, option)
            return self._gather_rows(ids)
        return self._update_gather_rows(
            ids, deltas, (option or AddOption()).as_tensors())

    def _apply_rows_local(self, ids: np.ndarray, deltas, opt) -> None:
        """One rank's row batch on this replica: duplicate ids pre-combine
        on the host in submission order, then the row path
        (``_update_rows``)."""
        if len(np.unique(ids)) != len(ids):
            # a device->host hop; block row sets are unique already
            host = deltas.detach().cpu().numpy() if isinstance(
                deltas, torch.Tensor) else deltas
            ids, deltas = _combine_duplicate_rows(ids, host, self.num_cols,
                                                  self.dtype)
        self._update_rows(ids, deltas, opt)

    def raw(self) -> np.ndarray:
        """Logical-view snapshot (host numpy)."""
        return self._ctx.fetch(self._logical(self.state["data"]))

    # -- serving-plane export (tables/base.py contract) -----------------------

    def _gather_from(self, data: torch.Tensor, ids) -> np.ndarray:
        """Logical rows ``ids`` (validated, in range) of ``data``, a copy of
        this table's storage, in host memory as an (n, num_cols) array: the
        lane mapping, ``<kGather>`` on the card, the column trim, then a
        synchronising fetch (the reply never carries unfinished rows)."""
        _, ids_t = self._lanes_tensor(np.asarray(ids))
        rows = ops.gather_rows(data, ids_t)
        if self.store_cols != self.num_cols:
            rows = rows[:, : self.num_cols]
        return rows.cpu().numpy()

    def _full_logical(self) -> np.ndarray:
        """The whole logical table in host memory, as a training Get of the
        whole table reads it (the updater's ``access()`` applied)."""
        return self._ctx.fetch(self._logical(self.updater.access(
            self.state["data"], self.state["aux"], None)))

    def serving_export(self):
        """Immutable row snapshot for the serving plane, by
        ``-mv_serving_residence`` (serving/snapshot.py):

        * the native store live (a CPU table; not under ``device``):
          copy-on-publish of the store, one copy of the logical rows (the
          store's updaters have an identity ``access()``, so the copy is
          the training view);
        * device (one process, no updater aux state; under ``auto`` only
          for a table on a CUDA device): ONE ``clone()`` of the padded
          storage on the table's device, which later in-place updates
          cannot reach, read by ``_gather_from`` (``<kGather>`` on the
          card), so only requested rows cross to the host;
        * otherwise the logical host materialization ``_full_logical``
          (the access() view); always so in a multi-process world."""
        from multiverso_tpu_torch.serving import snapshot as ssnap
        mode = ssnap.residence_mode()
        nat = self._host_store()
        if nat is not None and mode != "device":
            return ssnap.MatrixSnapshot.host(nat.get_all())
        device_legal = (multihost.world_size() <= 1
                        and not self.state["aux"])
        want_device = mode == "device" or (mode == "auto"
                                           and self.device.type == "cuda")
        if want_device and device_legal:
            return ssnap.MatrixSnapshot.device(
                self.state["data"].clone(), self._gather_from,
                self.num_rows, self.num_cols)
        return ssnap.MatrixSnapshot.host(self._full_logical())

    # -- checkpoint (reference matrix_table.cpp:457-465) ---------------------

    def Store(self, stream) -> None:
        stream.WriteInt(self.num_rows)
        stream.WriteInt(self.num_cols)
        stream.Write(self.raw().tobytes())

    def Load(self, stream) -> None:
        rows, cols = stream.ReadInt(), stream.ReadInt()
        CHECK(rows == self.num_rows and cols == self.num_cols,
              "checkpoint shape mismatch")
        raw = stream.Read(rows * cols * self.dtype.itemsize)
        values = np.frombuffer(raw, self.dtype).reshape(rows, cols)
        self.state = dict(self.state,
                          data=self._ctx.place(self._to_storage(values)))


class MatrixWorkerTable(WorkerTable):
    """Worker half (reference matrix_table.h:26-77)."""

    telemetry_label = "matrix"

    def __init__(self, num_rows: int, num_cols: int, dtype=np.float32,
                 compress: Optional[str] = None):
        super().__init__()
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.dtype = np.dtype(dtype)
        self._compress = compress
        if compress == "1bit":
            # one residual per table, shared by the worker threads
            self._onebit = RowOneBitsFilter(num_rows, num_cols)
            self._onebit_lock = threading.Lock()

    def _compressed_payload(self, ids: np.ndarray,
                            deltas) -> Optional[dict]:
        """A row batch compressed for the wire, or None when the dense
        payload goes instead (compression off, the sparse filter's dense
        fallback, or invalid ids: the server then raises at the caller's
        Wait and the 1-bit residual is left alone). Duplicate ids combine
        first: compression and the residual are per unique row."""
        if self._compress is None:
            return None
        ids = np.asarray(ids, np.int32).ravel()
        if (ids.size == 0 or int(ids.min()) < 0
                or int(ids.max()) >= self.num_rows):
            return None
        deltas = np.asarray(deltas, self.dtype).reshape(len(ids),
                                                        self.num_cols)
        ids, deltas = _combine_duplicate_rows(ids, deltas, self.num_cols,
                                              self.dtype)
        if self._compress == "sparse":
            is_sparse, idx, val = SparseFilter().compress(deltas)
            if not is_sparse:
                return None
            return {"kind": "sparse", "row_ids": ids, "idx": idx,
                    "val": val.astype(self.dtype)}
        with self._onebit_lock:
            packed, pos, neg = self._onebit.compress(
                ids, deltas, next_bucket(len(ids)))
        return {"kind": "1bit", "row_ids": ids, "packed": packed,
                "pos": pos, "neg": neg}

    def Get(self, option: Optional[GetOption] = None) -> np.ndarray:
        """Whole-table get (reference matrix_table.h:30-36)."""
        return self.Wait(self.GetAsync({"row_ids": None}, option))

    def GetRows(self, row_ids, option: Optional[GetOption] = None
                ) -> np.ndarray:
        """Row-set get; rows come back in the requested order."""
        ids = np.asarray(row_ids, np.int32)
        return self.Wait(self.GetAsync({"row_ids": ids}, option))

    def Add(self, delta: np.ndarray, option: Optional[AddOption] = None) -> None:
        self.Wait(self.AddAsync(
            {"row_ids": None, "values": np.asarray(delta, self.dtype)}, option))

    def _row_payload(self, ids, deltas) -> dict:
        """An Add's payload: compressed when the table compresses and the
        batch qualifies, dense otherwise (and for whole-table Adds)."""
        comp = None if ids is None else self._compressed_payload(ids, deltas)
        if comp is not None:
            return {"compressed": comp}
        return {"row_ids": ids, "values": np.asarray(deltas, self.dtype)}

    def AddRows(self, row_ids, deltas: np.ndarray,
                option: Optional[AddOption] = None) -> None:
        self.Wait(self.AddAsync(
            self._row_payload(np.asarray(row_ids, np.int32), deltas), option))

    def GetAsyncHandle(self, row_ids=None, option=None) -> int:
        ids = None if row_ids is None else np.asarray(row_ids, np.int32)
        return self.GetAsync({"row_ids": ids}, option)

    def AddAsyncHandle(self, deltas, row_ids=None, option=None) -> int:
        ids = None if row_ids is None else np.asarray(row_ids, np.int32)
        return self.AddAsync(self._row_payload(ids, deltas), option)

    def AddFireForget(self, deltas, row_ids=None, option=None) -> None:
        """Untracked async push (no Waiter/result bookkeeping)."""
        ids = None if row_ids is None else np.asarray(row_ids, np.int32)
        self.AddAsync(self._row_payload(ids, deltas), option, track=False)

    # -- write combining (tables/base.py contract) ----------------------------

    def _combinable_fire_forget(self, payload) -> bool:
        """Row-set Adds with a dense delta combine: the concatenated (ids,
        deltas) batch applies as ONE Add whose duplicate-row pre-combine
        sums in concatenation (= submission) order, the engine's own
        merged-run semantics for a burst. Whole-table Adds decline (a sum
        is sound only for linear updaters). A COMPRESSED table declines
        entirely: the sparse filter's compress-or-dense choice depends on
        each rank's data, so buffering only the dense fallbacks would
        make the combining itself data-dependent and diverge the ranks'
        verb streams; ``_compress`` is creation-time configuration every
        rank shares."""
        return (self._compress is None
                and payload.get("row_ids") is not None
                and payload.get("compressed") is None
                and isinstance(payload.get("values"), np.ndarray))

    def _combine_fire_forget(self, payloads) -> dict:
        ids = np.concatenate([np.asarray(p["row_ids"], np.int32).ravel()
                              for p in payloads])
        vals = np.concatenate(
            [np.asarray(p["values"], self.dtype).reshape(-1, self.num_cols)
             for p in payloads])
        return {"row_ids": ids, "values": vals}

    def server(self) -> MatrixServerTable:
        """The co-located server half (device-plane access)."""
        return self._zoo.server_tables[self.table_id]

    def Partition(self, row_ids, num_servers: Optional[int] = None
                  ) -> Dict[int, list]:
        """Bucket row ids by owning server (reference
        matrix_table.cpp:235-296), using the ceil-block ownership."""
        if num_servers is None:
            num_servers = self._zoo.num_servers
        ids = np.asarray(row_ids, np.int64).ravel()
        block = ceil_block_rows(self.num_rows, num_servers)
        owners = np.minimum(ids // block, num_servers - 1)
        return {int(s): [int(r) for r in ids[owners == s]]
                for s in np.unique(owners)}
