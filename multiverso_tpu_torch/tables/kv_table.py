"""KVTable — scalar values keyed by int64.

Counterpart of ``multiverso_tpu/tables/kv_table.py`` (reference
kv_table.h): the server-side Add is plain ``+=`` (no updater), Get returns
current values (missing keys read as 0).

Control plane / data plane split, as in the JAX package: the slot index
(key -> dense slot) is host logic; the values are one growable tensor.
The index is the JAX package's vectorized numpy lookup: a dict of every
key, sorted key/slot arrays for bulk ``searchsorted`` lookups, and a small
``_pending`` dict of keys added since the sorted arrays were last rebuilt.
New keys take slots in first-sight order, and the table grows (capacity
doubling past the key count) once the key count reaches the capacity, so
the last slot, ``capacity - 1``, is always free to serve as the trash slot
of padded slot vectors. When the repo's C++ library loads (``native.py``),
the index is its ``KvIndex`` instead, created at first use, as in the JAX
package: it assigns the same first-sight slots.

64-bit values stay on the host (control-plane counters, like the JAX
package's host-backed branch, e.g. the WordEmbedding word count); other
dtypes live on the world's device. The scatter-add and gather are
``index_add_``/``index_select`` (the JAX package uses XLA there, not a
Pallas kernel).

Multi-process worlds: every process keeps a replica. A collective Add
concatenates every rank's (keys, values) in rank order, so new keys take
the same slots on every rank however the key sets diverge, and applies
them with duplicate slots pre-combined on the host (``index_add_``'s CUDA
atomics sum duplicates in an undefined order; the replicas must stay
bitwise equal). A Get reads the local replica.

Device plane (``device_*``): a caller that keeps its work on the device
resolves its keys to a padded slot vector once (``device_slots``), places
it (``device_place_slots``) and gathers from / scatter-adds into the live
values (``device_values``). The verbs bypass the engine: the caller owns
the table while using them. Resolve with ``create=True`` BEFORE taking
``device_values()``: growth replaces the values tensor. Across processes
the verbs are COLLECTIVE, as in the JAX package: ``device_slots`` merges
every rank's keys in rank order (one shared bucket), ``device_place_slots``
returns the GLOBAL batch (every rank's slots and deltas in rank order, the
part the JAX package places as a batch-sharded array), and
``device_scatter_add_slots`` applies that batch to the local replica with
the deterministic segment sums, so the replicas stay bitwise equal. A rank
reads its own lanes of a gathered global batch at ``[rank * bucket,
(rank + 1) * bucket)``. ``device_set_values`` stays local: every rank sets
the same values on its replica.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from multiverso_tpu_torch import native
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.ops.rows import scatter_add_rows
from multiverso_tpu_torch.parallel.mesh import next_bucket
from multiverso_tpu_torch.telemetry import sketch as tsketch
from multiverso_tpu_torch.tables.base import (ServerTable, TableOption,
                                              WorkerTable)
from multiverso_tpu_torch.updaters.base import AddOption, GetOption
from multiverso_tpu_torch.utils.log import CHECK

_MIN_BUCKET = 8


@dataclass
class KVTableOption(TableOption):
    init_capacity: int = 1024
    dtype: type = np.float32

    def make_server(self, zoo):
        return KVServerTable(self.dtype, zoo, self.init_capacity)

    def make_worker(self, zoo):
        return KVWorkerTable(self.dtype)


class KVServerTable(ServerTable):
    def __init__(self, dtype, zoo, init_capacity: int = 1024):
        self.dtype = np.dtype(dtype)
        self._tdtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        self._host_backed = self.dtype.itemsize == 8
        self._device = (torch.device("cpu") if self._host_backed
                        else zoo.device_ctx.device)
        # one server shard: the JAX package's pad to a multiple of
        # num_servers is the identity here
        self.capacity = max(int(init_capacity), _MIN_BUCKET)
        self._index: Dict[int, int] = {}
        self._sorted_keys = np.empty(0, np.int64)
        self._sorted_slots = np.empty(0, np.int32)
        self._pending: Dict[int, int] = {}
        self._nat_index: Optional[native.KvIndex] = None
        self._nat_index_tried = False
        #: the -mv_row_sketch key-access sketch (lazily created when armed)
        self._row_sketch = None
        self._row_sketch_notes = 0
        self._values = torch.zeros(self.capacity, dtype=self._tdtype,
                                   device=self._device)

    @property
    def device(self) -> torch.device:
        """Where the values live (the CPU for a 64-bit table)."""
        return self._device

    # -- slot management ------------------------------------------------------

    def _rebuild_lookup(self) -> None:
        n = len(self._index)
        ks = np.fromiter(self._index.keys(), np.int64, n)
        vs = np.fromiter(self._index.values(), np.int32, n)
        order = np.argsort(ks, kind="stable")
        self._sorted_keys = ks[order]
        self._sorted_slots = vs[order]
        self._pending = {}

    def _bulk_lookup(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized key -> slot (-1 = absent): searchsorted against the
        sorted arrays, misses patched from the small pending dict."""
        if len(self._sorted_keys):
            pos = np.searchsorted(self._sorted_keys, keys)
            pos_c = np.minimum(pos, len(self._sorted_keys) - 1)
            hit = self._sorted_keys[pos_c] == keys
            slots = np.where(hit, self._sorted_slots[pos_c],
                             -1).astype(np.int32)
        else:
            slots = np.full(len(keys), -1, np.int32)
        if self._pending:
            pend = self._pending
            for i in np.nonzero(slots < 0)[0]:
                s = pend.get(int(keys[i]))
                if s is not None:
                    slots[i] = s
        return slots

    def _nat(self) -> Optional[native.KvIndex]:
        """The native index, created at the first use of the index (not at
        table construction: creating it may build the library). Never
        mixed with the numpy index: taken only while that one is empty."""
        if not self._nat_index_tried:
            self._nat_index_tried = True
            if not self._index:
                self._nat_index = native.KvIndex.create(self.capacity)
        return self._nat_index

    def _slots_for(self, keys: np.ndarray, create: bool) -> np.ndarray:
        """Key -> slot (-1 = absent); ``create`` gives new keys slots in
        first-sight order and grows the table once the key count reaches
        the capacity."""
        nat = self._nat()
        if nat is not None:
            if not create:
                return nat.lookup(keys)
            slots = nat.insert(keys)
            if len(nat) >= self.capacity:
                self._grow(len(nat))
            return slots
        slots = self._bulk_lookup(keys)
        if create:
            miss = slots < 0
            if miss.any():
                # sorted-unique new keys re-ranked by first occurrence:
                # duplicates of a new key share one slot, and slots issue
                # in first-appearance order
                mk = keys[miss]
                uniq, first_idx, inv = np.unique(mk, return_index=True,
                                                 return_inverse=True)
                order = np.argsort(first_idx, kind="stable")
                rank_of = np.empty(len(uniq), np.int64)
                rank_of[order] = np.arange(len(uniq))
                base = len(self._index)
                slots[miss] = (base + rank_of[inv]).astype(np.int32)
                new = dict(zip(uniq[order].tolist(),
                               range(base, base + len(uniq))))
                self._index.update(new)
                self._pending.update(new)
                # amortized: the sorted arrays re-sort only once pending
                # outgrows ~1/8 of the index
                if len(self._pending) > max(1024, len(self._index) // 8):
                    self._rebuild_lookup()
            if len(self._index) >= self.capacity:
                self._grow(len(self._index))
        return slots

    def _grow(self, needed: int) -> None:
        cap = self.capacity
        while cap <= needed:
            cap *= 2
        grown = torch.zeros(cap, dtype=self._tdtype, device=self._device)
        grown[: self.capacity] = self._values
        self._values, self.capacity = grown, cap

    def _pad_slots(self, slots: np.ndarray,
                   bucket: Optional[int] = None) -> np.ndarray:
        """Bucket-padded slot vector: pad and absent lanes take the trash
        slot ``capacity - 1`` (free by the grow rule); their deltas must be
        zero on a scatter-add, and a gather's caller masks them."""
        CHECK(bucket is None or len(slots) <= bucket,
              f"slot batch {len(slots)} exceeds the fixed bucket {bucket}")
        b = bucket if bucket is not None else next_bucket(len(slots))
        out = np.full(b, self.capacity - 1, np.int32)
        out[: len(slots)] = np.where(slots < 0, self.capacity - 1, slots)
        return out

    # -- server verbs (reference kv_table.h:82-112) ---------------------------

    def _apply(self, keys: np.ndarray, deltas: np.ndarray) -> None:
        slots = torch.from_numpy(self._slots_for(keys, create=True).astype(
            np.int64))
        self._values.index_add_(0, slots.to(self._device),
                                torch.from_numpy(deltas).to(self._device))

    def ProcessAdd(self, keys: np.ndarray, values: np.ndarray,
                   option: Optional[AddOption] = None) -> None:
        keys = np.asarray(keys, np.int64).ravel()
        deltas = np.asarray(values, self.dtype).ravel()
        CHECK(keys.size == deltas.size, "kv add size mismatch")
        self._apply(keys, deltas)

    def ProcessAddRun(self, payloads) -> bool:
        """A window's KV Adds merge into ONE scatter-add: the Add is plain
        ``+=``, and concatenation keeps key first-sight order."""
        keys, deltas = [], []
        for p in payloads:
            k = np.asarray(p.get("keys"), np.int64).ravel()
            d = np.asarray(p.get("values"), self.dtype).ravel()
            if k.size != d.size:
                return False
            keys.append(k)
            deltas.append(d)
        self._apply(np.concatenate(keys), np.concatenate(deltas))
        return True

    def _apply_parts(self, parts_list) -> None:
        """Every payload of ``parts_list`` concatenated in order (window
        position, then rank), slots assigned in first-sight order, one
        scatter-add over unique slots."""
        keys, deltas = [], []
        for p in parts_list:
            k = np.asarray(p["keys"], np.int64).ravel()
            d = np.asarray(p["values"], self.dtype).ravel()
            CHECK(k.size == d.size, "kv add size mismatch")
            keys.append(k)
            deltas.append(d)
        slots = self._slots_for(np.concatenate(keys), create=True)
        uniq, inv = np.unique(slots, return_inverse=True)
        combined = np.zeros(len(uniq), self.dtype)
        np.add.at(combined, inv, np.concatenate(deltas))
        self._values.index_add_(
            0, torch.from_numpy(uniq.astype(np.int64)).to(self._device),
            torch.from_numpy(combined).to(self._device))

    def ProcessAddParts(self, parts, my_rank: int) -> None:
        """One collective Add: every rank's (keys, values) in rank order."""
        self._check_parts_options(parts)
        self._apply_parts(parts)

    def ProcessAddRunParts(self, positions, my_rank: int) -> bool:
        """A window's collective KV Adds as ONE scatter-add: the KV Add is
        plain ``+=``, and position-major, rank-minor concatenation keeps
        the key first-sight order of per-position applies. Declines on any
        doubt."""
        flat = []
        for parts in positions:
            opts = self._norm_parts_options(parts)
            if not all(o == opts[0] for o in opts):
                return False
            for p in parts:
                k, d = p.get("keys"), p.get("values")
                if (not isinstance(k, np.ndarray)
                        or not isinstance(d, np.ndarray)
                        or k.size != d.size):
                    return False
                flat.append(p)
        self._apply_parts(flat)
        return True

    def ledger_bytes(self):
        """Byte-ledger probe (tables/base.py contract): the values vector's
        storage (device bytes, or host bytes for a 64-bit table, which is
        host-resident) and the key index's host arrays. Sizes only."""
        out = {"device_bytes": 0, "host_mirror_bytes": 0, "host_bytes": 0}
        nbytes = int(self._values.untyped_storage().nbytes())
        out["host_bytes" if self._host_backed else "device_bytes"] += nbytes
        out["host_bytes"] += int(self._sorted_keys.nbytes
                                 + self._sorted_slots.nbytes)
        nat = self._nat_index
        if nat is not None:
            out["host_bytes"] += 12 * int(nat.capacity())  # i64 key + i32
        return out

    def ProcessGet(self, keys: np.ndarray,
                   option: Optional[GetOption] = None) -> np.ndarray:
        return self._get_dispatch(keys)()

    def ProcessGetAsync(self, keys=None, option=None):
        """Two-phase Get (tables/base.py contract), as the JAX KV table: in
        one process the gather dispatches now and the device->host fetch
        waits for the window's finalize; across processes the parts path
        serves it."""
        if multihost.world_size() > 1 or keys is None:
            return None
        return self._get_dispatch(keys)

    def _get_dispatch(self, keys):
        keys = np.asarray(keys, np.int64).ravel()
        # key-access skew (-mv_row_sketch): this rank's requested keys;
        # every Get path funnels here, so each logical Get notes once
        tsketch.note_table_access(self, keys, "kv")
        slots = self._slots_for(keys, create=False)
        vals = self._values.index_select(0, torch.from_numpy(
            np.where(slots < 0, 0, slots).astype(np.int64)).to(self._device))

        def _finalize():
            out = vals.cpu().numpy().copy()
            out[slots < 0] = 0   # absent keys read as 0
            return out
        return _finalize

    # -- device plane (matrix_table device_* counterpart) ---------------------

    def _check_device_plane(self) -> None:
        CHECK(not self._host_backed,
              "64-bit KV tables are host-resident (no device plane)")

    def device_slots(self, keys, create: bool = False, *,
                     bucket: Optional[int] = None) -> np.ndarray:
        """keys -> bucket-padded int32 slot vector (pad and absent lanes ->
        the trash slot: a gather's caller masks them, a scatter-add's
        deltas there must be zero). Collective across processes with
        ``create=True`` or without ``bucket``: one tagged all-gather of
        every rank's keys; ``create`` adds their union in rank order on
        every rank (the host Add's rule, so the slot maps stay identical),
        and the vectors share ONE bucket, the global longest key batch's.
        An explicit ``bucket`` with ``create=False`` issues no
        collective."""
        self._check_device_plane()
        keys = np.asarray(keys, np.int64).ravel()
        if multihost.world_size() > 1 and (create or bucket is None):
            parts = multihost.host_allgather_objects_capped(keys,
                                                            "kv_slots")
            if create:
                self._slots_for(np.concatenate(parts), create=True)
            if bucket is None:
                bucket = next_bucket(max(len(p) for p in parts))
        return self._pad_slots(self._slots_for(keys, create=create), bucket)

    def device_place_slots(self, padded_slots, deltas=None, *, dtype=None):
        """A padded slot vector (and optional delta vector) -> tensors on
        the table's device; device deltas stay where they are. Collective
        across processes: the GLOBAL batch, every rank's slots (and
        deltas) concatenated in rank order, every rank passing the shared
        bucket of ``device_slots``."""
        self._check_device_plane()
        slots = np.asarray(padded_slots, np.int32).ravel()
        if deltas is not None:
            if isinstance(deltas, torch.Tensor):
                CHECK(tuple(deltas.shape) == slots.shape,
                      "device_place_slots: size mismatch")
            else:
                deltas = np.asarray(deltas, dtype or self.dtype).ravel()
                CHECK(deltas.size == slots.size,
                      "device_place_slots: size mismatch")
        if multihost.world_size() > 1:
            slots, deltas = self._global_batch(slots, deltas)
        gslots = torch.from_numpy(slots.astype(np.int64)).to(self._device)
        if deltas is None:
            return gslots
        if isinstance(deltas, torch.Tensor):
            return gslots, deltas.to(self._device)
        return gslots, torch.from_numpy(deltas).to(self._device)

    @staticmethod
    def _global_batch(slots: np.ndarray, deltas):
        """Every rank's (slots, deltas) in rank order: one tagged
        all-gather of host copies (device deltas cross in one D2H)."""
        if isinstance(deltas, torch.Tensor):
            deltas = deltas.detach().cpu().numpy()
        parts = multihost.host_allgather_objects_capped((slots, deltas),
                                                        "kv_place")
        CHECK(all(len(p[0]) == len(slots) for p in parts),
              f"device_place_slots: the ranks' buckets differ "
              f"{[len(p[0]) for p in parts]}; pass device_slots' shared "
              f"bucket on every rank")
        CHECK(all((p[1] is None) == (deltas is None) for p in parts),
              "device_place_slots: some ranks passed deltas, some did not")
        slots = np.concatenate([p[0] for p in parts])
        if deltas is not None:
            deltas = np.concatenate([p[1] for p in parts])
        return slots, deltas

    def device_values(self) -> torch.Tensor:
        """The live values tensor (take it fresh after any host-plane
        write or slot creation; write back with device_set_values)."""
        self._check_device_plane()
        return self._values

    def device_set_values(self, values: torch.Tensor) -> None:
        """Install ``values`` as the live values (local: across processes
        every rank sets the same values on its own replica)."""
        self._check_device_plane()
        CHECK(tuple(values.shape) == (self.capacity,),
              f"values shape {tuple(values.shape)} != capacity "
              f"{self.capacity}")
        CHECK(values.dtype == self._tdtype,
              f"values dtype {values.dtype} != table dtype {self._tdtype} "
              f"(a drifted dtype would corrupt Store/Load and Gets)")
        self._values = values

    @staticmethod
    def device_gather_slots(values: torch.Tensor,
                            padded_slots: torch.Tensor) -> torch.Tensor:
        """values[slots] (mask the trash lanes yourself)."""
        return values.index_select(0, padded_slots)

    def device_scatter_add_slots(self, values: torch.Tensor,
                                 padded_slots: torch.Tensor,
                                 padded_deltas: torch.Tensor
                                 ) -> torch.Tensor:
        """values[slots] += deltas IN PLACE (duplicates accumulate; pad
        lanes' deltas must be zero); returns ``values``. Across processes
        ``padded_slots``/``padded_deltas`` are the global batch of
        ``device_place_slots``, applied with the deterministic segment
        sums (``index_add_``'s CUDA atomics sum duplicates in an undefined
        order, and the replicas must stay bitwise equal)."""
        if multihost.world_size() > 1:
            return scatter_add_rows(values, padded_slots, padded_deltas,
                                    deterministic=True)
        return values.index_add_(0, padded_slots, padded_deltas)

    @property
    def size(self) -> int:
        if self._nat_index is not None:
            return len(self._nat_index)
        return len(self._index)

    # -- serving-plane export (tables/base.py contract) -----------------------

    def serving_export(self):
        """Key-addressed copy-on-publish snapshot: the (keys, values) pairs
        of Store()'s cut, host copies that alias nothing the live table
        later mutates. Absent keys keep reading 0 (the live Get contract)."""
        from multiverso_tpu_torch.serving import snapshot as ssnap
        return ssnap.KVSnapshot(*self._items())

    # -- checkpoint (improvement over reference kv_table.h:106-112) ----------

    def _items(self):
        """(keys, values) in slot order, host copies: slot i is the i-th
        key (the dict holds them in insertion order, the native index
        sorts its items by slot)."""
        if self._nat() is not None:
            keys = self._nat_index.items()[0]
        else:
            keys = np.fromiter(self._index.keys(), np.int64,
                               len(self._index))
        vals = self._values[: len(keys)].cpu().numpy().astype(self.dtype)
        return keys, vals

    def Store(self, stream) -> None:
        keys, vals = self._items()
        stream.WriteInt(len(keys))
        stream.Write(keys.tobytes())
        stream.Write(vals.tobytes())

    def Load(self, stream) -> None:
        n = stream.ReadInt()
        keys = np.frombuffer(stream.Read(n * 8), np.int64)
        vals = np.frombuffer(stream.Read(n * self.dtype.itemsize), self.dtype)
        self.load_items(keys, vals)

    def load_items(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Replace the table with ``keys`` (slot i = keys[i]) and their
        values; the capacity grows to n + 1 when n keys do not fit."""
        keys = np.asarray(keys, np.int64).ravel()
        vals = np.asarray(vals, self.dtype).ravel()
        CHECK(keys.size == vals.size, "kv load size mismatch")
        CHECK(len(np.unique(keys)) == keys.size, "kv load: duplicate keys")
        n = keys.size
        if self._nat() is not None:
            self._nat_index.set_items(keys, np.arange(n, dtype=np.int32))
        else:
            self._index = {int(k): i for i, k in enumerate(keys)}
            self._rebuild_lookup()
        if n >= self.capacity:
            self.capacity = max(n + 1, _MIN_BUCKET)
        host = np.zeros(self.capacity, self.dtype)
        host[:n] = vals
        self._values = torch.from_numpy(host).to(self._device)


class KVWorkerTable(WorkerTable):
    """Worker half with a local cache of the values it fetched (reference
    kv_table.h:19-46)."""

    telemetry_label = "kv"

    #: buffered fetched elements past which the local cache merges at once
    CACHE_MERGE_ELEMS = 2_000_000

    def __init__(self, dtype=np.float32):
        super().__init__()
        self.dtype = np.dtype(dtype)
        self._cache: Dict[int, float] = {}
        self._cache_buf: list = []
        self._cache_buf_elems = 0

    def Get(self, keys, option: Optional[GetOption] = None) -> np.ndarray:
        keys = np.asarray(keys, np.int64).ravel()
        vals = self.Wait(self.GetAsync({"keys": keys}, option))
        # the reference's local cache (kv_table.h:40), merged lazily (on
        # raw() or past a bound) to keep a dict update off every Get; the
        # copies are snapshots, since the caller may reuse its key buffer
        # or scale the values in place before the merge runs
        self._cache_buf.append((keys.copy(), vals.copy()))
        self._cache_buf_elems += len(keys)
        if self._cache_buf_elems > self.CACHE_MERGE_ELEMS:
            self._merge_cache()
        return vals

    def _merge_cache(self) -> None:
        for k, v in self._cache_buf:
            self._cache.update(zip(k.tolist(), v.tolist()))
        self._cache_buf, self._cache_buf_elems = [], 0

    def raw(self) -> Dict[int, float]:
        """Local cache of the last-fetched values (reference
        kv_table.h:40)."""
        self._merge_cache()
        return self._cache

    def Add(self, keys, values, option: Optional[AddOption] = None) -> None:
        keys = np.asarray(keys, np.int64).ravel()
        vals = np.asarray(values, self.dtype).ravel()
        self.Wait(self.AddAsync({"keys": keys, "values": vals}, option))

    def AddFireForget(self, keys, values,
                      option: Optional[AddOption] = None) -> None:
        """Untracked async push (no Waiter/result bookkeeping)."""
        keys = np.asarray(keys, np.int64).ravel()
        vals = np.asarray(values, self.dtype).ravel()
        self.AddAsync({"keys": keys, "values": vals}, option, track=False)

    # -- write combining (tables/base.py contract) ----------------------------

    def _combinable_fire_forget(self, payload) -> bool:
        """KV pushes always combine: the server Add is a plain ``+=`` with
        no updater, and concatenation keeps the keys' first-sight order
        (which keeps the ranks' index replicas in lockstep)."""
        return (isinstance(payload.get("keys"), np.ndarray)
                and isinstance(payload.get("values"), np.ndarray))

    def _combine_fire_forget(self, payloads) -> dict:
        return {"keys": np.concatenate([p["keys"] for p in payloads]),
                "values": np.concatenate([p["values"] for p in payloads])}

    def server(self) -> KVServerTable:
        """The co-located server half (device-plane access)."""
        return self._zoo.server_tables[self.table_id]
