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
``device_values()``: growth replaces the values tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from multiverso_tpu_torch import native
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.parallel.mesh import next_bucket
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
        self._values = torch.zeros(self.capacity, dtype=self._tdtype,
                                   device=self._device)

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

    def ProcessGet(self, keys: np.ndarray,
                   option: Optional[GetOption] = None) -> np.ndarray:
        keys = np.asarray(keys, np.int64).ravel()
        slots = self._slots_for(keys, create=False)
        vals = self._values.index_select(0, torch.from_numpy(
            np.where(slots < 0, 0, slots).astype(np.int64)).to(self._device))
        out = vals.cpu().numpy().copy()
        out[slots < 0] = 0   # absent keys read as 0
        return out

    # -- device plane (matrix_table device_* counterpart) ---------------------

    def _check_device_plane(self) -> None:
        CHECK(not self._host_backed,
              "64-bit KV tables are host-resident (no device plane)")

    def device_slots(self, keys, create: bool = False, *,
                     bucket: Optional[int] = None) -> np.ndarray:
        """keys -> bucket-padded int32 slot vector (pad and absent lanes
        -> the trash slot). Creating slots outside the engine is not
        ported across processes: the ranks' slot maps would drift."""
        self._check_device_plane()
        if create:
            multihost.require_one_process("device_slots(create=True)")
        keys = np.asarray(keys, np.int64).ravel()
        return self._pad_slots(self._slots_for(keys, create=create), bucket)

    def device_place_slots(self, padded_slots, deltas=None, *, dtype=None):
        """A padded slot vector (and optional delta vector) -> tensors on
        the table's device; device deltas stay where they are."""
        self._check_device_plane()
        slots = np.asarray(padded_slots, np.int32).ravel()
        gslots = torch.from_numpy(slots.astype(np.int64)).to(self._device)
        if deltas is None:
            return gslots
        if isinstance(deltas, torch.Tensor):
            CHECK(tuple(deltas.shape) == slots.shape,
                  "device_place_slots: size mismatch")
            return gslots, deltas.to(self._device)
        d = np.asarray(deltas, dtype or self.dtype).ravel()
        CHECK(d.size == slots.size, "device_place_slots: size mismatch")
        return gslots, torch.from_numpy(d).to(self._device)

    def device_values(self) -> torch.Tensor:
        """The live values tensor (take it fresh after any host-plane
        write or slot creation; write back with device_set_values)."""
        self._check_device_plane()
        return self._values

    def device_set_values(self, values: torch.Tensor) -> None:
        multihost.require_one_process("device_set_values")
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

    @staticmethod
    def device_scatter_add_slots(values: torch.Tensor,
                                 padded_slots: torch.Tensor,
                                 padded_deltas: torch.Tensor
                                 ) -> torch.Tensor:
        """values[slots] += deltas IN PLACE (duplicates accumulate; pad
        lanes' deltas must be zero); returns ``values``."""
        multihost.require_one_process("device_scatter_add_slots")
        return values.index_add_(0, padded_slots, padded_deltas)

    @property
    def size(self) -> int:
        if self._nat_index is not None:
            return len(self._nat_index)
        return len(self._index)

    # -- checkpoint (improvement over reference kv_table.h:106-112) ----------

    def Store(self, stream) -> None:
        # keys in slot order: slot i is the i-th key (the dict holds them
        # in insertion order, the native index sorts its items by slot)
        if self._nat() is not None:
            keys = self._nat_index.items()[0]
        else:
            keys = np.fromiter(self._index.keys(), np.int64,
                               len(self._index))
        vals = self._values[: len(keys)].cpu().numpy().astype(self.dtype)
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
    """Worker half (reference kv_table.h:19-46)."""

    def __init__(self, dtype=np.float32):
        super().__init__()
        self.dtype = np.dtype(dtype)

    def Get(self, keys, option: Optional[GetOption] = None) -> np.ndarray:
        keys = np.asarray(keys, np.int64).ravel()
        return self.Wait(self.GetAsync({"keys": keys}, option))

    def Add(self, keys, values, option: Optional[AddOption] = None) -> None:
        keys = np.asarray(keys, np.int64).ravel()
        vals = np.asarray(values, self.dtype).ravel()
        self.Wait(self.AddAsync({"keys": keys, "values": vals}, option))

    def server(self) -> KVServerTable:
        """The co-located server half (device-plane access)."""
        return self._zoo.server_tables[self.table_id]
