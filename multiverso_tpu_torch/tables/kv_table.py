"""KVTable — scalar values keyed by int64 (the subset this slice uses).

Counterpart of ``multiverso_tpu/tables/kv_table.py`` (reference
kv_table.h): the server-side Add is plain ``+=`` (no updater), Get returns
current values (missing keys read as 0). WordEmbedding keeps its int64
word count here.

Control plane / data plane split, as in the JAX package: the slot index
(key -> dense slot) is a host dict; the values are one growable tensor.
64-bit values stay on the host (they are control-plane counters, like the
JAX package's host-backed branch); other dtypes live on the world's
device. The scatter-add and gather are ``index_add_``/``index_select``
(the JAX package uses XLA there, not a Pallas kernel). The device-plane
slot verbs, checkpointing and the per-key access sketch are later work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from multiverso_tpu_torch.tables.base import (ServerTable, TableOption,
                                              WorkerTable)
from multiverso_tpu_torch.updaters.base import AddOption, GetOption
from multiverso_tpu_torch.utils.log import CHECK


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
        device = zoo.device_ctx.device
        self._device = (torch.device("cpu") if self.dtype.itemsize == 8
                        else device)
        self.capacity = max(int(init_capacity), 8)
        self._index: Dict[int, int] = {}
        self._values = torch.zeros(self.capacity, dtype=self._tdtype,
                                   device=self._device)

    def _slots_for(self, keys: np.ndarray, create: bool) -> np.ndarray:
        """Key -> slot (-1 = absent); ``create`` assigns new keys slots in
        first-sight order."""
        index = self._index
        if create:
            for k in keys.tolist():
                if k not in index:
                    index[k] = len(index)
            if len(index) > self.capacity:
                self._grow(len(index))
        return np.fromiter((index.get(k, -1) for k in keys.tolist()),
                           np.int64, len(keys))

    def _grow(self, needed: int) -> None:
        cap = self.capacity
        while cap < needed:
            cap *= 2
        grown = torch.zeros(cap, dtype=self._tdtype, device=self._device)
        grown[: self.capacity] = self._values
        self._values, self.capacity = grown, cap

    def _apply(self, keys: np.ndarray, deltas: np.ndarray) -> None:
        slots = torch.from_numpy(self._slots_for(keys, create=True))
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

    def ProcessGet(self, keys: np.ndarray,
                   option: Optional[GetOption] = None) -> np.ndarray:
        keys = np.asarray(keys, np.int64).ravel()
        slots = self._slots_for(keys, create=False)
        vals = self._values.index_select(0, torch.from_numpy(
            np.where(slots < 0, 0, slots)).to(self._device))
        out = vals.cpu().numpy().copy()
        out[slots < 0] = 0   # absent keys read as 0
        return out


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
