"""ArrayTable — 1-D dense vector; Get and Add move the whole table.

Counterpart of ``multiverso_tpu/tables/array_table.py`` (reference
array_table.h, src/table/array_table.cpp): ``Get``/``Add`` always move the
whole table (key = -1 semantics, array_table.cpp:29-67), the server applies
the configured updater (array_table.cpp:116-143), ``Store``/``Load``
checkpoint it (array_table.cpp:145-154).

The whole table is ONE tensor on the world's device, padded to a multiple
of ``num_servers`` as in the JAX package (one server shard here, so no pad).
An Add is a host->device copy of the delta and the updater's elementwise
rule on the whole vector, written back in place; a Get fetches a snapshot.
Per-worker aux leaves (AdaGrad, DC-ASGD) have shape ``(num_workers,
padded)``.

Multi-process worlds: every process keeps a replica; a collective Add sums
every rank's whole-vector delta in rank order and applies the sum once
(``ProcessAddParts``; a window's Adds of a linear aux-free updater sum into
one apply, ``ProcessAddRunParts``), and a Get reads the local replica.

Device plane (``device_*``): a caller that keeps its work on the device
takes the ``{"data", "aux"}`` state, applies ``device_update`` and writes
the result back with ``device_set_state``. The verbs bypass the engine:
the caller owns the table while using them. In a multi-process world
``device_update`` is COLLECTIVE: every rank's padded delta comes to the
host, the ranks' deltas are summed in rank order after one all-gather
(their options must agree), and the updater's rule applies the sum on
every replica; ``device_set_state`` then takes only the state that
collective update returned, so no rank writes a state of its own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.parallel.mesh import (pad_to_multiple,
                                                 partition_offsets)
from multiverso_tpu_torch.tables.base import (ServerTable, TableOption,
                                              WorkerTable)
from multiverso_tpu_torch.updaters.base import (AddOption, CreateUpdater,
                                                GetOption, Updater)
from multiverso_tpu_torch.utils.log import CHECK


@dataclass
class ArrayTableOption(TableOption):
    """reference multiverso.h ArrayTableOption equivalent."""

    size: int = 0
    updater_type: Optional[str] = None  # None -> updater_type flag

    def make_server(self, zoo):
        return ArrayServer(self.size, self.dtype, zoo, self.updater_type)

    def make_worker(self, zoo):
        return ArrayWorker(self.size, self.dtype)


class ArrayServer(ServerTable):
    def __init__(self, size: int, dtype, zoo,
                 updater_type: Optional[str] = None):
        CHECK(size > 0, "ArrayTable size must be positive")
        self.size = size
        self.dtype = np.dtype(dtype)
        CHECK(self.dtype == np.float32,
              f"array tables hold float32 in this port; got {self.dtype}")
        self._ctx = zoo.device_ctx
        self.device = self._ctx.device
        self.num_servers = self._ctx.num_servers
        self.padded = pad_to_multiple(size, self.num_servers)
        self.updater = CreateUpdater(updater_type)
        self._has_access = type(self.updater).access is not Updater.access
        self.state = {
            "data": torch.zeros(self.padded, dtype=torch.float32,
                                device=self.device),
            "aux": self.updater.init_aux((self.padded,), torch.float32,
                                         zoo.num_workers,
                                         device=self.device)}
        #: the state the last collective device_update returned: the only
        #: one device_set_state takes in a multi-process world
        self._collective_state = None
        # linear aux-free updaters: a window's summed deltas apply as one
        # Add (the matrix table's _merge_adds rule)
        self._merge_adds = (self.updater.combine_scale is not None
                            and not self.state["aux"])

    def _padded_delta(self, values) -> torch.Tensor:
        values = np.asarray(values, self.dtype).ravel()
        CHECK(values.size == self.size, "Add size mismatch")
        if self.padded != self.size:
            values = np.pad(values, (0, self.padded - self.size))
        return self._ctx.place(values)

    def ProcessAdd(self, values: np.ndarray,
                   option: Optional[AddOption] = None) -> None:
        delta = self._padded_delta(values)
        self.state = self._updated(self.state, delta,
                                   (option or AddOption()).as_tensors())

    def ProcessAddParts(self, parts, my_rank: int) -> None:
        """One collective Add: every rank's delta summed in rank order,
        applied once."""
        opts = self._check_parts_options(parts)
        vals = []
        for p in parts:
            v = np.asarray(p["values"], self.dtype).ravel()
            CHECK(v.size == self.size, "Add size mismatch")
            vals.append(v)
        self.ProcessAdd(np.sum(vals, axis=0).astype(self.dtype), opts[my_rank])

    def ProcessAddRunParts(self, positions, my_rank: int) -> bool:
        """A window's collective Adds (all positions, all ranks) summed into
        ONE apply: linear aux-free updaters only; declines on any doubt so
        the per-position path reports precise errors."""
        if not self._merge_adds:
            return False
        vals = []
        for parts in positions:
            opts = self._norm_parts_options(parts)
            if not all(o == opts[0] for o in opts):
                return False
            for p in parts:
                v = p.get("values")
                if not isinstance(v, np.ndarray) or v.size != self.size:
                    return False
                vals.append(np.asarray(v, self.dtype).ravel())
        self.ProcessAdd(np.sum(vals, axis=0).astype(self.dtype), AddOption())
        return True

    def ProcessGet(self, option: Optional[GetOption] = None) -> np.ndarray:
        return self.ProcessGetAsync(option)()

    def ProcessGetAsync(self, option: Optional[GetOption] = None):
        """Snapshot now, fetch in finalize: a later Add of the same engine
        window updates the live state."""
        out = self.device_access(self.state)
        if not self._has_access:
            out = out.clone()
        return lambda: self._ctx.fetch(out)[: self.size]

    def serving_export(self):
        """Whole-vector copy-on-publish snapshot: arrays are the small
        whole-table family, so a device copy would buy nothing over one
        fetch, and ProcessGet is the training view (access() applied)."""
        from multiverso_tpu_torch.serving import snapshot as ssnap
        return ssnap.VectorSnapshot(self.ProcessGet(GetOption()))

    # -- device plane ----------------------------------------------------------

    def device_state(self) -> Dict:
        """The live {'data', 'aux'} state (write back with
        device_set_state); re-take it after any host-plane Add."""
        return self.state

    def device_set_state(self, state: Dict) -> None:
        if multihost.process_count() > 1:
            CHECK(state is self._collective_state,
                  "device_set_state in a multi-process world takes only "
                  "the state the collective device_update returned (a "
                  "state of one rank's own would split the replicas)")
            self._collective_state = None
        data = state["data"]
        CHECK(tuple(data.shape) == (self.padded,)
              and data.dtype == torch.float32,
              "device_set_state: data leaf shape/dtype mismatch")
        old_aux = self.state["aux"]
        CHECK(set(state["aux"]) == set(old_aux),
              "device_set_state: aux leaves drifted")
        for name, leaf in state["aux"].items():
            old = old_aux[name]
            CHECK(leaf.shape == old.shape and leaf.dtype == old.dtype,
                  f"device_set_state: aux leaf {name!r} drifted "
                  f"({tuple(old.shape)}/{old.dtype} -> "
                  f"{tuple(leaf.shape)}/{leaf.dtype})")
        self.state = state

    def device_update(self, state: Dict, padded_delta: torch.Tensor,
                      opt, ride=None):
        """One whole-table Add through the table's updater (delta padded
        to ``self.padded``; opt = AddOption.as_tensors()); returns the new
        state and leaves ``state`` alone. Collective in a multi-process
        world (module docstring). ``ride`` (a float or a device scalar,
        such as a window's loss) travels with the delta and comes back
        summed over the ranks in rank order: with it the call returns
        ``(new state, ride sum)`` (one process: the ride as given)."""
        if multihost.process_count() <= 1:
            new = self._updated(state, padded_delta, opt)
            return new if ride is None else (new, ride)
        CHECK(tuple(padded_delta.shape) == (self.padded,),
              "device_update: the delta must be padded to the table")
        (host,), ride = multihost.host_payloads([padded_delta], ride)
        # the ride rides as one more float of the summed vector
        vals = np.append(host, np.float32(0.0 if ride is None else ride))
        key = tuple((k, float(v)) for k, v in sorted(opt.items()))
        summed = multihost.sum_collective_add(key, vals,
                                              key="array_update")
        t0 = time.perf_counter()
        new = self._updated(state, self._ctx.place(summed[: self.padded]),
                            opt)
        multihost.note("apply", time.perf_counter() - t0)
        self._collective_state = new
        return new if ride is None else (new, float(summed[-1]))

    def _updated(self, state: Dict, padded_delta: torch.Tensor,
                 opt) -> Dict:
        new_data, new_aux = self.updater.update(state["data"], state["aux"],
                                                padded_delta, opt)
        return {"data": new_data, "aux": new_aux}

    def device_access(self, state: Dict, opt=None) -> torch.Tensor:
        """The whole table through the updater's access hook (slice
        [: size] for the logical view)."""
        return self.updater.access(state["data"], state["aux"], opt)

    # -- checkpoint (reference array_table.cpp:145-154) ----------------------

    def Store(self, stream) -> None:
        stream.WriteInt(self.size)
        stream.Write(self._ctx.fetch(self.state["data"])[: self.size]
                     .tobytes())

    def Load(self, stream) -> None:
        size = stream.ReadInt()
        CHECK(size == self.size, "checkpoint size mismatch")
        values = np.frombuffer(stream.Read(size * self.dtype.itemsize),
                               self.dtype).copy()
        if self.padded != self.size:
            values = np.pad(values, (0, self.padded - self.size))
        self.state = dict(self.state, data=self._ctx.place(values))

    # -- aux (updater state) <-> logical layout ------------------------------

    def aux_to_logical(self, leaf: torch.Tensor) -> np.ndarray:
        """Strip padding: last axis padded -> logical size."""
        return self._ctx.fetch(leaf)[..., : self.size]

    def aux_from_logical(self, arr: np.ndarray) -> np.ndarray:
        pad = self.padded - self.size
        if pad:
            arr = np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, pad)])
        return arr


class ArrayWorker(WorkerTable):
    """Worker half (reference array_table.h:13-39)."""

    telemetry_label = "array"

    def __init__(self, size: int, dtype=np.float32):
        super().__init__()
        self.size = size
        self.dtype = np.dtype(dtype)

    def Get(self, buffer: Optional[np.ndarray] = None,
            option: Optional[GetOption] = None) -> np.ndarray:
        result = self.Wait(self.GetAsync({}, option))
        if buffer is not None:
            np.copyto(buffer, result)
            return buffer
        return result

    def Add(self, delta: np.ndarray,
            option: Optional[AddOption] = None) -> None:
        self.Wait(self.AddAsync({"values": np.asarray(delta, self.dtype)},
                                option))

    def GetAsyncHandle(self, option: Optional[GetOption] = None) -> int:
        return self.GetAsync({}, option)

    def AddAsyncHandle(self, delta: np.ndarray,
                       option: Optional[AddOption] = None) -> int:
        return self.AddAsync({"values": np.asarray(delta, self.dtype)},
                             option)

    def AddFireForget(self, delta: np.ndarray,
                      option: Optional[AddOption] = None) -> None:
        """Untracked async push (no Waiter/result bookkeeping)."""
        self.AddAsync({"values": np.asarray(delta, self.dtype)}, option,
                      track=False)

    def server(self) -> ArrayServer:
        """The co-located server half (device-plane access)."""
        return self._zoo.server_tables[self.table_id]

    def Partition(self, num_servers: Optional[int] = None
                  ) -> List[Tuple[int, int]]:
        """Contiguous per-server ranges, the last server taking the
        remainder (reference array_table.cpp:101-105)."""
        if num_servers is None:
            num_servers = self._zoo.num_servers
        return partition_offsets(self.size, num_servers)
