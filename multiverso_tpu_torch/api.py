"""Public ``MV_*`` API of the port.

Counterpart of ``multiverso_tpu/api.py`` (reference multiverso.h:9-64):
init/shutdown/barrier, rank and size, worker/server ids, table creation,
model-average aggregation, programmatic flags, batched verbs, worker
contexts, checkpoint/resume of every table, and the launcher-free net
wiring of a multi-process world (``MV_NetBind``/``MV_NetConnect``/
``MV_NetFinalize``). The rest of the JAX surface (serving, profiler,
telemetry, elastic, policy) is later work (``ROADMAP.md``).

Device rule: ``MV_Init`` runs the world on ``cuda:0`` unless the caller
asks for the CPU (``-mv_device=cpu`` or ``devices=[torch.device("cpu")]``);
with neither and no CUDA device it raises.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.utils.configure import (ResetFlagsToDefaults,
                                                  SetCMDFlag)
from multiverso_tpu_torch.zoo import Zoo


def MV_Init(argv: Optional[List[str]] = None, devices=None) -> List[str]:
    """Bring up the runtime; returns the argv entries no flag claimed."""
    return Zoo.Get().Start(argv, devices=devices)


def MV_ShutDown(finalize_net: bool = True) -> None:
    """Drain and stop the world; flags return to their defaults so one
    process can run successive worlds. Idempotent. ``finalize_net``
    (reference multiverso.h:13): True also tears down the multi-process
    world this runtime brought up (``MV_NetFinalize``); False keeps it up
    for the next ``MV_Init`` in this process, as the reference unit tests'
    ``MV_ShutDown(false)`` keeps MPI."""
    Zoo._reset()
    ResetFlagsToDefaults()
    if finalize_net:
        multihost.net_finalize()
    else:
        multihost.net_reset()


def MV_Barrier() -> None:
    Zoo.Get().Barrier()


def MV_Rank() -> int:
    return Zoo.Get().rank


def MV_Size() -> int:
    return Zoo.Get().size


def MV_NumWorkers() -> int:
    return Zoo.Get().num_workers


def MV_NumServers() -> int:
    return Zoo.Get().num_servers


def MV_WorkerId() -> int:
    return Zoo.Get().current_worker_id()


def MV_ServerId() -> int:
    return 0 if Zoo.Get().node.is_server() else -1


def MV_CreateTable(option):
    """Create a table (reference multiverso.h:34-41)."""
    from multiverso_tpu_torch.tables.base import CreateTable
    return CreateTable(option)


def MV_Aggregate(data: np.ndarray) -> np.ndarray:
    """Elementwise-sum allreduce across workers, in place (reference
    multiverso.h:45, src/multiverso.cpp:53-56)."""
    return Zoo.Get().Aggregate(data)


def MV_NetBind(rank: int, endpoint: str) -> int:
    """Declare this process's rank and endpoint for a launcher-free world
    (reference MV_NetBind, multiverso.h:55, zmq_net.h:64-81). Call before
    MV_Init; rank 0's endpoint is the address the world rendezvouses on.
    0 on success, -1 on error."""
    return multihost.net_bind(rank, endpoint)


def MV_NetConnect(ranks, endpoints) -> int:
    """Declare the whole world as parallel (ranks, endpoints) lists
    (reference MV_NetConnect, multiverso.h:56, zmq_net.h:83-110); the next
    MV_Init brings it up. 0 on success, -1 on error."""
    return multihost.net_connect(ranks, endpoints)


def MV_NetFinalize() -> None:
    """Forget the net declarations and tear down the multi-process world
    this runtime brought up (reference MV_NetFinalize, multiverso.h:65)."""
    multihost.net_finalize()


def MV_SetFlag(name: str, value) -> None:
    SetCMDFlag(name, value)


def MV_SaveCheckpoint(uri: str) -> int:
    """Store every registered server table and its updater aux state to
    ``uri`` (reference table_interface.h:61-70, driven for all tables;
    see ``checkpoint.py``). Returns the number of tables written."""
    from multiverso_tpu_torch.checkpoint import save_checkpoint
    return save_checkpoint(uri)


def MV_LoadCheckpoint(uri: str) -> int:
    """Restore every registered server table from ``uri``."""
    from multiverso_tpu_torch.checkpoint import load_checkpoint
    return load_checkpoint(uri)


def MV_MultiAddAsync(ops, option=None, track: bool = True):
    """Batched cross-table Add: ``ops`` is a list of ``(table, payload)``
    pairs; the batch rides ONE engine mailbox message. Returns a
    ``MultiCall``."""
    from multiverso_tpu_torch.tables.base import submit_multi
    return submit_multi([(t, "A", p) for t, p in ops], option=option,
                        track=track)


def MV_MultiAdd(ops, option=None, track: bool = True) -> None:
    MV_MultiAddAsync(ops, option=option, track=track).Wait()


def MV_MultiGetAsync(ops, option=None):
    """Batched cross-table Get; ``Wait()`` yields the results in
    submission order."""
    from multiverso_tpu_torch.tables.base import submit_multi
    return submit_multi([(t, "G", p) for t, p in ops], option=option)


def MV_MultiGet(ops, option=None) -> list:
    return MV_MultiGetAsync(ops, option=option).Wait()


def MV_WorkerContext(worker_id: int):
    """Bind the calling thread to a worker id for the ``with`` block."""
    return Zoo.Get().worker_context(worker_id)
