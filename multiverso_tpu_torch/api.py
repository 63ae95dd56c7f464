"""Public ``MV_*`` API of the port.

Counterpart of ``multiverso_tpu/api.py`` (reference multiverso.h:9-64):
init/shutdown/barrier, rank and size, worker/server ids, table creation,
model-average aggregation, programmatic flags, batched verbs, worker
contexts, checkpoint/resume of every table, the launcher-free net
wiring of a multi-process world (``MV_NetBind``/``MV_NetConnect``/
``MV_NetFinalize``) and the serving plane (``MV_PublishSnapshot``,
``MV_ServingLookup``, ``MV_PinVersion``, ``MV_UnpinVersion``), the
profiler (``MV_StartProfiler``/``MV_StopProfiler`` over
``torch.profiler``) and the telemetry verbs (``MV_MetricsSnapshot``,
``MV_DumpTrace``, ``MV_DumpFlightRecorder``, ``MV_DumpDiagnostics``) and
the elastic membership verbs (``MV_ElasticSync``, ``MV_ElasticLeave``,
``MV_ElasticJoin``, ``MV_ElasticEpoch``, ``MV_ElasticMembers``) and the
policy verbs (``MV_PolicySync``, ``MV_PolicyReport``, ``MV_PolicyKill``).

Device rule: ``MV_Init`` runs the world on ``cuda:0`` unless the caller
asks for the CPU (``-mv_device=cpu`` or ``devices=[torch.device("cpu")]``);
with neither and no CUDA device it raises.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np

from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.utils.configure import (ResetFlagsToDefaults,
                                                  SetCMDFlag)
from multiverso_tpu_torch.utils.log import CHECK, Log
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


def MV_WorkerIdToRank(worker_id: int) -> int:
    """The rank of the process hosting global worker ``worker_id``."""
    return Zoo.Get().worker_id_to_rank(worker_id)


def MV_ServerIdToRank(server_id: int) -> int:
    """The rank of the process hosting global server ``server_id``."""
    return Zoo.Get().server_id_to_rank(server_id)


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


def MV_PublishSnapshot() -> int:
    """Publish an immutable, versioned, cross-table-consistent snapshot of
    every live table for the serving plane (``serving/``); returns the new
    version. The cut rides the engine's stream as a barrier: every Add
    admitted before the call is in and none after. COLLECTIVE in a
    multi-process world (every process calls it at the same verb-stream
    position, like ``MV_Barrier``; the versions then agree on every rank).
    ``-mv_serving_keep`` newest versions stay live; pin older ones with
    ``MV_PinVersion``. CHECK-fails in ``-ma`` mode, which runs no engine and
    creates no table."""
    from multiverso_tpu_torch.serving import publish
    return publish()


def MV_ServingLookup(table, ids=None, version: Optional[int] = None,
                     deadline: Optional[float] = None) -> np.ndarray:
    """Serve ``ids`` of ``table`` (a worker table or a table id) from the
    published snapshot ``version`` (None = the latest) WITHOUT touching
    the engine's verb stream. ``ids=None`` reads the whole table; KV tables
    take int64 keys (absent keys read 0). Thread-safe and batched:
    concurrent callers of one table share one union read (one row gather
    on a device-resident snapshot). ``deadline`` (seconds, default
    ``-mv_deadline_s``) bounds the wait with ``DeadlineExceeded``; an
    admission past ``-mv_serving_max_inflight`` raises
    ``ServingOverloaded``."""
    from multiverso_tpu_torch.serving import get_plane
    table_id = getattr(table, "table_id", table)
    CHECK(isinstance(table_id, int) and table_id >= 0,
          f"MV_ServingLookup: bad table {table!r}")
    return get_plane().frontend.lookup(table_id, ids, version=version,
                                       deadline=deadline)


def MV_PinVersion(version: int) -> int:
    """Hold snapshot ``version`` live past the ``-mv_serving_keep``
    retention (pins nest); returns the version. Release with
    ``MV_UnpinVersion``."""
    from multiverso_tpu_torch.serving import get_plane
    return get_plane().store.pin(version)


def MV_UnpinVersion(version: int) -> None:
    """Release one ``MV_PinVersion`` pin; a version left without pins and
    outside the retention window is evicted at once."""
    from multiverso_tpu_torch.serving import get_plane
    get_plane().store.unpin(version)


def MV_MultiAddAsync(ops, option=None, track: bool = True):
    """Batched cross-table Add: ``ops`` is a list of ``(table, payload)``
    pairs; the batch rides ONE engine mailbox message. Returns a
    ``MultiCall``."""
    from multiverso_tpu_torch.tables.base import submit_multi
    return submit_multi([(t, "A", p) for t, p in ops], option=option,
                        track=track)


def MV_MultiAdd(ops, option=None, track: bool = True) -> None:
    # unbounded-ok: MultiCall.Wait honors -mv_deadline_s internally
    MV_MultiAddAsync(ops, option=option, track=track).Wait()


def MV_MultiGetAsync(ops, option=None):
    """Batched cross-table Get; ``Wait()`` yields the results in
    submission order."""
    from multiverso_tpu_torch.tables.base import submit_multi
    return submit_multi([(t, "G", p) for t, p in ops], option=option)


def MV_MultiGet(ops, option=None) -> list:
    # unbounded-ok: MultiCall.Wait honors -mv_deadline_s internally
    return MV_MultiGetAsync(ops, option=option).Wait()


def MV_WorkerContext(worker_id: int):
    """Bind the calling thread to a worker id for the ``with`` block."""
    return Zoo.Get().worker_context(worker_id)


_profiler_lock = threading.Lock()
#: the running trace: {"prof", "logdir", "cuda", "launches"} or None
_profiler: Optional[dict] = None


def _world_on_cuda() -> bool:
    """Whether the profiler traces the card: the running world's device,
    or (no world) whether the process has a card at all."""
    zoo = Zoo.Get()
    if zoo.started and zoo.device_ctx is not None:
        return zoo.device_ctx.device.type == "cuda"
    import torch
    return torch.cuda.is_available()


def _all_threads():
    """A Kineto config that records every thread's ``record_function``
    ranges (the engine shards, the exchange stage and the apply pool run
    off the caller's thread), or None on a torch without the option (the
    caller thread's spans and every kernel are recorded either way)."""
    import torch
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def MV_StartProfiler(logdir: str) -> None:
    """Start a ``torch.profiler`` trace into ``logdir``: the host's
    activity, and the card's (``ProfilerActivity.CUDA``) in a world on a
    CUDA device. One trace at a time: a second start fails the CHECK.
    While it runs, every telemetry span also enters a
    ``torch.profiler.record_function`` of its name (telemetry/trace.py),
    so the ``mv`` spans sit on the timeline beside the kernels they
    launched. Only one profiler runs in a process: never call this inside
    another ``torch.profiler.profile``."""
    global _profiler
    import torch
    from multiverso_tpu_torch.ops import cuda_rows
    from multiverso_tpu_torch.telemetry import trace as ttrace
    with _profiler_lock:
        CHECK(_profiler is None,
              "MV_StartProfiler: a profiler trace is already active — "
              "one trace at a time (call MV_StopProfiler first)")
        cuda = _world_on_cuda()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts,
                                      experimental_config=_all_threads())
        prof.start()
        _profiler = {"prof": prof, "logdir": logdir, "cuda": cuda,
                     "launches": sum(cuda_rows.LAUNCHES.values())}
    ttrace.set_xplane(True)


def MV_StopProfiler() -> Optional[str]:
    """Stop the trace ``MV_StartProfiler`` started and write it as Chrome
    trace JSON into its ``logdir``; returns the file's path. Without an
    active trace this is a logged no-op (None). A CUDA trace in which the
    row kernels launched but no kernel event arrived (the CUPTI tracer did
    not load) raises instead of passing off a host-only trace."""
    global _profiler
    from multiverso_tpu_torch.ops import cuda_rows
    from multiverso_tpu_torch.telemetry import trace as ttrace
    with _profiler_lock:
        if _profiler is None:
            Log.Error("MV_StopProfiler without an active MV_StartProfiler "
                      "trace — no-op")
            return None
        ttrace.set_xplane(False)
        run, _profiler = _profiler, None
        run["prof"].stop()
        path = os.path.join(run["logdir"],
                            f"mv_profile_rank{multihost.process_index()}_"
                            f"{os.getpid()}.json")
        run["prof"].export_chrome_trace(path)
    if run["cuda"] and sum(cuda_rows.LAUNCHES.values()) > run["launches"]:
        from torch.autograd import DeviceType
        kernels = sum(1 for e in run["prof"].events()
                      if e.device_type == DeviceType.CUDA)
        CHECK(kernels > 0,
              f"MV_StopProfiler: the row kernels launched during the trace "
              f"but it holds no CUDA event ({path}) — the CUPTI tracer did "
              f"not record the card")
    return path


def MV_MetricsSnapshot() -> dict:
    """Job-wide telemetry snapshot: every registered instrument
    (telemetry/metrics.py) merged across processes, ``{name: {"type":
    ..., "value"/"count"/"p50"/...}}``. COLLECTIVE in a multi-process
    world (every process calls it at the same point with the engine
    quiesced, after MV_Barrier), on the gloo control group; identity in
    one process."""
    from multiverso_tpu_torch.telemetry import metrics
    return metrics.merged_snapshot()


def MV_DumpTrace(path: str) -> str:
    """Write the buffered spans (``-trace=true``) as Chrome trace-event
    JSON to ``path`` (each rank its own); returns ``path``."""
    from multiverso_tpu_torch.telemetry import trace
    return trace.dump(path)


def MV_DumpFlightRecorder(path: str) -> str:
    """Write the flight recorder's ring (``-mv_flight_events``) as JSONL
    to ``path``: a header line, then one event per line. Per rank, never
    collective; ``python -m multiverso_tpu_torch.telemetry.forensics`` and
    ``.critpath`` align several ranks' dumps. Returns ``path``."""
    from multiverso_tpu_torch.telemetry import flight
    return flight.dump(path)


def MV_DumpDiagnostics(dir_path: Optional[str] = None) -> Optional[str]:
    """Write the postmortem set (``flight_rank<R>.jsonl``,
    ``telemetry_rank<R>.json``, ``trace_rank<R>.json``) under ``dir_path``
    (default ``-mv_diag_dir``); returns the directory, or None when none
    is configured."""
    from multiverso_tpu_torch.telemetry.ops import dump_diagnostics
    return dump_diagnostics(dir_path)


def MV_ElasticSync() -> int:
    """Elastic sync point (requires ``-mv_elastic``): a LOCKSTEP rendezvous
    every active member calls at the same loop position. Applies at most
    one staged membership transition (drain / admit) at a fenced
    window-stream cut and always refreshes the retained snapshot cut (the
    silent-death rollback anchor). Returns the membership epoch in
    effect."""
    from multiverso_tpu_torch import elastic
    return elastic.sync()


def MV_ElasticLeave() -> int:
    """Gracefully drain THIS member from the running world: stages the
    departure and runs the final collective sync that applies it (the
    other members reach the same position through ``MV_ElasticSync``).
    The process stays alive, and ``MV_ElasticJoin`` re-admits it. Returns
    the epoch departed at."""
    from multiverso_tpu_torch import elastic
    return elastic.leave()


def MV_ElasticJoin() -> int:
    """Re-admit a departed member: stages the join, parks until the live
    members reach a sync point, downloads every table from the shard-move
    plane (the cut the world fenced at), rebuilds them on this process's
    device and commits. Returns the epoch joined at."""
    from multiverso_tpu_torch import elastic
    # unbounded-ok: every RPC inside elastic.join() is bounded by the
    # elastic control timeout (the joiner legitimately parks until the
    # live members reach a sync point)
    return elastic.join()


def MV_ElasticEpoch() -> int:
    """The membership epoch in effect (0 = the boot world or the plane
    off)."""
    from multiverso_tpu_torch import elastic
    return elastic.epoch()


def MV_ElasticMembers() -> tuple:
    """Boot ranks of the current world's members (an empty tuple when the
    elastic plane is off)."""
    from multiverso_tpu_torch import elastic
    return elastic.members()


def MV_PolicySync(timeout: float = 60.0) -> list:
    """Policy actuation point (requires ``-mv_policy``): a LOCKSTEP call
    every active member makes at the same loop position (the
    MV_SaveCheckpoint / MV_ElasticSync discipline). Pulls the ONE agreed
    staged-action list from the policy control authority's rendezvous,
    installs route/tune actions at this rank's fenced engine cut, and runs
    at most one guarded elastic drain (the sick rank's MV_ElasticLeave
    against the survivors' MV_ElasticSync). Returns the actions actuated
    ([] while the plane is off; single-process worlds actuate from the
    policy thread and rarely have anything left to flush here)."""
    from multiverso_tpu_torch import policy
    return policy.sync_point(timeout=timeout)


def MV_PolicyReport() -> dict:
    """The policy plane's local action report (the ``/actions`` body):
    guard settings, install/revert/drain counts, tracked actions under
    revert watch, and the bounded action history. Never collective."""
    from multiverso_tpu_torch import policy
    return policy.actions_report()


def MV_PolicyKill() -> None:
    """Runtime kill switch: flip ``-mv_policy`` off. The plane keeps
    watching (sustain and burn state stay warm) but installs nothing from
    the next evaluation on, actions ALREADY STAGED included: the pull
    rendezvous agrees the kill verdict across ranks, so one disarmed rank
    vetoes the whole batch world-wide. Re-arm with
    ``MV_SetFlag('mv_policy', 'true')``."""
    SetCMDFlag("mv_policy", "false")
    Log.Info("policy: kill switch thrown — acting disabled "
             "(MV_SetFlag('mv_policy','true') re-arms)")
