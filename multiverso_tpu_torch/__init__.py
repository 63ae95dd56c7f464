"""multiverso_tpu_torch — the parameter server on PyTorch and CUDA.

The port of ``multiverso_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. It mirrors the JAX package's layout and names, so each module's
counterpart is found at the same path, and it imports nothing of JAX or
of ``multiverso_tpu``: what it needs from the JAX package's jax-free
modules it keeps as its own copy.

The port runs the MatrixTable row protocol (``MV_Init`` ->
``MV_CreateTable(MatrixTableOption)`` -> worker ``GetRows``/``AddRows`` ->
the engine -> the table's row programs -> the updater) on the JAX
package's engine modes (async, sharded async, BSP ``-sync``, and
model-average ``-ma`` with ``MV_Aggregate``), the Array, KV and
SparseMatrix tables (``tables``), and the WordEmbedding and
LogisticRegression apps on the host plane and the device plane, with
checkpoint/resume of every table (``MV_SaveCheckpoint``) and compressed
row pushes (``compress="sparse"|"1bit"``), and the serving plane
(versioned snapshots cut in the engine stream, served by batched lookups,
``MV_PublishSnapshot``/``MV_ServingLookup``), with worker-side write
combining and the staleness-bounded Get cache at the JAX package's
defaults, and the reference-compatible binding (``binding``: the Python
handlers, the param managers, and the C ABI's backend bridge), and the
telemetry plane (``telemetry``: metrics, spans, the flight recorder, the
ops endpoint, the byte ledger, the watchdog, the offline critpath and
forensics tools, the fleet rollup) with ``MV_StartProfiler`` over
``torch.profiler``, and the elastic membership plane (``elastic``: epochs,
heartbeat leases, drain and re-admit, resume from the snapshot cut after a
silent death, the coordinator's standby and failover, ``MV_Elastic*``) and
the policy plane (``policy``: sustained watchdog alerts turned into guarded
routing, tuning and drain actions at engine cuts, ``MV_Policy*``), on one
GPU,
and in worlds of several processes over ``torch.distributed`` (gloo), each
process keeping a replica of every table on its own card. Its three row
kernels (gather, scatter-set, fused update) are hand-written CUDA for
``sm_90a`` (``csrc/rows.cu``), built with nvcc at first use. Checkpoints
reach remote stores through fsspec behind ``-use_remote_io``, and the
JAX package's static analysis holds the port to its threading and
hot-path laws (``analysis``: ``python -m multiverso_tpu_torch.analysis``).
"""

from multiverso_tpu_torch.api import (  # noqa: F401
    MV_Aggregate,
    MV_Barrier,
    MV_CreateTable,
    MV_DumpDiagnostics,
    MV_DumpFlightRecorder,
    MV_DumpTrace,
    MV_ElasticEpoch,
    MV_ElasticJoin,
    MV_ElasticLeave,
    MV_ElasticMembers,
    MV_ElasticSync,
    MV_Init,
    MV_LoadCheckpoint,
    MV_MetricsSnapshot,
    MV_MultiAdd,
    MV_MultiAddAsync,
    MV_MultiGet,
    MV_MultiGetAsync,
    MV_NetBind,
    MV_NetConnect,
    MV_NetFinalize,
    MV_NumServers,
    MV_NumWorkers,
    MV_PinVersion,
    MV_PolicyKill,
    MV_PolicyReport,
    MV_PolicySync,
    MV_PublishSnapshot,
    MV_Rank,
    MV_SaveCheckpoint,
    MV_ServerId,
    MV_ServerIdToRank,
    MV_ServingLookup,
    MV_SetFlag,
    MV_ShutDown,
    MV_Size,
    MV_StartProfiler,
    MV_StopProfiler,
    MV_UnpinVersion,
    MV_WorkerContext,
    MV_WorkerId,
    MV_WorkerIdToRank,
)

__version__ = "0.1.0"
