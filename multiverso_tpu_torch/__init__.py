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
row pushes (``compress="sparse"|"1bit"``), on one GPU, and in worlds of
several processes over ``torch.distributed`` (gloo), each process keeping a
replica of every table on its own card. Its three row
kernels (gather, scatter-set, fused update) are hand-written CUDA for
``sm_90a`` (``csrc/rows.cu``), built with nvcc at first use.
"""

from multiverso_tpu_torch.api import (  # noqa: F401
    MV_Aggregate,
    MV_Barrier,
    MV_CreateTable,
    MV_Init,
    MV_LoadCheckpoint,
    MV_MultiAdd,
    MV_MultiAddAsync,
    MV_MultiGet,
    MV_MultiGetAsync,
    MV_NetBind,
    MV_NetConnect,
    MV_NetFinalize,
    MV_NumServers,
    MV_NumWorkers,
    MV_Rank,
    MV_SaveCheckpoint,
    MV_ServerId,
    MV_SetFlag,
    MV_ShutDown,
    MV_Size,
    MV_WorkerContext,
    MV_WorkerId,
)

__version__ = "0.1.0"
