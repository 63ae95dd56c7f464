"""Table layer (reference L5): typed parameter stores."""

from multiverso_tpu_torch.tables.base import (  # noqa: F401
    CreateTable,
    ServerTable,
    TableOption,
    WorkerTable,
)
from multiverso_tpu_torch.tables.array_table import (  # noqa: F401
    ArrayServer,
    ArrayTableOption,
    ArrayWorker,
)
from multiverso_tpu_torch.tables.kv_table import (  # noqa: F401
    KVServerTable,
    KVTableOption,
    KVWorkerTable,
)
from multiverso_tpu_torch.tables.matrix_table import (  # noqa: F401
    MatrixServerTable,
    MatrixTableOption,
    MatrixWorkerTable,
)
from multiverso_tpu_torch.tables.sparse_matrix_table import (  # noqa: F401
    SparseMatrixServerTable,
    SparseMatrixTableOption,
    SparseMatrixWorkerTable,
)
