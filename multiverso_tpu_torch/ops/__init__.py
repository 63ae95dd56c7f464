"""Row kernels of the parameter-server hot path: hand-written Hopper
kernels for CUDA tensors (``cuda_rows``, sources in ``csrc/rows.cu``)
behind the table layer's dispatch (``rows``)."""

from multiverso_tpu_torch.ops.rows import (dedup_rows, gather_rows,
                                           scatter_set_rows,
                                           update_gather_rows, update_rows)

__all__ = ["dedup_rows", "gather_rows", "scatter_set_rows",
           "update_gather_rows", "update_rows"]
