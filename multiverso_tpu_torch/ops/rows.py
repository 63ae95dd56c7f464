"""Row gather / scatter / update dispatch for the table layer.

Counterpart of ``multiverso_tpu/ops/rows.py``. The JAX package picks
between XLA and its Pallas kernels by the ``use_pallas`` flag and a set of
TPU laws (the 128-lane column pad, the SMEM id budget, the VMEM chunk
budget, the TPU-only dense-run cond). None of those carry over. The port's
rule is one line: a CUDA tensor goes to the hand-written kernel
(``cuda_rows``), a CPU tensor to the kernel's plain PyTorch version, and a
tensor the kernels cannot take (not float32, ids not int32, not
contiguous) raises instead of taking a slower path. The dense-run fast
path is later work (``ROADMAP.md``).

Caller contract, as in the JAX package: every id is in range (the table
maps pad lanes, -1, to its trash row first) and duplicate ids occur only
on the trash row (the table pre-combines duplicates). ``update_rows`` and
``update_gather_rows`` take the fusable updater's sign (+1 add, -1 sgd)
where the JAX functions take its ``combine`` callable.
"""

from __future__ import annotations

import torch

from multiverso_tpu_torch.ops import cuda_rows


def gather_rows(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """rows[i] = data[ids[i]] as a fresh tensor (never a view of data)."""
    return cuda_rows.gather_rows(data, ids)


def scatter_set_rows(data: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """data[ids[i]] = rows[i], in place; returns ``data``."""
    return cuda_rows.scatter_set_rows(data, ids, rows)


def update_rows(data: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor,
                sign: int) -> torch.Tensor:
    """data[ids[i]] = data[ids[i]] + sign * deltas[i], in place, in one
    pass over the touched rows; returns ``data``."""
    return cuda_rows.update_rows(data, ids, deltas, sign)


def update_gather_rows(data: torch.Tensor, ids: torch.Tensor,
                       deltas: torch.Tensor, sign: int):
    """The fused PS round: update in place AND return the post-update rows
    per lane, from one read of each row. Returns (data, rows); trash lanes
    of ``rows`` are arbitrary (callers mask)."""
    return cuda_rows.update_rows(data, ids, deltas, sign, want_rows=True)


def dedup_rows(ids: torch.Tensor, deltas: torch.Tensor):
    """Sum the deltas of equal ids into ONE surviving lane; the other
    duplicate lanes become pad lanes (id -1, zero delta). Same semantics
    and lane layout as the JAX ``dedup_rows`` (stable sort, segment sum in
    sorted order; on the CPU the sums round in the same order, on the
    card ``index_add_`` sums a segment in atomic order)."""
    n = ids.shape[0]
    if n == 0:
        return ids.clone(), deltas.clone()
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    sdeltas = deltas[order]
    head = torch.ones(n, dtype=torch.bool, device=ids.device)
    head[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    out_deltas = torch.zeros_like(deltas).index_add_(0, seg, sdeltas)
    # every lane of a segment writes the same id, so the write order on
    # duplicates is harmless; unused segments stay -1 (pad)
    out_ids = torch.full_like(ids, -1).index_copy_(0, seg, sids)
    return out_ids, out_deltas
