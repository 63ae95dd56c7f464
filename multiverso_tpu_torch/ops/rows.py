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

``dedup_rows`` and ``scatter_add_rows`` take a ``deterministic`` switch:
the scatter-adds of the WordEmbedding steps sum duplicates in atomic
order on the card, which two ranks running one program on their replicas
(``-device_pairs`` across processes) cannot afford.

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


def _segments(ids: torch.Tensor):
    """The lanes stably sorted by id -> (order, sorted ids, whether each
    sorted lane heads its id's segment, each sorted lane's segment)."""
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    head = torch.ones(ids.shape[0], dtype=torch.bool, device=ids.device)
    head[1:] = sids[1:] != sids[:-1]
    return order, sids, head, torch.cumsum(head.to(torch.int64), 0) - 1


def _lengths(seg: torch.Tensor) -> torch.Tensor:
    """Each segment's lane count (integer counts: exact in any order), one
    slot a lane (the unused slots 0)."""
    n = seg.shape[0]
    return torch.zeros(n, dtype=torch.int64, device=seg.device).scatter_add_(
        0, seg, torch.ones(n, dtype=torch.int64, device=seg.device))


def dedup_rows(ids: torch.Tensor, deltas: torch.Tensor,
               deterministic: bool = False):
    """Sum the deltas of equal ids into ONE surviving lane; the other
    duplicate lanes become pad lanes (id -1, zero delta). Same semantics
    and lane layout as the JAX ``dedup_rows`` (stable sort, segment sum in
    sorted order; on the CPU the sums round in the same order, on the
    card ``index_add_`` sums a segment in atomic order).

    ``deterministic``: the segment sum is ``torch.segment_reduce`` over
    the sorted lanes (each segment summed in sorted order, the same
    rounding on every run and every rank), so two ranks running the same
    program on their replicas get the same bits. The segment lengths are
    integer counts (exact in any order), and no host sync is needed.
    Integer deltas take ``index_add_`` either way: integer adds are exact
    in any order (``segment_reduce`` has no integer kernel)."""
    if ids.shape[0] == 0:
        return ids.clone(), deltas.clone()
    order, sids, head, seg = _segments(ids)
    sdeltas = deltas[order]
    if deterministic and deltas.is_floating_point():
        out_deltas = torch.segment_reduce(sdeltas, "sum",
                                          lengths=_lengths(seg), axis=0,
                                          unsafe=True)
    else:
        out_deltas = torch.zeros_like(deltas).index_add_(0, seg, sdeltas)
    # every lane of a segment writes the same id, so the write order on
    # duplicates is harmless; unused segments stay -1 (pad)
    out_ids = torch.full_like(ids, -1).index_copy_(0, seg, sids)
    return out_ids, out_deltas


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor,
                     deterministic: bool = False) -> torch.Tensor:
    """table[ids[i]] += rows[i], in place, duplicates accumulating in lane
    order (``index_add_``). Returns ``table``.

    ``deterministic``: the same sums in the same order on every run, on
    the card too, where ``index_add_`` adds duplicates in atomic order.
    The lanes are stably sorted by id, each id's segment is prefixed with
    its current table row, and ``torch.segment_reduce`` sums every segment
    in that order, so a row becomes ``((row + r0) + r1) + ...`` exactly as
    the CPU's ``index_add_`` computes it (and the JAX package's scatter:
    the duplicates summed first and added once round differently, which
    shows against the JAX program after a few blocks); the new rows are
    written back with unique ids. The table's LAST row must be a trash row (the
    storage layout of the tables' device state): the unused segments
    write zeros there. Integer rows take ``index_add_`` either way: integer
    adds are exact in any order, so its atomics give the same bits on
    every run (and ``segment_reduce`` has no integer kernel)."""
    if not deterministic or not rows.is_floating_point():
        return table.index_add_(0, ids, rows)
    n = ids.shape[0]
    if n == 0:
        return table
    dev = ids.device
    order, sids, head, seg = _segments(ids.long())
    lane = torch.arange(n, device=dev)
    # segment k: its table row at start_k + k, its lanes after it; the
    # heads of other lanes go to a dump row past every segment
    ext = torch.zeros((2 * n + 1,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=dev)
    ext.index_copy_(0, lane + seg + 1, rows[order])
    ext.index_copy_(0, torch.where(head, lane + seg, 2 * n), table[sids])
    lengths = _lengths(seg)
    lengths = lengths + (lengths > 0).to(torch.int64)
    sums = torch.segment_reduce(ext[: 2 * n], "sum", lengths=lengths,
                                axis=0, unsafe=True)
    out_ids = torch.full((n,), table.shape[0] - 1, dtype=torch.int64,
                         device=dev).index_copy_(0, seg, sids)
    return table.index_copy_(0, out_ids, sums)
