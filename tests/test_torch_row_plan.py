"""The launch planner of the row-group kernels (``cuda_rows.plan_rows``), on
the CPU. csrc/rows.cu moves each row of the gather, the scatter-set and
the fused update with a group of ``lanes`` threads and walks the rows
grid-stride: block ``b``'s tile at step ``k`` is the ``rows_per_block``
rows from ``(k * grid + b) * rows_per_block``. These tests hold the plan
to what that needs: every id in exactly one tile and every unit of a row
on exactly one lane, a geometry the card launches, and the PS shape
spread over every SM in one wave; and they hold the three wrappers to one
plan (``cuda_rows.launch_plan`` with each wrapper's tensors) at the PS and
WE shapes and on an unaligned layout.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.ops import cuda_rows as cr

SMS = (132, 114)            # H100 SXM, H100 PCIe
NS = (1, 2, 7, 31, 113, 132, 133, 1_000, 1_001, 10_000, 40_000, 123_457,
      1_000_000)
COLS = (1, 3, 4, 8, 50, 52, 128, 300, 1_024, 16_384, 16_388, 65_536)


def _table(cols: int, aligned: bool) -> torch.Tensor:
    """A 2-row table, 16-byte aligned or 4 bytes off it."""
    flat = torch.zeros(2 * cols + 4)
    return flat[(0 if aligned else 1):][:2 * cols].view(2, cols)


def _launch_plans(n: int, cols: int, sms: int, aligned: bool = True):
    """The plan each wrapper launches with: the gather (table, out), the
    scatter-set (table, rows) and the update with post-update rows (table,
    deltas, out)."""
    data, rows = _table(cols, aligned), torch.zeros(n, cols)
    return {"gather_rows": cr.launch_plan(data, n, torch.empty(n, cols),
                                          sms=sms),
            "scatter_set_rows": cr.launch_plan(data, n, rows, sms=sms),
            "update_rows": cr.launch_plan(data, n, rows, torch.empty(n, cols),
                                          sms=sms)}


# the PS shape (10,000 ids x 52 cols), the WE shape (40,000 ids x 128) and
# the PS shape on a table 4 bytes off 16-byte alignment
LAUNCHES = ((10_000, 52, True), (40_000, 128, True), (10_000, 52, False))


def _plans():
    for sms in SMS:
        for n in NS:
            for cols in COLS:
                for vec in (False, True) if cols % 4 == 0 else (False,):
                    yield sms, cr.plan_rows(n, cols, sms, vec)
        for n, cols, aligned in LAUNCHES:
            for p in _launch_plans(n, cols, sms, aligned).values():
                yield sms, p


def test_every_id_lies_in_exactly_one_tile():
    for sms, p in _plans():
        # the kernel's loop: row i = b * rpb + g + k * grid * rpb for block
        # b, group g, step k while i < n
        rpb, stride = p.rows_per_block, p.grid * p.rows_per_block
        b, g, k = np.meshgrid(np.arange(p.grid), np.arange(rpb),
                              np.arange(-(-p.n // stride)), indexing="ij")
        rows = (b * rpb + g + k * stride).ravel()
        rows = rows[rows < p.n]
        assert rows.size == p.n and np.unique(rows).size == p.n, p
        # lane l of a group moves units l, l + lanes, ... of its row
        units = np.zeros(p.units, dtype=np.int64)
        for lane in range(p.lanes):
            np.add.at(units, np.arange(lane, p.units, p.lanes), 1)
        assert (units == 1).all(), p


def test_launch_geometry_fits_the_card():
    for sms, p in _plans():
        assert p.units == (p.cols // 4 if p.vec else p.cols), p
        # a power of two up to a warp, covering the row where it can, and
        # never more than twice the lanes the row needs
        assert p.lanes in (1, 2, 4, 8, 16, 32), p
        assert p.lanes >= min(p.units, 32) and (
            p.lanes == 1 or p.lanes < 2 * p.units), p
        assert p.rows_per_block * p.lanes == cr.THREADS, p
        assert 1 <= p.grid <= cr.BLOCKS_PER_SM * sms, p
        assert p.grid * p.rows_per_block >= min(
            p.n, cr.BLOCKS_PER_SM * sms * p.rows_per_block), p
    for bad in ((0, 52, 132, True), (10, 0, 132, False), (10, 52, 0, True),
                (10, 50, 132, True)):
        with pytest.raises(ValueError):
            cr.plan_rows(*bad)


def test_batches_spread_over_every_sm_in_one_wave():
    # the PS shape: 10,000 ids x 52 cols (13 float4s): two rows a warp,
    # 625 blocks, every SM busy, all resident at once
    p = cr.plan_rows(10_000, 52, 132, True)
    assert (p.lanes, p.rows_per_block, p.grid) == (16, 16, 625), p
    assert 132 * 4 <= p.grid <= 132 * cr.BLOCKS_PER_SM, p
    # the WE shape: 40,000 ids x 128 cols: a warp a row, every SM full
    p = cr.plan_rows(40_000, 128, 132, True)
    assert (p.lanes, p.grid) == (32, 132 * cr.BLOCKS_PER_SM), p
    # fewer ids than SMs: one block, a row per group
    p = cr.plan_rows(7, 52, 132, True)
    assert (p.lanes, p.grid) == (16, 1), p
    # an unaligned layout moves floats: 52 floats take a warp
    p = cr.plan_rows(10_000, 52, 132, False)
    assert (p.lanes, p.grid) == (32, 132 * cr.BLOCKS_PER_SM), p
    # a narrow row: 4 floats are one float4, 256 rows a block
    p = cr.plan_rows(10_000, 4, 132, True)
    assert (p.lanes, p.rows_per_block, p.grid) == (1, 256, 40), p
    # the scatter-set launches with the gather's plan (lanes, grid, unit),
    # as does the update: PS and WE shapes, and an unaligned PS table
    for (n, cols, aligned), want in zip(LAUNCHES, ((16, 625, True),
                                                   (32, 1_056, True),
                                                   (32, 1_056, False))):
        plans = _launch_plans(n, cols, 132, aligned)
        for name, p in plans.items():
            assert (p.lanes, p.grid, p.vec) == want, (name, p)
        assert plans["scatter_set_rows"] == plans["gather_rows"]
