"""``DeviceContext.fetch``, the device-to-host funnel of the server tables'
replies.

On the CPU: ``cuda.d2h_staged_bytes`` is registered with the world and
reads zero, and a CPU fetch, however large, pins nothing and copies.
On the card (marked ``cuda``; each case skips without a CUDA device): a
fetch below, at and above ``PINNED_MIN_BYTES``, at sizes the pinned
allocator rounds up, and from a strided view, is bitwise
``t.cpu().numpy()`` in float32 and int32; back-to-back fetches and two
threads fetching at once each get a fresh array of their own, also when
a dropped reply's pinned block is reused; and the staged counter grows
by exactly the bytes of the fetches at or above the threshold; a MatrixTable's whole Get on the card, past the threshold,
is the table's logical rows, pinned. Run on a machine with the card:

    python -m pytest --noconftest tests/test_torch_fetch.py -q
"""

import threading

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.parallel import mesh
from multiverso_tpu_torch.telemetry import metrics

JOIN_S = 120.0


def _staged() -> float:
    return metrics.snapshot()["cuda.d2h_staged_bytes"]["value"]


def test_staged_counter_registered_and_a_cpu_fetch_pins_nothing():
    from multiverso_tpu_torch import api as mv
    from multiverso_tpu_torch.zoo import Zoo

    mv.MV_Init(["-mv_device=cpu"])
    try:
        snap = mv.MV_MetricsSnapshot()
        assert snap["cuda.d2h_staged_bytes"]["value"] == 0
        t = torch.arange(mesh.PINNED_MIN_BYTES // 4 + 3, dtype=torch.int32)
        host = Zoo.Get().device_ctx.fetch(t)
        assert host.tobytes() == t.numpy().tobytes()
        assert not np.shares_memory(host, t.numpy())
        assert mv.MV_MetricsSnapshot()["cuda.d2h_staged_bytes"]["value"] == 0
    finally:
        mv.MV_ShutDown()


@pytest.fixture
def ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned path copies from the "
                    "card")
    return mesh.DeviceContext(torch.device("cuda", 0))


def _tensor(nbytes: int, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = nbytes // 4
    if dtype == torch.float32:
        return torch.randn(n, device="cuda", generator=g)
    return torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                         device="cuda", generator=g)


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


MIN = mesh.PINNED_MIN_BYTES
# below the threshold, at it, a word past it, and sizes between powers of
# two (the pinned allocator's blocks are rounded up to one)
SIZES = [MIN - 4, MIN, MIN + 4, 2 * MIN + MIN // 2 + 12, 3 * MIN]


def _bitwise_cases(ctx, dtype):
    staged_before = _staged()
    want_staged = 0
    for i, nbytes in enumerate(SIZES):
        t = _tensor(nbytes, dtype, seed=i)
        host = ctx.fetch(t)
        assert host.dtype == t.cpu().numpy().dtype and host.shape == t.shape
        assert host.tobytes() == _bytes_of(t), nbytes
        assert torch.from_numpy(host).is_pinned() == (nbytes >= MIN)
        if nbytes >= MIN:
            want_staged += nbytes
    # a strided (n, 50) view of (n, 52) storage, as a table's whole Get
    # would hand it over uncut
    rows = MIN // (50 * 4) + 7
    wide = _tensor(rows * 52 * 4, dtype, seed=9).view(rows, 52)
    view = wide[:, :50]
    host = ctx.fetch(view)
    assert host.shape == (rows, 50) and torch.from_numpy(host).is_pinned()
    assert host.tobytes() == _bytes_of(view.contiguous())
    want_staged += rows * 50 * 4
    assert _staged() - staged_before == want_staged


def _fresh_arrays(ctx):
    t = _tensor(2 * MIN + 4, torch.float32, seed=1)
    first, second = ctx.fetch(t), ctx.fetch(t)
    assert not np.shares_memory(first, second)
    assert first.tobytes() == second.tobytes() == _bytes_of(t)
    first[...] = 0.0
    assert ctx.fetch(t).tobytes() == _bytes_of(t)
    # a dropped reply's block serves the next fetch; a kept one is left
    # alone
    kept = second
    del first, second
    other = _tensor(2 * MIN + 4, torch.float32, seed=2)
    again = ctx.fetch(other)
    assert not np.shares_memory(again, kept)
    assert again.tobytes() == _bytes_of(other)
    assert kept.tobytes() == _bytes_of(t)


@pytest.mark.cuda
def test_fetch_is_bitwise_the_pageable_copy_and_fresh(ctx):
    for dtype in (torch.float32, torch.int32):
        _bitwise_cases(ctx, dtype)
    _fresh_arrays(ctx)


def _two_threads(ctx):
    srcs = [_tensor(3 * MIN + 8 * (w + 1), torch.int32, seed=10 + w)
            for w in range(2)]
    want = [_bytes_of(s) for s in srcs]
    got = [[], []]
    errors = []
    start = threading.Barrier(2)

    def body(w):
        try:
            start.wait(JOIN_S)
            for _ in range(4):
                got[w].append(ctx.fetch(srcs[w]).tobytes())
        except BaseException as exc:        # re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(w,)) for w in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
    assert not any(th.is_alive() for th in threads)
    if errors:
        raise errors[0]
    for w in range(2):
        assert got[w] == [want[w]] * 4


def _large_whole_get():
    from multiverso_tpu_torch import api as mv
    from multiverso_tpu_torch.tables import MatrixTableOption

    rows, cols = MIN // (50 * 4) + 13, 50
    rng = np.random.default_rng(5)
    init = rng.integers(-1000, 1000, (rows, cols)).astype(np.float32)
    ids = rng.permutation(rows)[:1000].astype(np.int32)
    deltas = rng.integers(-8, 9, (1000, cols)).astype(np.float32)
    mv.MV_Init(["-mv_device=cuda"])
    try:
        t = mv.MV_CreateTable(MatrixTableOption(
            num_rows=rows, num_cols=cols, initializer=lambda s: init))
        t.AddRows(ids, deltas)
        before = _staged()
        whole = t.Get()
        grown = _staged() - before
    finally:
        mv.MV_ShutDown()
    want = init.copy()
    want[ids] += deltas
    assert whole.shape == (rows, cols) and whole.tobytes() == want.tobytes()
    assert torch.from_numpy(whole).is_pinned()
    assert grown == rows * cols * 4


@pytest.mark.cuda
def test_threads_and_a_large_whole_get(ctx):
    _two_threads(ctx)
    _large_whole_get()
