"""The port's hand-written CUDA row kernels against their plain versions,
on the card. Marked ``cuda``: without a CUDA device every test skips (the
kernels have no CPU mode). Run on a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Kernel and plain version must agree bitwise (outside the trash row, which
duplicate lanes may race on), and the device error word must flag exactly
the out-of-range ids. A sparse LogisticRegression device window, which
runs the gather and the sgd-sign update at rows of 4 floats, must train
the same weights on the card as on the CPU. Engine shards launch from several threads at once:
every launch must be counted and one error word serve the device.
"""

import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the row kernels have no CPU mode")
    from multiverso_tpu_torch.ops import cuda_rows
    cuda_rows.build()
    return torch.device("cuda", 0)


def _inputs(dev, rows, cols, n, seed, trash_lanes=0):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(rows - 1)[:n - trash_lanes]
    ids = rng.permutation(np.concatenate([ids, np.full(trash_lanes,
                                                       rows - 1)]))
    data = rng.standard_normal((rows, cols)).astype(np.float32)
    src = rng.standard_normal((n, cols)).astype(np.float32)
    return (torch.from_numpy(data).to(dev),
            torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(src).to(dev))


# (table rows, cols, ids, lanes on the trash row): the first slice's
# shapes, then the row groups' geometry: n = 1, n below the SM count, n
# not a multiple of a block's rows, cols 4 (a lane a row) and 300 (a warp
# looping over a row), cols 1,024, a batch of several grid strides, rows
# of 16,384 and 16,388 floats, all lanes on the trash row, and many more
# rows than the grid holds at once.
SHAPES = [(200, 50, 100, 0), (200, 128, 64, 0), (200, 52, 100, 20),
          (100_001, 128, 40_000, 0), (1_000_001, 52, 10_000, 5),
          (200, 52, 1, 0), (200, 52, 7, 0), (5_000, 52, 1_001, 0),
          (20_001, 4, 5_000, 0), (20_001, 300, 5_000, 3),
          (5_001, 1_024, 1_000, 0),
          (100_001, 128, 20_000, 0), (301, 16_384, 100, 0),
          (301, 16_388, 300, 0), (2_001, 52, 1_001, 1_001),
          (1_000_001, 52, 1_000_000, 0)]


def test_kernels_match_plain(dev, tmp_path):
    for shape in SHAPES:
        try:
            _check_shape(dev, *shape)
        except AssertionError as exc:
            raise AssertionError(f"rows,cols,n,trash={shape}: {exc}") \
                from exc
    _check_lr_window(dev, tmp_path)


def _check_lr_window(dev, tmp_path):
    """One sparse LR device-plane window (the gather and the sgd-sign
    update at rows of 4 floats) on the card against the same window on
    the CPU, where the plain versions run: weights rtol 1e-5, atol 1e-6
    (the window's gradient sums its lanes with atomics on the card)."""
    from multiverso_tpu_torch.models.logreg.configure import Configure
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    from multiverso_tpu_torch.ops import cuda_rows as cr
    rng = np.random.default_rng(4)
    data = tmp_path / "lr_sparse.data"
    with open(data, "w") as f:
        for _ in range(100):
            keys = rng.choice(300, 12, replace=False)
            vals = rng.standard_normal(12)
            f.write(f"{int(vals.sum() > 0)} " + " ".join(
                f"{k}:{v:.4f}" for k, v in zip(keys, vals)) + "\n")
    W = {}
    for platform in ("cuda", "cpu"):
        cfg = Configure(input_size=300, output_size=1, sparse=True,
                        objective_type="sigmoid", updater_type="sgd",
                        regular_type="L2", train_file=str(data),
                        output_model_file="", output_file="", use_ps=True,
                        device_plane=True, sync_frequency=5,
                        platform=platform)
        cr.reset_launches()
        app = LogReg(cfg)
        try:
            app.Train()
            W[platform] = app.model.weights()
        finally:
            app.close()
        if platform == "cuda":
            # one window: one gather, one update (weights() adds a Get)
            assert cr.LAUNCHES["update_rows"] == 1
            assert cr.LAUNCHES["gather_rows"] >= 1
    np.testing.assert_allclose(W["cuda"], W["cpu"], rtol=1e-5, atol=1e-6)


def _check_shape(dev, rows, cols, n, trash):
    from multiverso_tpu_torch.ops import cuda_rows as cr
    data, ids, src = _inputs(dev, rows, cols, n, seed=rows + cols,
                             trash_lanes=trash)
    cr.reset_error(dev)
    assert torch.equal(cr.gather_rows(data, ids),
                       cr.gather_rows_plain(data, ids))
    a, b = data.clone(), data.clone()
    cr.scatter_set_rows(a, ids, src)
    cr.scatter_set_rows_plain(b, ids, src)
    assert torch.equal(a[:-1], b[:-1])
    live = ids != rows - 1
    for sign in (1, -1):
        a, b = data.clone(), data.clone()
        _, ra = cr.update_rows(a, ids, src, sign, want_rows=True)
        _, rb = cr.update_rows_plain(b, ids, src, sign)
        assert torch.equal(a[:-1], b[:-1])
        assert torch.equal(ra[live], rb[live])
    torch.cuda.synchronize()
    assert cr.read_error(dev) == 0


def test_out_of_range_ids_set_the_error_word(dev):
    from multiverso_tpu_torch.ops import cuda_rows as cr
    data, _, _ = _inputs(dev, 64, 8, 4, seed=1)
    before = data.clone()
    cr.reset_error(dev)
    bad = torch.tensor([1, 64, -1], dtype=torch.int32, device=dev)
    out = cr.gather_rows(data, bad)
    assert cr.read_error(dev) == 1
    assert torch.equal(out[0], data[1]) and out[1:].abs().sum() == 0
    cr.reset_error(dev)
    cr.update_rows(data, bad, torch.ones((3, 8), device=dev), 1)
    assert cr.read_error(dev) == 1
    assert torch.equal(data[2:], before[2:]) and torch.equal(data[0],
                                                             before[0])
    cr.reset_error(dev)
    a = before.clone()
    cr.scatter_set_rows(a, bad, torch.ones((3, 8), device=dev))
    assert cr.read_error(dev) == 1
    assert torch.equal(a[1], torch.ones(8, device=dev))
    assert torch.equal(a[0], before[0]) and torch.equal(a[2:], before[2:])
    # out-of-range ids in the middle of a batch: lanes read zero
    data, ids, src = _inputs(dev, 5_000, 52, 1_001, seed=3)
    ids[500], ids[700] = 5_000, -1
    good = torch.ones(1_001, dtype=torch.bool, device=dev)
    good[500] = good[700] = False
    cr.reset_error(dev)
    out = cr.gather_rows(data, ids)
    assert cr.read_error(dev) == 1
    assert torch.equal(out[good], cr.gather_rows_plain(data, ids[good]))
    assert out[~good].abs().sum() == 0
    for sign in (1, -1):
        a, b = data.clone(), data.clone()
        cr.reset_error(dev)
        _, ra = cr.update_rows(a, ids, src, sign, want_rows=True)
        assert cr.read_error(dev) == 1
        _, rb = cr.update_rows_plain(b, ids[good], src[good], sign)
        assert torch.equal(a, b) and torch.equal(ra[good], rb)
        assert ra[~good].abs().sum() == 0
    # the scatter-set writes the valid lanes and leaves every other row
    a, b = data.clone(), data.clone()
    cr.reset_error(dev)
    cr.scatter_set_rows(a, ids, src)
    assert cr.read_error(dev) == 1
    cr.scatter_set_rows_plain(b, ids[good], src[good])
    assert torch.equal(a, b)
    cr.reset_error(dev)


def test_launches_count_only_real_launches(dev):
    from multiverso_tpu_torch.ops import cuda_rows as cr
    data, ids, src = _inputs(dev, 64, 8, 16, seed=2)
    cr.reset_launches()
    cr.gather_rows(data, ids[:0])               # n == 0: nothing launched
    cr.gather_rows(data, ids)
    cr.scatter_set_rows(data, ids, src)
    cr.update_rows(data, ids, src, -1)
    assert cr.LAUNCHES == {"gather_rows": 1, "scatter_set_rows": 1,
                           "update_rows": 1}
    # a table view 4 bytes off 16-byte alignment: rows move as floats
    flat = torch.zeros(64 * 8 + 1, device=dev)
    view = flat[1:].view(64, 8)
    view.copy_(data)
    assert torch.equal(cr.gather_rows(view, ids),
                       cr.gather_rows_plain(data, ids))
    cr.update_rows(view, ids, src, 1)
    cr.update_rows_plain(data, ids, src, 1)
    assert torch.equal(view, data)
    cr.scatter_set_rows(view, ids, src * 3)
    cr.scatter_set_rows_plain(data, ids, src * 3)
    assert torch.equal(view, data)
    assert cr.LAUNCHES == {"gather_rows": 2, "scatter_set_rows": 2,
                           "update_rows": 2}
    _check_concurrent_launches(dev, cr)


def _check_concurrent_launches(dev, cr, threads=4, per=50):
    """``threads`` threads launch gathers and updates at once from a
    device with no error word yet: every launch counted, one error word
    created, the error one thread sets seen through it, and each table as
    the same launches on the plain versions leave it."""
    cr._err_words.pop(dev, None)
    cr.reset_launches()
    inputs = [_inputs(dev, 5_000, 52, 1_000, seed=10 + k)
              for k in range(threads)]
    want = [data.clone() for data, _, _ in inputs]
    bad = torch.tensor([3, 5_000], dtype=torch.int32, device=dev)
    start = threading.Barrier(threads)
    errors = []

    def hammer(k):
        try:
            data, ids, src = inputs[k]
            start.wait(30)
            for i in range(per):
                cr.gather_rows(data, ids)
                cr.update_rows(data, ids, src, 1 if i % 2 else -1)
            if k == threads - 1:
                cr.gather_rows(data, bad)
        except BaseException as exc:        # re-raised by the test
            errors.append(exc)

    workers = [threading.Thread(target=hammer, args=(k,))
               for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(120)
    assert not any(w.is_alive() for w in workers)
    assert not errors, errors
    assert cr.LAUNCHES == {"gather_rows": threads * per + 1,
                           "scatter_set_rows": 0,
                           "update_rows": threads * per}
    assert list(cr._err_words) == [dev]
    torch.cuda.synchronize()
    assert cr.read_error(dev) == 1
    cr.reset_error(dev)
    for (data, ids, src), ref in zip(inputs, want):
        for i in range(per):
            cr.update_rows_plain(ref, ids, src, 1 if i % 2 else -1)
        assert torch.equal(data, ref)
