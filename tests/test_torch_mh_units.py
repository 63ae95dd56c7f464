"""The pieces of the port's multi-process app path, in one process.

(a) the deterministic segment sums (``ops.rows.dedup_rows`` and
    ``scatter_add_rows`` with ``deterministic=True``, and the WordEmbedding
    steps built on them), which ``-device_pairs`` runs on every rank's
    replica in a multi-process world: on the CPU they are bitwise the
    ``index_add_`` path (the same sums in the same order), outside the
    tables' trash row;
(b) the one-process identities of the collective helpers
    (``host_allgather_objects_capped``, ``merge_collective_add``,
    ``sum_collective_add``, ``host_payloads``), ``pad_to_multiple``
    against the JAX package's, the
    global block layout of ``-device_pairs``
    (``DevicePairsTrainer.global_layout``) against the JAX package's rule,
    and the tables' device writes in one process:
    ``device_apply_rows_many`` equal to each table's own
    ``device_apply_rows``, its ride and ``device_update``'s handed back as
    given.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def test_deterministic_segment_sums():
    from multiverso_tpu_torch.models.wordembedding.device_pairs import \
        sparse_adagrad_step
    from multiverso_tpu_torch.models.wordembedding.model import (
        TrainState, make_train_step)
    from multiverso_tpu_torch.ops.rows import dedup_rows, scatter_add_rows

    g = torch.Generator().manual_seed(3)
    for R, n in ((1, 5), (40, 300), (500, 64)):
        ids = torch.randint(0, R, (n,), generator=g)
        rows = torch.randn(n, 8, generator=g)
        table = torch.randn(R + 1, 8, generator=g)      # + the trash row
        u0, d0 = dedup_rows(ids.int(), rows)
        u1, d1 = dedup_rows(ids.int(), rows, deterministic=True)
        assert torch.equal(u0, u1) and torch.equal(d0, d1)
        want = table.clone().index_add_(0, ids, rows)
        got = scatter_add_rows(table.clone(), ids, rows, deterministic=True)
        assert torch.equal(got[:R], want[:R])
        assert torch.equal(scatter_add_rows(table.clone(), ids, rows), want)

    # the steps over full storage tables (the last row the trash row)
    R, D, P, K = 30, 8, 64, 4
    inputs = torch.randint(0, R, (P, 1), generator=g)
    outputs = torch.randint(0, R, (P, 1 + K), generator=g)
    imask = torch.ones(P, 1)
    omask = (torch.rand(P, 1 + K, generator=g) > 0.2).float()
    labels = torch.zeros(1, 1 + K)
    labels[0, 0] = 1.0
    lr = torch.tensor(0.05)

    def tables():
        gt = torch.Generator().manual_seed(9)
        return [torch.randn(R + 1, D, generator=gt) * 0.1,
                torch.randn(R + 1, D, generator=gt) * 0.1,
                torch.rand(R + 1, D, generator=gt) * 0.01,
                torch.rand(R + 1, D, generator=gt) * 0.01]

    for adagrad in (False, True):
        runs = []
        for det in (False, True):
            t = tables()
            state = TrainState(*t) if adagrad else TrainState(t[0], t[1],
                                                              None, None)
            step = make_train_step(adagrad, deterministic=det)
            for _ in range(3):
                state, loss = step(state, inputs, imask, outputs, labels,
                                   omask, lr)
            runs.append((state, loss))
        for a, b in zip(runs[0][0], runs[1][0]):
            if a is not None:
                assert torch.equal(a[:R], b[:R]), f"adagrad={adagrad}"
        assert torch.equal(runs[0][1], runs[1][1])
    runs = []
    for det in (False, True):
        state = TrainState(*tables())
        for _ in range(3):
            state, loss = sparse_adagrad_step(
                state, inputs.int(), imask, outputs.int(), labels, omask, lr,
                deterministic=det)
        runs.append(state)
    for a, b in zip(*runs):
        assert torch.equal(a[:R], b[:R]), "touched-rows step"


def test_one_process_collectives_layout_and_device_writes():
    import multiverso_tpu.parallel.mesh as jmesh
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.models.wordembedding.device_pairs import \
        DevicePairsTrainer
    from multiverso_tpu_torch.parallel import mesh
    from multiverso_tpu_torch.parallel import multihost as mh
    from multiverso_tpu_torch.tables import (ArrayTableOption,
                                             MatrixTableOption)
    from multiverso_tpu_torch.tables.matrix_table import \
        device_apply_rows_many
    from multiverso_tpu_torch.updaters.base import AddOption

    x = np.arange(6, dtype=np.float32)
    assert mh.host_allgather_objects_capped(x, "k")[0] is x
    assert mh.merge_collective_add(AddOption(), x, x, key="k")[1] is x
    assert mh.sum_collective_add(AddOption(), x, key="k") is x
    host, ride = mh.host_payloads([torch.ones(2, 3), x, torch.zeros(4)],
                                  torch.tensor(2.5))
    assert [h.shape for h in host] == [(2, 3), (6,), (4,)] and ride == 2.5
    assert host[1] is x and host[0].sum() == 6.0
    for n in (1, 7, 100, 1024, 1025, 70_000, 131_073):
        for m in (1, 2, 8):
            assert mesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)

    # the global -device_pairs block: rank r's tokens at r * t_pad, its
    # sentence ids offset by r * (the global sentence-id count)
    parts = [(np.arange(5, dtype=np.int32), np.array([0, 0, 1, 1, 1])),
             (np.arange(1500, dtype=np.int32) % 7,
              np.repeat(np.arange(3), 500)),
             (np.empty(0, np.int32), np.empty(0, np.int32))]
    ids, sent = DevicePairsTrainer.global_layout(parts)
    t_pad = jmesh.parts_bucket(max(1024, 1500), 1)
    assert len(ids) == 3 * t_pad
    np.testing.assert_array_equal(ids[:5], parts[0][0])
    np.testing.assert_array_equal(ids[t_pad: t_pad + 1500], parts[1][0])
    np.testing.assert_array_equal(sent[t_pad: t_pad + 1500],
                                  parts[1][1] + 3)
    assert (ids[5:t_pad] == -1).all() and (ids[2 * t_pad:] == -1).all()
    assert (sent[2 * t_pad:] == -1).all()

    mv.MV_Init(["-mv_device=cpu"])
    try:
        mats = [mv.MV_CreateTable(MatrixTableOption(
            num_rows=20, num_cols=3, updater_type=u))
            for u in ("default", "sgd", "default", "sgd")]
        rng = np.random.default_rng(1)
        batches = [(rng.integers(0, 20, 9).astype(np.int32),
                    rng.standard_normal((9, 3)).astype(np.float32))
                   for _ in range(2)]
        assert device_apply_rows_many(
            [(m.server(), ids_, torch.from_numpy(d))
             for m, (ids_, d) in zip(mats[:2], batches)], ride=1.5) == 1.5
        for m, (ids_, d) in zip(mats[2:], batches):
            assert m.server().device_apply_rows(ids_, d) is None
        for a, b in ((0, 2), (1, 3)):
            np.testing.assert_array_equal(mats[a].Get(), mats[b].Get())
        arr = mv.MV_CreateTable(ArrayTableOption(size=5,
                                                 updater_type="sgd"))
        srv = arr.server()
        new, ride = srv.device_update(srv.device_state(), torch.ones(5),
                                      AddOption().as_tensors(), ride=0.25)
        assert ride == 0.25
        srv.device_set_state(new)
        np.testing.assert_array_equal(arr.Get(), -np.ones(5))
    finally:
        mv.MV_ShutDown()
