"""The port's multi-process worlds against the JAX package's.

Two processes of ``tests/_mh_child.py`` run one seeded script in a JAX
package world (``jax.distributed``, CPU) and again in a port world
(``torch.distributed`` over gloo, ``-mv_device=cpu``); every Get is held to
a numpy oracle of both ranks' Adds inside the children. Here:

(a) the single-process identities in this process: ``-multihost=off``, auto
    without a launcher's environment, ``MV_Size() == 1``, the collectives'
    identities, the unported wires' CHECKs, the net declarations, the
    machine file, and ``RendezvousAllreduce``'s cross-process leg (applied
    once a round by the last thread; a failure releases every waiter);
(b) Array, Matrix (add and momentum), KV with divergent key sets,
    SparseMatrix's dirty rows, ``MV_Aggregate`` across 2 processes x 2
    threads and a checkpoint (rank 0 writes, both reload): both port ranks
    bitwise equal, each equal to the JAX run (exact for the integer-valued
    add deltas, rtol 1e-6 for momentum and for the aggregate of float32
    normals, which the port sums exactly in float64 and the JAX package
    rounds to float32 per process before the cross-process sum);
(c) a world wired by ``MV_NetBind``/``MV_NetConnect`` and one by
    ``-machine_file``; the unported multi-process paths (compressed
    pushes, the apps, the tables' public ``device_*`` writes) failing on
    every rank and leaving the replicas alone; a diverging verb stream
    failing its CHECK on both ranks, and a dead peer failing the next
    collective Add, each well within the children's 60 s collective
    timeout.
"""

import threading

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import free_port, run_world

torch.set_num_threads(1)

#: results a rank computes from its own ids (the rest equal across ranks)
_PER_RANK = ("mat_get", "mom_get", "sp_ids", "sp_rows")


def test_single_process_identities(tmp_path, monkeypatch):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.parallel import multihost as mh
    from multiverso_tpu_torch.parallel.allreduce import RendezvousAllreduce
    from multiverso_tpu_torch.utils.configure import SetCMDFlag
    from multiverso_tpu_torch.utils.log import FatalError

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert mh.maybe_initialize() is False          # auto, no environment
    SetCMDFlag("multihost", "off")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    try:
        assert mh.maybe_initialize() is False      # off wins over the env
    finally:
        SetCMDFlag("multihost", "auto")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var)
    assert (mh.process_count(), mh.process_index()) == (1, 0)
    x = np.arange(6, dtype=np.float32)
    assert mh.host_allreduce_sum(x) is x
    assert mh.host_allgather_objects(x)[0] is x
    assert mh.host_allgather_bytes(b"ab") == [b"ab"]
    assert mh.capped_exchange(b"ab", {}, "k") == [b"ab"]
    mh.host_barrier()
    mv.MV_Init(["-mv_device=cpu"])
    try:
        assert (mv.MV_Size(), mv.MV_Rank()) == (1, 0)
        mh.require_one_process("device_apply_rows")
    finally:
        mv.MV_ShutDown()

    # the unported wires and transport fail a CHECK that says so
    for argv, words in (
            (["-multihost=on", "-mv_wire=shm", "-dist_coordinator=127.0.0.1:1",
              "-dist_rank=0", "-dist_size=2"], "-mv_wire=shm is not ported"),
            (["-multihost=on", "-mv_wire=tcp", "-dist_coordinator=127.0.0.1:1",
              "-dist_rank=0", "-dist_size=2"], "-mv_wire=tcp is not ported"),
            (["-window_transport=device"], "is not ported yet")):
        with pytest.raises(FatalError, match=words):
            mv.MV_Init(["-mv_device=cpu"] + argv)
        mv.MV_ShutDown()

    # the net declarations (reference return convention)
    try:
        assert mv.MV_NetConnect([0, 1], ["a:1", "b:2"]) == -1   # no bind
        assert mv.MV_NetBind(-1, "x:1") == -1
        assert mv.MV_NetBind(0, "127.0.0.1:7000") == 0
        assert mv.MV_NetConnect([0, 2], ["127.0.0.1:7000", "b:2"]) == -1
        assert mv.MV_NetConnect([0, 1], ["127.0.0.1:7001", "b:2"]) == -1
        assert mv.MV_NetConnect([0, 1], ["127.0.0.1:7000", "b:2"]) == 0
    finally:
        mv.MV_NetFinalize()

    # the machine file: ports filled, IPv6, loud errors, local rank match
    mf = tmp_path / "hosts"
    SetCMDFlag("port", 6000)
    try:
        mf.write_text("# cluster\nhost-a:7000\n\nhost-b\n")
        assert mh._parse_machine_file(str(mf)) == ["host-a:7000",
                                                   "host-b:6000"]
        mf.write_text("[::1]:7000\nfe80::abcd\n")
        assert mh._parse_machine_file(str(mf)) == ["[::1]:7000",
                                                   "[fe80::abcd]:6000"]
        mf.write_text("# only comments\n")
        with pytest.raises(FatalError):
            mh._parse_machine_file(str(mf))
        with pytest.raises(FatalError):
            mh._parse_machine_file(str(mf) + ".nope")
    finally:
        SetCMDFlag("port", 55555)
    assert mh._match_local_rank(["10.255.255.1:7000",
                                 "127.0.0.1:7001"]) == 1
    assert mh._match_local_rank(["127.0.0.1:7000", "127.0.0.1:7001"]) is None

    # MV_Aggregate's cross-process leg: once a round, by the last thread;
    # a failure raises in every participant and the next round works
    calls = []

    def cross(buf):
        calls.append(buf.copy())
        if len(calls) == 2:
            raise ConnectionError("peer died")
        return buf * 10

    ar = RendezvousAllreduce(3, cross_reduce=cross)
    for round_idx in range(3):
        outs, errors = {}, []

        def run(i):
            try:
                outs[i] = ar.allreduce(np.full(4, float(i + 1), np.float32))
            except RuntimeError as exc:
                errors.append(exc)

        ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        [t.start() for t in ts]
        [t.join(10) for t in ts]
        assert not any(t.is_alive() for t in ts), "waiters stranded"
        if round_idx == 1:
            assert len(errors) == 3
        else:
            assert not errors
            for i in range(3):
                np.testing.assert_array_equal(outs[i], np.full(4, 60.0))
    assert len(calls) == 3
    np.testing.assert_array_equal(calls[0], np.full(4, 6.0))


def test_two_process_tables_match_jax(tmp_path):
    jax_res, _ = run_world("jax", "tables", tmp_path)
    port_res, _ = run_world("torch", "tables", tmp_path)
    assert set(port_res[0]) == set(jax_res[0])
    for key in port_res[0]:
        if not key.startswith(_PER_RANK):
            np.testing.assert_array_equal(port_res[0][key], port_res[1][key],
                                          err_msg=f"ranks differ: {key}")
        for r in range(2):
            # momentum, and MV_Aggregate, whose JAX cross-process leg
            # rounds each process's float64 sum to float32 (the port's
            # is exact, checked in the child)
            if "mom" in key or key == "aggregate":
                np.testing.assert_allclose(
                    port_res[r][key], jax_res[r][key], rtol=1e-6, atol=1e-6,
                    err_msg=f"rank {r} {key}")
            else:
                np.testing.assert_array_equal(
                    port_res[r][key], jax_res[r][key],
                    err_msg=f"rank {r} {key}")


def test_wiring_unported_paths_and_failures(tmp_path):
    run_world("torch", "wiring", tmp_path, "netbind")
    port = free_port()
    mf = tmp_path / "hosts"
    mf.write_text(f"127.0.0.1:{port}\n127.0.0.1:{port + 1}\n")
    run_world("torch", "wiring", tmp_path, "machine_file", str(mf),
              port=port)
    for pipeline in ("1", "0"):
        res, _ = run_world("torch", "diverge", tmp_path,
                           f"-mv_pipeline={pipeline}")
        for r in range(2):
            assert float(res[r]["fail_s"]) < 30.0
    res, outs = run_world("torch", "dead", tmp_path, ok_ranks=(0,))
    assert float(res[0]["fail_s"]) < 60.0
    assert "child 1 dead OK" not in outs[1]
