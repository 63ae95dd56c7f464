"""The elastic plane's hooks in the port's Zoo, engine and multihost
layer, held against the JAX package where the JAX package answers.

(a) ``-mv_elastic`` clamps the engine to one shard (``engine_shard_cap``
    and ``requested_engine_channels`` equal to the JAX package's under the
    same flags); a one-process world syncs at epoch 0 with members
    ``(0,)``; rank 0 (the coordinator's host) is refused a drain.
(b) A departed member's verbs fail with the typed ``MembershipChanged``
    (``guard_verbs``, and a departed member's group exchange); the id
    maps follow the view: in range the boot rank, past it the typed
    error under ``-mv_elastic`` and a CHECK without, as the JAX
    ``TestEpochIdMaps`` drill has it.
(c) ``-mv_standby`` attaches rank 0's coordinator to a standby: with a
    live ``StandbyServer`` the op log replicates (``ha_status()`` says
    "replicated", the standby stores the world's records, ``/healthz``
    carries no warning); with the standby down ``MV_Init`` still succeeds,
    the authority serves solo (``ha_status()`` says "degraded", the
    ``elastic.standby_degraded`` counter counts it, ``/healthz`` names the
    lost standby in ``warnings``) and the world syncs; each world leaves
    no thread running. (The JAX package's ``attach_standby`` raises on an
    unreachable standby; the port degrades instead, ROADMAP.md §3.)
"""

import threading

import numpy as np
import pytest

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401


def test_shard_clamp_single_sync_and_rank0_drain():
    import multiverso_tpu.elastic  # noqa: F401  (registers -mv_elastic)
    from multiverso_tpu.sync import server as jserver
    from multiverso_tpu.utils import configure as jcfg
    jcfg.ParseCMDFlags(["-mv_elastic=true", "-mv_engine_shards=4"])
    try:
        want = (jserver.engine_shard_cap(),
                jserver.requested_engine_channels())
    finally:
        jcfg.ResetFlagsToDefaults()
    assert want == (1, 1)

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.sync import server as tserver
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.utils.log import FatalError
    from multiverso_tpu_torch.zoo import Zoo
    mv.MV_Init(["-mv_device=cpu", "-mv_elastic=true",
                "-mv_engine_shards=4"])
    try:
        assert (tserver.engine_shard_cap(),
                tserver.requested_engine_channels()) == want
        assert type(Zoo.Get().server_engine) is tserver.Server
        t = mv.MV_CreateTable(MatrixTableOption(num_rows=8, num_cols=2))
        t.AddRows(np.array([1, 3], np.int32), np.ones((2, 2), np.float32))
        assert mv.MV_ElasticSync() == 0
        assert mv.MV_ElasticEpoch() == 0 and mv.MV_ElasticMembers() == (0,)
        assert mv.MV_Size() == 1
        with pytest.raises(FatalError, match="cannot drain"):
            mv.MV_ElasticLeave()
        assert mv.MV_ElasticSync() == 0          # the world goes on
        np.testing.assert_array_equal(
            t.GetRows(np.array([1, 3], np.int32)),
            np.ones((2, 2), np.float32))
    finally:
        mv.MV_ShutDown()
    assert mv.MV_ElasticMembers() == ()          # the plane is down


def _id_maps(mv, FatalError, typed):
    out = [mv.MV_WorkerIdToRank(0), mv.MV_ServerIdToRank(0)]
    for bad in (99, -1):
        try:
            mv.MV_WorkerIdToRank(bad)
            out.append("accepted")
        except FatalError:
            out.append("FatalError")
        except typed:
            out.append("MembershipChanged")
    return out


def test_departed_verbs_and_id_maps_are_typed():
    import multiverso_tpu as jmv
    from multiverso_tpu.failsafe.errors import \
        MembershipChanged as JMembershipChanged
    from multiverso_tpu.utils.log import FatalError as JFatal
    jmv.MV_Init([])
    try:
        want = _id_maps(jmv, JFatal, JMembershipChanged)
    finally:
        jmv.MV_ShutDown()
    assert want == [0, 0, "FatalError", "FatalError"]

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import elastic
    from multiverso_tpu_torch.failsafe.errors import MembershipChanged
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.utils.log import FatalError
    mv.MV_Init(["-mv_device=cpu"])
    try:
        assert _id_maps(mv, FatalError, MembershipChanged) == want
    finally:
        mv.MV_ShutDown()
    mv.MV_Init(["-mv_device=cpu", "-mv_elastic=true"])
    try:
        # past the view: typed under the elastic plane (the negative id
        # stays a CHECK, as in the JAX package)
        assert _id_maps(mv, FatalError, MembershipChanged) == \
            [0, 0, "MembershipChanged", "FatalError"]
        t = mv.MV_CreateTable(MatrixTableOption(num_rows=4, num_cols=2))
        st = elastic._state
        st.departed, st.epoch = True, 1
        try:
            with pytest.raises(MembershipChanged) as exc:
                t.GetRows(np.arange(4, dtype=np.int32))
            assert exc.value.departed == (0,) and exc.value.epoch == 1
            with pytest.raises(MembershipChanged):
                t.AddRows(np.array([0], np.int32),
                          np.ones((1, 2), np.float32))
        finally:
            st.departed, st.epoch = False, 0
        np.testing.assert_array_equal(t.GetRows(np.arange(4,
                                                          dtype=np.int32)),
                                      np.zeros((4, 2), np.float32))
        # a departed member's group collective fails typed, a singleton
        # member's is the identity
        with pytest.raises(MembershipChanged):
            multihost.Group(1, [3]).exchange(b"x", "K")
        assert multihost.Group(1, [0]).exchange(b"x", "K") == [b"x"]
    finally:
        mv.MV_ShutDown()


def test_standby_flag_fails_init_and_leaves_nothing_running():
    """The standby attaches and replicates; a standby that is down
    degrades the authority to solo without failing ``MV_Init`` (the
    name predates the standby: a non-empty flag used to fail)."""
    import json
    import socket
    import urllib.request

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import elastic
    from multiverso_tpu_torch.elastic.standby import StandbyServer
    from multiverso_tpu_torch.telemetry import metrics, ops

    def healthz():
        return json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{ops.port()}/healthz", timeout=10).read())

    def degraded():
        return metrics.snapshot().get("elastic.standby_degraded",
                                      {}).get("value", 0)

    before = {t.name for t in threading.enumerate()}
    srv = StandbyServer(("127.0.0.1", 0), ("127.0.0.1", 0),
                        lease_s=3600.0)
    try:
        mv.MV_Init(["-mv_device=cpu", "-mv_elastic=true", "-mv_ops_port=0",
                    f"-mv_standby=127.0.0.1:{srv.port}"])
        try:
            assert elastic.ha_status()["standby"] == "replicated"
            assert mv.MV_ElasticSync() == 0
            assert srv.record_count() >= 1          # register at least
            assert "warnings" not in healthz()
            d0 = degraded()
        finally:
            mv.MV_ShutDown()
    finally:
        srv.stop()
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()                     # refused from here on
    mv.MV_Init(["-mv_device=cpu", "-mv_elastic=true", "-mv_ops_port=0",
                f"-mv_standby=127.0.0.1:{dead_port}"])
    try:
        assert elastic.ha_status()["standby"] == "degraded"
        assert degraded() == d0 + 1
        assert any("standby lost" in w for w in healthz()["warnings"])
        assert mv.MV_ElasticSync() == 0
    finally:
        mv.MV_ShutDown()
    left = {t.name for t in threading.enumerate()} - before
    assert not {n for n in left if n.startswith(("mv", "mvt"))}, left
