"""The port's failsafe plane across processes and on the tcp wire, held
against the JAX package.

(a) The two-rank chaos soak: both packages run ``tests/_mh_child.py``'s
    ``failsafe`` mode (the JAX soak's mailbox, verb and ``wire.bitflip``
    sites, ``-chaos_seed=1234``, tracked AddRows + GetRows on an add and a
    momentum table). Every Get of the add table equals the oracle of both
    ranks' Adds, the replicas are bitwise equal across the ranks and across
    the packages, every armed site fired, the CRC caught every flipped
    frame, and the failsafe and chaos counters are equal in both packages
    (one fault schedule). The port's world at ``-mv_engine_shards=2`` (the
    two tables on two shards, each with its own stream, dedup window and
    exchange channel) gives the same tables and counters: its shards admit
    on their own threads, but blocking verbs draw in program order.
(b) The tcp wire's chaos sites, a port end against a JAX end on loopback:
    ``tcp.partition`` severs the channel and BOTH ends raise ``ActorDied``
    (whichever package armed it), ``tcp.drop`` turns into a fatal
    ``DeadlineExceeded`` on the starved end instead of a hang, and
    ``tcp.delay`` slows an exchange without corrupting it.
"""

import threading
import time

import numpy as np

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

_SITES = ("chaos.mailbox.drop", "chaos.mailbox.dup", "chaos.mailbox.delay",
          "chaos.verb.transient", "chaos.verb.failack", "chaos.wire.bitflip")


def test_two_rank_chaos_soak_matches_jax(tmp_path):
    jres, _ = run_world("jax", "failsafe", tmp_path, timeout=240)
    (tmp_path / "sharded").mkdir()
    sres, _ = run_world("torch", "failsafe", tmp_path / "sharded",
                        "-mv_engine_shards=2", timeout=240)
    tres, _ = run_world("torch", "failsafe", tmp_path, timeout=240)
    for r in range(2):
        for key in tres[r]:
            np.testing.assert_array_equal(sres[r][key], tres[r][key],
                                          err_msg=f"sharded {key}")
    for key in ("final_add", "final_mom"):
        np.testing.assert_array_equal(tres[0][key], tres[1][key],
                                      err_msg=key)
    for r in range(2):
        for key in jres[r]:
            if key.startswith("add_get") or key == "final_add":
                np.testing.assert_array_equal(tres[r][key], jres[r][key],
                                              err_msg=key)
            elif key.startswith("mom_get") or key == "final_mom":
                np.testing.assert_allclose(tres[r][key], jres[r][key],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=key)
            else:
                assert float(tres[r][key]) == float(jres[r][key]), \
                    (key, float(tres[r][key]), float(jres[r][key]))
        for key in _SITES + ("failsafe.retries", "failsafe.dedup_hits"):
            assert float(tres[r][key]) > 0, key
        # each flipped frame was caught by the peer's CRC check
        assert float(tres[r]["wire.crc_failures"]) == \
            float(tres[r]["chaos.wire.bitflip"]) > 0


def _both(fns, timeout=30):
    out, errs = {}, {}

    def run(key, fn):
        try:
            out[key] = fn()
        except BaseException as exc:     # reported to the caller
            errs[key] = exc

    ts = [threading.Thread(target=run, args=(k, fn))
          for k, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "wire exchange hung"
    return out, errs


def _pair(jax_rank):
    from multiverso_tpu.parallel.tcp_wire import TcpWire as JWire
    from multiverso_tpu_torch.parallel.tcp_wire import TcpWire as TWire
    ends = [None, None]
    ends[jax_rank] = JWire("fs", jax_rank, 2, 1, 4096)
    ends[1 - jax_rank] = TWire("fs", 1 - jax_rank, 2, 1, 4096)
    eps = {r: ends[r].listen_endpoints() for r in (0, 1)}
    _, errs = _both([lambda w=w: w.connect(eps) for w in ends])
    assert not errs, errs
    return ends


def test_tcp_chaos_sites_against_the_jax_wire():
    from multiverso_tpu.failsafe.errors import ActorDied as JDied
    from multiverso_tpu.failsafe.errors import DeadlineExceeded as JDead
    from multiverso_tpu.utils.configure import SetCMDFlag as jset
    from multiverso_tpu_torch.failsafe.errors import ActorDied as TDied
    from multiverso_tpu_torch.failsafe.errors import \
        DeadlineExceeded as TDead
    from multiverso_tpu_torch.telemetry import metrics
    from multiverso_tpu_torch.utils.configure import SetCMDFlag as tset
    died = {"jax": JDied, "torch": TDied}
    dead = {"jax": JDead, "torch": TDead}

    def arm(pkg, spec):
        (jset if pkg == "jax" else tset)("chaos_spec", spec)
        (jset if pkg == "jax" else tset)("chaos_seed", 7)

    try:
        for jax_rank in (0, 1):
            pkgs = {jax_rank: "jax", 1 - jax_rank: "torch"}
            for armed in ("jax", "torch"):
                ends = _pair(jax_rank)
                try:
                    arm(armed, "tcp.partition:1.0")
                    out, errs = _both([
                        lambda w=w, r=r: w.exchange(b"p%d" % r, 0,
                                                    timeout_s=10)
                        for r, w in enumerate(ends)])
                    for r in (0, 1):
                        assert isinstance(errs.get(r), died[pkgs[r]]), \
                            (jax_rank, armed, out, errs)
                finally:
                    arm(armed, "")
                    for w in ends:
                        w.close()
            # both ends drop their final frame toward the other: each
            # starves and its deadline (not a hang) converts the stall
            ends = _pair(jax_rank)
            try:
                for pkg in ("jax", "torch"):
                    arm(pkg, "tcp.drop:1.0")
                t0 = time.perf_counter()
                out, errs = _both([
                    lambda w=w: w.exchange(b"x" * 500, 0, timeout_s=1.5)
                    for w in ends])
                assert time.perf_counter() - t0 < 10
                for r in (0, 1):
                    assert isinstance(errs.get(r), dead[pkgs[r]]), errs
                    assert errs[r].mv_fatal
            finally:
                for pkg in ("jax", "torch"):
                    arm(pkg, "")
                for w in ends:
                    w.close()
        ends = _pair(0)
        try:
            before = metrics.counter("chaos.tcp.delay").value
            arm("torch", "tcp.delay:1.0@0.08")
            t0 = time.perf_counter()
            out, errs = _both([lambda w=w, r=r: w.exchange(b"d%d" % r, 0,
                                                           timeout_s=10)
                               for r, w in enumerate(ends)])
            assert not errs, errs
            assert out[0] == [b"d0", b"d1"] == out[1]
            assert time.perf_counter() - t0 >= 0.08
            assert metrics.counter("chaos.tcp.delay").value > before
        finally:
            arm("torch", "")
            for w in ends:
                w.close()
    finally:
        for pkg in ("jax", "torch"):
            arm(pkg, "")
