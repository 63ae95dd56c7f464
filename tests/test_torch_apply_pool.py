"""The windowed engine's parallel apply (``-mv_apply_workers``) against the
serial apply and the JAX package's.

(a) ``tests/_mh_child.py`` mode ``apply``, two processes, in each package:
    an add, sgd, momentum and AdaGrad table take fire-and-forget AddRows
    in turn (windows carry several tables) at the default 4 workers, with
    a tracked Add out of range to a fifth table in the middle of the
    traffic, which fails at its caller alone; then the same traffic on new
    tables at 1 worker. The port's turns end bitwise equal, its pool took
    jobs at 4 workers and none at 1, its ranks are bitwise equal, and its
    tables equal the JAX world's: add and sgd bitwise, momentum and
    AdaGrad within rtol 1e-5, atol 1e-6.
(b) In this process, the engine's apply of one window on fake tables: the
    parallel branch runs one job a table in window order and sums the
    merged Add runs after the join (the serial branch's counts), ticks
    the window epoch once, counts pool and inline jobs; a verb's failure
    replies to that verb alone; a job's escape is raised again on the
    actor thread; a job that never finishes fails the wait at
    ``-mv_deadline_s``.
"""

import threading

import numpy as np
import pytest
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world

torch.set_num_threads(1)

_KINDS = ("add", "sgd", "mom", "ada")


def test_two_process_parallel_apply_matches_serial_and_jax(tmp_path):
    jres, _ = run_world("jax", "apply", tmp_path)
    tres, _ = run_world("torch", "apply", tmp_path)
    for r in range(2):
        assert tres[r]["pool_w4"][0] > 0 and tres[r]["pool_w4"][1] > 0
        assert tres[r]["pool_w1"][:2].tolist() == [0, 0]
        for k in _KINDS:
            for turn in ("w4", "w1"):
                key = f"{turn}_{k}"
                np.testing.assert_array_equal(tres[r][key], tres[0][key],
                                              err_msg=key)
                np.testing.assert_array_equal(jres[r][key], jres[0][key],
                                              err_msg=key)
                if k in ("add", "sgd"):
                    np.testing.assert_array_equal(tres[r][key],
                                                  jres[r][key], err_msg=key)
                else:
                    np.testing.assert_allclose(tres[r][key], jres[r][key],
                                               rtol=1e-5, atol=1e-6,
                                               err_msg=key)


class _Table:
    """A fake server table: records its ops, merges Add runs, fails an Add
    whose payload says so, raises a BaseException or blocks on request."""

    def __init__(self, tid, log, gate=None):
        self.tid, self.log, self.gate = tid, log, gate
        self.threads = set()

    def mh_apply_is_local(self):
        return True

    def ProcessAddRunParts(self, positions, my_rank):
        self._note("R")
        return all(not p[my_rank].get("bad") for p in positions)

    def ProcessAddParts(self, parts, my_rank):
        self._note("A")
        if parts[my_rank].get("escape"):
            raise _Escape("a job escaped")
        if parts[my_rank].get("bad"):
            raise ValueError(f"bad add to table {self.tid}")

    def ProcessGetWindowParts(self, positions, my_rank):
        self._note("G")
        return [self.tid] * len(positions)

    def ProcessGetParts(self, parts, my_rank):
        self._note("G")
        return self.tid

    def _note(self, kind):
        self.threads.add(threading.current_thread().name)
        self.log.append((self.tid, kind))
        if self.gate is not None:
            self.gate.wait()


class _Escape(BaseException):
    pass


class _Msg:
    def __init__(self):
        self.result = "unset"

    def reply(self, result=None):
        self.result = result


def _window(spec):
    """``spec``: [(kind, table, payload)] -> (verbs, windows, prefix,
    descs0) of a one-rank world."""
    local = [(k, t, p) for k, t, p in spec]
    return ([_Msg() for _ in spec], [local], len(spec),
            [(k, t) for k, t, _ in spec])


def test_parallel_apply_in_process(monkeypatch):
    from multiverso_tpu_torch.failsafe.errors import DeadlineExceeded
    from multiverso_tpu_torch.sync.server import Server
    from multiverso_tpu_torch.telemetry import metrics
    from multiverso_tpu_torch.utils.configure import SetCMDFlag

    srv = Server()
    pool = [metrics.counter(f"engine.apply_pool.{n}")
            for n in ("jobs", "inline_jobs")]
    p0 = [c.value for c in pool]
    log: list = []
    srv.store_ = [_Table(t, log) for t in range(3)]
    spec = [("A", 0, {}), ("G", 1, {}), ("A", 0, {}), ("A", 1, {}),
            ("G", 0, {}), ("A", 2, {"bad": True}), ("G", 0, {}),
            ("A", 1, {}), ("G", 2, {})]
    results = {}
    for parallel in (False, True):
        log.clear()
        srv.mh_add_run_merged = 0
        epoch = srv.window_epoch
        verbs, windows, prefix, descs0 = _window(spec)
        srv._mh_apply_window(verbs, windows, prefix, descs0,
                             parallel_ok=parallel)
        assert srv.window_epoch == epoch + 1
        assert srv.mh_add_run_merged == 2       # tables 0 and 1
        results[parallel] = [repr(v.result) for v in verbs]
        for t in range(3):                      # each table in its order
            assert [k for tid, k in log if tid == t] == \
                {0: ["R", "G"], 1: ["G", "R"], 2: ["A", "G"]}[t]
    assert results[False] == results[True] == [
        "None", "1", "None", "None", "0",
        "ValueError('bad add to table 2')", "0", "None", "2"]
    assert [c.value - v for c, v in zip(pool, p0)] == [2, 1]
    assert any(n.startswith("mvt-apply-") for t in srv.store_
               for n in t.threads)

    # one table's window, or workers at 1: no pool
    verbs, windows, prefix, descs0 = _window([("A", 0, {}), ("G", 0, {})])
    srv._mh_apply_window(verbs, windows, prefix, descs0, parallel_ok=True)
    SetCMDFlag("mv_apply_workers", 1)
    try:
        verbs, windows, prefix, descs0 = _window(spec)
        srv._mh_apply_window(verbs, windows, prefix, descs0,
                             parallel_ok=True)
    finally:
        SetCMDFlag("mv_apply_workers", 4)
    assert [c.value - v for c, v in zip(pool, p0)] == [2, 1]

    # a job's escape (not a verb's failure) reaches the actor thread
    verbs, windows, prefix, descs0 = _window(
        [("A", 0, {"escape": True}), ("A", 1, {}), ("A", 2, {})])
    with pytest.raises(_Escape):
        srv._mh_apply_window(verbs, windows, prefix, descs0,
                             parallel_ok=True)

    # a job that never finishes fails the wait at the deadline
    gate = threading.Event()
    srv.store_[0] = _Table(0, log, gate)
    SetCMDFlag("mv_deadline_s", 0.2)
    try:
        verbs, windows, prefix, descs0 = _window([("G", 0, {}),
                                                  ("G", 1, {})])
        with pytest.raises(DeadlineExceeded, match="parallel window apply"):
            srv._mh_apply_window(verbs, windows, prefix, descs0,
                                 parallel_ok=True)
    finally:
        SetCMDFlag("mv_deadline_s", 0.0)
        gate.set()
    srv.Stop()
    assert srv._apply_pool is None
