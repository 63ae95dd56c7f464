"""The port's failsafe verbs (``failsafe/``, the admission gate in
``sync/server.py``, the retry loop in ``tables/base.py``) against the JAX
package, one world after the other on the CPU.

(a) The verb scripts of the JAX package's tests/test_failsafe.py under
    ``verb.failack:1.0`` (an Array and a momentum Matrix table: every
    tracked Add applies once, its ack fails, the retry is answered from
    the dedup window), ``verb.transient:0.5`` (rejected before applying,
    retried with backoff to success), ``mailbox.dup:1.0`` (the copy is
    dropped by identity) and ``mailbox.dup:1.0`` on the BSP engine (the
    clocks are not ticked twice: every i-th Get sees exactly i Adds). The
    tables equal the JAX package's (the momentum table bitwise the
    chaos-free run's too), and the ``failsafe.*`` and ``chaos.*`` counters
    move by the same amounts in both packages.
(b) The deadline drill: a Get whose server-side handler wedges raises
    ``DeadlineExceeded`` within ``-mv_deadline_s`` with the diagnostic
    bundle (the JAX bundle's five section titles, the mailbox depth and
    the waiting msg_id), the abandoned request leaks no bookkeeping and
    its late reply is dropped, ``failsafe.deadline_exceeded`` moves by
    one, and ``MV_ShutDown`` on the still-wedged engine returns within its
    bound; chaos ``apply.delay`` stalls the port's single-process window
    the same way; ``-mv_deadline_s=0`` hands ``Waiter.Wait`` a None.
"""

import re
import threading
import time

import numpy as np
import pytest

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

_COUNTERS = ("failsafe.retries", "failsafe.dedup_hits",
             "chaos.verb.failack", "chaos.verb.transient",
             "chaos.mailbox.dup")

#: (flags, script) of each case; the scripts issue tracked verbs only
_CASES = (
    (["-chaos_spec=verb.failack:1.0", "-chaos_seed=3"], "failack"),
    (["-chaos_spec=verb.transient:0.5", "-chaos_seed=11",
      "-mv_max_retries=12"], "transient"),
    (["-chaos_spec=mailbox.dup:1.0", "-chaos_seed=5"], "dup"),
    (["-sync=true", "-chaos_spec=mailbox.dup:1.0", "-chaos_seed=2"],
     "bsp"),
)


def _pkg(name):
    if name == "jax":
        import multiverso_tpu as mv
        from multiverso_tpu.failsafe import chaos
        from multiverso_tpu.tables import ArrayTableOption, MatrixTableOption
        from multiverso_tpu.telemetry import metrics
        from multiverso_tpu.updaters.base import AddOption
        return mv, chaos, ArrayTableOption, MatrixTableOption, metrics, \
            AddOption, []
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.failsafe import chaos
    from multiverso_tpu_torch.tables import (ArrayTableOption,
                                             MatrixTableOption)
    from multiverso_tpu_torch.telemetry import metrics
    from multiverso_tpu_torch.updaters.base import AddOption
    return mv, chaos, ArrayTableOption, MatrixTableOption, metrics, \
        AddOption, ["-mv_device=cpu"]


def _script(name, flags, case):
    mv, chaos, ArrayOpt, MatrixOpt, metrics, AddOption, base = _pkg(name)
    before = {c: metrics.counter(c).value for c in _COUNTERS}
    out = {}
    mv.MV_Init(base + flags)
    try:
        arr = mv.MV_CreateTable(ArrayOpt(size=8))
        if case == "failack":
            mom = mv.MV_CreateTable(MatrixOpt(num_rows=20, num_cols=4,
                                              updater_type="momentum"))
            g = np.random.default_rng(3)
            for _ in range(2):
                arr.Add(np.ones(8, np.float32))
            for _ in range(3):
                mom.AddRows(g.choice(20, 6, replace=False).astype(np.int32),
                            g.integers(-3, 4, (6, 4)).astype(np.float32),
                            AddOption(momentum=0.5))
        elif case == "transient":
            for _ in range(6):
                arr.Add(np.ones(8, np.float32))
        elif case == "dup":
            for _ in range(4):
                arr.Add(np.ones(8, np.float32))
        else:
            for i in range(4):
                arr.Add(np.ones(8, np.float32))
                out[f"get{i}"] = arr.Get()
        mv.MV_SetFlag("chaos_spec", "")
        chaos.quiesce()
        out["array"] = arr.Get()
        if case == "failack":
            out["momentum"] = mom.Get()
    finally:
        mv.MV_ShutDown()
    return out, {c: metrics.counter(c).value - before[c]
                 for c in _COUNTERS}


def test_verb_scripts_match_jax():
    for flags, case in _CASES:
        jout, jcount = _script("jax", flags, case)
        tout, tcount = _script("torch", flags, case)
        assert tcount == jcount, (case, tcount, jcount)
        for key in jout:
            np.testing.assert_array_equal(tout[key], jout[key],
                                          err_msg=f"{case} {key}")
        expect = {"failack": 2.0, "transient": 6.0, "dup": 4.0,
                  "bsp": 4.0}[case]
        np.testing.assert_array_equal(tout["array"], expect)
        if case == "bsp":
            for i in range(4):
                np.testing.assert_array_equal(tout[f"get{i}"], i + 1.0)
        if case == "failack":
            # the momentum table applied each Add once: bitwise the
            # chaos-free run
            clean, _ = _script("torch", [], "failack")
            np.testing.assert_array_equal(tout["momentum"],
                                          clean["momentum"])
            assert tcount["chaos.verb.failack"] == 5
            assert tcount["failsafe.dedup_hits"] >= 5
        if case == "transient":
            assert tcount["chaos.verb.transient"] >= 1
            assert tcount["failsafe.retries"] >= 1
        if case in ("dup", "bsp"):
            assert tcount["failsafe.dedup_hits"] >= 4


def _wedged_get(name, monkeypatch):
    """A world whose Array table's Get wedges in the handler; returns the
    DeadlineExceeded text, its seconds, the table's leftover bookkeeping
    and the counter's move."""
    mv, _, ArrayOpt, _, metrics, _, base = _pkg(name)
    if name == "jax":
        from multiverso_tpu.failsafe.errors import DeadlineExceeded
        from multiverso_tpu.zoo import Zoo
    else:
        from multiverso_tpu_torch.failsafe.errors import DeadlineExceeded
        from multiverso_tpu_torch.zoo import Zoo
    before = metrics.counter("failsafe.deadline_exceeded").value
    mv.MV_Init(base)
    release = threading.Event()
    try:
        arr = mv.MV_CreateTable(ArrayOpt(size=4))
        srv = Zoo.Get().server_tables[0]
        monkeypatch.setattr(srv, "ProcessGetAsync", lambda **kw: None)
        monkeypatch.setattr(
            srv, "ProcessGet",
            lambda **kw: release.wait(3.0) and np.zeros(4, np.float32))
        mv.MV_SetFlag("mv_deadline_s", 0.3)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded) as ei:
            arr.Get()
        secs = time.monotonic() - t0
        left = (dict(arr._waiters), dict(arr._inflight))
        moved = metrics.counter("failsafe.deadline_exceeded").value - before
        release.set()
        time.sleep(0.3)
        left += (dict(arr._results),)
    finally:
        release.set()
        mv.MV_SetFlag("mv_deadline_s", 0.0)
        mv.MV_ShutDown()
    return str(ei.value), secs, left, moved


def test_deadline_drill_matches_jax(monkeypatch):
    jtext, _, _, _ = _wedged_get("jax", monkeypatch)
    text, secs, left, moved = _wedged_get("torch", monkeypatch)
    titles = re.findall(r"^-- (.+) --$", text, re.M)
    assert titles == re.findall(r"^-- (.+) --$", jtext, re.M)
    assert titles == ["threads", "engine", "in-flight requests",
                      "telemetry", "flight"]
    assert 0.3 <= secs < 2.5
    assert "diagnostic bundle" in text and "mailbox depth" in text
    msg_id = int(re.search(r"reply to msg_id (\d+)", text).group(1))
    assert re.search(rf"waiting on msg_ids \[{msg_id}\]", text), text[:2000]
    assert left == ({}, {}, {}) and moved == 1

    # chaos apply.delay stalls the single-process window: the Get raises
    # within the bound and the shutdown of the stalled engine is bounded
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.failsafe.errors import DeadlineExceeded
    from multiverso_tpu_torch.tables import MatrixTableOption
    mv.MV_Init(["-mv_device=cpu", "-chaos_spec=apply.delay:1.0@2.0",
                "-mv_deadline_s=0.5"])
    try:
        mat = mv.MV_CreateTable(MatrixTableOption(num_rows=10, num_cols=3))
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded) as ei:
            mat.GetRows(np.arange(4, dtype=np.int32))
        assert 0.5 <= time.monotonic() - t0 < 2.0
        assert "table 0 reply to msg_id" in str(ei.value)
    finally:
        t0 = time.monotonic()
        mv.MV_ShutDown()
        assert time.monotonic() - t0 < 5.0


def test_unset_deadline_hands_waiter_none(monkeypatch):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.failsafe import deadline as fdeadline
    from multiverso_tpu_torch.tables import ArrayTableOption
    from multiverso_tpu_torch.utils.waiter import Waiter
    seen = []
    orig = Waiter.Wait

    def spy(self, timeout=None):
        seen.append(timeout)
        return orig(self, timeout)

    mv.MV_Init(["-mv_device=cpu"])
    try:
        assert fdeadline.timeout_or_none() is None
        arr = mv.MV_CreateTable(ArrayTableOption(size=4))
        monkeypatch.setattr(Waiter, "Wait", spy)
        arr.Add(np.ones(4, np.float32))
        arr.Get()
        mv.MV_Barrier()
        monkeypatch.setattr(Waiter, "Wait", orig)
        assert seen and all(t is None for t in seen), seen
        # no runner thread without a deadline: bounded() is a direct call
        assert fdeadline.bounded(threading.get_ident, "probe") == \
            threading.get_ident()
        mv.MV_SetFlag("mv_deadline_s", 5.0)
        assert fdeadline.bounded(threading.get_ident, "probe") != \
            threading.get_ident()
    finally:
        mv.MV_SetFlag("mv_deadline_s", 0.0)
        mv.MV_ShutDown()
