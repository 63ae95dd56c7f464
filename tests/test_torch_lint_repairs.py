"""The repairs mvlint forced on the port (``multiverso_tpu_torch/analysis``),
on the CPU.

(a) The per-verb flags read through listener caches still follow a
    ``MV_SetFlag`` at the next verb, as the JAX package's do: in a JAX
    world and then a port world on the same seeded script, a change of
    ``-mv_write_combine`` between two fire-and-forget Adds and of
    ``-mv_get_staleness`` between two Gets shows in the next verb: the
    Add messages the engine received, the ``worker.write_combine_hits``
    and ``worker.get_cache_hits`` counters after every verb, the buffer
    lengths and the table are JAX's.
(b) ``-mv_pipeline_depth`` set between two windows bounds the next one: the
    exchange stage's gate (``_ExchangeStage._gate``, run before every
    window's collective) waits for the targets JAX's gate waits for, and
    classifies the same stalls, at depths 2, 1 and 3 in turn. In the port
    ``-mv_pipeline=false`` makes the next gate depth 1.
(c) The two build fields written by concurrent builds (``native.py``'s
    ``last_build_error``, ``ops/cuda_rows.py``'s ``last_build_log``): more
    threads than cores asking for a missing library (the interpreter
    switching threads every microsecond) run the compiler once, one at a
    time, all get the one library, and the field holds that build's
    output (a failed build's log for ``native.py``). Port-only code: the
    JAX package builds with ``make``.
"""

import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

R, C = 20, 3


def _world(pkg):
    if pkg == "jax":
        import multiverso_tpu as mv
        from multiverso_tpu import tables
        from multiverso_tpu.message import MsgType
        from multiverso_tpu.telemetry import metrics as tmetrics
        from multiverso_tpu.zoo import Zoo
        argv = []
    else:
        import multiverso_tpu_torch as mv
        from multiverso_tpu_torch import tables
        from multiverso_tpu_torch.message import MsgType
        from multiverso_tpu_torch.telemetry import metrics as tmetrics
        from multiverso_tpu_torch.zoo import Zoo
        argv = ["-mv_device=cpu"]
    mv.MV_Init(argv + ["-num_workers=1", "-mv_engine_shards=1",
                       "-mv_write_combine=4", "-mv_get_staleness=0"])
    eng = Zoo.Get().server_engine
    adds = [0]
    recv = eng.Receive

    def counting(msg):
        adds[0] += msg.msg_type == MsgType.Request_Add
        return recv(msg)

    eng.Receive = counting

    def stat(name):
        return int(tmetrics.snapshot().get(name, {}).get("value", 0))

    return SimpleNamespace(mv=mv, tables=tables, adds=adds, stat=stat)


def _flag_script(ns):
    mv = ns.mv
    tab = mv.MV_CreateTable(ns.tables.MatrixTableOption(num_rows=R,
                                                        num_cols=C))
    rng = np.random.default_rng(5)
    rec = []
    # the counters live as long as the process: count from here
    names = ("worker.write_combine_hits", "worker.get_cache_hits")
    base = [ns.stat(n) for n in names]

    def note(tag):
        rec.append((tag, ns.adds[0],
                    *(ns.stat(n) - b for n, b in zip(names, base)),
                    len(tab._wc_buf)))

    def push(tag):
        ids = rng.integers(0, R, 4).astype(np.int32)
        tab.AddFireForget(rng.integers(-3, 4, (4, C)).astype(np.float32),
                          row_ids=ids)
        note(tag)

    def get(tag):
        rows = tab.GetRows(np.arange(R, dtype=np.int32))
        note(tag)
        return rows

    for _ in range(3):
        push("combine 4")
    mv.MV_SetFlag("mv_write_combine", "0")
    for _ in range(2):
        push("combine off")
    mv.MV_SetFlag("mv_write_combine", "2")
    for _ in range(3):
        push("combine 2")
    first = get("staleness 0")
    get("staleness 0")
    mv.MV_SetFlag("mv_get_staleness", "3")
    get("staleness 3 fill")
    hit = get("staleness 3 hit")
    mv.MV_SetFlag("mv_get_staleness", "0")
    last = get("staleness off")
    return rec, first, hit, last


def test_set_flag_reaches_the_next_verb_as_in_jax():
    out = []
    for pkg in ("jax", "torch"):
        ns = _world(pkg)
        try:
            out.append(_flag_script(ns))
        finally:
            ns.mv.MV_ShutDown()
    (jrec, *jrows), (trec, *trows) = out
    assert trec == jrec
    for t, j in zip(trows, jrows):
        np.testing.assert_array_equal(t, j)
    # the changes did show: combining stopped and resumed, the cache
    # opened and shut
    hits = {tag: h for tag, _, h, _, _ in trec}
    assert hits["combine 4"] == 2 and hits["combine off"] == 2
    assert hits["combine 2"] == 3
    cache = [g for tag, _, _, g, _ in trec if tag.startswith("staleness")]
    assert cache == [0, 0, 0, 1, 1]


def _gate_run(server, configure, flags):
    """``_gate`` of an exchange stage with 6 windows exchanged and 3
    applied, after each flag change in turn: the targets it waited for and
    the stalls it classified."""
    stage = object.__new__(server._ExchangeStage)
    stage._emitted, stage._applied = 6, 3
    stage._fence_at, stage._fence_cause = 0, "barrier"
    seen = []
    stage._wait_applied = lambda target, what: seen.append(target)
    stage._srv = SimpleNamespace(
        _note_fence=lambda cause, s: seen.append(cause))
    try:
        for name, value in flags:
            configure.SetCMDFlag(name, value)
            stage._gate()
            seen.append("|")
    finally:
        configure.ResetFlagsToDefaults()
    return seen


def test_pipeline_depth_reaches_the_next_window_as_in_jax():
    from multiverso_tpu.sync import server as jserver
    from multiverso_tpu.utils import configure as jconf
    from multiverso_tpu_torch.sync import server as tserver
    from multiverso_tpu_torch.utils import configure as tconf
    depths = [("mv_pipeline_depth", d) for d in ("2", "1", "3")]
    want = _gate_run(jserver, jconf, depths)
    assert want == [5, "depth", "|", 6, "depth", "|", 4, "depth", "|"]
    assert _gate_run(tserver, tconf, depths) == want
    # the port's -mv_pipeline=false is depth 1 from the next window on
    assert _gate_run(tserver, tconf, [("mv_pipeline_depth", "3"),
                                      ("mv_pipeline", "false")]) == \
        [4, "depth", "|", 6, "depth", "|"]


class _Compiler:
    """A stand-in compiler: counts runs, records how many ran at once,
    and makes its ``-o`` output after a pause."""

    def __init__(self, fail=False):
        self.lock = threading.Lock()
        self.runs = self.inflight = self.peak = 0
        self.fail = fail

    def _run(self, cmd):
        with self.lock:
            self.runs += 1
            self.inflight += 1
            self.peak = max(self.peak, self.inflight)
            n = self.runs
        time.sleep(0.05)
        if not self.fail:
            out = cmd[cmd.index("-o") + 1]
            with open(out, "wb") as f:
                f.write(b"lib")
        with self.lock:
            self.inflight -= 1
        return n

    def run(self, cmd, **kw):
        n = self._run(cmd)
        return subprocess.CompletedProcess(cmd, 1 if self.fail else 0,
                                           stdout=f"log {n}", stderr="")

    def popen(self, cmd, **kw):
        n = self._run(cmd)
        return SimpleNamespace(
            returncode=1 if self.fail else 0,
            communicate=lambda timeout=None: (f"error {n}", None))


#: more builder threads than cores
THREADS = (os.cpu_count() or 4) + 1


def _race(build):
    got, errs = [], []

    def one():
        try:
            got.append(build())
        except BaseException as exc:    # reported by the assert below
            errs.append(exc)

    ths = [threading.Thread(target=one) for _ in range(THREADS)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not errs and not any(th.is_alive() for th in ths), errs
    return got


def test_concurrent_builds_run_one_compiler(tmp_path, monkeypatch):
    from multiverso_tpu_torch import native
    from multiverso_tpu_torch.ops import cuda_rows
    # the row kernels: one nvcc run, its log kept
    nvcc = _Compiler()
    monkeypatch.setattr(cuda_rows, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(cuda_rows, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_rows.subprocess, "run", nvcc.run)
    monkeypatch.setattr(cuda_rows, "last_build_log", None)
    paths = _race(cuda_rows.build)
    assert nvcc.runs == 1 and nvcc.peak == 1
    assert len(set(paths)) == 1 and paths[0].read_bytes() == b"lib"
    assert cuda_rows.last_build_log == "log 1"
    # the native library: one compile of each source and one link; a
    # failing compiler leaves its own log; one compiler process at a time
    # (the stand-in compiles inside Popen, so two at once means two builds)
    srcs = [tmp_path / "a.cc", tmp_path / "b.cc"]
    monkeypatch.setattr(native, "makefile_recipe", lambda: (srcs, [], {}))
    monkeypatch.setattr(native, "lib_path",
                        lambda cxx=None: tmp_path / "native" / "lib.so")
    monkeypatch.setattr(native.shutil, "which", lambda cxx: "/bin/true")
    monkeypatch.setattr(native, "last_build_error", native.last_build_error)
    for fail in (True, False):
        cxx = _Compiler(fail=fail)
        monkeypatch.setattr(native.subprocess, "Popen", cxx.popen)
        monkeypatch.setattr(native.subprocess, "run", cxx.run)
        got = _race(native.build)
        if fail:
            assert got == [None] * THREADS
            assert cxx.runs == THREADS * len(srcs)
            assert native.last_build_error.startswith("error ")
        else:
            assert cxx.runs == len(srcs) + 1        # two objects, one link
            assert got == [tmp_path / "native" / "lib.so"] * THREADS
            assert native.last_build_error is None
        assert cxx.peak == 1
