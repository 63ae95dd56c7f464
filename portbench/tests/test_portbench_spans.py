"""CPU tests of ``portbench/lib/spans.py``: the program's spans beside the
device trace.

    python -m pytest portbench/tests -q

On synthetic records: the six span metrics' values, None on a record
without spans and on one whose ring dropped events, the device-idle time
inside and outside spans, a device op's launching span, and the idle
gaps' names (unchanged without spans, ``>span`` added with them). On the
CPU at a tiny size: each cell's window gives the program's spans and
flow pairs through :func:`spans.install`, and the runs stay correct.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import core, spans  # noqa: E402
from portbench.lib import trace as tr  # noqa: E402

S = 10**9          # one second in ns
T0 = 1_700_000_000 * S


def _rt(calls):
    """Runtime records from (name, t0 s, t1 s, corr, thread key)."""
    return {"name": [c[0] for c in calls],
            "t0": [T0 + int(c[1] * S) for c in calls],
            "t1": [T0 + int(c[2] * S) for c in calls],
            "corr": [c[3] for c in calls], "key": [c[4] for c in calls]}


def _dev(ops):
    """Device records from (name, t0 s, t1 s, corr)."""
    return {"name": [o[0] for o in ops], "kind": [tr._kind(o[0]) for o in ops],
            "t0": [T0 + int(o[1] * S) for o in ops],
            "t1": [T0 + int(o[2] * S) for o in ops],
            "corr": [o[3] for o in ops]}


def _span(name, a, b, key=7):
    return [T0 + int(a * S), T0 + int(b * S), name, key]


#: one WE window of 10 s: two train() calls on thread 7, each with a
#: loader wait and blocks of batch steps; the loader on thread 9
WE_SPANS = [
    _span("we.train", 0.0, 4.0), _span("we.loader_wait", 0.0, 0.5),
    _span("we.block", 0.5, 3.5), _span("we.lanes", 0.5, 0.6),
    _span("we.batch", 0.6, 2.0), _span("we.batch", 2.0, 3.4),
    _span("we.harvest", 3.4, 3.5),
    _span("we.train", 5.0, 9.0), _span("we.loader_wait", 5.0, 5.2),
    _span("we.block", 5.2, 9.0), _span("we.batch", 5.2, 9.0),
    _span("we.loader.tokenize", 0.0, 0.3, 9),
    _span("we.loader.make_block", 0.3, 0.5, 9),
    _span("we.loader.tokenize", 0.4, 0.45, 9),
    _span("we.loader.push_wait", 0.5, 1.5, 9),
    _span("we.loader.make_block", 5.0, 5.1, 9),
    _span("we.loader.push_wait", 5.1, 5.2, 9),
]
#: kernels: busy 0.6-3.0 and 5.3-8.0 (and 9.5-9.8, outside every call)
WE_DEV = [("k1", 0.6, 2.0, 1), ("k2", 1.9, 3.0, 2), ("k3", 5.3, 8.0, 3),
          ("k4", 9.5, 9.8, 4)]
WE_RT = [("cudaLaunchKernel", 0.59, 0.595, 1, 7),
         ("cudaLaunchKernel", 1.8, 1.81, 2, 7),
         ("cudaLaunchKernel", 5.25, 5.26, 3, 7),
         ("cudaLaunchKernel", 9.4, 9.41, 4, 7)]


def _we_run(spans_=None, dropped=0):
    dev, rt = _dev(WE_DEV), _rt(WE_RT)
    busy = spans.merged([[a, b] for a, b in zip(dev["t0"], dev["t1"])])
    sp = {"spans": WE_SPANS if spans_ is None else spans_, "flows": [],
          "growth": {}, "dropped": dropped}
    if dropped:
        sp = {"dropped": dropped}
    run = {"window_s": 10.0, "spans": sp,
           "we": {"words": 1, "loader_wait_s": 0.7},
           "trace": {"busy_s": 5.4, "breakdown": {}}}
    if sp.get("spans"):
        run["trace"]["breakdown"]["spans"] = spans.window_figures(
            sp, dev, rt, busy)
    return run


def test_we_span_metrics_read_the_idle_inside_and_outside_blocks():
    run = _we_run()
    # idle inside we.train: [0, 0.6) + [3.0, 4.0) + [5.0, 5.3) + [8.0, 9.0)
    # of which inside we.block: [0.5, 0.6) + [3.0, 3.5) + [5.2, 5.3)
    # + [8.0, 9.0)
    assert spans.metric("we.block_idle_share", run) == pytest.approx(
        (0.1 + 0.5 + 0.1 + 1.0) / 10 * 100)
    assert spans.metric("we.call_edge_idle_share", run) == pytest.approx(
        (0.5 + 0.5 + 0.2) / 10 * 100)
    # the loader's union: [0, 0.5) + [5.0, 5.1)
    assert spans.metric("we.loader_busy_share", run) == pytest.approx(6.0)
    fig = run["trace"]["breakdown"]["spans"]
    # the loader blocked on a full queue: [0.5, 1.5) + [5.1, 5.2)
    assert fig["we_loader_blocked_s"] == pytest.approx(1.1)
    assert fig["launches_in_train"] == pytest.approx(0.75)
    # the two shares lie inside the device's idle share, which also
    # holds the idle outside every call
    device_idle = (1 - run["trace"]["busy_s"] / run["window_s"]) * 100
    parts = (spans.metric("we.block_idle_share", run)
             + spans.metric("we.call_edge_idle_share", run))
    assert parts <= device_idle
    assert device_idle - parts == pytest.approx(
        (1.0 + 0.5 + 0.2) / 10 * 100)       # [4, 5) [9, 9.5) [9.8, 10)


def test_span_metrics_are_none_without_spans_or_after_drops():
    for run in (_we_run(spans_=[]), _we_run(dropped=3),
                dict(_we_run(), spans={}), dict(_we_run(), trace=None)):
        for m in spans.METRICS:
            assert spans.metric(m["name"], run) is None, m["name"]
    ps = dict(_ps_run(), spans={})
    for m in spans.METRICS:
        assert spans.metric(m["name"], ps) is None


def _ps_run():
    sp = [_span("worker.get", 0.0, 2.0, 1),
          _span("server.window", 0.5, 1.9, 2),
          _span("cuda.fetch", 1.0, 1.8, 2),
          _span("cuda.fetch", 2.5, 2.9, 2)]
    dev = _dev([("Memcpy DtoH (Device -> Pageable)", 1.01, 1.79, 11),
                ("Memcpy DtoH (Device -> Pageable)", 2.51, 2.81, 12),
                ("Memcpy DtoH (Device -> Pageable)", 3.0, 3.2, 13),
                ("Memcpy HtoD (Pageable -> Device)", 3.3, 3.4, 14)])
    rt = _rt([("cudaMemcpyAsync", 1.005, 1.79, 11, 2),
              ("cudaMemcpyAsync", 2.505, 2.81, 12, 2),
              ("cudaMemcpyAsync", 2.99, 3.2, 13, 1),
              ("cudaMemcpyAsync", 3.29, 3.4, 14, 1)])
    flows = [[T0, T0 + 300 * 10**6], [T0 + S, T0 + S + 100 * 10**6]]
    sp_rec = {"spans": sp, "flows": flows, "dropped": 0,
              "growth": {"cuda.d2h_bytes": 2.16e9, "engine.cpu_s": 4.5}}
    busy = spans.merged([[a, b] for a, b in zip(dev["t0"], dev["t1"])])
    return {"window_s": 5.0, "spans": sp_rec, "ps": {"rounds": 3},
            "trace": {"busy_s": 1.38, "breakdown": {
                "spans": spans.window_figures(sp_rec, dev, rt, busy)}}}


def test_ps_span_metrics():
    run = _ps_run()
    assert spans.metric("ps.mailbox_wait_ms.getall", run) == \
        pytest.approx(200.0)
    # 2.16 GB over the D2H time launched inside cuda.fetch: 0.78 + 0.30 s
    assert spans.metric("ps.d2h_gbps.getall", run) == pytest.approx(2.0)
    assert spans.metric("ps.engine_cpu_share.getall", run) == \
        pytest.approx(90.0)
    fig = run["trace"]["breakdown"]["spans"]
    assert fig["d2h_in_fetch"] == pytest.approx(1.08 / 1.28)
    # the WE metrics read nothing in the PS cell, and the PS ones
    # nothing in the WE cell
    for m in spans.METRICS:
        if m["name"].startswith("we."):
            assert spans.metric(m["name"], run) is None
        else:
            assert spans.metric(m["name"], _we_run()) is None


def test_a_device_op_belongs_to_the_innermost_span_of_its_launch():
    lines = spans.timelines(WE_SPANS)
    dev, rt = _dev(WE_DEV), _rt(WE_RT)
    # k3's launch at 5.25 is past the loader wait (5.0-5.2), in a batch
    assert spans.owners(dev, rt, lines) == ["we.lanes", "we.batch",
                                            "we.batch", ""]
    # a record whose runtime call is not in the trace has no owner
    assert spans.owners(_dev([("k", 1.0, 1.1, 99)]), rt, lines) == [""]
    bounds, _ = lines[7]
    assert spans.at(lines[7], [T0 + int(3.45 * S)]) == ["we.harvest"]
    assert spans.at(lines[7], [T0 + int(4.5 * S)]) == [""]
    assert spans.at(lines[7], [T0 - S]) == [""]
    assert list(bounds) == sorted(bounds)


def test_innermost_returns_to_the_parent_when_a_child_ends():
    line = spans.innermost([(0, 10, "a"), (2, 4, "b"), (3, 4, "c"),
                            (6, 8, "d")])
    assert spans.at(line, [0, 2, 3, 4, 5, 6, 8, 9, 10]) == [
        "a", "b", "c", "a", "a", "d", "a", "a", ""]


def test_idle_inside_and_outside():
    busy = (np.array([2, 6]), np.array([4, 8]))
    inside = (np.array([0]), np.array([10]))
    outside = (np.array([3]), np.array([7]))
    assert spans.idle_inside(busy, inside) == pytest.approx(6e-9)
    assert spans.idle_inside(busy, inside, outside) == pytest.approx(4e-9)
    empty = (np.empty(0, np.int64), np.empty(0, np.int64))
    assert spans.idle_inside(busy, empty) == 0.0


class _Phases(tr.PhaseLog):
    def __init__(self, spans_):
        super().__init__()
        self.wall_minus_perf_ns = T0
        self.spans = spans_


def _reduce(cls, dev, rt, phases, window_s):
    trace = cls.__new__(cls)
    trace._recs = (dev, rt)
    trace._records = lambda: (dev, rt)
    return trace.reduce(phases, window_s)


def test_idle_gap_names_keep_their_form_without_spans_and_gain_the_span():
    dev, rt = _dev(WE_DEV), _rt(WE_RT)
    phases = _Phases([("we.train", 0.0, 4.0), ("we.train", 5.0, 9.0)])
    base = _reduce(tr.DeviceTrace, dev, rt, phases, 10.0)
    plain = _reduce(spans.SpanTrace, dev, rt, phases, 10.0)
    assert plain == base                 # no program spans: as it was
    phases.program = {"spans": [], "flows": []}
    assert _reduce(spans.SpanTrace, dev, rt, phases, 10.0) == base
    phases.program = {"spans": WE_SPANS, "flows": [], "growth": {}}
    out = _reduce(spans.SpanTrace, dev, rt, phases, 10.0)
    gaps = dict(out["breakdown"]["idle_gaps"])
    # gap [3.0, 5.3), midpoint 4.15: no phase; ended by k3, launched from
    # thread 7, which has no span open at 4.15. Gap [8.0, 9.5), midpoint
    # 8.75: in a we.train phase; ended by k4, launched from thread 7,
    # inside its we.batch at 8.75
    assert dict(base["breakdown"]["idle_gaps"]) == {
        "harness": pytest.approx(2.3), "we.train": pytest.approx(1.5)}
    assert gaps == {"harness": pytest.approx(2.3),
                    "we.train>we.batch": pytest.approx(1.5)}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps", "spans"}
    assert {k: v for k, v in out.items() if k != "breakdown"} == \
        {k: v for k, v in base.items() if k != "breakdown"}


def test_collect_maps_the_dump_onto_the_profiler_clock():
    dump = {"clock": {"wall_s": 1000.0, "mono_us": 500.0},
            "traceEvents": [
                {"ph": "X", "name": "a", "ts": 600.0, "dur": 50.0,
                 "tid": 5, "args": {}},
                {"ph": "s", "id": 3, "ts": 510.0},
                {"ph": "s", "id": 3, "ts": 520.0},
                {"ph": "f", "id": 3, "ts": 530.0},
                {"ph": "f", "id": 3, "ts": 560.0},
                {"ph": "f", "id": 4, "ts": 570.0},
                {"ph": "M", "name": "process_name"}]}
    from multiverso_tpu_torch.telemetry import trace
    got = spans.collect(dump, trace.profiler_ns, trace.profiler_thread, {})
    assert got["spans"] == [[1000 * S + 100_000, 1000 * S + 150_000, "a",
                             5]]
    assert [b - a for a, b in got["flows"]] == [20_000, 40_000]


@pytest.fixture
def installed(monkeypatch):
    for name in ("load_cell", "cell_metrics", "read_metric"):
        monkeypatch.setattr(core, name, getattr(core, name))
    monkeypatch.setattr(tr, "DeviceTrace", tr.DeviceTrace)
    got = []
    stop = spans.ProgramSpans.stop

    def keep(self):
        got.append(stop(self))
        return got[-1]

    monkeypatch.setattr(spans.ProgramSpans, "stop", keep)
    spans.install(core)
    from multiverso_tpu_torch.models.wordembedding import device_pairs
    monkeypatch.setattr(device_pairs, "_SPARSE_BYTES", 0)
    return got


@pytest.mark.parametrize("cell", ["we_sgns_1bw.b65536",
                                  "ps_matrix_perf.getall"])
def test_cells_give_their_spans_on_the_cpu(cell, installed):
    harness = core.load_module(Path(__file__).parent
                               / "test_portbench_harness.py", "pb_harness")
    out = harness.tiny_run(cell, trace=True)
    assert out["correct"], out["checks"]
    (got,) = installed
    assert got["dropped"] == 0
    names = {s[2] for s in got["spans"]}
    if cell.startswith("we"):
        assert {"we.train", "we.block", "we.batch", "we.lanes",
                "we.loader_wait", "we.loader.tokenize",
                "we.loader.make_block"} <= names
    else:
        assert {"worker.get", "server.window", "cuda.fetch"} & names
        assert got["flows"] and min(b - a for a, b in got["flows"]) >= 0
        assert got["growth"]["engine.cpu_s"] > 0
    # the CPU has no device trace: the span metrics read nothing there
    assert not {m["name"] for m in spans.METRICS} & set(out["metrics"])
    from multiverso_tpu_torch.telemetry import trace
    assert not trace.enabled()
