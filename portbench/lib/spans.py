"""The program's own spans beside the device trace: why the card sits idle.

The port records spans (``multiverso_tpu_torch/telemetry/trace.py``, under
``-trace``) around the WordEmbedding app's calls, blocks, batch steps and
loader work, the server tables' device-to-host copies (``cuda.fetch``)
and the engine's windows, and flow events at each message's enqueue and
dequeue; it counts the copies' bytes (``cuda.d2h_bytes``) and the engine
threads' CPU seconds (``engine.cpu_s``). This module reads them over a
window and lays them on the device trace's clock:

* :class:`ProgramSpans`: turns the program's spans on and clears its ring
  before the window; after it, reads the ring and the counters' growth.
  Against a program that cannot give them (no ``trace.profiler_ns``) or a
  ring that dropped events it reads nothing, and every span metric is
  None;
* :class:`SpanTrace`: the device trace (``lib/trace.py``) with each
  record's correlation id and thread key kept, and the idle gaps named by
  the span open on the launching thread (``we.train>we.loader_wait:
  cudaMemcpyAsync``);
* the reductions, pure functions of the records: a thread's innermost
  open span through time (:func:`innermost`), the span each device op was
  launched from (:func:`owners`), device-idle time inside spans, the flow
  pairs' waits, and :func:`metric`, the six per-layer metrics of
  :data:`METRICS`.

Times are Unix-epoch nanoseconds, the clock of ``torch.profiler``'s
records (``trace.profiler_ns``); a CUDA runtime record's thread key is
its ``device_resource_id()`` (``trace.profiler_thread`` of a span's
``tid``). The harness does not call this module yet:
``portbench/spans_run.py`` runs a cell with it (:func:`install`).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from portbench.lib import trace as tr

#: the counters whose growth over the window is read
COUNTERS = ("cuda.d2h_bytes", "engine.cpu_s")

_WE, _PS = "we_sgns_1bw.b65536", "ps_matrix_perf.getall"

#: the per-layer metrics read from the spans, as ``BENCHMARK.json``
#: entries
METRICS = [
    {"name": "we.call_edge_idle_share", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "WE app and loader",
     "moves": "words_per_s", "workloads": [_WE]},
    {"name": "we.block_idle_share", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "WE model step",
     "moves": "words_per_s", "workloads": [_WE]},
    {"name": "we.loader_busy_share", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "WE app and loader",
     "moves": "words_per_s", "workloads": [_WE]},
    {"name": "ps.mailbox_wait_ms.getall", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "engine",
     "moves": "ps_getall_rounds_per_s", "workloads": [_PS]},
    {"name": "ps.d2h_gbps.getall", "unit": "GB/s", "better": "higher",
     "source": "device_trace", "layer": "server tables' transfers",
     "moves": "ps_getall_rounds_per_s", "workloads": [_PS]},
    {"name": "ps.engine_cpu_share.getall", "unit": "%", "better": "lower",
     "source": "program_counter", "layer": "engine",
     "moves": "ps_getall_rounds_per_s", "workloads": [_PS]},
]


# -- the program's side -------------------------------------------------------

class ProgramSpans:
    """The program's spans and counters over one window."""

    def __init__(self):
        self.trace = None
        self.was_on = False
        self.c0 = {}

    def start(self) -> None:
        from multiverso_tpu_torch import api
        from multiverso_tpu_torch.telemetry import trace
        if not hasattr(trace, "profiler_ns"):
            return                  # a program whose spans cannot be mapped
        self.trace = trace
        self.was_on = bool(trace.enabled())
        api.MV_SetFlag("trace", True)
        trace.clear()
        self.c0 = counters()

    def stop(self) -> dict:
        """The window's spans (:func:`collect`); {} when the program has
        none to give or its ring dropped events (then ``dropped`` alone)."""
        if self.trace is None:
            return {}
        from multiverso_tpu_torch import api
        dump = self.trace.to_chrome_trace()
        c1 = counters()
        api.MV_SetFlag("trace", self.was_on)
        if dump.get("dropped", 0):
            return {"dropped": dump["dropped"]}
        growth = {k: c1[k] - self.c0[k] for k in COUNTERS
                  if k in c1 and k in self.c0}
        return collect(dump, self.trace.profiler_ns,
                       self.trace.profiler_thread, growth)


def counters() -> dict:
    from multiverso_tpu_torch.telemetry import metrics
    snap = metrics.snapshot()
    return {k: float(snap[k]["value"]) for k in COUNTERS if k in snap}


def collect(dump: dict, to_ns, to_key, growth: dict) -> dict:
    """The window's spans from a program trace dump: every finished span
    as ``[t0, t1, name, thread key]`` on the profiler's clock,
    each flow pair (``s`` at enqueue, ``f`` at dequeue, matched by id in
    order) as ``[enqueue, dequeue]``, and the counters' growth."""
    clock = dump["clock"]
    spans, starts, flows = [], defaultdict(list), []
    for e in sorted((e for e in dump["traceEvents"] if "ts" in e),
                    key=lambda e: e["ts"]):
        if e["ph"] == "X":
            spans.append([to_ns(e["ts"], clock),
                          to_ns(e["ts"] + e["dur"], clock), e["name"],
                          to_key(e["tid"])])
        elif e["ph"] == "s":
            starts[e["id"]].append(to_ns(e["ts"], clock))
        elif e["ph"] == "f" and starts.get(e["id"]):
            flows.append([starts[e["id"]].pop(0), to_ns(e["ts"], clock)])
    return {"spans": spans, "flows": flows, "growth": growth, "dropped": 0}


# -- reductions ---------------------------------------------------------------

def innermost(spans) -> tuple:
    """One thread's innermost open span through time: (bounds, names),
    ``names[i]`` innermost on ``[bounds[i], bounds[i+1])``, "" where no
    span is open. ``spans``: (t0, t1, name) of one thread; they nest."""
    bounds, names = [], []

    def emit(t, name):
        t = max(t, bounds[-1]) if bounds else t
        if bounds and bounds[-1] == t:
            names[-1] = name
        else:
            bounds.append(t)
            names.append(name)

    stack = []                                  # (end, name), outermost first
    for t0, t1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= t0:
            end = stack.pop()[0]
            emit(end, stack[-1][1] if stack else "")
        stack.append((t1, name))
        emit(t0, name)
    while stack:
        end = stack.pop()[0]
        emit(end, stack[-1][1] if stack else "")
    return np.asarray(bounds, np.int64), names


def at(timeline: tuple, t) -> list:
    """The innermost span names on one thread at times ``t``."""
    bounds, names = timeline
    t = np.atleast_1d(np.asarray(t, np.int64))
    if len(bounds) == 0:
        return [""] * len(t)
    i = np.searchsorted(bounds, t, side="right") - 1
    return [names[k] if k >= 0 else "" for k in i]


def timelines(spans) -> dict:
    """{thread key: :func:`innermost` timeline} of the window's spans."""
    by_key = defaultdict(list)
    for t0, t1, name, key in spans:
        by_key[key].append((t0, t1, name))
    return {k: innermost(v) for k, v in by_key.items()}


def launchers(dev: dict, rt: dict) -> tuple:
    """For each device record, its runtime call's (start, thread key) by
    correlation id; (-1, None) where the trace holds no such call."""
    by_corr = {c: (t0, k) for c, t0, k in zip(rt["corr"], rt["t0"],
                                               rt["key"])}
    got = [by_corr.get(c, (-1, None)) for c in dev["corr"]]
    return [g[0] for g in got], [g[1] for g in got]


def owners(dev: dict, rt: dict, lines: dict) -> list:
    """The innermost span that was open on the launching thread when each
    device record's runtime call was made ("" where none was, or the
    call is not in the trace)."""
    t0s, keys = launchers(dev, rt)
    out = [""] * len(t0s)
    by_key = defaultdict(list)
    for i, k in enumerate(keys):
        if k in lines:
            by_key[k].append(i)
    for k, idx in by_key.items():
        for i, n in zip(idx, at(lines[k], [t0s[i] for i in idx])):
            out[i] = n
    return out


def merged(intervals) -> tuple:
    """(starts, ends) of the union of [t0, t1) intervals."""
    a = np.asarray(intervals, np.int64).reshape(-1, 2)
    _, m0, m1 = tr.union_length(a[:, 0], a[:, 1])
    return m0, m1


def seconds(m: tuple) -> float:
    """The length of a union of intervals (:func:`merged`), in s."""
    return float((m[1] - m[0]).sum()) / 1e9


def _covers(s: tuple, mids) -> np.ndarray:
    m0, m1 = s
    i = np.searchsorted(m0, mids, side="right") - 1
    return (i >= 0) & (mids < m1[np.maximum(i, 0)]) if len(m0) else \
        np.zeros(len(mids), bool)


def idle_inside(busy: tuple, inside: tuple, outside: tuple = None) -> float:
    """Seconds inside the union ``inside`` (and outside the union
    ``outside``) where the union ``busy`` of device intervals is not."""
    sets = [s for s in (busy, inside, outside) if s is not None]
    b = np.unique(np.concatenate([np.concatenate(s) for s in sets]))
    if len(b) < 2:
        return 0.0
    mids = b[:-1] + (b[1:] - b[:-1]) // 2
    keep = _covers(inside, mids) & ~_covers(busy, mids)
    if outside is not None:
        keep &= ~_covers(outside, mids)
    return float(np.diff(b)[keep].sum()) / 1e9


def named(spans, *names) -> list:
    return [[s[0], s[1]] for s in spans if s[2] in names]


def window_figures(spans: dict, dev: dict, rt: dict, busy: tuple) -> dict:
    """What the window's spans say of the device trace: the six metrics'
    raw seconds and bytes, the seconds the loader sat blocked on a full
    block queue (``we.loader.push_wait``: blocks were ready before the
    trainer asked), and how well the two clocks line up (the training
    thread's kernel launches inside ``we.train``; the D2H device time
    launched inside ``cuda.fetch``)."""
    sp = spans["spans"]
    out = {}
    train = named(sp, "we.train")
    if train:
        T, B = merged(train), merged(named(sp, "we.block"))
        out["we_edge_idle_s"] = idle_inside(busy, T, B)
        out["we_block_idle_s"] = idle_inside(busy, B)
        out["we_loader_busy_s"] = seconds(merged(named(
            sp, "we.loader.tokenize", "we.loader.make_block")))
        blocked = named(sp, "we.loader.push_wait")
        out["we_loader_blocked_s"] = seconds(merged(blocked)) if blocked \
            else 0.0
        keys = {s[3] for s in sp if s[2] == "we.train"}
        lk = [(t0, k) for n, t0, k in zip(rt["name"], rt["t0"], rt["key"])
              if n.startswith("cudaLaunchKernel") and k in keys]
        if lk:
            inside = _covers(T, np.asarray([t for t, _ in lk], np.int64))
            out["launches_in_train"] = float(inside.mean())
    kinds = np.asarray(dev["kind"], object)
    d2h = np.nonzero(kinds == "d2h")[0]
    if len(d2h):
        own = owners({"corr": [dev["corr"][i] for i in d2h]}, rt,
                     timelines(sp))
        dur = (np.asarray(dev["t1"], np.int64)[d2h]
               - np.asarray(dev["t0"], np.int64)[d2h]) / 1e9
        fetch = np.asarray([o == "cuda.fetch" for o in own])
        out["d2h_fetch_s"] = float(dur[fetch].sum())
        out["d2h_in_fetch"] = float(dur[fetch].sum() / max(dur.sum(), 1e-12))
    return out


def metric(name: str, run: dict):
    """The value of one of :data:`METRICS` from a run's record: None
    where the record holds no program spans (``run["spans"]`` empty or
    missing, or the ring dropped events) or no traced window."""
    sp, trc = run.get("spans") or {}, run.get("trace")
    if not sp.get("spans") or trc is None or "spans" not in trc["breakdown"]:
        return None
    fig, w = trc["breakdown"]["spans"], run["window_s"]
    growth = sp.get("growth", {})
    if name.startswith("we."):
        key = {"we.call_edge_idle_share": "we_edge_idle_s",
               "we.block_idle_share": "we_block_idle_s",
               "we.loader_busy_share": "we_loader_busy_s"}[name]
        return fig[key] / w * 100.0 if run.get("we") and key in fig \
            else None
    if run.get("ps") is None:
        return None
    if name == "ps.mailbox_wait_ms.getall":
        f = np.asarray(sp["flows"], np.int64).reshape(-1, 2)
        return float((f[:, 1] - f[:, 0]).mean()) / 1e6 if len(f) else None
    if name == "ps.d2h_gbps.getall":
        s = fig.get("d2h_fetch_s", 0.0)
        b = growth.get("cuda.d2h_bytes")
        return b / s / 1e9 if b and s > 0 else None
    if name == "ps.engine_cpu_share.getall":
        c = growth.get("engine.cpu_s")
        return None if c is None else c / w * 100.0
    raise KeyError(name)


# -- the device trace with spans ----------------------------------------------

class SpanTrace(tr.DeviceTrace):
    """``DeviceTrace`` keeping each record's correlation id and thread
    key, and reading the program's spans the window left on the
    ``PhaseLog`` (``phases.program``, set by :func:`install`'s window)."""

    #: (device records, runtime records), read once
    _recs = None

    def _records(self):
        if self._recs is not None:
            return self._recs
        from torch.autograd import DeviceType
        dev, rt = defaultdict(list), defaultdict(list)
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                d = dev
                dev["kind"].append(tr._kind(name))
            elif name.startswith("cuda"):
                d = rt
                rt["key"].append(e.device_resource_id())
            else:
                continue
            d["name"].append(name)
            d["t0"].append(t0)
            d["t1"].append(t1)
            d["corr"].append(e.correlation_id())
        self._recs = (dev, rt)
        return self._recs

    def reduce(self, phases, window_s: float) -> dict:
        out = super().reduce(phases, window_s)
        spans = getattr(phases, "program", None) or {}
        if not spans.get("spans"):
            return out
        dev, rt = self._records()
        t0 = np.asarray(dev["t0"], np.int64)
        t1 = np.asarray(dev["t1"], np.int64)
        _, m0, m1 = tr.union_length(t0, t1)
        out["breakdown"]["spans"] = window_figures(spans, dev, rt, (m0, m1))
        out["breakdown"]["idle_gaps"] = idle_by_span(
            m0, m1, phases, rt, dev, timelines(spans["spans"]))
        return out


def idle_by_span(m0, m1, phases, rt, dev, lines: dict) -> list:
    """``DeviceTrace._idle_by_host``'s gaps and names, each name with
    ``>`` and the innermost span open at the gap's midpoint on the thread
    whose runtime call launched the device op that ends the gap, before
    the runtime call in flight: ``we.train>we.loader_wait:cudaMemcpyAsync``.
    A gap with no such span keeps its name as it was."""
    if len(m0) < 2 or not phases.spans:
        return []
    off = phases.wall_minus_perf_ns
    ph = sorted((int(a * 1e9) + off, int(b * 1e9) + off, n)
                for n, a, b in phases.spans)
    p0 = np.array([s[0] for s in ph], np.int64)
    p1 = np.array([s[1] for s in ph], np.int64)
    r0 = np.asarray(rt["t0"], np.int64)
    r1 = np.asarray(rt["t1"], np.int64)
    rorder = np.argsort(r0, kind="stable")
    r0, r1 = r0[rorder], r1[rorder]
    rn = [rt["name"][i] for i in rorder]
    g0, g1 = m1[:-1], m0[1:]
    mids = (g0 + g1) // 2
    keep = (mids >= p0.min()) & (mids <= p1.max())
    g0, g1, mids = g0[keep], g1[keep], mids[keep]
    # the op that ends a gap: the first device record of the next merged
    # interval, and its launching thread
    d0 = np.asarray(dev["t0"], np.int64)
    dorder = np.argsort(d0, kind="stable")
    first = dorder[np.searchsorted(d0[dorder], g1, side="left")]
    _, keys = launchers({"corr": [dev["corr"][i] for i in first]}, rt)
    suffix = [""] * len(mids)
    by_key = defaultdict(list)
    for k, key in enumerate(keys):
        if key in lines:
            by_key[key].append(k)
    for key, idx in by_key.items():
        for k, n in zip(idx, at(lines[key], mids[idx])):
            suffix[k] = f">{n}" if n else ""
    last = np.searchsorted(p0, mids, side="right") - 1
    cover = []
    for back in range(8):
        i = last - back
        ok = (i >= 0) & (p1[np.maximum(i, 0)] >= mids)
        cover.append(np.where(ok, i, -1))
    j = np.searchsorted(r0, mids, side="right") - 1
    j_ok = ((j >= 0) & (r1[np.maximum(j, 0)] >= mids)) if len(r0) else \
        np.zeros(len(mids), bool)
    idle = defaultdict(float)
    secs = (g1 - g0) / 1e9
    for k in range(len(mids)):
        names = sorted({ph[c[k]][2] for c in cover if c[k] >= 0})
        host = ("+".join(names) or "harness") + suffix[k]
        if j_ok[k]:
            host += ":" + rn[j[k]]
        idle[host] += float(secs[k])
    return [[n, s] for n, s in
            sorted(idle.items(), key=lambda kv: -kv[1])[:10]]


# -- running a cell with them ------------------------------------------------

def install(core) -> None:
    """Run ``core``'s cells with the program's spans: each driver's
    window between :class:`ProgramSpans` ``start`` and ``stop`` (the
    spans go to the record's ``spans`` and to the ``PhaseLog``),
    :class:`SpanTrace` as the device trace, and :data:`METRICS` reported
    in their cells' traced lines. It stands in for the harness's own
    calls (``core.run_cell``, ``trace.DeviceTrace``) until they make
    them."""
    load_cell, read_metric = core.load_cell, core.read_metric
    cell_metrics = core.cell_metrics

    def load_cell_spans(cell, bench_dir=core.BENCH_DIR):
        wl, cfg, driver = load_cell(cell, bench_dir)
        base = driver.Cell

        class Cell(base):
            def window(self, seconds, phases):
                prog = ProgramSpans()
                prog.start()
                rec = base.window(self, seconds, phases)
                rec["spans"] = phases.program = prog.stop()
                return rec

        driver.Cell = Cell
        return wl, cfg, driver

    def cell_metrics_spans(bench, cell, kind):
        extra = [m for m in METRICS if kind == "per_layer"
                 and cell in m["workloads"]]
        return cell_metrics(bench, cell, kind) + extra

    def read_metric_spans(name, run, bench_dir=core.BENCH_DIR):
        entry = next((m for m in METRICS if m["name"] == name), None)
        if entry is None:
            return read_metric(name, run, bench_dir)
        return metric(name, run), entry["unit"]

    core.load_cell = load_cell_spans
    core.cell_metrics = cell_metrics_spans
    core.read_metric = read_metric_spans
    tr.DeviceTrace = SpanTrace
