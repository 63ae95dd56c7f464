"""The device trace of a window and its reduction to numbers.

``DeviceTrace`` runs ``torch.profiler`` with the CUDA activity alone over
the window (the host ops are not recorded: at a hundred launches a batch
their records would slow the window and take minutes to read back), then
reduces the kernel, copy and memset records:

* ``busy_s``: the length of the UNION of the device intervals (the port
  launches from several threads and streams, so durations may overlap and
  their sum may exceed the busy time);
* per class: kernels, H2D, D2H and other copies, memsets, as time sums
  and counts;
* ``breakdown``: the ten device operations that took most time, and the
  idle gaps between device intervals summed by what the host was doing:
  the benchmark's own phase (``PhaseLog``, e.g. ``ps.GetRows``) joined
  with the CUDA runtime call in flight, where the trace holds one.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import numpy as np


class PhaseLog:
    """Host phases of the window, recorded by the benchmark's own code
    around its calls into the program: (name, start, end) in perf_counter
    seconds, from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans = []
        # perf_counter -> wall clock (the profiler's clock)
        self.wall_minus_perf_ns = time.time_ns() - time.perf_counter_ns()

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.spans.append((name, t0, t1))


def _kind(name: str) -> str:
    """A device record's class by its CUPTI name ("Memcpy HtoD (Pageable
    -> Device)", "Memset (Device)", else a kernel)."""
    n = name.lower()
    if n.startswith("memcpy"):
        if "htod" in n:
            return "h2d"
        if "dtoh" in n:
            return "d2h"
        return "copy"
    if n.startswith("memset"):
        return "memset"
    return "kernel"


def union_length(starts: np.ndarray, ends: np.ndarray) -> tuple:
    """(total length of the union of [start, end) intervals, merged
    interval starts, merged interval ends)."""
    if len(starts) == 0:
        return 0.0, starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.nonzero(new)[0]
    m_start = s[idx]
    m_end = np.append(reach[idx[1:] - 1], reach[-1])
    return float((m_end - m_start).sum()), m_start, m_end


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def _records(self):
        """(device records, CUDA runtime records) as numpy columns; times
        in wall-clock ns."""
        from torch.autograd import DeviceType
        dev = defaultdict(list)
        rt = defaultdict(list)
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                dev["name"].append(name)
                dev["kind"].append(_kind(name))
                dev["t0"].append(t0)
                dev["t1"].append(t1)
            elif name.startswith("cuda"):
                rt["name"].append(name)
                rt["t0"].append(t0)
                rt["t1"].append(t1)
        return dev, rt

    def reduce(self, phases: PhaseLog, window_s: float) -> dict:
        dev, rt = self._records()
        t0 = np.asarray(dev["t0"], np.int64)
        t1 = np.asarray(dev["t1"], np.int64)
        kinds = np.asarray(dev["kind"], object)
        busy_ns, m0, m1 = union_length(t0, t1)
        out = {"busy_s": busy_ns / 1e9}
        for k in ("kernel", "h2d", "d2h", "copy", "memset"):
            sel = kinds == k
            out[f"{k}_n"] = int(sel.sum())
            out[f"{k}_s"] = float((t1[sel] - t0[sel]).sum()) / 1e9
        names = defaultdict(float)
        for n, a, b in zip(dev["name"], dev["t0"], dev["t1"]):
            names[n] += (b - a) / 1e9
        top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": self._idle_by_host(m0, m1, phases, rt)}
        return out

    @staticmethod
    def _idle_by_host(m0, m1, phases: PhaseLog, rt) -> list:
        """The gaps between merged device intervals (inside the window's
        phases), summed by the host phase and runtime call at each gap's
        midpoint."""
        if len(m0) < 2 or not phases.spans:
            return []
        off = phases.wall_minus_perf_ns
        spans = sorted((int(a * 1e9) + off, int(b * 1e9) + off, n)
                       for n, a, b in phases.spans)
        p0 = np.array([s[0] for s in spans], np.int64)
        p1 = np.array([s[1] for s in spans], np.int64)
        pn = [s[2] for s in spans]
        r0 = np.asarray(rt["t0"], np.int64)
        r1 = np.asarray(rt["t1"], np.int64)
        rorder = np.argsort(r0) if len(r0) else r0
        r0, r1 = r0[rorder], r1[rorder]
        rn = [rt["name"][i] for i in rorder]
        g0, g1 = m1[:-1], m0[1:]
        mids = (g0 + g1) // 2
        keep = (mids >= p0.min()) & (mids <= p1.max())
        g0, g1, mids = g0[keep], g1[keep], mids[keep]
        # phase spans overlap across worker threads: the spans covering a
        # midpoint are among the last few that started before it
        last = np.searchsorted(p0, mids, side="right") - 1
        cover = []
        for back in range(8):
            i = last - back
            ok = (i >= 0) & (p1[np.maximum(i, 0)] >= mids)
            cover.append(np.where(ok, i, -1))
        j = np.searchsorted(r0, mids, side="right") - 1
        j_ok = (j >= 0) & (r1[np.maximum(j, 0)] >= mids) if len(r0) \
            else np.zeros(len(mids), bool)
        idle = defaultdict(float)
        secs = (g1 - g0) / 1e9
        for k in range(len(mids)):
            names = sorted({pn[c[k]] for c in cover if c[k] >= 0})
            host = "+".join(names) or "harness"
            if j_ok[k]:
                host += ":" + rn[j[k]]
            idle[host] += float(secs[k])
        return [[n, s] for n, s in
                sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
