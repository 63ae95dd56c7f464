"""The port's metrics math, sketch and flags against the JAX package's.

(1) the bucket ladder (``bucket_index``/``bucket_bounds`` over values from
    0 to 1e13, exact powers of two and their neighbours included), the
    same observations through both packages' Histogram and Digest (equal
    vectors, equal p50/p90/p99 and clamped quantiles), the Digest merge
    (elementwise, and equal to one digest of the joined stream), the
    snapshot records, and ``render_prometheus``: the port's renderer and
    the JAX package's render the same snapshot to the same bytes, and each
    renders the other package's snapshot of the same instruments
    byte-equal; the single-process ``merged_snapshot`` is the local one;
(2) the SpaceSaving row sketch: the same id stream gives the same top
    keys, counts, over-count bounds and top share, under eviction too;
    the Dashboard's monitor line format is the JAX package's;
(3) every flag of the telemetry slice is registered in the port's own
    registry at the JAX package's default; a world's ``-telemetry=false``
    hands out the shared no-op instrument, and after ``MV_ShutDown`` every
    gate reads its default again; a name keeps its first kind.
"""

import numpy as np
import pytest

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401


def _observations():
    g = np.random.default_rng(11)
    vals = np.concatenate([
        g.lognormal(-7, 2, 400), g.lognormal(10, 3, 100),
        [0.0, -1.0, 2.0 ** -20, 2.0 ** -21, 1.0, 2.0, 3.0, 1e12, 1e13,
         np.nextafter(1.0, 2.0), np.nextafter(1.0, 0.0)]])
    return [float(v) for v in vals]


def test_ladder_histograms_digests_and_prometheus_match_jax():
    from multiverso_tpu.telemetry import metrics as jm
    from multiverso_tpu.telemetry import ops as jops
    from multiverso_tpu_torch.telemetry import metrics as tm
    from multiverso_tpu_torch.telemetry import ops as tops
    obs = _observations()
    assert tm.N_BUCKETS == jm.N_BUCKETS and tm._WIDTHS == jm._WIDTHS
    for v in obs:
        assert tm.bucket_index(v) == jm.bucket_index(v), v
    for i in range(tm.N_BUCKETS):
        assert tm.bucket_bounds(i) == jm.bucket_bounds(i)
    pairs = []
    for mod in (tm, jm):
        h, d = mod.Histogram("lat_s"), mod.Digest("dig_s")
        d2, d3 = mod.Digest("a"), mod.Digest("b")
        for i, v in enumerate(obs):
            h.observe(v)
            d.observe(v)
            (d2 if i % 3 else d3).observe(v)
        c, g, m = (mod.Counter("c"), mod.Gauge("g"), mod.MaxGauge("m"))
        c.inc(3)
        c.inc(0.5)
        g.set(7)
        g.dec(2)
        m.set(4)
        pairs.append((h, d, d2.merge(d3), c, g, m))
    (th, td, tmerged, tc, tg, tmx), (jh, jd, jmerged, jc, jg, jmx) = pairs
    assert th._vector() == jh._vector()
    assert td._vector() == jd._vector()
    assert tmerged._vector() == jmerged._vector() == td._vector()
    assert tm.Digest.merge_vec(td._vector(), tm.Digest.empty_vector()) \
        == td._vector()
    for q in (0.01, 0.5, 0.9, 0.99):
        assert tm.Histogram.percentile(th._vector()[2:], th.count, q) == \
            jm.Histogram.percentile(jh._vector()[2:], jh.count, q)
        assert tm.Digest.quantile(td._vector(), q) == \
            jm.Digest.quantile(jd._vector(), q)
    for t_inst, j_inst in zip((th, td, tc, tg, tmx), (jh, jd, jc, jg, jmx)):
        assert t_inst._snapshot(t_inst._vector()) == \
            j_inst._snapshot(j_inst._vector())
    # the same instruments, registered in each package's registry
    snaps = []
    for mod in (tm, jm):
        reg = mod.MetricsRegistry()
        reg.counter("server.window.verbs").inc(12)
        reg.gauge("mem.total_bytes").set(4096)
        reg.max_gauge("server.bsp.staleness").set(3)
        for v in obs:
            reg.histogram("server.window.latency_s").observe(v)
            reg.digest("digest.worker.rtt_s").observe(v)
        snaps.append(reg.snapshot())
        assert reg.merged_snapshot() == snaps[-1]
    assert snaps[0] == snaps[1]
    text = tops.render_prometheus(snaps[0])
    assert text == jops.render_prometheus(snaps[0])
    assert text == tops.render_prometheus(snaps[1])
    assert "# TYPE mv_server_window_latency_s histogram" in text
    assert "# TYPE mv_digest_worker_rtt_s summary" in text
    assert tops.prom_name("a.b-c") == jops.prom_name("a.b-c")


def test_row_sketch_and_monitor_lines_match_jax():
    from multiverso_tpu.telemetry import sketch as js
    from multiverso_tpu.utils import dashboard as jd
    from multiverso_tpu_torch.telemetry import sketch as ts
    from multiverso_tpu_torch.utils import dashboard as td
    g = np.random.default_rng(5)
    for cap in (4, 16, 256):
        a, b = ts.SpaceSaving(cap), js.SpaceSaving(cap)
        for _ in range(40):
            ids = np.minimum(g.zipf(1.3, 64), 500).astype(np.int64)
            a.update_ids(ids)
            b.update_ids(ids)
        assert a.top(8) == b.top(8)
        assert a.summary() == b.summary()
        assert a.top_share() == b.top_share() > 0
    for args in (("X", 3, 12.5), ("Y", 0, 0.0), ("Z", 7, 1.0, " (all)")):
        assert td.format_monitor_line(*args) == jd.format_monitor_line(*args)
    mon = td.Monitor("port_only_region", register=False)
    mon.Begin()
    mon.End()
    mon.Add(0.5, 2)
    assert mon.count == 3 and mon.elapse_ms >= 500.0


FLAGS = {"telemetry": True, "trace": False, "stats_interval_s": 0.0,
         "mv_flight_events": 4096, "mv_diag_dir": "", "mv_ops_port": -1,
         "mv_watchdog_s": 0.0, "mv_row_sketch": 0, "mv_phase_stamps": True}


def test_flags_registered_at_the_jax_defaults():
    import multiverso_tpu.telemetry  # noqa: F401  (registers JAX's flags)
    import multiverso_tpu.sync.server  # noqa: F401
    import multiverso_tpu_torch as mv
    from multiverso_tpu.utils.configure import GetFlag as jget
    from multiverso_tpu_torch.utils.configure import GetFlag as tget
    for name, want in FLAGS.items():
        assert tget(name) == jget(name) == want, name
        assert type(tget(name)) is type(want), name
    from multiverso_tpu_torch.telemetry import flight, metrics, trace
    mv.MV_Init(["-mv_device=cpu", "-telemetry=false", "-trace=true",
                "-mv_flight_events=0", "-mv_row_sketch=8"])
    try:
        assert not metrics.enabled() and trace.enabled()
        assert not flight.enabled()
        assert metrics.counter("x.y") is metrics.NULL
    finally:
        mv.MV_ShutDown()
    for name, want in FLAGS.items():
        assert tget(name) == want, name
    assert metrics.enabled() and not trace.enabled() and flight.enabled()
    # one name, one kind
    from multiverso_tpu_torch.utils.log import FatalError
    metrics.counter("test.kind_check")
    with pytest.raises(FatalError, match="already registered"):
        metrics.histogram("test.kind_check")
