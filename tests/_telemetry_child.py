"""One fresh interpreter running a seeded verb script through the JAX
package and then through the port, for tests/test_torch_telemetry_*.py.

    python tests/_telemetry_child.py MODE LIBPATH

Each package's metrics registry, flight ring and Dashboard are
process-wide and live across worlds, so a parity run needs an interpreter
of its own: here both packages start from empty registries and run the
same script one world after the other. LIBPATH is the port's build of the
repo's C++ library, handed to the JAX package's loader instead of ``make``
("" = none). The last line printed is one JSON object with what the mode
compares.

Modes:

* ``parity`` — one Matrix and one KV table: blocking Adds, fire-and-forget
  Adds that combine (``-mv_write_combine`` 8), repeated Gets served by the
  Get cache (``-mv_get_staleness=2``), GetRows, a batched Get. One message
  a window (``GET_PIPELINE_WINDOW = 1``, both packages), so the windows do
  not depend on timing; a drain ping settles the engine before reading.
  Prints each package's instrument names, counter values, histogram and
  digest counts, Dashboard monitor counts and flight events per stream
  (time-bearing details blanked).
* ``trace`` — the same script under ``-trace=true``: prints each
  package's span names, read back from ``MV_DumpTrace``'s file, and, for
  the port, whether every dispatch span has its worker span's trace id.
* ``off`` — ``-telemetry=false``: prints each package's registry after the
  script (it must stay empty).
* ``scrape0`` — an empty world with ``-mv_ops_port=0`` and the watchdog
  armed: prints each package's FIRST ``/metrics`` scrape's ``mv_mem_*``
  and ``mv_alert_*`` samples.
"""

import json
import os
import sys

import numpy as np

MODE, LIBPATH = sys.argv[1], sys.argv[2]


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from multiverso_tpu import native as jnative

    def no_make():
        raise AssertionError("the JAX loader ran make -C native")

    jnative._lib = jnative._try_load(LIBPATH) if LIBPATH else None
    jnative._tried = True
    jnative._build = no_make
    import multiverso_tpu as mv
    from multiverso_tpu import tables
    from multiverso_tpu.sync.server import Server
    from multiverso_tpu.telemetry import flight, metrics, trace
    from multiverso_tpu.utils.dashboard import Dashboard
    from multiverso_tpu.zoo import Zoo
    return mv, tables, Server, flight, metrics, trace, Dashboard, Zoo, []


def _torch():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch import tables
    from multiverso_tpu_torch.sync.server import Server
    from multiverso_tpu_torch.telemetry import flight, metrics, trace
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    from multiverso_tpu_torch.zoo import Zoo
    return mv, tables, Server, flight, metrics, trace, Dashboard, Zoo, [
        "-mv_device=cpu"]


def script(mv, tables):
    """The verb sequence (seeded; integer deltas keep every sum exact)."""
    g = np.random.default_rng(7)
    mat = mv.MV_CreateTable(tables.MatrixTableOption(num_rows=32,
                                                     num_cols=4))
    kv = mv.MV_CreateTable(tables.KVTableOption())
    for i in range(3):
        ids = np.array([1, 2, 5 + i], np.int32)
        mat.AddRows(ids, g.integers(-3, 4, (3, 4)).astype(np.float32))
        for _ in range(4):                   # combined fire-and-forget
            mat.AddFireForget(np.ones((2, 4), np.float32),
                              row_ids=np.array([3, 4], np.int32))
        mat.GetRows(np.array([1, 2], np.int32))
        mat.GetRows(np.array([1, 2], np.int32))      # a cache hit
        kv.Add(np.array([1, 9 + i], np.int64),
               np.array([1.0, 2.0], np.float32))
        kv.Get(np.array([1, 9], np.int64))
    mat.MultiGet([{"row_ids": np.array([0, 3], np.int32)}])


def run(pkg, argv):
    mv, tables, Server, flight, metrics, trace, Dashboard, Zoo, base = (
        _jax() if pkg == "jax" else _torch())
    Server.GET_PIPELINE_WINDOW = 1
    mv.MV_Init(base + list(argv))
    try:
        script(mv, tables)
        Zoo.Get().DrainServer()
        snap = metrics.snapshot()
        mons = {k: v["count"] for k, v in
                Dashboard.AggregateAcrossHosts().items()}
        events = {}
        for e in flight.events():
            detail = ("" if e["kind"] in ("window.phases", "window.tables")
                      else e["detail"])
            events.setdefault(str(e["stream"]), []).append(
                [e["kind"], e["seq"], e["epoch"], detail])
        # the span tree's round trip through MV_DumpTrace's file
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            with open(mv.MV_DumpTrace(os.path.join(d, "t.json"))) as f:
                spans = [ev for ev in json.load(f)["traceEvents"]
                         if ev.get("ph") == "X"]
    finally:
        mv.MV_ShutDown()
    out = {"names": sorted(snap),
           "counters": {n: r["value"] for n, r in snap.items()
                        if r["type"] == "counter"},
           "counts": {n: r["count"] for n, r in snap.items()
                      if r["type"] in ("histogram", "digest")},
           "monitors": mons, "flight": events,
           "span_names": sorted({s["name"] for s in spans})}
    if pkg == "torch":
        by_id = {s["args"]["span_id"]: s for s in spans}
        out["dispatch_rooted"] = all(
            by_id.get(s["args"]["parent_id"], {}).get("name", "").startswith(
                "worker.") and s["args"]["trace_id"]
            == by_id[s["args"]["parent_id"]]["args"]["trace_id"]
            for s in spans if s["name"] == "actor.server.dispatch"
            and s["args"]["parent_id"])
        out["n_dispatch"] = sum(1 for s in spans
                                if s["name"] == "actor.server.dispatch")
    return out


def scrape0(pkg):
    """The first /metrics scrape of an empty world."""
    import urllib.request
    mv, _, _, _, _, _, _, _, base = _jax() if pkg == "jax" else _torch()
    if pkg == "jax":
        from multiverso_tpu.telemetry import ops
    else:
        from multiverso_tpu_torch.telemetry import ops
    mv.MV_Init(base + ["-mv_ops_port=0", "-mv_watchdog_s=60"])
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{ops.port()}/metrics", timeout=30).read()
    finally:
        mv.MV_ShutDown()
    return {"samples": {ln.split()[0]: float(ln.split()[1])
                        for ln in body.decode().splitlines()
                        if ln.startswith(("mv_mem_", "mv_alert_"))}}


def main():
    if MODE == "scrape0":
        res = {pkg: scrape0(pkg) for pkg in ("jax", "torch")}
        print(json.dumps(res, sort_keys=True))
        return
    argv = {"parity": ["-mv_get_staleness=2"],
            "trace": ["-trace=true"],
            "off": ["-telemetry=false", "-mv_get_staleness=2"]}[MODE]
    res = {pkg: run(pkg, argv) for pkg in ("jax", "torch")}
    print(json.dumps(res, sort_keys=True))


if __name__ == "__main__":
    main()
