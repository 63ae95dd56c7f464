"""The port's telemetry against the JAX package's, after one verb sequence.

Each case runs ``tests/_telemetry_child.py`` in a fresh interpreter (the
metrics registries, flight rings and Dashboards of both packages are
process-wide, so a clean comparison needs a process of its own): the JAX
package's world, then the port's on the CPU, the same seeded script on one
Matrix and one KV table (blocking Adds, combined fire-and-forget Adds,
Get-cache hits, GetRows, a batched Get), one message a window in both
engines so the windows do not depend on timing.

(1) ``parity``: the two packages register the same set of instrument
    names; every counter's value is equal; every histogram's and digest's
    COUNT is equal (never a time); the Dashboard monitors'
    counts are equal; and the flight events of each engine stream
    (kind, SEQ, epoch, and the detail where it carries no time) are equal,
    in order;
(2) ``trace`` (``-trace=true``): the same span names in both packages, and
    every engine dispatch span of the port sits in its worker span's
    trace (``worker.* -> actor.server*.dispatch``, one trace id);
    ``off`` (``-telemetry=false``): neither package registers an
    instrument;
(3) ``MV_StartProfiler`` on the CPU with ``-trace=true`` (the spans it
    bridges): a second start fails the CHECK, a stop without a start is a
    logged no-op, and the trace file it writes holds the ``mv`` spans as
    ``user_annotation`` ranges: the worker's, and (on a torch that records
    every thread) the engine's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests._mh_worlds import ROOT, _libpath

CHILD = Path(__file__).resolve().parent / "_telemetry_child.py"


def _child(mode: str) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, str(CHILD), mode, _libpath()],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_instruments_and_flight_events_match_jax():
    out = _child("parity")
    jax, port = out["jax"], out["torch"]
    assert port["names"] == jax["names"]
    assert len(port["names"]) >= 60
    assert port["counters"] == jax["counters"]
    assert port["counts"] == jax["counts"]
    assert port["monitors"] == jax["monitors"]
    assert port["flight"] == jax["flight"]
    # the script's verbs are there, not zeros compared with zeros
    c = port["counters"]
    assert c["table.matrix0.add.count"] == 15
    assert c["table.matrix0.get.count"] == 7
    assert c["table.kv1.get.count"] == 3
    assert c["worker.write_combine_hits"] == 9
    assert c["worker.get_cache_hits"] == 3
    assert c["engine.multi_verb_batches"] == 1
    assert port["counts"]["digest.worker.rtt_s"] == 1
    assert {k for k, _, _, _ in port["flight"]["0"]} >= {
        "window.applied", "window.phases", "window.tables"}


def test_span_trees_and_the_off_switch_match_jax():
    out = _child("trace")
    jax, port = out["jax"], out["torch"]
    assert port["span_names"] == jax["span_names"]
    assert {"worker.add", "worker.get", "server.window",
            "actor.server.dispatch"} <= set(port["span_names"])
    assert port["n_dispatch"] > 0 and port["dispatch_rooted"]
    off = _child("off")
    assert off["jax"]["names"] == off["torch"]["names"] == []


def test_profiler_check_and_trace_file(tmp_path):
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.tables import MatrixTableOption
    from multiverso_tpu_torch.utils.log import FatalError
    assert mv.MV_StopProfiler() is None          # no trace: a no-op
    mv.MV_Init(["-mv_device=cpu", "-trace=true"])
    try:
        t = mv.MV_CreateTable(MatrixTableOption(num_rows=16, num_cols=4))
        mv.MV_StartProfiler(str(tmp_path))
        try:
            with pytest.raises(FatalError, match="one trace at a time"):
                mv.MV_StartProfiler(str(tmp_path))
            ids = np.array([1, 5], np.int32)
            t.AddRows(ids, np.ones((2, 4), np.float32))
            np.testing.assert_array_equal(t.GetRows(ids),
                                          np.ones((2, 4), np.float32))
        finally:
            path = mv.MV_StopProfiler()
        assert mv.MV_StopProfiler() is None
    finally:
        mv.MV_ShutDown()
    events = json.loads(Path(path).read_text())["traceEvents"]
    ranges = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert {"worker.add", "worker.get"} <= ranges
    import torch
    try:
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return          # this torch records the caller's thread only
    assert {"actor.server.dispatch", "server.window"} <= ranges
