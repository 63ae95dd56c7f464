"""The port's flight dumps across two processes, read by both packages'
offline tools.

(1) mode ``telemetry`` of ``tests/_mh_child.py`` (fire-and-forget bursts
    on four tables, then ``MV_Barrier`` and the collective
    ``MV_MetricsSnapshot``) with ``-mv_diag_dir``: each rank leaves
    ``flight_rank<R>.jsonl``, ``telemetry_rank<R>.json`` and
    ``trace_rank<R>.json``; the merged counters are the two ranks' sum and
    agree on both ranks; the port's dumps go through the port's AND the JAX
    package's ``forensics.correlate`` (no divergence, the same report) and
    ``critpath.correlate`` (the same windows, binding ranks and phases; no
    degraded verdict), and the port's CLIs read the directory; the JAX
    package's own two-rank dumps read the same way through the port's
    tools;
(2) the forensics cases of the JAX package's tests/test_opsplane.py on
    hand-written dumps (a diverging verb, a barrier against a verb, agreeing
    streams, a shorter dump, a hole, an evicted head, a front gap without
    drops): the port's report equals the JAX package's in every case, so a
    dump with a hole is a divergence in both.
"""

import glob
import json

import numpy as np
import pytest

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401
from tests._mh_worlds import run_world


def _reports(paths):
    from multiverso_tpu.telemetry import critpath as jcritpath
    from multiverso_tpu.telemetry import forensics as jforensics
    from multiverso_tpu_torch.telemetry import critpath, forensics
    f, jf = forensics.correlate(paths), jforensics.correlate(paths)
    c, jc = critpath.correlate(paths), jcritpath.correlate(paths)
    assert f == jf and c == jc
    return f, c


def test_two_rank_dumps_read_by_both_packages(tmp_path):
    from multiverso_tpu_torch.telemetry import critpath, forensics
    diags = {}
    for pkg in ("torch", "jax"):
        sub = tmp_path / pkg
        sub.mkdir()
        diags[pkg] = sub / "diag"
        res, _ = run_world(pkg, "telemetry", sub, f"-mv_diag_dir={diags[pkg]}",
                           timeout=240)
        if pkg == "torch":
            for r in range(2):
                for name in ("server.window.exchanges",
                             "server.window.verbs",
                             "table.matrix0.add.count"):
                    merged = float(res[r][f"merged:{name}"])
                    assert merged == sum(float(res[k][f"local:{name}"])
                                         for k in range(2)), name
                    assert merged == float(res[1 - r][f"merged:{name}"])
            assert list(res[0]["merged_names"]) == \
                list(res[1]["merged_names"])
    for pkg, diag in diags.items():
        paths = sorted(glob.glob(str(diag / "flight_rank*.jsonl")))
        assert len(paths) == 2, pkg
        f, c = _reports(paths)
        assert not f["diverged"] and f["agreed_through"] > 0, f
        assert c["degraded"] is None and c["n_windows"] > 0, c
        assert sum(c["binding_rank_hist"].values()) == c["n_windows"]
        assert set(c["binding_phase_hist"]) <= set(critpath.PHASES)
        assert {t["verb"] for t in c["tables_top"]} <= {"A", "G"}
        assert c["align_err_s"] >= 0.0
    port_dir = diags["torch"]
    for r in range(2):
        snap = json.loads((port_dir / f"telemetry_rank{r}.json").read_text())
        assert snap["server.window.exchanges"]["value"] > 0
        trace = json.loads((port_dir / f"trace_rank{r}.json").read_text())
        assert "traceEvents" in trace and "clock" in trace
    assert forensics.main([str(port_dir)]) == 0
    assert critpath.main([str(port_dir)]) == 0
    merged = json.loads(json.dumps(critpath.to_chrome_trace(
        sorted(glob.glob(str(port_dir / "flight_rank*.jsonl"))))))
    assert any(e.get("cat") == "critpath" for e in merged["traceEvents"])
    with pytest.raises(FileNotFoundError):
        forensics.main([str(tmp_path)])


def _write_dump(path, rank, events, dropped=0):
    with open(path, "w") as f:
        f.write(json.dumps({"flight_header": 1, "rank": rank, "pid": 1,
                            "recorded": len(events) + dropped,
                            "dropped": dropped}) + "\n")
        for kind, seq, detail in events:
            f.write(json.dumps({"t": 0.0, "kind": kind, "seq": seq,
                                "epoch": -1, "detail": detail}) + "\n")


def _ex(seqs, detail="A0"):
    return [("window.exchanged", i, detail) for i in seqs]


CASES = {
    "diverging verb": (_ex([0]) + [("window.exchanged", 1, "A0,G0"),
                                   ("window.exchanged", 2, "A1")],
                       _ex([0]) + [("window.exchanged", 1, "A0,G0"),
                                   ("window.exchanged", 2, "A0")], 0, 2),
    "barrier vs verb": (_ex([0]) + [("barrier", 1, "Request_StoreLoad")],
                        _ex([0, 1]), 0, 1),
    "agreeing": (_ex(range(4)), _ex(range(4)), 0, None),
    "shorter dump": (_ex(range(4)), _ex(range(2)), 0, None),
    "hole": (_ex(range(3)), _ex([0, 2]), 0, 1),
    "evicted head": (_ex(range(5)), _ex(range(2, 5)), 7, None),
    "front gap, no drops": (_ex(range(5)), _ex(range(2, 5)), 0, 0),
}


def test_forensics_cases_match_jax(tmp_path):
    from multiverso_tpu.telemetry import forensics as jforensics
    from multiverso_tpu_torch.telemetry import forensics
    for name, (ev0, ev1, dropped, seq) in CASES.items():
        p0, p1 = str(tmp_path / "r0.jsonl"), str(tmp_path / "r1.jsonl")
        _write_dump(p0, 0, ev0)
        _write_dump(p1, 1, ev1, dropped=dropped)
        rep = forensics.correlate([p0, p1])
        assert rep == jforensics.correlate([p0, p1]), name
        assert rep["diverged"] == (seq is not None), name
        assert rep["seq"] == seq, name
        assert forensics.report_text(rep) == jforensics.report_text(rep)
        assert forensics.main([p0, p1]) == (1 if seq is not None else 0)
    np.testing.assert_equal(len(CASES), 7)
