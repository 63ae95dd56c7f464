"""CPU tests of the port's benchmark (``portbench/``) at tiny sizes.

    python -m pytest portbench/tests -q

Each cell's whole run (set-up, window, comparison with the plain
reference) on the CPU with ``-mv_device=cpu``; the result line's shape;
the faults the comparison has to catch, planted in the program under a
run; the controls; the cells, configurations and metrics found as data
(a throwaway cell added by files alone in a temporary copy); and the
isolation of the benchmark from JAX and the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import control  # noqa: E402
from portbench.lib import core  # noqa: E402

BENCH = core.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]

#: tiny sizes of each configuration, the CPU's share of a cell
TINY = {
    "we_sgns_1bw": {"vocab_size": 3000, "size": 16,
                    "data_block_size": 8 * 27 * 40, "corpus_words": 300000},
    "ps_matrix_perf": {"num_rows": 4000, "num_cols": 8},
}
TINY_PARAMS = {
    "we_sgns_1bw": lambda p: {"pair_batch": max(64, p["pair_batch"] // 256)},
    "ps_matrix_perf": lambda p: {"ids_per_round": 100, "pool_rounds": 4,
                                 "sample_every": 2},
}


def config_of(cell: str) -> str:
    return next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)


def tiny_run(cell: str, seed: int = 2**31 + 7, seconds: float = 0.5,
             trace: bool = False) -> dict:
    cfg = config_of(cell)
    params = core.read_json(ROOT / "portbench" / "workloads" / f"{cell}.json")
    return core.run_cell(cell, seed, seconds, trace, device="cpu",
                         cfg_override=TINY[cfg],
                         params_override=TINY_PARAMS[cfg](params["params"]))


@pytest.fixture
def sparse_step(monkeypatch):
    """The touched-rows AdaGrad step at the CPU's tiny tables (the card's
    tables are above its 64 MB floor)."""
    from multiverso_tpu_torch.models.wordembedding import device_pairs
    monkeypatch.setattr(device_pairs, "_SPARSE_BYTES", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell, sparse_step):
    out = tiny_run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in core.cell_metrics(BENCH, cell, "end_to_end")}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_trace_run_reports_host_side_per_layer_metrics(cell, sparse_step):
    """On the CPU there is no device trace: the per-layer metrics read
    from the trace are left out, those from the program's counters and
    the host clock are there."""
    out = tiny_run(cell, trace=True)
    assert out["correct"], out["checks"]
    names = {m["name"]: m for m in core.cell_metrics(BENCH, cell,
                                                     "per_layer")}
    for name, m in out["metrics"].items():
        assert names[name]["source"] != "device_trace"
    host = {n for n, m in names.items() if m["source"] != "device_trace"}
    assert host <= set(out["metrics"])


def _break_we(monkeypatch, fault: str):
    from multiverso_tpu_torch.models.wordembedding import device_pairs as dp
    if fault == "unchanged":
        monkeypatch.setattr(dp, "sparse_adagrad_step",
                            lambda state, *a, **k: (
                                state, torch.zeros(())))
    elif fault == "half":
        real = dp.sparse_adagrad_step

        def half(state, inputs, imask, outputs, labels, omask, lr, **k):
            h = inputs.shape[0] // 2
            return real(state, inputs[:h], imask[:h], outputs[:h], labels,
                        omask[:h] * 2, lr, **k)
        monkeypatch.setattr(dp, "sparse_adagrad_step", half)
    elif fault == "token":
        real = dp.make_lanes

        def altered(ids, *a, **k):
            out = real(ids, *a, **k)
            out["inputs"] = (out["inputs"] + 1) % int(ids.max() + 1)
            return out
        monkeypatch.setattr(dp, "make_lanes", altered)


def _break_ps(monkeypatch, fault: str):
    from multiverso_tpu_torch.tables import matrix_table as mt
    cls = mt.MatrixServerTable
    if fault == "unchanged":
        monkeypatch.setattr(cls, "ProcessAdd", lambda self, *a, **k: None)
        monkeypatch.setattr(cls, "ProcessAddRun", lambda self, p: True)
    elif fault == "half":
        real = cls.ProcessAdd

        def half(self, values=None, option=None, row_ids=None, **k):
            h = len(row_ids) // 2
            return real(self, np.asarray(values)[:h], option, row_ids[:h],
                        **k)
        monkeypatch.setattr(cls, "ProcessAdd", half)
        monkeypatch.setattr(cls, "ProcessAddRun", lambda self, p: False)
    elif fault == "token":
        real = cls.ProcessGetAsync

        def altered(self, *a, **k):
            fin = real(self, *a, **k)

            def finish():
                out = np.array(fin(), copy=True)
                out.reshape(-1)[0] += 1
                return out
            return finish
        monkeypatch.setattr(cls, "ProcessGetAsync", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "token"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch,
                                          sparse_step):
    (_break_we if cell.startswith("we_") else _break_ps)(monkeypatch, fault)
    out = tiny_run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "nan"])
def test_broken_window_is_not_correct(fault, monkeypatch, sparse_step):
    """Faults of the WordEmbedding window's own train() calls, after the
    checked steps of set-up: a step that leaves the tables as they were,
    a step that writes a NaN into the input table."""
    from multiverso_tpu_torch.models.wordembedding import device_pairs as dp
    real_load, real_step = core.load_cell, dp.sparse_adagrad_step

    def nan_step(state, *a, **k):
        out = real_step(state, *a, **k)
        state.ie[0, 0] = float("nan")
        return out
    broken = {"unchanged": lambda state, *a, **k: (state, torch.zeros(())),
              "nan": nan_step}[fault]

    def load(cell, bench_dir=core.BENCH_DIR):
        wl, cfg, drv = real_load(cell, bench_dir)

        class Broken(drv.Cell):
            def window(self, seconds, phases):
                monkeypatch.setattr(dp, "sparse_adagrad_step", broken)
                return super().window(seconds, phases)
        drv.Cell = Broken
        return wl, cfg, drv
    monkeypatch.setattr(core, "load_cell", load)
    out = tiny_run("we_sgns_1bw.b65536")
    name = {"unchanged": "tables_unmoved", "nan": "tables_nonfinite"}[fault]
    assert out["checks"][name]["value"] > 0, out["checks"]
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("where", ["loss", "grad", "change"])
def test_non_finite_reading_is_not_correct(where):
    """A NaN in a later step's loss, or in the second leaf's gradient or
    change while the first stays finite, fails its limit."""
    drv = core.load_module(ROOT / "portbench" / "drivers" / "we_sgns_1bw.py",
                           "drv_nan")
    ref = {"loss": [10.0, 9.0, 8.0], "pairs": [5, 5, 5],
           "grad": {"eo": 2.0, "ie": 1.0}, "change": {"eo": 3.0, "ie": 2.0}}
    prog = json.loads(json.dumps(ref))
    if where == "loss":
        prog["loss"][1] = float("nan")
    else:
        prog[where]["ie"] = float("nan")
    limits = core.read_json(ROOT / "portbench" / "workloads"
                            / "we_sgns_1bw.b65536.json")["params"]["limits"]
    got = drv.checks(drv.readings(prog, ref), limits)
    assert got[f"{where}_gap"]["value"] > got[f"{where}_gap"]["limit"]
    assert drv.checks(drv.readings(ref, ref), limits)[f"{where}_gap"][
        "value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_lower_precision_is_not_correct(cell):
    cfg = config_of(cell)
    wl = core.read_json(ROOT / "portbench" / "workloads" / f"{cell}.json")
    params = dict(wl["params"], **TINY_PARAMS[cfg](wl["params"]))
    conf = dict(core.read_json(ROOT / "portbench" / "configs"
                               / f"{cfg}.json"), **TINY[cfg])
    res = control.run(cell, conf, params, seed=11, device="cpu")
    assert any(r["value"] > r["limit"] for r in res["control"].values()), res


def test_cells_metrics_and_configs_are_found_as_data(tmp_path):
    """A throwaway cell, traffic and metric added by files and entries
    alone (no file of the harness edited) runs and reports."""
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    src = core.read_json(ROOT / "portbench" / "workloads"
                         / "ps_matrix_perf.getall.json")
    src["traffic"] = "tiny"
    src["params"].update(ids_per_round=50, pool_rounds=2, sample_every=1)
    (copy / "portbench" / "workloads" / "ps_matrix_perf.tiny.json"
     ).write_text(json.dumps(src))
    (copy / "portbench" / "metrics" / "ps.rounds_seen.py").write_text(
        'UNIT = "rounds"\n\n\ndef read(run):\n'
        '    return run["ps"]["rounds"] if "ps" in run else None\n')
    bench["workloads"].append({"name": "ps_matrix_perf.tiny",
                               "config": "ps_matrix_perf", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "ps_getall_rounds_per_s":
            m["workloads"].append("ps_matrix_perf.tiny")
    bench["per_layer"].append({"name": "ps.rounds_seen", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine",
                               "moves": "ps_getall_rounds_per_s",
                               "workloads": ["ps_matrix_perf.tiny"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    (copy / "multiverso_tpu_torch").symlink_to(ROOT / "multiverso_tpu_torch")
    out = core.run_cell("ps_matrix_perf.tiny", 3, 0.3, True, device="cpu",
                        root=copy, cfg_override=TINY["ps_matrix_perf"])
    assert out["correct"], out["checks"]
    assert out["metrics"]["ps.rounds_seen"]["value"] == out["attempted"]
    assert "ps_getall_rounds_per_s" in tiny_metrics(copy, out)


def tiny_metrics(root, out) -> set:
    """The end-to-end metrics a --trace 0 run of the tiny cell reports."""
    out0 = core.run_cell("ps_matrix_perf.tiny", 4, 0.3, False, device="cpu",
                         root=root, cfg_override=TINY["ps_matrix_perf"])
    assert out0["correct"], out0["checks"]
    return set(out0["metrics"])


def test_every_metric_entry_has_a_reader_and_every_cell_its_files():
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            mod = core.load_module(ROOT / "portbench" / "metrics"
                                   / f"{m['name']}.py", "m")
            assert mod.UNIT == m["unit"]
    for w in BENCH["workloads"]:
        wl, cfg, driver = core.load_cell(w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert hasattr(driver, "Cell")
    for c in BENCH["configs"]:
        conf = core.read_json(ROOT / c["file"])
        assert conf["name"] == c["name"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])


ISOLATION = r"""
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from portbench.lib import core
from portbench import control
for p in sorted(Path({root!r}, "portbench").rglob("*.py")):
    if "tests" not in p.parts:
        core.load_module(p, "iso_" + str(abs(hash(p))))
bad = core.forbidden_modules()
print("FORBIDDEN", bad)
port = sorted(m for m in sys.modules
              if m.split(".")[0] == "multiverso_tpu_torch")
print("PORT", port)
"""


def test_benchmark_modules_load_no_jax_and_references_no_port():
    """The harness, drivers, metrics and references import neither JAX
    nor the JAX package (by whole top-level name), and the references and
    the harness's own library import nothing of the port."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = ISOLATION.format(root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "FORBIDDEN []" in res.stdout, res.stdout
    # drivers import the port lazily, inside Cell: loading every module of
    # the benchmark (references included) loads nothing of it
    assert "PORT []" in res.stdout, res.stdout


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_run_fails_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "portbench/run.py",
                          "--workload", "ps_matrix_perf.getall", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_controls_on_the_card(cell, card):
    """The controls at the tiny sizes on the card (at the cells' own sizes
    they run through ``python3 portbench/control.py``)."""
    cfg = config_of(cell)
    wl = core.read_json(ROOT / "portbench" / "workloads" / f"{cell}.json")
    params = dict(wl["params"], **TINY_PARAMS[cfg](wl["params"]))
    conf = dict(core.read_json(ROOT / "portbench" / "configs"
                               / f"{cfg}.json"), **TINY[cfg])
    res = control.run(cell, conf, params, seed=5, device=card)
    assert any(r["value"] > r["limit"] for r in res["control"].values()), res
