"""The harness core: one cell, one run, one result line.

Everything a cell needs is found by name:

* ``BENCHMARK.json`` at the root of the checkout: which end-to-end and
  per-layer metrics the cell reports (an entry without ``workloads``
  belongs to every cell);
* ``portbench/workloads/<cell>.json``: the configuration's name, the
  traffic's name and the traffic parameters;
* ``portbench/configs/<config>.json``: the configuration as it is run;
* ``portbench/drivers/<config>.py``: ``Cell(cfg, params, seed, workdir,
  device)``, the set-up; ``Cell.window(seconds, phases)``, the timed
  window; ``Cell.verify()``, the comparison with the plain reference;
* ``portbench/metrics/<metric>.py``: ``UNIT`` and ``read(run)``, the reader
  of one metric from the run's record (None where it finds nothing).

A later cell, mix, configuration or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
#: top-level module names that may not be loaded in a benchmark process:
#: the JAX package and JAX itself (compared whole: the port's package name
#: begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "multiverso_tpu")


class ChipMissing(RuntimeError):
    """The cell asks for more CUDA devices than the machine has."""


class ProgramMissing(RuntimeError):
    """The checkout holds no program (the port's package) to measure."""


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that belong to ``cell``."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(cell: str, bench_dir: Path = BENCH_DIR) -> tuple:
    """-> (workload entry, configuration, driver module)."""
    wl = read_json(bench_dir / "workloads" / f"{cell}.json")
    cfg = read_json(bench_dir / "configs" / f"{wl['config']}.json")
    driver = load_module(bench_dir / "drivers" / f"{wl['config']}.py",
                         f"portbench_driver_{wl['config'].replace('.', '_')}")
    return wl, cfg, driver


def read_metric(name: str, run: dict, bench_dir: Path = BENCH_DIR):
    """(value or None, unit) of metric ``name`` from the run's record."""
    mod = load_module(bench_dir / "metrics" / f"{name}.py",
                      f"portbench_metric_{name.replace('.', '_')}")
    return mod.read(run), mod.UNIT


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def process_start_wall() -> float:
    """The wall-clock second this process started (``/proc/self/stat``'s
    start time against ``/proc/uptime``; 10 ms resolution)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - start_ticks / hz)
    except (OSError, ValueError, IndexError):
        return time.time()


def device_info(torch, device: str, chips: int) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             bench_dir: Optional[Path] = None, cfg_override=None,
             params_override=None, start_wall: Optional[float] = None
             ) -> dict:
    """One run of ``cell``; returns the result object (the last line).

    ``device="cpu"`` and the overrides exist for the CPU tests, which
    drive a whole run at a tiny size; the command line always takes the
    card."""
    import torch
    from portbench.lib import trace as tr

    bench_dir = bench_dir or root / "portbench"
    start_wall = process_start_wall() if start_wall is None else start_wall
    bench = benchmark(root)
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    chips = int(entry["chips"])
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        raise ChipMissing(f"{cell} needs {chips} CUDA device(s); "
                          f"available: {torch.cuda.is_available()}, "
                          f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if not (Path(root) / "multiverso_tpu_torch" / "__init__.py").exists():
        raise ProgramMissing(f"no multiverso_tpu_torch in {root}")
    wl, cfg, driver = load_cell(cell, bench_dir)
    if cfg_override:
        cfg = dict(cfg, **cfg_override)
    params = dict(wl["params"], **(params_override or {}))
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    workdir = tempfile.mkdtemp(prefix="portbench-")
    c = None
    try:
        c = driver.Cell(cfg, params, seed, workdir, device)
        phases = tr.PhaseLog()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        prof = tr.DeviceTrace(torch) if trace and device == "cuda" else None
        if prof is not None:
            prof.start()
        setup_s = time.time() - start_wall
        rec = c.window(seconds, phases)
        if prof is not None:
            prof.stop()
        dev = device_info(torch, device, chips)
        rec["setup_s"] = setup_s
        if prof is not None:
            rec["trace"] = prof.reduce(phases, rec["window_s"])
            dev["busy_s"] = rec["trace"]["busy_s"]
            dev["window_s"] = rec["window_s"]
        if trace:
            c.per_layer(rec)
        checks = c.verify()
    finally:
        if c is not None:
            c.close()
        shutil.rmtree(workdir, ignore_errors=True)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, kind):
        value, unit = read_metric(m["name"], rec, bench_dir)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": unit}
    correct = (rec["failed"] == 0
               and all(ch["value"] <= ch["limit"] for ch in checks.values()))
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    if prof is not None:
        out["breakdown"] = rec["trace"]["breakdown"]
    if "diag" in rec:
        out["diag"] = rec["diag"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    import argparse
    start_wall = process_start_wall()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), start_wall=start_wall)
    except (ChipMissing, ProgramMissing) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    diag = out.pop("diag", None)
    if diag is not None:
        print("diag " + json.dumps(diag), file=sys.stderr)
    for name, ch in out["checks"].items():
        print(f"check {name} {ch['value']!r} limit {ch['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
