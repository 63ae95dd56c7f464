"""Package rules of the port: no JAX, nothing of ``multiverso_tpu``, and
no silent CPU fallback.

* importing ``multiverso_tpu_torch`` and every module under it in a fresh
  interpreter leaves ``jax`` and ``multiverso_tpu``/``multiverso_tpu.*``
  out of ``sys.modules``;
* no source line of the package (or ``chip_smoke.py``) imports them;
* without a CUDA device, ``MV_Init`` with no CPU request raises, so do the
  WordEmbedding and LogisticRegression apps, a kernel wrapper handed a
  non-CPU tensor raises instead of running its plain version, and ``chip_smoke.py`` exits non-zero without its ``ok`` line —
  also from a directory holding nothing of the repository.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "multiverso_tpu_torch"


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_import_graph_is_free_of_jax_and_the_jax_package():
    """A fresh interpreter importing every module of the port holds no jax
    and nothing of multiverso_tpu; no source line imports them."""
    code = r"""
import importlib, pkgutil, sys
import multiverso_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "multiverso_tpu" or m.startswith("multiverso_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 60, names
# the slices of the Array, KV and SparseMatrix tables and the LR app, of
# -device_pairs and the native library bridge, of the checkpoint and the
# compressed row wire, of the serving plane, of the binding, of the
# host wires and of the window codecs
new = {"binding", "binding.param_manager", "binding.sharedvar",
       "binding.native_bridge", "utils.async_buffer",
       "tables.array_table", "tables.kv_table", "tables.sparse_matrix_table",
       "models.logreg.configure", "models.logreg.data",
       "models.logreg.updater", "models.logreg.objective",
       "models.logreg.model", "models.logreg.device_plane",
       "models.logreg.logreg", "models.logreg.main",
       "models.wordembedding.device_pairs", "native", "checkpoint",
       "utils.quantization", "serving", "serving.store",
       "serving.snapshot", "serving.frontend", "failsafe",
       "failsafe.errors", "failsafe.deadline", "parallel.shm_wire",
       "parallel.tcp_wire", "parallel.compress"}
missing = {m for m in new if pkg.__name__ + "." + m not in names}
assert not missing, missing
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=_child_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # the forbidden-import pattern, and it spares the port's own name
    assert _FORBIDDEN.search("from multiverso_tpu.ops import rows")
    assert _FORBIDDEN.search("import multiverso_tpu")
    assert _FORBIDDEN.search("  import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from multiverso_tpu_torch.ops import rows")
    assert not _FORBIDDEN.search("import multiverso_tpu_torch as mv")
    sources = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                           ROOT / "profile_port.py"]
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if _FORBIDDEN.findall(p.read_text())]
    assert not offenders, offenders


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
    r"import\s+multiverso_tpu(\.|\s|$|,)|from\s+multiverso_tpu(\.|\s))",
    re.MULTILINE)


def _check_mv_init_raises():
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.utils.log import FatalError
    try:
        with pytest.raises(FatalError, match="no CUDA device"):
            mv.MV_Init([])
        with pytest.raises(FatalError, match="no CUDA device"):
            mv.MV_Init([], devices=[torch.device("cuda")])
        from multiverso_tpu_torch import binding
        with pytest.raises(FatalError, match="no CUDA device"):
            binding.init()
        mv.MV_Init(["-mv_device=cpu"])
        from multiverso_tpu_torch.zoo import Zoo
        assert Zoo.Get().device_ctx.device == torch.device("cpu")
    finally:
        mv.MV_ShutDown()


def _check_we_cli_raises(tmp_path):
    from multiverso_tpu_torch.models.wordembedding import distributed
    from multiverso_tpu_torch.utils.log import FatalError
    corpus = tmp_path / "c.txt"
    corpus.write_text("a b c a b\n" * 20)
    with pytest.raises(FatalError, match="no CUDA device"):
        distributed.main(["-train_file", str(corpus), "-min_count", "1",
                          "-output", str(tmp_path / "v.txt")])
    from multiverso_tpu_torch.zoo import Zoo
    assert not Zoo.Get().started


def _check_logreg_raises(tmp_path):
    """The LR app in local mode (no world) and in PS mode, without the CPU
    asked for, raises; a PS run leaves no world behind."""
    from multiverso_tpu_torch.models.logreg.configure import Configure
    from multiverso_tpu_torch.models.logreg.logreg import LogReg
    from multiverso_tpu_torch.utils.log import FatalError
    from multiverso_tpu_torch.zoo import Zoo
    data = tmp_path / "lr.data"
    data.write_text("1 0.5 -0.25\n0 -1.0 0.75\n" * 10)
    for use_ps in (False, True):
        cfg = Configure(input_size=2, output_size=1, train_file=str(data),
                        output_model_file="", output_file="",
                        objective_type="sigmoid", use_ps=use_ps)
        with pytest.raises(FatalError, match="no CUDA device"):
            LogReg(cfg).Train()
        assert not Zoo.Get().started
    cfg.platform = "cpu"
    app = LogReg(cfg)
    try:
        app.Train()
    finally:
        app.close()
    assert app.model.device == torch.device("cpu")


def _check_wrappers_raise():
    from multiverso_tpu_torch.ops import cuda_rows
    data = torch.empty((8, 4), device="meta")
    ids = torch.empty(2, dtype=torch.int32, device="meta")
    before = dict(cuda_rows.LAUNCHES)
    with pytest.raises(Exception):
        cuda_rows.gather_rows(data, ids)
    with pytest.raises(Exception):
        cuda_rows.scatter_set_rows(data, ids, torch.empty((2, 4),
                                                          device="meta"))
    with pytest.raises(Exception):
        cuda_rows.update_rows(data, ids, torch.empty((2, 4), device="meta"),
                              1)
    assert cuda_rows.LAUNCHES == before


def _check_build_needs_nvcc():
    from multiverso_tpu_torch.ops import cuda_rows
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        return          # the build is exercised on the card
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_rows.build()


def test_no_silent_cpu_fallback_without_a_card(tmp_path):
    """Without a CUDA device: MV_Init and the binding's init with no CPU
    request raise, the WordEmbedding CLI (default -platform cuda) and the LogisticRegression
    app (default platform cuda, local and PS) raise, a kernel wrapper
    handed a non-CPU tensor raises, and the kernel build needs nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the port runs on it")
    _check_mv_init_raises()
    _check_we_cli_raises(tmp_path)
    _check_logreg_raises(tmp_path)
    _check_wrappers_raise()
    _check_build_needs_nvcc()


def _check_baseline_import():
    """``chip_smoke.py --baseline`` imports another checkout's
    ``cuda_rows.py`` (here this one's) as a module of its own."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from multiverso_tpu_torch.ops import cuda_rows
    base = smoke.import_rows_module(str(ROOT))
    assert base is not cuda_rows and base.LAUNCHES is not cuda_rows.LAUNCHES
    assert base.plan_rows(10_000, 52, 132, True).grid == 625


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero without its ok line: away from the
    repository always, and in it when there is no card. Its --baseline
    loader imports another checkout's kernels module."""
    _check_baseline_import()
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    places = [tmp_path] + ([] if torch.cuda.is_available() else [ROOT])
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for cwd in places:
        res = subprocess.run([sys.executable, "chip_smoke.py"],
                             cwd=str(cwd), env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0, cwd
        assert '"ok": true' not in res.stdout, cwd
