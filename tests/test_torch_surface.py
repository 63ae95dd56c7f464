"""Surface parity: every public name of the JAX package has a counterpart
in the port, or sits in ``ABSENT`` with its reason.

For every module of ``multiverso_tpu/``, both packages are imported on
the CPU. Each public top-level name the JAX module defines (a def, a
class, an assignment; for a package ``__init__``, also the names it
re-exports from the package) must resolve with ``getattr`` on the port's
counterpart module, so re-exports count; each public method of a public
JAX class must resolve with ``getattr`` on the port's class, so inherited
methods count (the method resolution order). Two files map by a new name:
``native/__init__.py`` to ``native.py`` and ``ops/pallas_rows.py`` to
``ops/cuda_rows.py`` (its kernels in ``csrc/rows.cu``). Private names
(``_x``) are out of scope; the methods of a class in ``ABSENT`` are
absent with it. ``ABSENT`` is held exact: each entry is a JAX
name the port really lacks, with a reason that cites its entry in
ROADMAP.md §3 ("Allowed absences of the surface test").
"""

import ast
import importlib
from pathlib import Path

import torch

from tests._jax_native_from_port import jax_native_from_port  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "multiverso_tpu"

#: JAX modules whose counterpart has another name
RENAMED = {"multiverso_tpu.ops.pallas_rows": "multiverso_tpu_torch.ops.cuda_rows"}

_TILING = ("TPU tiling and the Pallas kernels' own budgets; the three "
           "kernels are ported to rows_group_kernel<op> in csrc/rows.cu, "
           "launched by ops/cuda_rows.py (ROADMAP §3, allowed absences: "
           "TPU tiling)")
_MESH = ("the XLA mesh and its shardings; the port keeps one device a "
         "process (parallel/mesh.py DeviceContext) and moves rank parts "
         "over its wires (ROADMAP §3, allowed absences: XLA mesh)")
_PARTS = ("XLA placement of rank parts for a traced collective round; the "
          "port's device writes are collectives over the device wire "
          "(ROADMAP §3, the collective writes' departure; allowed "
          "absences: XLA mesh)")

#: (JAX module, name) -> why the port has no counterpart
ABSENT = {
    ("multiverso_tpu.binding.param_manager", "JaxParamManager"):
        "manages jax arrays; the port imports no jax (ROADMAP §3, "
        "allowed absences: jax)",
    ("multiverso_tpu.ops", "padded_cols"): _TILING,
    ("multiverso_tpu.ops", "use_pallas"): _TILING,
    ("multiverso_tpu.ops.rows", "LANE"): _TILING,
    ("multiverso_tpu.ops.rows", "SMEM_IDS_BYTES"): _TILING,
    ("multiverso_tpu.ops.rows", "use_pallas"): _TILING,
    ("multiverso_tpu.ops.rows", "padded_cols"): _TILING,
    ("multiverso_tpu.ops.pallas_rows", "CHUNK"): _TILING,
    ("multiverso_tpu.ops.pallas_rows", "VMEM_BUDGET"): _TILING,
    ("multiverso_tpu.ops.pallas_rows", "MIN_CHUNK"): _TILING,
    ("multiverso_tpu.ops.pallas_rows", "FUSED_BLOCKS"): _TILING,
    ("multiverso_tpu.ops.pallas_rows", "pallas_gather_rows"): _TILING,
    ("multiverso_tpu.ops.pallas_rows", "pallas_scatter_set_rows"): _TILING,
    ("multiverso_tpu.ops.pallas_rows", "pallas_update_rows"): _TILING,
    ("multiverso_tpu.parallel.allreduce", "device_allreduce"):
        "no caller in the JAX package; a device collective needs NCCL "
        "and a card per rank (ROADMAP §1 item 4d; §3, allowed absences: "
        "device collectives)",
    ("multiverso_tpu.parallel.allreduce", "jit_mean_across"):
        "no caller in the JAX package; a device collective needs NCCL "
        "and a card per rank (ROADMAP §1 item 4d; §3, allowed absences: "
        "device collectives)",
    ("multiverso_tpu.parallel.mesh", "SERVER_AXIS"): _MESH,
    ("multiverso_tpu.parallel.mesh", "local_device_count"): _MESH,
    ("multiverso_tpu.parallel.mesh", "parts_bucket"): _MESH,
    ("multiverso_tpu.parallel.mesh", "place_parts"): _MESH,
    ("multiverso_tpu.parallel.mesh", "build_mesh"): _MESH,
    ("multiverso_tpu.parallel.mesh", "MeshContext"): _MESH,
    ("multiverso_tpu.parallel.multihost", "pjrt_heartbeat_kwargs"):
        "the PJRT (jax.distributed) heartbeat settings; the port's process "
        "groups are gloo, bounded by -mv_dist_timeout_s (ROADMAP §3, "
        "allowed absences: jax)",
    ("multiverso_tpu.tables.array_table",
     "ArrayServer.device_place_parts_delta"): _PARTS,
    ("multiverso_tpu.tables.array_table",
     "ArrayServer.device_update_parts"): _PARTS,
    ("multiverso_tpu.tables.matrix_table",
     "MatrixServerTable.device_place_batch"): _PARTS,
    ("multiverso_tpu.updaters.base", "AddOption.as_jnp"):
        "jnp scalars; the port's counterpart is AddOption.as_tensors "
        "(ROADMAP §3, allowed absences: jax)",
    ("multiverso_tpu.utils.configure", "T"):
        "the type variable of the JAX registry's Generic class; the "
        "port's registry is not generic (ROADMAP §3, allowed absences: "
        "typing)",
}


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(ROOT).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _port_name(jax_module: str) -> str:
    return RENAMED.get(jax_module, "multiverso_tpu_torch"
                       + jax_module[len("multiverso_tpu"):])


def _public_surface(path: Path):
    """(top-level names, {class: [methods]}) the JAX file defines, from
    its syntax tree; a package ``__init__`` adds its re-exports."""
    tree = ast.parse(path.read_text())
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            classes[node.name] = [
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not n.name.startswith("_")]
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and (node.level or (node.module or "").startswith(
                  "multiverso_tpu"))):
            names.update(a.asname or a.name for a in node.names)
    return ({n for n in names if not n.startswith("_")},
            {c: m for c, m in classes.items() if not c.startswith("_")})


def _surface():
    """Every (JAX module, name or Class.method) with whether the port
    resolves it."""
    out = {}
    for path in sorted(JAX_ROOT.rglob("*.py")):
        jname = _module_name(path)
        names, classes = _public_surface(path)
        if path.name != "__main__.py":      # that one runs its CLI
            jmod = importlib.import_module(jname)
            assert all(hasattr(jmod, n) for n in names), jname
        pmod = importlib.import_module(_port_name(jname))
        for n in names:
            out[(jname, n)] = hasattr(pmod, n)
        for cls, methods in classes.items():
            pcls = getattr(pmod, cls, None)
            for m in methods:
                out[(jname, f"{cls}.{m}")] = (pcls is not None
                                              and hasattr(pcls, m))
    return out


def test_every_public_jax_name_resolves_in_the_port():
    surface = _surface()
    assert len(surface) > 1000
    # the methods of an absent class are absent with it
    missing = sorted((m, n) for (m, n), ok in surface.items()
                     if not ok and (m, n) not in ABSENT
                     and (m, n.split(".")[0]) not in ABSENT)
    assert not missing, "JAX names with no port counterpart:\n" + "\n".join(
        f"{m}: {n}" for m, n in missing)
    # the renamed files: the JAX loader package is the port's module, and
    # the Pallas kernels' counterpart is the CUDA source the wrappers build
    assert (ROOT / "multiverso_tpu_torch" / "native.py").is_file()
    rows_cu = ROOT / "multiverso_tpu_torch" / "csrc" / "rows.cu"
    assert "rows_group_kernel" in rows_cu.read_text()
    cuda_rows = importlib.import_module("multiverso_tpu_torch.ops.cuda_rows")
    for fn in ("gather_rows", "scatter_set_rows", "update_rows"):
        assert callable(getattr(cuda_rows, fn))


def test_the_absent_list_is_exact():
    surface = _surface()
    for key, reason in ABSENT.items():
        assert key in surface, f"{key}: not a public JAX name"
        assert not surface[key], f"{key}: the port has it now"
        assert "ROADMAP §" in reason and len(reason) > 40, key
    roadmap = (ROOT / "ROADMAP.md").read_text()
    assert "Allowed absences of the surface test" in roadmap
    for topic in ("TPU tiling", "XLA mesh", "jax", "device collectives",
                  "typing"):
        assert f"allowed absences: {topic}" in " ".join(
            ABSENT.values()), topic
