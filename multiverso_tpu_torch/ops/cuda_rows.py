"""The three row kernels: builder, ctypes bindings, wrappers, plain versions
and launch counters.

Each wrapper takes a CPU tensor to the kernel's plain PyTorch version
beside it and any other tensor to its hand-written Hopper kernel in
``multiverso_tpu_torch/csrc/rows.cu``. Nothing routes a CUDA tensor to a
plain version: a kernel that fails to build or launch raises.

=========================  =============================================
wrapper                    replaces (multiverso_tpu/ops/pallas_rows.py)
=========================  =============================================
``gather_rows``            ``pallas_gather_rows``
``scatter_set_rows``       ``pallas_scatter_set_rows``
``update_rows``            ``pallas_update_rows`` (sign +1 add, -1 sgd;
                           optional post-update rows for the Add+Get round)
=========================  =============================================

Eligibility, checked by every wrapper (anything else raises): float32
rows, int32 ids, both contiguous, on one device, ``rows`` shaped
``(len(ids), data.shape[1])``. Ids outside ``[0, data.shape[0])`` are the
caller's bug: the kernel skips the lane and sets the device's error word
(``read_error``), the plain versions raise from ``index_select``.

Launch geometry: ``launch_plan`` computes it on the host, from the batch,
the row width, the layout and the card's SM count (plain functions the
CPU tests reach), the same for all three kernels, and the C entry takes
it as an ``MvtRowPlan``. All three move each row with a group of threads
sized to the row; rows move as float4s when ``cols % 4 == 0`` and every
pointer is 16-byte aligned (the tables pad their columns for this), else
as floats.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a plain-C
shared library at first use, under ``build/torch_kernels/<source hash>/``
at the root of the checkout (``build/`` is git-ignored), so a fresh
checkout builds its kernels from its own sources. Loaded with ctypes
(route (b) of a by-hand binding: seconds to build, no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional

import torch

#: launches per wrapper, counted where the kernel is launched and nowhere
#: else (chip_smoke.py zeroes them before driving the main path); engine
#: shards launch from several threads, so counts change under _state_lock
LAUNCHES: Dict[str, int] = {"gather_rows": 0, "scatter_set_rows": 0,
                            "update_rows": 0}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "rows.cu"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
#: guards the launch counts and the creation of the error words
_state_lock = threading.Lock()
_err_words: Dict[torch.device, torch.Tensor] = {}
#: compiler output of the last build (register and spill report); None
#: when the library came from an earlier build. Written only under a
#: source's build lock
last_build_log: Optional[str] = None
_build_lock = threading.Lock()
#: one build lock per source (``build``), created under ``_build_lock``
_source_locks: Dict[str, threading.Lock] = {}


def reset_launches() -> None:
    with _state_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _state_lock:
        LAUNCHES[name] += 1


# -- launch geometry (mirrors csrc/rows.cu) ---------------------------------

THREADS = 256                   # threads per block, every kernel
BLOCKS_PER_SM = 8               # __launch_bounds__(THREADS, 8): a full SM
WARP = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class RowPlan:
    """Launch geometry of one row-kernel call. Each row moves with a group
    of ``lanes`` neighbouring threads (units of float4 when ``vec``, else
    floats; a wider row loops); block ``b``'s group ``g`` takes rows
    ``b * rows_per_block + g``, then every ``grid * rows_per_block``-th row
    after it."""
    n: int
    cols: int
    vec: bool
    lanes: int
    grid: int

    @property
    def units(self) -> int:
        """16-byte (``vec``) or 4-byte units of one row."""
        return self.cols // 4 if self.vec else self.cols

    @property
    def rows_per_block(self) -> int:
        return THREADS // self.lanes


@lru_cache(maxsize=4096)
def plan_rows(n: int, cols: int, sms: int, vec: bool) -> RowPlan:
    """The launch geometry for ``n`` ids of ``cols`` float32 columns on a
    card of ``sms`` SMs; ``vec`` when rows move as float4s (``cols % 4 ==
    0`` and every pointer 16-byte aligned). ``lanes`` is the smallest power
    of two covering a row's units, at most a warp, so narrow rows share a
    warp; the grid is one block per ``rows_per_block`` rows, capped at the
    blocks the card keeps resident, so a batch runs in one wave."""
    if n < 1 or cols < 1 or sms < 1 or (vec and cols % 4):
        raise ValueError(f"no plan for n={n} cols={cols} sms={sms} "
                         f"vec={vec}")
    units = cols // 4 if vec else cols
    lanes = min(WARP, 1 << (units - 1).bit_length())
    return RowPlan(n=n, cols=cols, vec=vec, lanes=lanes,
                   grid=min(_cdiv(n, THREADS // lanes), sms * BLOCKS_PER_SM))


class _CPlan(ctypes.Structure):
    """``MvtRowPlan`` of csrc/rows.cu."""
    _fields_ = [(name, ctypes.c_longlong) for name in
                ("lanes", "grid", "vec")]


@lru_cache(maxsize=4096)
def _c_plan(p: RowPlan) -> _CPlan:
    return _CPlan(p.lanes, p.grid, int(p.vec))


_sm_counts: Dict[int, int] = {}


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    count = _sm_counts.get(index)
    if count is None:
        count = torch.cuda.get_device_properties(index).multi_processor_count
        _sm_counts[index] = count
    return count


def _vec(cols: int, *tensors: torch.Tensor) -> bool:
    """Whether rows move as float4s: 16-byte rows and addresses."""
    return cols > 0 and cols % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def launch_plan(data: torch.Tensor, n: int, *rows: torch.Tensor,
                sms: Optional[int] = None) -> RowPlan:
    """The geometry every wrapper launches with: ``n`` ids of ``data``'s
    columns, float4 units when ``data`` and the call's other row tensors
    (``rows``: source rows, deltas, outputs) are 16-byte aligned, on
    ``sms`` SMs (default: the table's card)."""
    cols = data.shape[1]
    # a table of 0 columns moves nothing; its launch still flags bad ids
    return plan_rows(n, max(cols, 1), sms or _sms(data.device),
                     _vec(cols, data, *rows))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the row kernels build on a machine "
                       "with the CUDA toolkit")


def build(source: Path = SOURCE, lib_name: str = "libmvt_rows.so") -> Path:
    """Compile ``source`` (default ``csrc/rows.cu``) unless this source's
    library exists; returns the library path. Each source has a cache key
    of its own (its bytes and the flags), so ``csrc/ipc.cu`` (the device
    window transport's binding) builds beside the row kernels. One build
    of a source at a time in a process (a lock per source: two threads
    never both run nvcc on one source, two sources build at once, and
    ``last_build_log`` is the log of the build that made the last
    library); other processes building it at once race safely (each
    writes a private temp file, the first rename wins)."""
    global last_build_log
    with _build_lock:
        lock = _source_locks.setdefault(str(source), threading.Lock())
    with lock:
        src = source.read_bytes()
        key = hashlib.sha256(
            src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_ROOT / key / lib_name
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}")
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {source}:\n{res.stderr}")
        os.replace(tmp, out)
        last_build_log = res.stderr + res.stdout
        return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            plan = ctypes.POINTER(_CPlan)
            lib.mvt_gather_rows.argtypes = [p, p, p, ll, ll, ll, p, plan, p]
            lib.mvt_scatter_set_rows.argtypes = [p, p, p, ll, ll, ll, p, plan,
                                                 p]
            lib.mvt_update_rows.argtypes = [p, p, p, p, ll, ll, ll, i, p, plan,
                                            p]
            for fn in (lib.mvt_gather_rows, lib.mvt_scatter_set_rows,
                       lib.mvt_update_rows):
                fn.restype = i
            _lib = lib
        return _lib


def error_word(device) -> torch.Tensor:
    """The device's int32 error word the kernels set on a bad id: one per
    device, whichever thread launches first (an error written into a
    second word would be lost)."""
    device = torch.device(device)
    word = _err_words.get(device)
    if word is None:
        with _state_lock:
            word = _err_words.get(device)
            if word is None:
                word = torch.zeros(1, dtype=torch.int32, device=device)
                _err_words[device] = word
    return word


def read_error(device) -> int:
    """Synchronising read of the device's error word (tests, smoke runs)."""
    return int(error_word(device).item())


def reset_error(device) -> None:
    error_word(device).zero_()


def _check(data: torch.Tensor, ids: torch.Tensor,
           rows: Optional[torch.Tensor] = None) -> None:
    if data.dtype != torch.float32 or data.dim() != 2:
        raise TypeError(f"row kernels take a 2-D float32 table, got "
                        f"{data.dtype} {tuple(data.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"row kernels take 1-D int32 ids, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if not (data.is_contiguous() and ids.is_contiguous()):
        raise ValueError("row kernels take contiguous tensors")
    if ids.device != data.device:
        raise ValueError(f"ids on {ids.device}, table on {data.device}")
    if rows is not None:
        if rows.dtype != torch.float32 or tuple(rows.shape) != (
                ids.shape[0], data.shape[1]):
            raise ValueError(f"rows must be float32 {(ids.shape[0], data.shape[1])}"
                             f", got {rows.dtype} {tuple(rows.shape)}")
        if not rows.is_contiguous() or rows.device != data.device:
            raise ValueError("rows must be contiguous and on the table's "
                             "device")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# -- plain versions (CPU path and the on-card reference) --------------------

def gather_rows_plain(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return data.index_select(0, ids.long())


def scatter_set_rows_plain(data: torch.Tensor, ids: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    return data.index_copy_(0, ids.long(), rows)


def update_rows_plain(data: torch.Tensor, ids: torch.Tensor,
                      deltas: torch.Tensor, sign: int):
    """-> (data updated in place, the post-update rows per lane)."""
    idx = ids.long()
    old = data.index_select(0, idx)
    new = old + deltas if sign > 0 else old - deltas
    data.index_copy_(0, idx, new)
    return data, new


# -- kernel wrappers ---------------------------------------------------------

def gather_rows(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[i] = data[ids[i]] as a fresh (n, cols) tensor."""
    _check(data, ids)
    if data.device.type == "cpu":
        return gather_rows_plain(data, ids)
    n, cols = ids.shape[0], data.shape[1]
    out = torch.empty((n, cols), dtype=data.dtype, device=data.device)
    if n == 0:
        return out
    lib = _load()
    plan = _c_plan(launch_plan(data, n, out))
    with torch.cuda.device(data.device):
        rc = lib.mvt_gather_rows(
            data.data_ptr(), ids.data_ptr(), out.data_ptr(), n, cols,
            data.shape[0], error_word(data.device).data_ptr(),
            ctypes.byref(plan), _stream(data.device))
    _raise_on(rc, "gather_rows")
    _count("gather_rows")
    return out


def scatter_set_rows(data: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """data[ids[i]] = rows[i] in place; returns ``data``."""
    _check(data, ids, rows)
    if data.device.type == "cpu":
        return scatter_set_rows_plain(data, ids, rows)
    n, cols = ids.shape[0], data.shape[1]
    if n == 0:
        return data
    lib = _load()
    plan = _c_plan(launch_plan(data, n, rows))
    with torch.cuda.device(data.device):
        rc = lib.mvt_scatter_set_rows(
            data.data_ptr(), ids.data_ptr(), rows.data_ptr(), n, cols,
            data.shape[0], error_word(data.device).data_ptr(),
            ctypes.byref(plan), _stream(data.device))
    _raise_on(rc, "scatter_set_rows")
    _count("scatter_set_rows")
    return data


def update_rows(data: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor,
                sign: int, want_rows: bool = False):
    """data[ids[i]] = data[ids[i]] + sign * deltas[i] in place, one pass.
    Returns ``data``, or ``(data, new_rows)`` with ``want_rows`` (the
    post-update rows per lane, read in the same pass)."""
    if sign not in (1, -1):
        raise ValueError(f"update sign must be +1 or -1, got {sign}")
    _check(data, ids, deltas)
    if data.device.type == "cpu":
        data, new = update_rows_plain(data, ids, deltas, sign)
        return (data, new) if want_rows else data
    n, cols = ids.shape[0], data.shape[1]
    out = (torch.empty((n, cols), dtype=data.dtype, device=data.device)
           if want_rows else None)
    if n > 0:
        lib = _load()
        plan = _c_plan(launch_plan(data, n, deltas,
                                   *([out] if want_rows else [])))
        with torch.cuda.device(data.device):
            rc = lib.mvt_update_rows(
                data.data_ptr(), ids.data_ptr(), deltas.data_ptr(),
                out.data_ptr() if out is not None else None, n, cols,
                data.shape[0], sign, error_word(data.device).data_ptr(),
                ctypes.byref(plan), _stream(data.device))
        _raise_on(rc, "update_rows")
        _count("update_rows")
    return (data, out) if want_rows else data
