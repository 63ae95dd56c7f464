"""The port's loader for the repo's C++ runtime library (ctypes).

Counterpart of ``multiverso_tpu/native/__init__.py``: the pieces the
port's hot host paths call:

* ``parse_libsvm`` — the libsvm text parser of LogisticRegression's sparse
  reader (``models/logreg/data.py`` ``_iter_samples_native``);
* ``VocabTokenizer`` — WordEmbedding's tokenize + vocabulary lookup
  (``models/wordembedding/data.py`` ``sentences_from_file``);
* ``KvIndex`` — the KV table's int64 key -> int32 slot index
  (``tables/kv_table.py``);
* ``crc32c`` — the hardware CRC32C that seals every frame the
  multi-process window exchange moves (``parallel/seal.py``);
* ``NativeHostStore`` — the threaded float32 row store of a matrix table
  that lives on the CPU (``tables/matrix_table.py``'s host plane), with
  ``pool_stats``, the tallies of its worker pool that the watchdog's
  ``apply_pool_sat`` rule reads.

Build: the library is compiled from the repo's own sources, with the
recipe read from ``native/Makefile`` (its ``SRCS``, ``CXXFLAGS`` and the
flags its per-object rules add), at first use, into
``build/native_torch/<hash>/libmultiverso_tpu.so`` at the root of the
checkout (``build/`` is git-ignored). The hash covers the sources, the
headers, the Makefile and the compiler's ``--version``, so a change to
any of them builds anew. The build runs under a file
lock, one compiler process per source, and the library is linked under a
temporary name and moved into place with ``os.replace``, so a process
never loads a half-written file. Nothing is written under ``native/``:
the JAX package builds its own copy there with ``make``.

When no C++ compiler is present, or the build fails, ``lib()`` returns
None and every caller takes its pure-Python path (the JAX package's
contract). ``USES`` counts the calls into the library per piece, so a run
can show which of its paths went through it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
NATIVE_DIR = ROOT / "native"
BUILD_ROOT = ROOT / "build" / "native_torch"
MAKEFILE = NATIVE_DIR / "Makefile"
LIB_NAME = "libmultiverso_tpu.so"

#: calls into the library per piece (chip_smoke.py reads them per path)
USES: Dict[str, int] = {"parse_libsvm": 0, "tokenize": 0, "kv_index": 0,
                        "crc32c": 0, "host_store": 0}

_lock = threading.Lock()
_uses_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: why the last build failed (compiler output), None after a success;
#: written only under ``_build_lock``
last_build_error: Optional[str] = None
_build_lock = threading.Lock()


def reset_uses() -> None:
    with _uses_lock:
        for k in USES:
            USES[k] = 0


def _use(name: str) -> None:
    with _uses_lock:
        USES[name] += 1


def makefile_recipe() -> Tuple[List[Path], List[str], Dict[str, List[str]]]:
    """``native/Makefile``'s sources, its ``CXXFLAGS`` (include paths made
    absolute) and the flags a per-object rule adds after ``$(CXXFLAGS)``,
    by source name: the one place the recipe is written."""
    lines = MAKEFILE.read_text().replace("\\\n", " ").splitlines()
    var = {}
    extra: Dict[str, List[str]] = {}
    for i, line in enumerate(lines):
        m = re.match(r"(SRCS|CXXFLAGS)\s*[:?]?=(.*)", line)
        if m:
            var[m.group(1)] = m.group(2).split()
        m = re.match(r"src/(\w+)\.o:", line)
        if m and i + 1 < len(lines):
            rule = lines[i + 1].split()
            start = rule.index("$(CXXFLAGS)") + 1
            extra[m.group(1) + ".cc"] = rule[start: rule.index("-c")]
    srcs = [NATIVE_DIR / s for s in var["SRCS"]]
    flags = [f"-I{NATIVE_DIR / f[2:]}" if f.startswith("-I") else f
             for f in var["CXXFLAGS"]]
    return srcs, flags, extra


def _compiler_version(cxx: str) -> str:
    try:
        return subprocess.run([cxx, "--version"], capture_output=True,
                              text=True, timeout=60).stdout
    except OSError:
        return ""


def _build_hash(cxx: str) -> str:
    h = hashlib.sha256()
    srcs, _, _ = makefile_recipe()
    for path in ([MAKEFILE] + srcs
                 + sorted((NATIVE_DIR / "include" / "mvt").glob("*.h"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(cxx.encode())
    h.update(_compiler_version(cxx).encode())
    return h.hexdigest()[:16]


def lib_path(cxx: Optional[str] = None) -> Path:
    cxx = cxx or os.environ.get("CXX", "g++")
    return BUILD_ROOT / _build_hash(cxx) / LIB_NAME


def build() -> Optional[Path]:
    """Compile and link the library unless this source hash already has
    one; returns its path, or None when there is no compiler or the build
    fails (``last_build_error`` then says why). One build at a time in a
    process (``_build_lock``), so two threads never both run the compiler
    or overwrite each other's ``last_build_error``; the file lock orders
    builds across processes."""
    global last_build_error
    with _build_lock:
        cxx = os.environ.get("CXX", "g++")
        if shutil.which(cxx) is None:
            last_build_error = f"no C++ compiler ({cxx})"
            return None
        out = lib_path(cxx)
        if out.exists():
            return out
        srcs, flags, extra = makefile_recipe()
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out.parent / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():                # another process built it
                return out
            with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
                procs = []
                for src in srcs:
                    obj = os.path.join(tmp, src.stem + ".o")
                    cmd = [cxx, *flags, *extra.get(src.name, ()), "-c",
                           str(src), "-o", obj]
                    procs.append((obj, subprocess.Popen(
                        cmd, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True)))
                errors = []
                for obj, p in procs:
                    log, _ = p.communicate(timeout=600)
                    if p.returncode != 0:
                        errors.append(log)
                if errors:
                    last_build_error = "\n".join(errors)
                    return None
                tmp_lib = os.path.join(tmp, LIB_NAME)
                res = subprocess.run([cxx, "-shared", "-o", tmp_lib,
                                      *(o for o, _ in procs), "-pthread"],
                                     capture_output=True, text=True,
                                     timeout=600)
                if res.returncode != 0:
                    last_build_error = res.stdout + res.stderr
                    return None
                os.replace(tmp_lib, out)
        last_build_error = None
        return out


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is not None:
            handle = ctypes.CDLL(str(path))
            _configure_signatures(handle)
            _lib = handle
        return _lib


def loaded() -> bool:
    """Whether the library is loaded in this process (no build starts)."""
    return _lib is not None


def _configure_signatures(h: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    h.MV_CountLibsvm.restype = i64
    h.MV_CountLibsvm.argtypes = [ctypes.c_char_p, i64,
                                 ctypes.POINTER(i64), ctypes.POINTER(i64)]
    h.MV_ParseLibsvm.restype = i64
    h.MV_ParseLibsvm.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.float32),
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.float32)]
    h.MV_BuildVocabHash.restype = i64
    h.MV_BuildVocabHash.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64), i64]
    h.MV_TokenizeLinesToIds.restype = i64
    h.MV_TokenizeLinesToIds.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32, np.ctypeslib.ndpointer(np.int64), i64,
        np.ctypeslib.ndpointer(np.int32), i64]
    h.MV_TokenizeToIds.restype = i64
    h.MV_TokenizeToIds.argtypes = h.MV_TokenizeLinesToIds.argtypes
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    h.MV_KvIndexNew.restype = ctypes.c_void_p
    h.MV_KvIndexNew.argtypes = [i64]
    h.MV_KvIndexFree.argtypes = [ctypes.c_void_p]
    h.MV_KvIndexSize.restype = i64
    h.MV_KvIndexSize.argtypes = [ctypes.c_void_p]
    h.MV_KvIndexCapacity.restype = i64
    h.MV_KvIndexCapacity.argtypes = [ctypes.c_void_p]
    h.MV_KvIndexLookup.argtypes = [ctypes.c_void_p, i64p, i64, i32p]
    h.MV_KvIndexInsert.argtypes = [ctypes.c_void_p, i64p, i64, i32p]
    h.MV_KvIndexItems.argtypes = [ctypes.c_void_p, i64p, i32p]
    h.MV_KvIndexSetItems.argtypes = [ctypes.c_void_p, i64p, i32p, i64]
    h.MV_Crc32c.restype = ctypes.c_uint32
    h.MV_Crc32c.argtypes = [ctypes.c_void_p, i64, ctypes.c_uint32]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    h.MV_HostStoreNew.restype = ctypes.c_void_p
    h.MV_HostStoreNew.argtypes = [i64, i64, ctypes.c_float]
    h.MV_HostStoreFree.argtypes = [ctypes.c_void_p]
    h.MV_HostStoreLoad.argtypes = [ctypes.c_void_p, f32p]
    h.MV_HostStoreGetAll.argtypes = [ctypes.c_void_p, f32p]
    h.MV_HostStoreAddAll.argtypes = [ctypes.c_void_p, f32p]
    h.MV_HostStoreAddRows.argtypes = [ctypes.c_void_p, i32p, i64, f32p]
    h.MV_HostStoreGetRows.argtypes = [ctypes.c_void_p, i32p, i64, f32p]
    h.MV_HostStorePoolStats.argtypes = [i64p]


def crc32c_fn():
    """The raw ``MV_Crc32c(data, n, seed)`` entry point (a u32, chained
    as ``zlib.crc32`` chains), or None without the library: a caller on a
    hot loop pays the lookup once."""
    h = lib()
    return None if h is None else h.MV_Crc32c


_charp_fn = None


def crc32c_charp_fn():
    """``MV_Crc32c`` bound with a ``c_char_p`` first argument, the cheaper
    binding for ``bytes`` inputs, on a second handle of the same library
    (the ``c_void_p`` binding keeps taking any buffer); None without the
    library."""
    global _charp_fn
    if _charp_fn is None and lib() is not None:
        fn = ctypes.CDLL(str(lib_path())).MV_Crc32c
        fn.restype = ctypes.c_uint32
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
        _charp_fn = fn
    return _charp_fn


def crc32c(data, value: int = 0) -> int:
    """CRC32C of ``data`` (bytes or any contiguous buffer) chained from
    ``value``, the ``zlib.crc32`` call shape; the library must be loaded
    (``lib()`` not None)."""
    h = lib()
    _use("crc32c")
    arr = np.frombuffer(data, np.uint8)
    return int(h.MV_Crc32c(arr.ctypes.data, arr.size, value & 0xFFFFFFFF))


def parse_libsvm(text: bytes, weighted: bool = False
                 ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]]:
    """Parse a libsvm text chunk: -> (labels i32, weights f32, offsets
    i64[n+1], keys i64, values f32), or None when the library is
    unavailable. Malformed input raises ValueError."""
    h = lib()
    if h is None:
        return None
    _use("parse_libsvm")
    n_samples = ctypes.c_int64()
    n_entries = ctypes.c_int64()
    h.MV_CountLibsvm(text, len(text), ctypes.byref(n_samples),
                     ctypes.byref(n_entries))
    ns, ne = n_samples.value, n_entries.value
    labels = np.empty(max(ns, 1), np.int32)
    weights = np.empty(max(ns, 1), np.float32)
    offsets = np.zeros(ns + 1, np.int64)
    keys = np.empty(max(ne, 1), np.int64)
    values = np.empty(max(ne, 1), np.float32)
    parsed = h.MV_ParseLibsvm(text, len(text), int(weighted), labels, weights,
                              offsets, keys, values)
    if parsed < 0:
        raise ValueError("native libsvm parser: malformed input")
    if parsed != ns:
        return None
    return labels[:ns], weights[:ns], offsets, keys[:ne], values[:ne]


class VocabTokenizer:
    """Tokenize + vocabulary lookup in C++ (native/src/reader.cc
    ``MV_BuildVocabHash`` / ``MV_TokenizeLinesToIds``): an open-addressing
    word hash built once, then whitespace-tokenized text mapped to word
    ids, -1 for words outside the vocabulary. ``words`` must be in id
    order."""

    def __init__(self, handle: ctypes.CDLL, words):
        self._h = handle
        self._word_bytes = [w.encode("utf-8") for w in words]  # keep alive
        self._words = (ctypes.c_char_p * len(words))(*self._word_bytes)
        self._n = len(words)
        cap = 8
        while cap < 2 * self._n + 1:
            cap <<= 1
        self._table = np.empty(cap, np.int64)
        self._cap = cap
        handle.MV_BuildVocabHash(self._words, self._n, self._table, cap)

    @classmethod
    def create(cls, words) -> Optional["VocabTokenizer"]:
        handle = lib()
        if handle is None or not len(words):
            return None
        return cls(handle, list(words))

    def tokenize(self, text: bytes, max_ids: int) -> np.ndarray:
        """Word ids of ``text`` in order (at most ``max_ids``), -1 for
        words outside the vocabulary."""
        _use("tokenize")
        out = np.empty(max(max_ids, 1), np.int32)
        n = self._h.MV_TokenizeToIds(text, len(text), self._words, self._n,
                                     self._table, self._cap, out, len(out))
        return out[:n]

    def tokenize_lines(self, text: bytes) -> np.ndarray:
        """Word ids of a multi-line chunk with -2 at each newline, in one
        foreign call; -1 still marks out-of-vocab words."""
        _use("tokenize")
        out = np.empty(len(text) + 2, np.int32)
        n = self._h.MV_TokenizeLinesToIds(text, len(text), self._words,
                                          self._n, self._table, self._cap,
                                          out, len(out))
        return out[:n]


class KvIndex:
    """int64 key -> int32 slot index in C++ (native/src/kv_index.cc):
    linear probing, new keys take slots ``size, size + 1, ...`` in batch
    order (first sight). Single writer."""

    def __init__(self, handle: ctypes.CDLL, cap_hint: int):
        self._h = handle
        self._ptr = handle.MV_KvIndexNew(cap_hint)
        if not self._ptr:
            raise MemoryError("MV_KvIndexNew failed")

    @classmethod
    def create(cls, cap_hint: int = 1024) -> Optional["KvIndex"]:
        handle = lib()
        if handle is None:
            return None
        return cls(handle, cap_hint)

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._h.MV_KvIndexFree(ptr)

    def __len__(self) -> int:
        return int(self._h.MV_KvIndexSize(self._ptr))

    def capacity(self) -> int:
        """Allocated probing-table slots (the byte ledger's count)."""
        return int(self._h.MV_KvIndexCapacity(self._ptr))

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Slots of ``keys``, -1 for absent keys."""
        _use("kv_index")
        keys = np.ascontiguousarray(keys, np.int64)
        out = np.empty(len(keys), np.int32)
        self._h.MV_KvIndexLookup(self._ptr, keys, len(keys), out)
        return out

    def insert(self, keys: np.ndarray) -> np.ndarray:
        """Missing keys get the next slots in batch order; returns every
        key's slot."""
        _use("kv_index")
        keys = np.ascontiguousarray(keys, np.int64)
        out = np.empty(len(keys), np.int32)
        self._h.MV_KvIndexInsert(self._ptr, keys, len(keys), out)
        return out

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (keys i64[n], slots i32[n]) in slot order."""
        n = len(self)
        keys = np.empty(max(n, 1), np.int64)
        slots = np.empty(max(n, 1), np.int32)
        self._h.MV_KvIndexItems(self._ptr, keys, slots)
        order = np.argsort(slots[:n], kind="stable")
        return keys[:n][order], slots[:n][order]

    def set_items(self, keys: np.ndarray, slots: np.ndarray) -> None:
        """Replace the contents. Keys must be unique and ``slots`` a
        permutation of 0..n-1 (the library keeps one next-slot counter)."""
        keys = np.ascontiguousarray(keys, np.int64)
        slots = np.ascontiguousarray(slots, np.int32)
        if len(keys) != len(slots):
            raise ValueError("keys/slots length mismatch")
        if len(slots) and not np.array_equal(
                np.sort(slots), np.arange(len(slots), dtype=np.int32)):
            raise ValueError("set_items slots must be a permutation of "
                             "0..n-1")
        self._h.MV_KvIndexSetItems(self._ptr, keys, slots, len(keys))


class NativeHostStore:
    """Threaded float32 LOGICAL row store in C++ (native/src/host_store.cc):
    the apply and gather substrate of a matrix table on the CPU for the
    linear aux-free updaters (``data += sign * delta``). One writer (the
    engine thread that owns the table); the parallelism is inside one
    call, on the library's persistent worker pool (the reference's
    OpenMP-parallel server loop), and ctypes drops the interpreter lock
    for the call."""

    def __init__(self, handle: ctypes.CDLL, rows: int, cols: int,
                 sign: float):
        self._h = handle
        self.rows, self.cols = rows, cols
        self._ptr = handle.MV_HostStoreNew(rows, cols, ctypes.c_float(sign))
        if not self._ptr:
            raise MemoryError("MV_HostStoreNew failed")

    @classmethod
    def create(cls, rows: int, cols: int,
               sign: float) -> Optional["NativeHostStore"]:
        handle = lib()
        if handle is None:
            return None
        return cls(handle, rows, cols, sign)

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._h.MV_HostStoreFree(ptr)

    def _check_full(self, arr: np.ndarray) -> np.ndarray:
        # the library copies or applies rows * cols floats unchecked
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.size != self.rows * self.cols:
            raise ValueError(f"expected {self.rows}x{self.cols} floats, "
                             f"got shape {arr.shape}")
        return arr

    def load(self, full: np.ndarray) -> None:
        self._h.MV_HostStoreLoad(self._ptr, self._check_full(full))

    def get_all(self) -> np.ndarray:
        """The whole table as a fresh (rows, cols) array."""
        _use("host_store")
        out = np.empty((self.rows, self.cols), np.float32)
        self._h.MV_HostStoreGetAll(self._ptr, out)
        return out

    def add_all(self, delta: np.ndarray) -> None:
        _use("host_store")
        self._h.MV_HostStoreAddAll(self._ptr, self._check_full(delta))

    def _check_ids(self, ids: np.ndarray) -> np.ndarray:
        # the library indexes data + id * cols unchecked
        ids = np.ascontiguousarray(ids, np.int32)
        if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= self.rows):
            raise ValueError(f"row id out of range [0, {self.rows})")
        return ids

    def add_rows(self, ids: np.ndarray, deltas: np.ndarray) -> None:
        """``ids`` UNIQUE and in range (the caller pre-combines)."""
        ids = self._check_ids(ids)
        deltas = np.ascontiguousarray(deltas, np.float32)
        if deltas.size != len(ids) * self.cols:
            raise ValueError(f"expected {len(ids)}x{self.cols} delta "
                             f"floats, got shape {deltas.shape}")
        _use("host_store")
        self._h.MV_HostStoreAddRows(self._ptr, ids, len(ids), deltas)

    def get_rows(self, ids: np.ndarray) -> np.ndarray:
        ids = self._check_ids(ids)
        _use("host_store")
        out = np.empty((len(ids), self.cols), np.float32)
        self._h.MV_HostStoreGetRows(self._ptr, ids, len(ids), out)
        return out


def pool_stats() -> Optional[dict]:
    """The host store pool's dispatch tallies since the process started:
    ``parallel_runs`` (applies split over the pool), ``inline_busy``
    (applies that found the pool owned by another engine shard, or a
    one-thread pool, and ran inline: the saturation signal of the
    watchdog's ``apply_pool_sat``), ``inline_small`` (under the pool's
    byte floor) and ``pool_threads``. None without the library."""
    handle = lib()
    if handle is None:
        return None
    out = np.zeros(4, np.int64)
    handle.MV_HostStorePoolStats(out)
    return {"parallel_runs": int(out[0]), "inline_busy": int(out[1]),
            "inline_small": int(out[2]), "pool_threads": int(out[3])}
