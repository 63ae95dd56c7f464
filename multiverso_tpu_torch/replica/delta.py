"""Versioned delta codec: publish journals, base/delta blobs, mirrors.

The port's own copy of ``multiverso_tpu/replica/delta.py``; its blobs are
the JAX package's bytes.

**The journal.** A matrix or sparse table keeps a row dirty bitmap ORed at
every applied Add (the ``_note_add_parts`` hook every Add path fires), a
kv table a write-set of touched key arrays, an array table a whole-table
flag. ``drain()`` runs inside the publish cut (the engine thread, every
stream fenced), so the drained descriptor is exactly "what changed between
publish k-1 and publish k": every Add admitted before the cut marked the
journal before the drain, none after. That is the delta-soundness
argument, inherited from the cut.

**The blobs.** A fan-out blob is one pickled bundle sealed with the CRC32
trailer (``parallel/seal.py``, verified before any byte is parsed):

* ``base``  — every exported table's full state at one version (a first
  join, or a reader too far behind the retained dirty sets);
* ``delta`` — a table's rows or keys dirtied since ``prev_version``, with
  the values read from the already-captured immutable snapshot (the
  fan-out thread never touches live tables). Fan-out bytes scale with the
  churn, not the table.

Under ``-mv_compress`` the payload arrays ride the tagged codec envelopes
of :mod:`multiverso_tpu_torch.parallel.compress`: id and key descriptors
bitmap-RLE (lossless, when it wins), delta rows int8 a row and base rows
bf16 (lossy, only for tables in ``-mv_compress_lossy``). :func:`decode`
materializes every envelope back to a plain array. A bundle holds only
numpy arrays, ints, floats, strings, dicts and those envelopes, and an
envelope crosses under the reference package's class name
(``_WIRE_ENVELOPE``), so either package decodes the other's blob; with
the codecs off the bundle is the JAX package's pickle, byte for byte.

**Delta applicability.** A delta ``prev -> L`` applies to any reader state
at version W with ``prev <= W <= L``: rows inside the dirty union take
their version-L values, rows outside are bit-identical in every version of
that interval (the journal proves it). The mirror store CHECKs that window
and the publisher composes per-version descriptors with
:func:`merge_descriptors` for readers more than one publish behind.

**The mirrors.** :class:`MirrorStore` is the reader-side twin: numpy
logical state a table, copy-on-apply (the previous version's installed
snapshot keeps its own arrays: immutability is what makes the front-end's
lock-free reads sound), building the same ``serving.snapshot`` host
snapshots the training process serves, so the reused ``ServingFrontend``
cannot tell it runs in a reader.

Everything here is numpy on the host: no tensor, no device.
"""

from __future__ import annotations

import io
import pickle
import time
from typing import Dict, List, Optional

import numpy as np

from multiverso_tpu_torch.parallel import compress, seal
from multiverso_tpu_torch.serving.snapshot import (KVSnapshot, MatrixSnapshot,
                                                   Snapshot, VectorSnapshot)
from multiverso_tpu_torch.utils.log import CHECK

#: bundle format version (inside the sealed pickle)
FORMAT_VERSION = 1

#: the codec envelope's class as a bundle names it: the reference
#: package's module and class. A name in the stream, never imported here:
#: the port's unpickler maps it to its own class, and a reader of the
#: reference package resolves it to its own
_WIRE_ENVELOPE = ("multiverso_tpu.parallel.compress", "CompressedArray")
_OWN_ENVELOPE = (compress.CompressedArray.__module__,
                 compress.CompressedArray.__qualname__)


# -- publish journals ------------------------------------------------------


class TableJournal:
    """Dirty-set accumulator for ONE server table between publish cuts.

    Kinds: ``rows`` (matrix/sparse: a row bitmap), ``keys`` (kv: the
    write-set of touched key arrays), ``all`` (array: a whole-table flag;
    its state is one vector, row granularity buys nothing). Marks run on
    the engine or apply thread that owns the table's applies (serial a
    table); ``drain()`` runs at the fenced cut, so no mark races it."""

    __slots__ = ("kind", "_bits", "_keys", "_all")

    def __init__(self, kind: str, num_rows: int = 0):
        CHECK(kind in ("rows", "keys", "all"),
              f"unknown journal kind {kind!r}")
        self.kind = kind
        self._all = False
        self._bits = (np.zeros(int(num_rows), dtype=bool)
                      if kind == "rows" else None)
        self._keys: List[np.ndarray] = []

    def mark_rows(self, row_ids) -> None:
        """``row_ids`` touched (None = the whole table)."""
        if row_ids is None:
            self._all = True
        elif not self._all:
            self._bits[np.asarray(row_ids, np.int64).ravel()] = True

    def mark_keys(self, keys) -> None:
        # a copy: a window decode hands out views into the exchanged
        # blob, which the engine recycles after the apply
        if not self._all:
            self._keys.append(
                np.array(np.asarray(keys, np.int64).ravel(), copy=True))

    def mark_all(self) -> None:
        self._all = True
        if self.kind == "keys":
            self._keys.clear()

    def drain(self) -> dict:
        """The interval's dirty descriptor; resets the journal."""
        if self._all:
            out = {"kind": "all"}
        elif self.kind == "rows":
            out = {"kind": "rows",
                   "ids": np.nonzero(self._bits)[0].astype(np.int64)}
        elif self.kind == "keys":
            out = {"kind": "keys",
                   "keys": (np.unique(np.concatenate(self._keys))
                            if self._keys
                            else np.empty(0, np.int64))}
        else:       # an "all" journal with nothing marked
            out = {"kind": "none"}
        self._all = False
        if self._bits is not None:
            self._bits[:] = False
        self._keys = []
        return out

    def nbytes(self) -> int:
        """Ledger probe: the journal's footprint (bitmap + buffered keys)."""
        n = int(self._bits.nbytes) if self._bits is not None else 0
        return n + sum(int(k.nbytes) for k in self._keys)


def journal_for_table(table) -> TableJournal:
    """The journal kind a server table's family declares
    (``tables/base.py`` ``publish_journal_kind``): row-addressed tables
    journal rows, key-addressed tables keys, whole-vector tables a flag."""
    kind = getattr(table, "publish_journal_kind", "all")
    return TableJournal(kind, num_rows=getattr(table, "num_rows", 0))


def merge_descriptors(descs: List[Optional[dict]]) -> Optional[dict]:
    """Union of consecutive intervals' dirty descriptors (oldest first).
    ``None`` anywhere (an interval without journal coverage) or any
    ``all`` makes the union ``all``; absent or empty intervals contribute
    nothing."""
    kinds = set()
    ids: List[np.ndarray] = []
    keys: List[np.ndarray] = []
    for d in descs:
        if d is None or d["kind"] == "all":
            return {"kind": "all"}
        if d["kind"] == "none":
            continue
        kinds.add(d["kind"])
        if d["kind"] == "rows":
            ids.append(d["ids"])
        else:
            keys.append(d["keys"])
    CHECK(len(kinds) <= 1, f"mixed journal kinds in one merge: {kinds}")
    if not kinds:
        return {"kind": "none"}
    if "rows" in kinds:
        return {"kind": "rows",
                "ids": np.unique(np.concatenate(ids)).astype(np.int64)}
    return {"kind": "keys",
            "keys": np.unique(np.concatenate(keys)).astype(np.int64)}


def descriptor_nbytes(desc: Optional[dict]) -> int:
    if not desc:
        return 0
    arr = desc.get("ids") if desc.get("kind") == "rows" \
        else desc.get("keys")
    return int(arr.nbytes) if isinstance(arr, np.ndarray) else 0


# -- blob encode/decode ----------------------------------------------------


def _full_payload(ts) -> dict:
    """One table snapshot's complete state as a bundle payload."""
    if isinstance(ts, MatrixSnapshot):
        rows = ts._rows if ts._rows is not None else ts.full()
        return {"fam": "matrix", "num_rows": int(ts.num_rows),
                "num_cols": int(ts.num_cols),
                "rows": np.ascontiguousarray(rows)}
    if isinstance(ts, KVSnapshot):
        keys, vals = ts.items()
        return {"fam": "kv", "keys": np.ascontiguousarray(keys),
                "values": np.ascontiguousarray(vals)}
    if isinstance(ts, VectorSnapshot):
        return {"fam": "vector",
                "values": np.ascontiguousarray(ts._values)}
    CHECK(False, f"no fan-out payload for snapshot family "
                 f"{type(ts).__name__}")


def _delta_payload(ts, desc: dict) -> Optional[dict]:
    """One table's delta payload from its merged dirty descriptor; None =
    clean (the table is omitted and the reader carries its mirror
    forward). The values come from the IMMUTABLE captured snapshot."""
    if desc["kind"] == "none":
        return None
    if desc["kind"] == "all":
        return _full_payload(ts)
    if desc["kind"] == "rows":
        CHECK(isinstance(ts, MatrixSnapshot),
              f"rows descriptor against {type(ts).__name__}")
        ids = desc["ids"]
        if ids.size == 0:
            return None
        return {"fam": "matrix", "num_rows": int(ts.num_rows),
                "num_cols": int(ts.num_cols),
                "ids": ids.astype(np.int64),
                "rows": np.ascontiguousarray(ts.lookup_union(ids))}
    CHECK(isinstance(ts, KVSnapshot),
          f"keys descriptor against {type(ts).__name__}")
    keys = desc["keys"]
    if keys.size == 0:
        return None
    return {"fam": "kv", "keys": keys.astype(np.int64),
            "values": np.ascontiguousarray(ts.lookup_union(keys))}


class _EnvelopePickler(pickle._Pickler):
    """The pure-Python pickler with the codec envelope's class written
    under its wire name (``_WIRE_ENVELOPE``). Used only for bundles that
    hold an envelope; a bundle without one is ``pickle.dumps``' bytes."""

    def save_global(self, obj, name=None):
        if obj is compress.CompressedArray:
            self.save(_WIRE_ENVELOPE[0])
            self.save(_WIRE_ENVELOPE[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _EnvelopeUnpickler(pickle.Unpickler):
    """Resolves the envelope's wire name (and the port's own) to the
    port's class, so a bundle of either package decodes here without
    importing the other."""

    def find_class(self, module, name):
        if (module, name) in (_WIRE_ENVELOPE, _OWN_ENVELOPE):
            return compress.CompressedArray
        return super().find_class(module, name)


def _has_envelope(tables: Dict[int, dict]) -> bool:
    return any(isinstance(v, compress.CompressedArray)
               for p in tables.values() for v in p.values())


def _bundle(kind: str, snap: Snapshot, prev_version: int,
            tables: Dict[int, dict]) -> bytes:
    obj = {
        "v": FORMAT_VERSION, "kind": kind,
        "version": int(snap.version), "prev_version": int(prev_version),
        "window_epoch": int(snap.window_epoch),
        "created_wall": float(snap.created_wall),
        "sent_wall": time.time(),
        "tables": tables,
    }
    if not _has_envelope(tables):
        body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    else:
        buf = io.BytesIO()
        _EnvelopePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
        body = buf.getvalue()
    return seal.seal_frame(body)


def encode_base(snap: Snapshot) -> bytes:
    """Full-base blob: every exported table's complete state at
    ``snap.version`` (a first join, a resync). Value rows ride bf16 for
    lossy-opted tables under ``-mv_compress``."""
    return _bundle("base", snap, -1,
                   {tid: compress.pack_payload(tid, _full_payload(ts))
                    for tid, ts in snap.tables.items()})


def encode_delta(snap: Snapshot, prev_version: int,
                 descs: Dict[int, Optional[dict]]) -> bytes:
    """Delta blob ``prev_version -> snap.version``. ``descs`` maps a table
    id to its merged dirty descriptor over that interval; a table id in
    the snapshot but ABSENT from ``descs`` is one created after
    ``prev_version`` and ships whole."""
    tables: Dict[int, dict] = {}
    for tid, ts in snap.tables.items():
        desc = descs.get(tid)
        payload = (_full_payload(ts) if desc is None
                   else _delta_payload(ts, desc))
        if payload is not None:
            # -mv_compress: ids/keys -> bitmap-RLE (lossless); rows ->
            # int8 (delta) / bf16 (full) for lossy-opted tables only
            tables[tid] = compress.pack_payload(tid, payload)
    return _bundle("delta", snap, prev_version, tables)


def decode(blob: bytes) -> dict:
    """Verify the CRC trailer, unpickle, and sanity-check the bundle.
    Raises ``WireCorruption`` on a torn or flipped blob BEFORE parsing."""
    bundle = _EnvelopeUnpickler(io.BytesIO(seal.open_frame(blob))).load()
    CHECK(isinstance(bundle, dict)
          and bundle.get("v") == FORMAT_VERSION
          and bundle.get("kind") in ("base", "delta"),
          f"unrecognized fan-out bundle "
          f"(v={bundle.get('v') if isinstance(bundle, dict) else '?'})")
    # materialize every codec envelope (an unknown codec tag, from a
    # NEWER writer, fails loudly here, before the mirror sees it)
    for payload in bundle["tables"].values():
        compress.unpack_payload(payload)
    return bundle


# -- reader-side mirrors ---------------------------------------------------


def _merge_kv(keys: np.ndarray, vals: np.ndarray,
              new_keys: np.ndarray, new_vals: np.ndarray):
    """Merge (new_keys, new_vals) into a sorted (keys, vals) pair:
    existing keys updated, unseen keys inserted; returns fresh arrays
    (the previous version keeps its own)."""
    pos = np.searchsorted(keys, new_keys)
    pos_c = np.minimum(pos, max(len(keys) - 1, 0))
    exists = (keys[pos_c] == new_keys) if len(keys) else \
        np.zeros(len(new_keys), dtype=bool)
    out_keys = keys.copy()
    out_vals = vals.copy()
    if exists.any():
        out_vals[pos_c[exists]] = new_vals[exists]
    if (~exists).any():
        ins = pos[~exists]
        out_keys = np.insert(out_keys, ins, new_keys[~exists])
        out_vals = np.insert(out_vals, ins, new_vals[~exists])
    return out_keys, out_vals


class MirrorStore:
    """A reader's logical table mirrors and snapshot builder. ``apply``
    consumes one decoded bundle and returns the serving ``Snapshot`` to
    install; a previous version's arrays are never mutated (copy-on-
    apply), so the surrounding ``SnapshotStore``'s retention and pin
    contract carries over unchanged."""

    def __init__(self):
        #: tid -> {"fam", arrays...}: the NEWEST version's state
        self._tables: Dict[int, dict] = {}
        self.version = -1

    def apply(self, bundle: dict) -> Snapshot:
        kind = bundle["kind"]
        version = int(bundle["version"])
        CHECK(version > self.version,
              f"fan-out bundle v{version} is not newer than mirror "
              f"v{self.version}")
        if kind == "base":
            self._tables = {tid: self._from_payload(p)
                            for tid, p in bundle["tables"].items()}
        else:
            prev = int(bundle["prev_version"])
            CHECK(prev <= self.version,
                  f"delta v{prev}->v{version} skips past mirror "
                  f"v{self.version} — resync with a base blob")
            for tid, p in bundle["tables"].items():
                cur = self._tables.get(tid)
                self._tables[tid] = self._apply_payload(cur, p)
        self.version = version
        return self._snapshot(bundle)

    # -- payload application ------------------------------------------------

    @staticmethod
    def _from_payload(p: dict) -> dict:
        fam = p["fam"]
        if fam == "matrix":
            CHECK("ids" not in p,
                  "row-delta payload for a table the mirror has never "
                  "seen — resync with a base blob")
            return {"fam": fam,
                    "rows": np.array(p["rows"], copy=True)}
        if fam == "kv":
            keys = np.asarray(p["keys"], np.int64)
            order = np.argsort(keys, kind="stable")
            return {"fam": fam, "keys": np.array(keys[order], copy=True),
                    "values": np.array(np.asarray(p["values"])[order],
                                       copy=True)}
        CHECK(fam == "vector", f"unknown payload family {fam!r}")
        return {"fam": fam, "values": np.array(p["values"], copy=True)}

    def _apply_payload(self, cur: Optional[dict], p: dict) -> dict:
        if cur is None or "ids" not in p and p["fam"] == "matrix":
            # a new table, or a whole-table matrix payload: replace
            return self._from_payload(p)
        fam = p["fam"]
        CHECK(cur["fam"] == fam,
              f"fan-out family flip {cur['fam']} -> {fam}")
        if fam == "matrix":
            rows = cur["rows"].copy()
            rows[np.asarray(p["ids"], np.int64)] = p["rows"]
            return {"fam": fam, "rows": rows}
        if fam == "kv":
            new_keys = np.asarray(p["keys"], np.int64)
            order = np.argsort(new_keys, kind="stable")
            keys, vals = _merge_kv(cur["keys"], cur["values"],
                                   new_keys[order],
                                   np.asarray(p["values"])[order])
            return {"fam": fam, "keys": keys, "values": vals}
        return self._from_payload(p)     # vector: always the whole state

    # -- snapshot construction ----------------------------------------------

    def _snapshot(self, bundle: dict) -> Snapshot:
        tables = {}
        for tid, st in self._tables.items():
            if st["fam"] == "matrix":
                tables[tid] = MatrixSnapshot.host(st["rows"])
            elif st["fam"] == "kv":
                tables[tid] = KVSnapshot(st["keys"], st["values"])
            else:
                tables[tid] = VectorSnapshot(st["values"])
        return Snapshot(version=int(bundle["version"]),
                        created_wall=float(bundle["created_wall"]),
                        window_epoch=int(bundle["window_epoch"]),
                        tables=tables)

    def mirror_bytes(self) -> int:
        """The mirrors' exact footprint (the newest version's arrays; older
        retained versions are the SnapshotStore's ledger entry)."""
        total = 0
        for st in self._tables.values():
            for v in st.values():
                if isinstance(v, np.ndarray):
                    total += int(v.nbytes)
        return total
