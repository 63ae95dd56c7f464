"""Shard re-partitioning: pure ownership math and the shard-move wire.

The port's own copy of ``multiverso_tpu/elastic/rebalance.py``. Under a
view of M members every table's addressable space (matrix rows, array
elements, KV items) splits into M ceil blocks (``parallel/mesh.py``
``ceil_block_rows``), member ``members[i]`` owning block i; an epoch
transition N -> M re-partitions by the same math, and :func:`plan_moves`
names exactly the contiguous runs whose owner changed (the ``shard.moved``
flight events).

The move wire: one table's whole logical state is a **checkpoint frame**
(``checkpoint.write_table_frame``: the Store payload and the updater aux
in the logical layout, the bytes a checkpoint file would hold).
:func:`split_frame` slices the frame's value region into the M row shards
without decoding values; shard 0 also carries the header and the aux
tail. Each shard ships sealed with the window wire's trailer
(``parallel/seal.py``) and is deduped by ``(epoch, table, shard)`` at the
coordinator; :func:`join_shards` reassembles and refuses torn coverage.
The shard blobs are the JAX package's bytes for equal frames.

Rebuild: :func:`rebuild_world` re-creates every server table from its
frame and swaps it into the Zoo and engine registries. The JAX package
re-forms a device mesh over the new view's processes; the port keeps one
card per process (``_devices_for`` is this process's device), so the
rebuilt tables land on the live tables' device, the worker-side Get
caches are dropped and the old tables' device tensors are released.
"""

from __future__ import annotations

import io as _io
import pickle
from typing import Dict, List, Tuple

from multiverso_tpu_torch.parallel import seal
from multiverso_tpu_torch.parallel.mesh import ceil_block_rows
from multiverso_tpu_torch.utils.io import Stream
from multiverso_tpu_torch.utils.log import CHECK, Log

# -- pure ownership math (the member-axis Partition()) -------------------


def shard_ranges(count: int, nshards: int) -> List[Tuple[int, int]]:
    """``nshards`` contiguous ceil blocks covering ``[0, count)`` —
    the member-axis twin of the tables' device-shard law
    (mesh.ceil_block_rows): block i = [i*b, min((i+1)*b, count)), tail
    blocks possibly empty. Pure; unit-tested for exact coverage."""
    CHECK(nshards > 0, "shard_ranges: nshards must be positive")
    CHECK(count >= 0, "shard_ranges: negative count")
    block = ceil_block_rows(count, nshards) if count else 0
    out = []
    for s in range(nshards):
        lo = min(s * block, count)
        hi = min((s + 1) * block, count) if s < nshards - 1 else count
        out.append((lo, hi))
    return out


def shard_owner_map(count: int, members) -> Dict[int, Tuple[int, int]]:
    """``{member_rank: (lo, hi)}`` — the epoch's shard→owner view for
    one table's addressable space."""
    members = sorted(members)
    ranges = shard_ranges(count, len(members))
    return {m: ranges[i] for i, m in enumerate(members)}


def plan_moves(count: int, old_members, new_members) -> List[Tuple[int, int, int, int]]:
    """Contiguous ``(lo, hi, from_member, to_member)`` runs whose owner
    changes across an old-view -> new-view transition (``from_member``
    is -1 for rows previously unowned — only possible when the space
    grew, which tables never do today). Rows whose owner is unchanged
    do not appear. Pure; the flight recorder's ``shard.moved`` events
    and the unit matrix both consume this. O(|old| + |new|): ownership
    is piecewise-constant between the two views' merged block
    boundaries, so the plan walks boundary segments, never rows (this
    runs inside the transition fence — a per-row walk would add
    seconds of fenced stream per 10M-row table)."""
    old_members, new_members = sorted(old_members), sorted(new_members)
    old_ranges = shard_ranges(count, len(old_members))
    new_ranges = shard_ranges(count, len(new_members))

    def _owner_at(row, view, ranges):
        for m, (lo, hi) in zip(view, ranges):
            if lo <= row < hi:
                return m
        return -1

    cuts = sorted({0, count}
                  | {b for lo, hi in old_ranges for b in (lo, hi)}
                  | {b for lo, hi in new_ranges for b in (lo, hi)})
    moves: List[Tuple[int, int, int, int]] = []
    for lo, hi in zip(cuts, cuts[1:]):
        if lo >= hi:
            continue
        pair = (_owner_at(lo, old_members, old_ranges),
                _owner_at(lo, new_members, new_ranges))
        if pair[0] == pair[1]:
            continue
        if moves and moves[-1][1] == lo and moves[-1][2:] == pair:
            moves[-1] = (moves[-1][0], hi, *pair)   # merge adjacent run
        else:
            moves.append((lo, hi, *pair))
    return moves


def plan_routing(shard_load: Dict[int, float],
                 table_verbs: Dict[int, Dict[int, int]],
                 routing: Dict[int, int],
                 live_slots,
                 min_ratio: float = 1.5) -> Tuple[int, int, int] | None:
    """Pure routing-map decision for the policy plane's
    ``shard_imbalance`` loop: given per-ENGINE-SHARD apply-
    second deltas (``shard_load``), per-shard per-table verb-count
    deltas (``table_verbs``), the effective table->slot ``routing`` and
    the live slot set, name ONE move ``(table_id, src_slot, dst_slot)``
    — the hottest table (by verb delta, smallest id on ties) of the
    hottest slot, onto the coolest live slot — or None when no move can
    help:

    * fewer than two live slots (nothing to rebalance onto);
    * peak/mean load under ``min_ratio`` (the alert's own threshold —
      the plan must not out-trigger the watchdog);
    * the hot slot hosts fewer than two tables (one table cannot be
      split across streams; moving it just relocates the hot spot).

    Deterministic over its inputs (sorted walks, explicit tie-breaks):
    SPMD ranks feeding it near-identical local tallies converge on one
    content-derived action id, which is what lets the coordinator's
    (epoch, action id) dedup collapse N rank proposals into one staged
    install."""
    slots = sorted(live_slots)
    if len(slots) < 2:
        return None
    loads = {s: float(shard_load.get(s, 0.0)) for s in slots}
    peak = max(loads.values())
    mean = sum(loads.values()) / len(slots)
    if mean <= 0 or peak / mean < min_ratio:
        return None
    src = min(s for s in slots if loads[s] == peak)
    dst = min(s for s in slots
              if loads[s] == min(loads[s2] for s2 in slots if s2 != src)
              and s != src)
    hosted = sorted(t for t, s in routing.items() if s == src)
    if len(hosted) < 2:
        return None
    verbs = table_verbs.get(src, {})
    top = max(verbs.get(t, 0) for t in hosted)
    tid = min(t for t in hosted if verbs.get(t, 0) == top)
    return (tid, src, dst)


def shard_shippers(nshards: int, old_members) -> Dict[int, int]:
    """Which LIVE old-view member ships shard i of the new view: round-
    robin over the old members (every member holds the full logical cut
    — the assignment is pure load balancing of the move wire)."""
    old_members = sorted(old_members)
    CHECK(old_members, "shard_shippers: empty old view")
    return {s: old_members[s % len(old_members)] for s in range(nshards)}


# -- checkpoint-frame region math (split without decoding) ---------------
# A write_table_frame blob is:
#   table_id i64 | type str | store_len i64 | store bytes | aux tail
# and each family's Store payload opens with a fixed header whose
# counts locate the row-strided value region(s):
#   Matrix/Sparse:  rows i64 | cols i64 | rows*cols*itemsize raw
#   Array:          size i64 | size*itemsize raw
#   KV:             n i64    | n*8 keys | n*itemsize values


def _parse_frame(blob: bytes) -> dict:
    stream = Stream(_io.BytesIO(blob), "<shard split>")
    table_id = stream.ReadInt()
    type_name = stream.ReadStr()
    store_len = stream.ReadInt()
    pos = stream._f.tell()
    store = blob[pos:pos + store_len]
    aux_tail = blob[pos + store_len:]
    return {"table_id": table_id, "type": type_name, "store": store,
            "aux_tail": aux_tail}


def _store_regions(type_name: str, store: bytes) -> dict:
    """``{count, header, regions: [(offset, stride)]}`` for one family's
    Store payload — the minimal knowledge needed to slice rows without
    decoding values. Unknown families return count=0 (whole-frame
    transfer in shard 0: correct, just not row-granular)."""
    import struct
    i64 = struct.Struct("<q")
    if type_name in ("MatrixServerTable", "SparseMatrixServerTable"):
        rows, cols = i64.unpack_from(store, 0)[0], i64.unpack_from(store, 8)[0]
        body = len(store) - 16
        stride = body // rows if rows else 0
        CHECK(rows == 0 or stride * rows == body,
              f"matrix store region not row-strided ({body} bytes / "
              f"{rows} rows)")
        return {"count": rows, "header": store[:16],
                "regions": [(16, stride)]}
    if type_name == "ArrayServer":
        size = i64.unpack_from(store, 0)[0]
        body = len(store) - 8
        stride = body // size if size else 0
        CHECK(size == 0 or stride * size == body,
              "array store region not element-strided")
        return {"count": size, "header": store[:8],
                "regions": [(8, stride)]}
    if type_name == "KVServerTable":
        n = i64.unpack_from(store, 0)[0]
        vbody = len(store) - 8 - n * 8
        stride = vbody // n if n else 0
        CHECK(n == 0 or stride * n == vbody,
              "kv store value region not item-strided")
        return {"count": n, "header": store[:8],
                "regions": [(8, 8), (8 + n * 8, stride)]}
    return {"count": 0, "header": store, "regions": []}


def split_frame(blob: bytes, nshards: int, epoch: int = 0) -> List[bytes]:
    """One table frame -> ``nshards`` sealed shard blobs. Shard i holds
    the value-region rows of ceil block i; shard 0 additionally carries
    the frame header, Store header and aux tail. Every shard is sealed
    with the window wire's CRC32 trailer."""
    parsed = _parse_frame(blob)
    meta = _store_regions(parsed["type"], parsed["store"])
    ranges = shard_ranges(meta["count"], nshards) if meta["count"] \
        else [(0, 0)] * nshards
    out = []
    for s, (lo, hi) in enumerate(ranges):
        shard = {
            "v": 1, "epoch": int(epoch),
            "table_id": parsed["table_id"], "type": parsed["type"],
            "shard": s, "nshards": nshards,
            "lo": lo, "hi": hi, "count": meta["count"],
            "regions": [parsed["store"][off + lo * stride:
                                        off + hi * stride]
                        for off, stride in meta["regions"]],
        }
        if s == 0:
            shard["header"] = meta["header"]
            shard["aux_tail"] = parsed["aux_tail"]
            shard["frame_head"] = blob[:len(blob) - len(parsed["aux_tail"])
                                       - len(parsed["store"])]
        out.append(seal.seal_frame(pickle.dumps(
            shard, protocol=pickle.HIGHEST_PROTOCOL)))
    return out


def join_shards(shard_blobs: List[bytes]) -> bytes:
    """Sealed shard blobs (any order) -> the original table frame.
    Validates CRC per shard, then coverage: the shards' [lo, hi) ranges
    must tile [0, count) exactly — a lost or duplicated row range
    raises instead of silently mis-joining."""
    shards = [pickle.loads(seal.open_frame(b)) for b in shard_blobs]
    CHECK(shards, "join_shards: no shards")
    shards.sort(key=lambda s: s["shard"])
    head = shards[0]
    CHECK(head["shard"] == 0 and "header" in head,
          "join_shards: shard 0 (header carrier) missing")
    n = head["nshards"]
    CHECK([s["shard"] for s in shards] == list(range(n)),
          f"join_shards: shard set not exactly 0..{n - 1}: "
          f"{[s['shard'] for s in shards]}")
    count = head["count"]
    cover = 0
    for s in shards:
        CHECK(s["count"] == count and s["nshards"] == n
              and s["type"] == head["type"]
              and s["table_id"] == head["table_id"]
              and s["epoch"] == head["epoch"],
              "join_shards: mixed shard sets")
        CHECK(s["lo"] == cover,
              f"join_shards: row coverage torn at {cover} (shard "
              f"{s['shard']} starts at {s['lo']}) — rows lost or "
              f"duplicated")
        CHECK(s["hi"] >= s["lo"], "join_shards: negative shard range")
        cover = s["hi"]
    CHECK(cover == count,
          f"join_shards: rows {cover}..{count} never shipped")
    nregions = len(head["regions"])
    store = bytearray(head["header"])
    for r in range(nregions):
        for s in shards:
            CHECK(len(s["regions"]) == nregions,
                  "join_shards: region count mismatch")
            store.extend(s["regions"][r])
    return head["frame_head"] + bytes(store) + head["aux_tail"]


# -- capture + rebuild ---------------------------------------------------


def capture_cut(tables) -> List[bytes]:
    """Every table's frame at the current stream position. Runs at the
    engine fence; local, since every process holds a full replica."""
    from multiverso_tpu_torch.checkpoint import write_table_frame
    return [write_table_frame(t, tid) for tid, t in enumerate(tables)]


def _devices_for(members) -> list:
    """The devices the new view's tables live on in THIS process: one
    card per process, so every view keeps the live tables' device (the
    JAX package spans a mesh over the members' devices). A solo view
    issues no cross-process collective, which keeps a survivor's world
    sound after a peer died mid-collective."""
    from multiverso_tpu_torch.zoo import Zoo
    ctx = Zoo.Get().device_ctx
    return [ctx.device] if ctx is not None else []


def _release(table) -> None:
    """Drop a replaced table's device tensors, so the rebuilt world holds
    one copy of every table."""
    state = getattr(table, "state", None)
    if isinstance(state, dict):
        table.state = {}


def rebuild_world(zoo, frames: List[bytes], members) -> None:
    """Re-create every server table from its cut frame on this process's
    device and swap the new tables into the Zoo and engine registries in
    place. Must run with the verb stream fenced (the engine thread, or a
    quiesced world): nothing may hold the old tables mid-swap."""
    from multiverso_tpu_torch.checkpoint import read_table_frame
    CHECK(len(frames) == len(zoo.server_tables),
          f"rebuild_world: {len(frames)} frames for "
          f"{len(zoo.server_tables)} tables")
    devices = _devices_for(members)
    engine = zoo.server_engine
    for tid, frame in enumerate(frames):
        old = zoo.server_tables[tid]
        option = getattr(old, "_mv_option", None)
        CHECK(option is not None,
              f"table {tid} ({type(old).__name__}) has no creation "
              f"option recorded — cannot rebuild elastically")
        new = option.make_server(zoo)
        new._mv_option = option
        new.table_id = getattr(old, "table_id", tid)
        read_table_frame(new, frame)
        zoo.server_tables[tid] = new
        if engine is not None:
            engine.store_[tid] = new
        _release(old)
    # worker-side fast-path caches refer to pre-transition state: drop
    # them (combined adds were flushed by the fence already)
    for wt in zoo.worker_tables:
        with wt._lock:
            wt._gc_cache.clear()
    Log.Info("elastic: rebuilt %d tables on %s (members %s)", len(frames),
             devices[0] if devices else "?", sorted(members))
