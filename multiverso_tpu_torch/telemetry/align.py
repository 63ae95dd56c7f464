"""Shared (membership epoch, stream, exchange SEQ) stream alignment.

Two offline tools read per-rank flight dumps and line their events up
by stream position: ``telemetry/forensics.py`` (divergence hunting)
and ``telemetry/critpath.py`` (cross-rank critical-path
reconstruction). Both must apply IDENTICAL rules for

* the alignment key — the ``(mepoch, stream, seq)`` triple: the
  elastic plane re-bases the exchange SEQ to 0 at every membership
  epoch transition, and the SHARDED engine (round 12) runs one
  independent window stream per shard, each with its own SEQ counter —
  two healthy ranks legally record seq 0 once per (epoch, stream). A
  dump from an older world carries neither field and reads as epoch 0,
  stream 0 throughout;
* ragged tails — a dump whose ``(mepoch, stream)`` sub-stream merely
  ENDS earlier than its peers' (the rank died or dumped first) covers
  a shorter range and is NOT a hole at the uncovered positions; the
  rule is applied PER sub-stream, because shards drain independently
  (shard 1 legally runs far ahead of shard 0);
* evicted heads — a dump that STARTS later because the bounded ring
  aged out its oldest events (``dropped > 0`` in the header) is NOT a
  hole at the front either; a front-missing position on a rank that
  dropped NOTHING cannot be eviction and IS one.

This module is that single rule set — factored out in round 11 so the
two tools cannot drift on epoch re-basing, shard-stream keying or
ragged-tail handling.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

#: an alignment key: (membership epoch, engine shard stream, SEQ)
Pos = Tuple[int, int, int]


def expand_paths(paths: List[str]) -> List[str]:
    """CLI argument expansion shared by the forensics and critpath
    mains (round 13): a DIRECTORY argument globs its own
    ``flight_rank*.jsonl`` dumps — the exact layout ``-mv_diag_dir``
    writes — so ``python -m ...forensics <diag_dir>`` works without
    hand-listing every rank. File arguments pass through untouched; a
    directory holding no dumps raises loudly (a typo'd path must not
    silently correlate the remaining ranks)."""
    import glob
    import os
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            found = sorted(glob.glob(os.path.join(p,
                                                  "flight_rank*.jsonl")))
            if not found:
                raise FileNotFoundError(
                    f"directory {p!r} holds no flight_rank*.jsonl "
                    f"dumps (is it the -mv_diag_dir of a run that "
                    f"dumped?)")
            out.extend(found)
        else:
            out.append(p)
    return out


def load(path: str) -> dict:
    """Read one flight JSONL dump -> ``{"rank": r, "header": {...},
    "events": [...], "path": path}`` (events oldest first)."""
    header: dict = {}
    events: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("flight_header"):
                header = rec
            else:
                events.append(rec)
    return {"rank": int(header.get("rank", -1)), "header": header,
            "events": events, "path": path}


def stream(events: List[dict], kinds) -> Dict[Pos, List[dict]]:
    """``(mepoch, stream, seq) -> ordered events of ``kinds`` at that
    stream position`` (ring order preserved within a position). Events
    with a negative seq — e.g. single-process ``window.phases``
    records — are not stream positions and are skipped."""
    out: Dict[Pos, List[dict]] = {}
    for e in events:
        if e.get("kind") in kinds and e.get("seq", -1) >= 0:
            key = (int(e.get("mepoch", 0) or 0),
                   int(e.get("stream", 0) or 0), int(e["seq"]))
            out.setdefault(key, []).append(e)
    return out


def by_rank(dumps: List[dict], kinds) -> Tuple[Dict[int, Dict[Pos, List[dict]]],
                                               Dict[int, int]]:
    """Per-rank keyed streams + per-rank header drop counts from loaded
    dumps (see :func:`load`). A dump without a rank in its header gets
    a synthetic one so degenerate inputs still align."""
    streams: Dict[int, Dict[Pos, List[dict]]] = {}
    dropped: Dict[int, int] = {}
    for d in dumps:
        rank = d["rank"] if d["rank"] >= 0 else len(streams)
        streams[rank] = stream(d["events"], kinds)
        dropped[rank] = int(d["header"].get("dropped", 0))
    return streams, dropped


def all_positions(streams: Dict[int, Dict[Pos, List[dict]]]) -> List[Pos]:
    """Sorted union of every rank's stream positions."""
    if not streams:
        return []
    return sorted(set().union(*[set(s) for s in streams.values()]))


def common_positions(streams: Dict[int, Dict[Pos, List[dict]]]) -> List[Pos]:
    """Sorted positions present on EVERY rank — the covered overlap the
    ragged-tail/evicted-head rules leave usable for cross-rank math."""
    if not streams:
        return []
    covered = None
    for s in streams.values():
        covered = set(s) if covered is None else covered & set(s)
    return sorted(covered or ())


def stream_bounds(rank_stream: Dict[Pos, List[dict]]) -> Dict[tuple,
                                                              Tuple[Pos,
                                                                    Pos]]:
    """Per-``(mepoch, stream)`` (min, max) covered positions of one
    rank's keyed stream — computed in ONE pass so repeated
    :func:`is_hole` calls over a large dump stay linear (callers
    checking many positions pass this in)."""
    out: Dict[tuple, Tuple[Pos, Pos]] = {}
    for p in rank_stream:
        sub = p[:2]
        b = out.get(sub)
        out[sub] = ((p, p) if b is None
                    else (min(b[0], p), max(b[1], p)))
    return out


def is_hole(rank_stream: Dict[Pos, List[dict]], pos: Pos,
            dropped: int, bounds=None) -> bool:
    """True when ``pos`` missing from ``rank_stream`` is a HOLE — a
    genuine stream gap — rather than a legal shorter covered range.

    Evaluated WITHIN ``pos``'s own ``(mepoch, stream)`` sub-stream:
    shard streams drain independently, so shard 1 being far ahead of
    shard 0 must not turn shard 0's ragged tail into a "gap". A rank
    that never recorded the sub-stream at all covers none of it —
    shorter coverage, not a hole. Within the sub-stream, a missing
    position only counts as a hole when the rank recorded activity on
    BOTH sides of it, or ahead of it while its header says it dropped
    nothing (a front-missing position then cannot be ring eviction).
    ``bounds`` (optional): this rank's precomputed
    :func:`stream_bounds`, for callers probing many positions."""
    if not rank_stream or pos in rank_stream:
        return False
    b = (bounds if bounds is not None
         else stream_bounds(rank_stream)).get(pos[:2])
    if b is None:
        return False            # this (mepoch, stream) never recorded
    if pos >= b[1]:
        return False            # ragged tail: the sub-stream ends here
    if pos > b[0]:
        return True             # activity on both sides: a real gap
    return dropped == 0         # front-missing without eviction


def coverage_note(streams: Dict[int, Dict[Pos, List[dict]]],
                  dropped: Dict[int, int]) -> Optional[str]:
    """Human-readable summary of ragged coverage across ranks (None
    when every rank covers the same positions)."""
    allp = all_positions(streams)
    common = set(common_positions(streams))
    if not allp or len(common) == len(allp):
        return None
    parts = []
    for r in sorted(streams):
        s = streams[r]
        missing = len(allp) - len(s)
        if missing:
            why = ("ring evicted its head" if dropped.get(r, 0)
                   else "shorter covered range")
            parts.append(f"rank {r} misses {missing} position(s) "
                         f"({why})")
    return ("; ".join(parts) + f" — {len(common)}/{len(allp)} "
            f"positions covered by every rank")
