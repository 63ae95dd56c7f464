"""Cross-rank divergence forensics over flight-recorder dumps.

A multi-process world's correctness rests on the SPMD collective
contract: every rank issues the same table-verb sequence at the same
stream positions. When that breaks, the engine's divergence CHECK (or
SEQ-mismatch CHECK) fires — loud, but the message only shows the
mismatched window, not WHERE the streams first came apart. With
``-mv_diag_dir`` set, every rank dumps its flight ring on those
failures (telemetry/flight.py); :func:`correlate` aligns the dumps by
**exchange SEQ** and reports the first diverging stream position with
each rank's verbs at it.

Alignment algorithm:

* every successful window exchange records a ``window.exchanged`` event
  stamped with the engine's exchange SEQ and a compact descriptor of
  the recording rank's verbs over the AGREED prefix (``"A0,G1"`` = Add
  table 0, Get table 1; the prefix rather than the full local pack —
  ragged drains legally pack different window lengths per rank) —
  recorded BEFORE the cross-rank descriptor CHECK, so the diverging
  window is in the ring even though the CHECK aborted it;
* barrier head-markers record a ``barrier`` event stamped with the seq
  of the NEXT exchange (barriers do not advance the SEQ counter), so a
  rank at a barrier while a peer exchanges verbs shows up as a kind
  mismatch at that seq;
* per rank, events sharing a seq keep their ring order. Ranks are
  compared seq by seq over the union: the first seq whose per-rank
  event lists differ (kind or verbs) — or that some rank never reached
  while a peer with later activity did — is the divergence point.

Events *applied* (``window.applied``) carry the window epoch instead;
they corroborate how far each rank's APPLY stage got but alignment
rides the exchange SEQ, which is the collective clock.

Elastic worlds (round 10): the engine re-bases the exchange SEQ to 0
at every MEMBERSHIP epoch transition, and every stream event carries
its membership epoch (``mepoch``). Sharded engines (round 12) run one
independent window stream per shard, each with its own SEQ counter,
stamped as ``stream``. Alignment therefore keys on the ``(mepoch,
stream, seq)`` triple (telemetry/align.py, shared with critpath), so
a legal re-base or an independent shard stream never reads as a
divergence while a real divergence *within* one stream still does.

CLI::

    python -m multiverso_tpu_torch.telemetry.forensics diag/flight_rank*.jsonl
    python -m multiverso_tpu_torch.telemetry.forensics diag/

(a directory argument globs its own ``flight_rank*.jsonl`` — the
layout ``-mv_diag_dir`` writes) prints the report and exits 1 when a
divergence was found (0 when the streams agree — useful in drills).
"""

from __future__ import annotations

from typing import List, Optional

from multiverso_tpu_torch.telemetry import align

#: event kinds that are stream positions (collective-clock events)
_STREAM_KINDS = ("window.exchanged", "barrier")

#: one flight JSONL dump -> {"rank", "header", "events", "path"} —
#: shared with telemetry/critpath.py (telemetry/align.py owns the
#: loader AND the (mepoch, seq) keying + ragged-tail rules, so the two
#: tools cannot drift on epoch re-basing or hole classification)
load = align.load


def _desc(evs: Optional[List[dict]]) -> Optional[str]:
    if not evs:
        return None
    return ";".join(f"{e['kind']}:{e.get('detail', '')}" for e in evs)


def correlate(paths: List[str]) -> dict:
    """Align the rings in ``paths`` by (membership epoch, exchange SEQ);
    return a report:

    ``{"diverged": bool, "seq": first diverging seq or None, "mepoch":
    its membership epoch (0 = boot world), "per_rank": {rank:
    verbs-at-that-position or None}, "ranks": [...],
    "agreed_through": last seq every rank agreed at (or None),
    "agreed_mepoch": that position's membership epoch, "note": str}``

    A rank whose dump merely covers a SHORTER seq range than its
    peers' does not count as diverged at the uncovered seqs: a dump
    can end earlier (the rank died or dumped first) and it can START
    later (the bounded ring evicted the oldest events — a long-running
    rank with extra serving/snapshot events ages out early exchanges
    its peers still hold). Divergence needs either differing events at
    a seq, or a HOLE: a seq missing on a rank that recorded activity
    on both sides of it — or ahead of it while its header says it
    dropped nothing (a front-missing seq then cannot be eviction).
    """
    dumps = [load(p) for p in paths]
    streams, dropped = align.by_rank(dumps, _STREAM_KINDS)
    ranks = sorted(streams)
    all_pos = align.all_positions(streams)
    # per-rank sub-stream bounds ONCE: is_hole over every missing
    # position stays linear on large multi-shard dumps
    bounds = {r: align.stream_bounds(streams[r]) for r in ranks}
    agreed: Optional[tuple] = None
    for pos in all_pos:
        mepoch, stream_id, seq = pos
        descs = {r: _desc(streams[r].get(pos)) for r in ranks}
        present = {r: d for r, d in descs.items() if d is not None}
        missing = [r for r, d in descs.items() if d is None]
        # the hole-vs-shorter-covered-range rule lives in align.is_hole
        # (shared with critpath): a dump may legally end earlier (rank
        # died / dumped first) or start later (bounded ring evicted its
        # oldest events, dropped > 0) — only a genuine gap diverges
        holes = [r for r in missing
                 if align.is_hole(streams[r], pos, dropped.get(r, 0),
                                  bounds=bounds[r])]
        vals = set(present.values())
        if len(vals) > 1 or holes:
            per_rank = {r: descs[r] for r in ranks}
            detail = ", ".join(
                f"rank {r}: {descs[r] if descs[r] is not None else '<missing>'}"
                for r in ranks)
            ep = f" (membership epoch {mepoch})" if mepoch else ""
            st = f" (engine stream {stream_id})" if stream_id else ""
            return {"diverged": True, "seq": seq, "mepoch": mepoch,
                    "stream": stream_id,
                    "ranks": ranks, "per_rank": per_rank,
                    "agreed_through": (agreed[2] if agreed else None),
                    "agreed_mepoch": (agreed[0] if agreed else None),
                    "agreed_stream": (agreed[1] if agreed else None),
                    "note": (f"first diverging exchange SEQ {seq}"
                             f"{ep}{st}: {detail}")}
        if len(present) == len(ranks):
            agreed = pos
    return {"diverged": False, "seq": None, "mepoch": None,
            "stream": None,
            "ranks": ranks, "per_rank": {},
            "agreed_through": (agreed[2] if agreed else None),
            "agreed_mepoch": (agreed[0] if agreed else None),
            "agreed_stream": (agreed[1] if agreed else None),
            "note": (f"streams agree through exchange SEQ {agreed[2]}"
                     + (f" of membership epoch {agreed[0]}"
                        if agreed[0] else "")
                     + (f" on engine stream {agreed[1]}"
                        if agreed[1] else "")
                     if agreed is not None
                     else "no common stream events")}


def report_text(report: dict) -> str:
    """Human-readable rendering of a :func:`correlate` report."""
    lines = [f"== flight forensics: ranks {report['ranks']} =="]
    if report["diverged"]:
        ep = (f" of membership epoch {report['mepoch']}"
              if report.get("mepoch") else "")
        st = (f" on engine stream {report['stream']}"
              if report.get("stream") else "")
        lines.append(f"DIVERGED at exchange SEQ {report['seq']}{ep}{st} "
                     f"(streams agreed through "
                     f"{report['agreed_through']})")
        for r in report["ranks"]:
            d = report["per_rank"].get(r)
            lines.append(f"  rank {r}: "
                         f"{d if d is not None else '<no event>'}")
    else:
        lines.append(report["note"])
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from multiverso_tpu_torch.utils.log import Log
    parser = argparse.ArgumentParser(
        prog="python -m multiverso_tpu_torch.telemetry.forensics",
        description="align per-rank flight-recorder dumps by exchange "
                    "SEQ and report the first diverging stream position")
    parser.add_argument("paths", nargs="+",
                        help="per-rank flight_rank<R>.jsonl dumps, or "
                             "a directory (e.g. the -mv_diag_dir) "
                             "whose flight_rank*.jsonl are globbed")
    args = parser.parse_args(argv)
    report = correlate(align.expand_paths(args.paths))
    Log.Info("%s", report_text(report))
    return 1 if report["diverged"] else 0


if __name__ == "__main__":      # pragma: no cover - CLI shim
    raise SystemExit(main())
