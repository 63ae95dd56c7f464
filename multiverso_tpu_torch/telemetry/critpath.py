"""Cross-rank window critical-path reconstruction (round 11).

PR 6's fence-cause profiling answered WHY the pipelined engine's
exchange stage stalls (the depth cap — apply lags the exchange); this
tool answers WHERE each window's wall time actually went and WHICH
rank bound it. Every rank's engine stamps its window lifecycle phases
— form, pack, encode, exchange (with the time blocked in the
collective split from local codec work), decode, apply — as compact
``window.phases`` flight events keyed by ``(mepoch, stream, SEQ)``
(sync/server.py; ``stream`` is the engine shard, round 12 — each
shard owns an independent window stream), plus per-(table, verb)
apply seconds as ``window.tables``. :func:`correlate` merges the
per-rank dumps into ONE cross-rank timeline and names the binding
rank and binding phase per window — per stream, with a cross-stream
summary in ``report["streams"]``.

Clock alignment
===============

Ranks' wall clocks disagree (NTP skew, steps). But the windowed
engine hands us a free sync pulse per window: every rank leaves the
SAME allgather at ~the same instant, and each ``window.phases`` event
carries its exchange-done wall stamp (re-anchored through the event's
dual wall/mono stamps, telemetry/flight.py). The per-rank offset vs
the reference rank is the MEDIAN over common windows of the
exchange-done deltas — median, so a straggler-free estimate survives
occasional outliers. The residual per-window spread after removing
the offsets is the ALIGNMENT ERROR BOUND the report carries
(``align_err_s``): it is bounded by the collective's exit skew (one
gloo/ICI hop, sub-millisecond on a healthy fabric) plus the ~us stamp
latency, and every cross-rank comparison this tool makes is only
trusted to that bound.

Binding attribution
===================

The binding rank of a window is the LAST rank to enter its collective
(everyone else sat blocked in the allgather waiting for it). What
delayed its entry is read off its own rank-local monotonic timeline —
no cross-rank clock math needed for the phase verdict: between its
previous exchange-done and this exchange-enter it ran decode (prev
window), apply (any window applying in the gap — the depth-fence
culprit), form/pack/encode (this window). The largest component — or
the collective itself when the gap is negligible — is the binding
phase. Per-window verdicts aggregate into the straggler report:
binding-rank histogram, per-rank exchange-wait asymmetry, top tables
by apply seconds.

CLI::

    python -m multiverso_tpu_torch.telemetry.critpath diag/flight_rank*.jsonl
    python -m multiverso_tpu_torch.telemetry.critpath diag/
    python -m multiverso_tpu_torch.telemetry.critpath --trace merged.json ...

(a directory argument globs its own ``flight_rank*.jsonl`` — the
layout ``-mv_diag_dir`` writes).

``--trace`` writes the merged cross-rank timeline as Chrome trace
JSON (one track per rank x stage, the PR 2 writer's schema) for
Perfetto. Offline, local, never collective.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from multiverso_tpu_torch.telemetry import align

#: phase taxonomy, mirroring sync/server.py ENGINE_PHASES (binding
#: verdicts draw from these plus the synthetic "exchange" = the
#: collective itself bound the window)
PHASES = ("form", "pack", "encode", "exchange", "exchange_wait",
          "decode", "apply")

_US = 1e-6


def _parse_detail(detail: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for part in str(detail).split(";"):
        key, sep, val = part.partition("=")
        if sep:
            try:
                out[key] = float(val)
            except ValueError:
                pass
    return out


def _window_record(ev: dict) -> dict:
    """One ``window.phases`` event -> phase durations (seconds) +
    rank-local monotonic landmarks + the exchange-done wall anchor."""
    d = _parse_detail(ev.get("detail", ""))
    rec = {"verbs": int(d.get("v", 0)),
           "form": d.get("f", 0.0) * _US, "pack": d.get("p", 0.0) * _US,
           "encode": d.get("e", 0.0) * _US,
           "exchange": d.get("x", 0.0) * _US,
           "exchange_wait": d.get("xw", 0.0) * _US,
           "decode": d.get("d", 0.0) * _US,
           "apply": d.get("a", 0.0) * _US,
           "x_done_m": None, "x_done_w": None, "x_enter_m": None,
           "a_start_m": None}
    tm = ev.get("tm")
    xd = d.get("xd")
    if tm is not None and xd is not None:
        # the event's dual stamps were sampled together, so the same
        # offset re-anchors the landmark on both clocks
        x_done_m = float(tm) - xd * _US
        rec["x_done_m"] = x_done_m
        rec["x_done_w"] = float(ev.get("t", 0.0)) - xd * _US
        rec["x_enter_m"] = x_done_m - rec["exchange"]
        ax = d.get("ax")
        if ax is not None:
            rec["a_start_m"] = x_done_m + ax * _US
    return rec


def _table_totals(events: List[dict]) -> Dict[tuple, float]:
    """Sum ``window.tables`` attribution events into
    {(table_label, verb): seconds}."""
    out: Dict[tuple, float] = {}
    for ev in events:
        if ev.get("kind") != "window.tables":
            continue
        for part in str(ev.get("detail", "")).split(";"):
            name, sep, val = part.partition("=")
            if not sep or ":" not in name:
                continue
            label, _, verb = name.rpartition(":")
            try:
                secs = float(val) * _US
            except ValueError:
                continue
            out[(label, verb)] = out.get((label, verb), 0.0) + secs
    return out


def correlate(paths: List[str]) -> dict:
    """Merge per-rank flight dumps into a cross-rank window timeline;
    return the critical-path / straggler report (see module
    docstring). Degrades gracefully: a single-rank dump yields local
    phase totals with a ``degraded`` note instead of binding verdicts;
    ragged/evicted tails shrink the covered overlap (the shared
    telemetry/align.py rules) and are summarized in ``coverage``."""
    dumps = [align.load(p) for p in paths]
    streams, dropped = align.by_rank(dumps, ("window.phases",))
    ranks = sorted(streams)
    # per-rank ALL phase events (single-process records carry seq -1 —
    # not stream positions, but their durations are real local data
    # and must land in the phase totals)
    all_phase: Dict[int, List[dict]] = {}
    #: rank -> host label from the dump header (round 24 — cross-host
    #: worlds need verdicts that name WHICH BOX binds, not just which
    #: rank; pre-round-24 dumps without the field fall back to "rankN")
    hosts: Dict[int, str] = {}
    for d in dumps:
        rank = d["rank"] if d["rank"] >= 0 else len(all_phase)
        all_phase[rank] = [_window_record(e) for e in d["events"]
                           if e.get("kind") == "window.phases"]
        hosts[rank] = str(d["header"].get("host") or "") or f"rank{rank}"
    # per-rank parsed stream windows + per-rank apply intervals (mono)
    win: Dict[int, Dict[tuple, dict]] = {}
    apply_iv: Dict[int, List[tuple]] = {}
    for r in ranks:
        win[r] = {}
        apply_iv[r] = []
        for pos, evs in streams[r].items():
            rec = _window_record(evs[0])
            win[r][pos] = rec
            if rec["a_start_m"] is not None and rec["apply"] > 0:
                apply_iv[r].append((rec["a_start_m"],
                                    rec["a_start_m"] + rec["apply"]))
        apply_iv[r].sort()
    phase_totals = {r: {p: sum(rec[p] for rec in all_phase.get(r, ()))
                        for p in PHASES} for r in ranks}
    tables = {}
    for d in dumps:
        for key, secs in _table_totals(d["events"]).items():
            tables[key] = tables.get(key, 0.0) + secs
    tables_top = [{"table": label, "verb": verb,
                   "seconds": round(secs, 6)}
                  for (label, verb), secs in
                  sorted(tables.items(), key=lambda kv: -kv[1])]
    report = {"ranks": ranks,
              "hosts": {r: hosts.get(r, f"rank{r}") for r in ranks},
              "n_windows": 0, "windows": [],
              "clock_offsets_s": {r: 0.0 for r in ranks},
              "align_err_s": 0.0,
              "binding_rank_hist": {}, "binding_phase_hist": {},
              "streams": {},
              "phase_totals_s": {r: {p: round(s, 6)
                                     for p, s in phase_totals[r].items()}
                                 for r in ranks},
              "exchange_wait_excess_s": {},
              "tables_top": tables_top,
              "coverage": align.coverage_note(streams, dropped),
              "degraded": None, "accounted_pct": None, "note": ""}
    if not ranks or all(not s for s in streams.values()):
        if any(all_phase.get(r) for r in ranks):
            # stamped, but only single-process (seq -1) records: real
            # local phase data, just nothing to align across ranks
            report["degraded"] = (
                "only single-process phase records (no exchange SEQ) "
                "— cross-rank alignment needs multi-process windows; "
                "reporting local phase totals")
        else:
            report["degraded"] = (
                "no window.phases events found — phase stamping off "
                "(-mv_phase_stamps=0 / -mv_flight_events=0) or a "
                "pre-round-11 dump")
        report["note"] = report["degraded"]
        return report
    common = [pos for pos in align.common_positions(streams)
              if all(win[r][pos]["x_done_w"] is not None for r in ranks)]
    report["n_windows"] = len(common)
    if len(ranks) < 2:
        report["degraded"] = ("single-rank dump: cross-rank critical "
                              "path needs every rank's ring — "
                              "reporting local phase totals only")
        report["note"] = report["degraded"]
        return report
    if not common:
        report["degraded"] = ("no common stamped window positions "
                              "across ranks — dumps do not overlap")
        report["note"] = report["degraded"]
        return report
    # -- clock offsets from the exchange-done rendezvous ------------------
    ref = ranks[0]
    offsets = {ref: 0.0}
    for r in ranks[1:]:
        offsets[r] = statistics.median(
            win[r][pos]["x_done_w"] - win[ref][pos]["x_done_w"]
            for pos in common)
    spreads = []
    for pos in common:
        aligned = [win[r][pos]["x_done_w"] - offsets[r] for r in ranks]
        spreads.append(max(aligned) - min(aligned))
    err = (statistics.quantiles(spreads, n=10)[-1]
           if len(spreads) >= 2 else (spreads[0] if spreads else 0.0))
    report["clock_offsets_s"] = {r: round(offsets[r], 6) for r in ranks}
    report["align_err_s"] = round(err, 6)
    # -- per-window binding verdicts --------------------------------------
    rank_hist: Dict[int, int] = {}
    phase_hist: Dict[str, int] = {}
    wait_excess = {r: 0.0 for r in ranks}
    accounted = []
    # the binding gap is between CONSECUTIVE windows of the SAME
    # (mepoch, stream) sub-stream: engine shards drain independently,
    # so "previous window" must never cross shard streams
    prev_common: Dict[tuple, tuple] = {}
    last_by_sub: Dict[tuple, tuple] = {}
    for pos in common:
        prev_common[pos] = last_by_sub.get(pos[:2])
        last_by_sub[pos[:2]] = pos
    #: per engine shard stream: binding verdicts (round 12 — the
    #: sharded engine's per-stream report + cross-stream summary)
    per_stream: Dict[int, dict] = {}
    windows_out = []
    for pos in common:
        enters = {r: win[r][pos]["x_done_w"] - offsets[r]
                  - win[r][pos]["exchange"] for r in ranks}
        binding = max(enters, key=enters.get)
        rank_hist[binding] = rank_hist.get(binding, 0) + 1
        # wait asymmetry from the BLOCKED-IN-COLLECTIVE slice (xw) —
        # the total exchange wall also carries per-rank local staging
        # (buffer copies scale with the rank's own blob size), which
        # must not be billed as "waited on a slower peer". Dumps from
        # engines that recorded no xw fall back to the total.
        waits = {r: (win[r][pos]["exchange_wait"]
                     or win[r][pos]["exchange"]) for r in ranks}
        min_w = min(waits.values())
        for r in ranks:
            wait_excess[r] += waits[r] - min_w
        # binding phase: what the binding rank did between its previous
        # exchange-done and this exchange-enter, on ITS OWN monotonic
        # clock (no cross-rank math -> not limited by align_err_s)
        rec = win[binding][pos]
        prev = prev_common[pos]
        comp = {"form": rec["form"], "pack": rec["pack"],
                "encode": rec["encode"], "exchange": rec["exchange"]}
        period = None
        unacc = None
        if prev is not None and win[binding][prev]["x_done_m"] is not None:
            prec = win[binding][prev]
            gap_lo = prec["x_done_m"]
            gap_hi = rec["x_enter_m"]
            comp["decode"] = prec["decode"]
            comp["apply"] = sum(
                max(0.0, min(hi, gap_hi) - max(lo, gap_lo))
                for lo, hi in apply_iv[binding]
                if hi > gap_lo and lo < gap_hi)
            # the engine's "form" stamp includes the depth-fence wait,
            # and while the fence holds, an APPLY is what is running —
            # the same wall time shows up in both. Attribute the
            # overlapped stretch to its cause (apply) and keep only the
            # apply-free remainder as genuine window formation, so a
            # straggling apply stage is named "apply", not "form".
            comp["form"] = max(0.0, comp["form"] - comp["apply"])
            period = rec["x_done_m"] - prec["x_done_m"]
            unacc = max(0.0, period - sum(comp.values()))
        phase = max(comp, key=comp.get) if any(comp.values()) else "exchange"
        phase_hist[phase] = phase_hist.get(phase, 0) + 1
        if period is not None and period > 0:
            accounted.append(100.0 * (period - unacc) / period)
        ps = per_stream.setdefault(pos[1], {
            "n_windows": 0, "binding_rank_hist": {},
            "binding_phase_hist": {}})
        ps["n_windows"] += 1
        ps["binding_rank_hist"][binding] = (
            ps["binding_rank_hist"].get(binding, 0) + 1)
        ps["binding_phase_hist"][phase] = (
            ps["binding_phase_hist"].get(phase, 0) + 1)
        windows_out.append({
            "pos": list(pos), "binding_rank": binding,
            "binding_host": hosts.get(binding, f"rank{binding}"),
            "binding_phase": phase,
            "period_s": round(period, 6) if period is not None else None,
            "unaccounted_s": (round(unacc, 6) if unacc is not None
                              else None),
            "per_rank": {r: {
                "x_enter": round(enters[r], 6),
                "x_done": round(win[r][pos]["x_done_w"] - offsets[r], 6),
                "exchange_s": round(win[r][pos]["exchange"], 6),
                "apply_s": round(win[r][pos]["apply"], 6),
            } for r in ranks}})
    report["windows"] = windows_out
    report["binding_rank_hist"] = rank_hist
    report["binding_phase_hist"] = phase_hist
    # cross-stream summary: the flat hists above AGGREGATE every shard
    # stream; per_stream carries each stream's own verdicts so a
    # straggling shard is visible as such
    for s in per_stream.values():
        bp = s["binding_phase_hist"]
        br = s["binding_rank_hist"]
        s["dominant_phase"] = max(bp, key=bp.get)
        s["dominant_rank"] = max(br, key=br.get)
        s["dominant_host"] = hosts.get(s["dominant_rank"],
                                       f"rank{s['dominant_rank']}")
    report["streams"] = per_stream
    report["exchange_wait_excess_s"] = {r: round(s, 6)
                                        for r, s in wait_excess.items()}
    if accounted:
        report["accounted_pct"] = round(
            sum(accounted) / len(accounted), 1)
    top_rank = max(rank_hist, key=rank_hist.get)
    top_phase = max(phase_hist, key=phase_hist.get)
    multi = (f" across {len(per_stream)} engine streams"
             if len(per_stream) > 1 else "")
    report["note"] = (
        f"{len(common)} windows{multi}: rank {top_rank} "
        f"(host {hosts.get(top_rank, f'rank{top_rank}')}) binds "
        f"{rank_hist[top_rank]}/{len(common)}, dominant binding phase "
        f"'{top_phase}' ({phase_hist[top_phase]}/{len(common)}); "
        f"alignment error <= {report['align_err_s'] * 1e3:.3f} ms")
    return report


def report_text(report: dict) -> str:
    """Human-readable straggler report."""
    lines = [f"== window critical path: ranks {report['ranks']} =="]
    if report.get("degraded"):
        lines.append(f"DEGRADED: {report['degraded']}")
    if report.get("coverage"):
        lines.append(f"coverage: {report['coverage']}")
    if report["note"] and report["note"] != report.get("degraded"):
        lines.append(report["note"])
    hosts = report.get("hosts", {})

    def _host(r):
        return hosts.get(r, f"rank{r}")

    if report["binding_rank_hist"]:
        lines.append("binding ranks: " + ", ".join(
            f"rank {r} ({_host(r)}): {n}" for r, n in
            sorted(report["binding_rank_hist"].items())))
        lines.append("binding phases: " + ", ".join(
            f"{p}: {n}" for p, n in
            sorted(report["binding_phase_hist"].items(),
                   key=lambda kv: -kv[1])))
        if len(report.get("streams", {})) > 1:
            for sid, s in sorted(report["streams"].items()):
                lines.append(
                    f"  stream {sid}: {s['n_windows']} windows, "
                    f"binding rank {s['dominant_rank']} on "
                    f"{s.get('dominant_host', _host(s['dominant_rank']))} "
                    f"({s['binding_rank_hist'][s['dominant_rank']]}"
                    f"/{s['n_windows']}), dominant phase "
                    f"'{s['dominant_phase']}'")
        lines.append("exchange-wait excess (blocked waiting on a "
                     "slower peer): " + ", ".join(
                         f"rank {r}: {s * 1e3:.1f}ms" for r, s in
                         sorted(report["exchange_wait_excess_s"].items())))
        if report.get("accounted_pct") is not None:
            lines.append(f"phase accounting covers "
                         f"{report['accounted_pct']:.1f}% of window "
                         f"wall on the binding ranks")
    for r in report["ranks"]:
        tot = report["phase_totals_s"].get(r, {})
        lines.append(f"rank {r} phase totals: " + ", ".join(
            f"{p}={tot.get(p, 0.0) * 1e3:.1f}ms" for p in PHASES))
    if report["tables_top"]:
        lines.append("top tables by apply seconds:")
        for rec in report["tables_top"][:5]:
            lines.append(f"  {rec['table']} {rec['verb']}: "
                         f"{rec['seconds'] * 1e3:.1f}ms")
    return "\n".join(lines)


#: stage -> Perfetto track id (one track per rank x stage; rank = pid)
_TRACKS = {"form": 1, "pack": 2, "encode": 3, "exchange": 4,
           "decode": 5, "apply": 6}


def to_chrome_trace(paths: List[str],
                    report: Optional[dict] = None) -> dict:
    """The merged cross-rank timeline as Chrome trace JSON (Perfetto):
    one process per rank, one track per stage. EVERY stamped window
    renders (ragged tails included — they carry real local phases);
    ranks sit on the reference rank's clock via the report's offsets.
    When the report is degraded (no common windows to estimate offsets
    from), multi-rank output is rendered on RAW wall clocks and each
    process label says so — a silently skewed timeline must not look
    aligned."""
    from multiverso_tpu_torch.telemetry import trace as ttrace

    report = report if report is not None else correlate(paths)
    dumps = [align.load(p) for p in paths]
    streams, _ = align.by_rank(dumps, ("window.phases",))
    offsets = report.get("clock_offsets_s", {})
    unaligned = (report.get("degraded") is not None
                 and len(streams) > 1)
    events = []
    t0 = None
    slices = []
    for r, stream_r in sorted(streams.items()):
        off = offsets.get(r, 0.0)
        for pos, evs in sorted(stream_r.items()):
            rec = _window_record(evs[0])
            if rec["x_done_w"] is None:
                continue
            done = rec["x_done_w"] - off
            enter = done - rec["exchange"]
            marks = [("exchange", enter, rec["exchange"]),
                     ("decode", done, rec["decode"]),
                     ("encode", enter - rec["encode"], rec["encode"]),
                     ("pack", enter - rec["encode"] - rec["pack"],
                      rec["pack"]),
                     ("form", enter - rec["encode"] - rec["pack"]
                      - rec["form"], rec["form"])]
            if rec["a_start_m"] is not None:
                # apply landmarks are rank-local mono; re-anchor via
                # this window's exchange-done on both clocks
                marks.append(("apply",
                              done + (rec["a_start_m"]
                                      - rec["x_done_m"]),
                              rec["apply"]))
            for stage, start, dur in marks:
                if dur <= 0.0:
                    continue
                slices.append((r, stage, start, dur, pos))
                t0 = start if t0 is None else min(t0, start)
    for r, stage, start, dur, pos in slices:
        st = f" st{pos[1]}" if pos[1] else ""
        events.append({"name": f"{stage}{st} s{pos[2]}",
                       "cat": "critpath",
                       "ph": "X", "ts": (start - (t0 or 0.0)) * 1e6,
                       "dur": dur * 1e6, "pid": r,
                       "tid": _TRACKS[stage],
                       "args": {"mepoch": pos[0], "stream": pos[1],
                                "seq": pos[2]}})
    suffix = " (UNALIGNED CLOCK)" if unaligned else ""
    process_names = {r: f"rank {r}{suffix}" for r in streams}
    thread_names = {(r, tid): stage for r in streams
                    for stage, tid in _TRACKS.items()}
    return ttrace.chrome_trace(events, process_names=process_names,
                               thread_names=thread_names)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json

    from multiverso_tpu_torch.utils.log import Log
    parser = argparse.ArgumentParser(
        prog="python -m multiverso_tpu_torch.telemetry.critpath",
        description="merge per-rank flight dumps by (mepoch, stream, "
                    "SEQ), align clocks on exchange-done rendezvous "
                    "points, and report each window's binding rank + "
                    "phase (per engine shard stream)")
    parser.add_argument("paths", nargs="+",
                        help="per-rank flight_rank<R>.jsonl dumps, or "
                             "a directory (e.g. the -mv_diag_dir) "
                             "whose flight_rank*.jsonl are globbed")
    parser.add_argument("--trace", default="",
                        help="also write the merged timeline as Chrome "
                             "trace JSON (Perfetto) to this path")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON instead of "
                             "the text rendering")
    args = parser.parse_args(argv)
    paths = align.expand_paths(args.paths)
    report = correlate(paths)
    if args.json:
        Log.Info("%s", json.dumps(report, indent=1, sort_keys=True))
    else:
        Log.Info("%s", report_text(report))
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(to_chrome_trace(paths, report), f)
        Log.Info("critpath: wrote merged timeline to %s", args.trace)
    return 0 if report.get("degraded") is None else 2


if __name__ == "__main__":      # pragma: no cover - CLI shim
    raise SystemExit(main())
