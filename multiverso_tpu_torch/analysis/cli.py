"""``python -m multiverso_tpu_torch.analysis`` — the port's mvlint CLI
(counterpart of ``multiverso_tpu/analysis/cli.py``).

Exit code contract (the tier-1 test pins it, so CI can gate on it):

* ``0`` — every checker ran, zero unsuppressed findings, zero stale
  suppressions;
* ``1`` — findings (violations, stale/malformed suppressions, parse
  failures);
* ``2`` — usage errors (unknown rule, bad flag, unreadable root,
  unwritable diag dir).

``--json`` prints the machine-readable result to stdout and, when a
diagnostics directory is configured (``--diag-dir`` or the package's
``-mv_diag_dir`` flag), also drops ``analysis_rank<R>.json`` next to
the flight/trace/telemetry artifacts — same layout
:func:`multiverso_tpu_torch.telemetry.ops.dump_diagnostics` uses, so one
directory still holds everything a postmortem (or a CI gate) needs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from multiverso_tpu_torch.analysis import core


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m multiverso_tpu_torch.analysis",
        description="mvlint: static invariant analysis over the package "
                    "(AST rules + the never-collective call-graph "
                    "checker)")
    p.add_argument("--root", default=None,
                   help="package root to scan (default: the installed "
                        "multiverso_tpu_torch package)")
    p.add_argument("--rules", default=None,
                   help="comma-separated subset of rules (default: all); "
                        "see --list")
    p.add_argument("--list", action="store_true", dest="list_rules",
                   help="list registered rules and exit")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable result to stdout "
                        "(and to the diagnostics dir when configured)")
    p.add_argument("--diag-dir", default=None,
                   help="directory for the analysis_rank<R>.json "
                        "artifact (default: the -mv_diag_dir flag)")
    return p


def _out(text: str) -> None:
    sys.stdout.write(text + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    # checker modules register on import
    from multiverso_tpu_torch.analysis import (  # noqa: F401
        collective, concurrency, rules, threads)
    try:
        args = _parser().parse_args(argv)
    except SystemExit as exc:       # argparse exits 2 on usage errors
        return int(exc.code or 0)

    if args.list_rules:
        for name in core.all_checker_names():
            _out(f"{name}: {core.CHECKERS[name].description}")
        return 0

    rule_names = None
    if args.rules:
        rule_names = [r.strip() for r in args.rules.split(",") if r.strip()]
        if not rule_names:
            # exit 0 means "every checker ran": a --rules that names
            # nothing (e.g. an unset CI variable interpolated into
            # --rules "$RULES,") must not read as a clean pass
            _out(f"usage error: --rules {args.rules!r} names no rules")
            return 2
    if args.root is not None and not os.path.isdir(args.root):
        _out(f"usage error: --root {args.root!r} is not a directory")
        return 2
    try:
        result = core.run_analysis(root=args.root, rules=rule_names)
    except KeyError as exc:
        _out(f"usage error: {exc.args[0]}")
        return 2

    if args.json:
        payload = result.as_dict()
        _out(json.dumps(payload, indent=1, sort_keys=True))
        try:
            _write_artifact(args.diag_dir, payload)
        except OSError as exc:
            # an unwritable diag dir must not masquerade as exit 1
            # ("findings") or crash past the pinned 0/1/2 contract
            _out(f"usage error: cannot write diag artifact: {exc}")
            return 2
    else:
        for f in result.findings:
            _out(f.render())
        scanned = {rel for c in result.checkers for rel in c.scanned}
        _out(f"mvlint: {len(result.findings)} finding(s), "
             f"{len(result.suppressed)} suppressed, "
             f"{len(result.checkers)} rule(s) over "
             f"{len(scanned)} file(s)")
    return 0 if result.clean else 1


def _write_artifact(diag_dir: Optional[str], payload: dict) -> None:
    """Drop analysis_rank<R>.json into the -mv_diag_dir layout."""
    d = diag_dir
    if not d:
        try:
            from multiverso_tpu_torch.telemetry import flight
            d = flight.diag_dir()
        except Exception:
            d = ""
    if not d:
        return
    try:
        from multiverso_tpu_torch.telemetry import flight
        r = flight._rank()
    except Exception:
        r = 0
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"analysis_rank{r}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
