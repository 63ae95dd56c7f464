"""mvlint for the port — the static invariant-analysis plane
(docs/DESIGN.md §16, §18), keyed to ``multiverso_tpu_torch``.

Counterpart of ``multiverso_tpu/analysis/``: the same ten checkers with
the same AST logic, each holding this package to the conventions its
threads rely on (never-collective reporter and handler threads, bounded
blocking, logger-routed output, hot-path flag caching, SPMD lockstep verb
streams, classified thread spawns, cross-domain state, device work kept
off the sampling threads, lock order). Only the configuration that names
code is the port's own:

* :mod:`core` — package index, the port's checker registry, the inline
  suppression contract (``# mv-lint: ok(<rule>): <reason>``; stale or
  reasonless suppressions are themselves errors);
* :mod:`callgraph` — the package-wide static call graph
  (``EXTERNAL_COLLECTIVE_ATTRS``: the ``torch.distributed`` collectives);
* :mod:`rules` — the four AST checkers (``HOT_ZONES``: the port's engine,
  row ops, tables, flight record and codec predicates);
* :mod:`collective` — the never-collective checker (``DEFAULT_ROOTS`` and
  ``DEFAULT_SINKS``);
* :mod:`threads` — the thread inventory (``INVENTORY``: every spawn of
  the port, in the JAX package's domains);
* :mod:`concurrency` — the four domain checkers (the device-work law
  keyed to the card: ``DEVICE_MODULES``, ``DEVICE_METHODS``,
  ``DEVICE_ZONES``);
* :mod:`cli` — ``python -m multiverso_tpu_torch.analysis`` (text /
  ``--json``, exit codes 0 clean / 1 findings / 2 usage).

The analysis modules import neither torch nor any runtime state:
scanning is pure source analysis, so the CLI works on a machine that
cannot start a world.
"""

from multiverso_tpu_torch.analysis.core import (  # noqa: F401
    AnalysisResult, Checker, CHECKERS, Finding, all_checker_names,
    load_package, run_analysis)
