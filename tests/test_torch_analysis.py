"""mvlint keyed to the port (``multiverso_tpu_torch/analysis``), on the CPU.

(1) The whole-port baseline: ``run_analysis()`` over
    ``multiverso_tpu_torch`` runs the JAX package's ten checkers and finds
    nothing, with no stale suppression; every suppression in the port
    names its rule and a reason. Every ``HOT_ZONES``, ``DEVICE_ZONES`` and
    ``INVENTORY`` entry and every never-collective root and sink matches
    a live def; the inventory claims every thread spawn of the port (13
    ``threading.Thread``/``Timer`` calls) and the analysis modules import
    neither torch nor jax.
(2) Engine parity: the port's checkers, given the JAX package's
    configuration (read from ``multiverso_tpu.analysis``: the hot and
    device zones, the thread inventory, the roots and sinks, the allow
    lists and restricted domains, ``jax`` as the device module and no
    device methods), report exactly the JAX package's findings on
    ``tests/mvlint_fixtures/bad`` and ``clean`` as ``(rule, path, line,
    message)`` lists, and suppress the same.
(3) The CLI contract: ``python -m multiverso_tpu_torch.analysis`` exits 0
    on the port, 1 on the bad fixture tree, 2 on an unknown rule, a
    ``--rules`` that names nothing and a missing root; ``--json`` prints
    the result and writes ``analysis_rank0.json`` to ``--diag-dir``;
    ``--list`` names the ten rules.
"""

import ast
import dataclasses
import importlib
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "mvlint_fixtures")
PORT = os.path.join(REPO, "multiverso_tpu_torch")

TEN = {"no-bare-print", "bounded-blocking", "hot-path-flag-cache",
       "spmd-stream-guard", "never-collective", "thread-domains",
       "cross-domain-state", "device-work-domain", "lock-order",
       "blocking-domain"}


def _defs(pkg, rel_pat, qual_pat):
    """(rel, qualname) of every top-level def matching the two patterns."""
    from multiverso_tpu_torch.analysis import callgraph
    out = []
    for sf in pkg.files:
        if sf.tree is None or not re.search(rel_pat, sf.rel):
            continue
        out += [(sf.rel, q) for q, _, _ in callgraph.iter_top_defs(sf.tree)
                if re.search(qual_pat, q)]
    return out


def test_port_is_clean_under_every_checker():
    from multiverso_tpu_torch.analysis import (collective, concurrency,
                                               core, rules, threads)
    res = core.run_analysis()
    assert res.package_root == PORT
    assert res.clean, "\n".join(f.render() for f in res.findings)
    assert {c.name for c in res.checkers} == TEN
    from multiverso_tpu.analysis import core as jcore
    for name in ("collective", "concurrency", "rules", "threads"):
        # the JAX package's checkers register as their modules load
        importlib.import_module(f"multiverso_tpu.analysis.{name}")
    assert set(core.CHECKERS) == set(jcore.CHECKERS) == TEN
    assert core.CHECKERS is not jcore.CHECKERS
    pkg = core.load_package()
    # every marker names its rule and a reason (a reasonless one would be
    # an mvlint-suppression finding above), and each excused a finding
    sups = [(sf.rel, s) for sf in pkg.files for s in sf.suppressions]
    assert len(res.suppressed) >= len(sups) >= 9
    assert all(s.reason and s.rule in TEN for _, s in sups)
    # every configured entry names live code
    hot = rules.HotPathFlagCacheChecker()
    hot.check(pkg)
    for zone, hits in zip(hot.HOT_ZONES, hot.zone_hits):
        assert hits > 0, zone
    for rel_pat, qual_pat, label in \
            concurrency.DeviceWorkDomainChecker.DEVICE_ZONES:
        assert _defs(pkg, rel_pat, qual_pat), label
    inv = threads.inventory_for(pkg)
    assert inv.rot == [] and inv.unclaimed == []
    for e in threads.INVENTORY:
        if e.qual is not None:
            assert inv.roots[e.domain] & {
                f"{rel}:{q}" for rel, q in _defs(pkg, f"^{re.escape(e.rel)}$",
                                                 e.qual)}, e
    spawned = {(s.rel, s.qual) for s in inv.spawns}
    # 15 + the standby and policy planes' 5 + the replica plane's 3
    assert len(inv.spawns) == 23
    assert spawned == {e.spawn for e in threads.INVENTORY if e.spawn}
    graph = inv.graph
    for node in list(collective.DEFAULT_ROOTS) + list(
            collective.DEFAULT_SINKS):
        assert graph.has_node(node), node
    never = collective.NeverCollectiveChecker()
    never.check(pkg)
    for root, seen in never.closures.items():
        assert len(seen) > 1, root
    # the device law sees the card: torch.cuda chains and the transfer
    # methods in the row-kernel wrappers
    facts = concurrency.facts_for(pkg)
    touched = {w for mf in facts.by_rel.values() for df in mf.defs
               for _, w in df.device}
    assert {".cpu()", ".item()", "torch.cuda.current_stream"} <= touched
    # the analysis plane itself is pure source analysis
    for sf in pkg.files:
        if not sf.rel.startswith("analysis/"):
            continue
        for node in ast.walk(sf.tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("torch", "jax",
                                               "multiverso_tpu"), sf.rel


def _clear_caches():
    from multiverso_tpu_torch.analysis import (callgraph, concurrency, core,
                                               threads)
    for cache in (core._INDEX_CACHE, callgraph._GRAPH_CACHE,
                  threads._INV_CACHE, concurrency._FACTS_CACHE):
        cache.clear()


def _jax_config(monkeypatch):
    """Hand every configured name of the port's checkers the JAX
    package's value."""
    from multiverso_tpu.analysis import callgraph as jcg
    from multiverso_tpu.analysis import collective as jcol
    from multiverso_tpu.analysis import concurrency as jcon
    from multiverso_tpu.analysis import rules as jrules
    from multiverso_tpu.analysis import threads as jthr
    from multiverso_tpu_torch.analysis import callgraph as pcg
    from multiverso_tpu_torch.analysis import collective as pcol
    from multiverso_tpu_torch.analysis import concurrency as pcon
    from multiverso_tpu_torch.analysis import core as pcore
    from multiverso_tpu_torch.analysis import rules as prules
    from multiverso_tpu_torch.analysis import threads as pthr
    monkeypatch.setattr(pcg, "EXTERNAL_COLLECTIVE_ATTRS",
                        jcg.EXTERNAL_COLLECTIVE_ATTRS)
    monkeypatch.setattr(pcol, "DEFAULT_ROOTS", jcol.DEFAULT_ROOTS)
    monkeypatch.setattr(pcol, "DEFAULT_SINKS", jcol.DEFAULT_SINKS)
    monkeypatch.setattr(pthr, "INVENTORY", [
        pthr.DomainRoot(**dataclasses.asdict(e)) for e in jthr.INVENTORY])
    monkeypatch.setattr(pcon, "DEVICE_MODULES", ("jax",))
    monkeypatch.setattr(pcon, "DEVICE_METHODS", frozenset())
    for pmod, jmod in ((prules, jrules), (pcon, jcon)):
        for name, jcls in vars(jmod).items():
            pcls = getattr(pmod, name, None)
            if not (isinstance(jcls, type) and isinstance(pcls, type)
                    and issubclass(pcls, pcore.Checker)):
                continue
            for attr in ("ALLOW", "HOT_ZONES", "DEVICE_ZONES",
                         "RESTRICTED", "VERB_ATTRS", "VERB_NAMES",
                         "RANK_TOKENS"):
                if attr in vars(jcls):
                    monkeypatch.setattr(pcls, attr, vars(jcls)[attr])


def test_engine_parity_with_the_jax_configuration(monkeypatch):
    from multiverso_tpu.analysis import run_analysis as jax_run
    from multiverso_tpu_torch.analysis import run_analysis as port_run
    _jax_config(monkeypatch)
    _clear_caches()
    try:
        for tree, n in (("bad", 25), ("clean", 0)):
            root = os.path.join(FIXTURES, tree)
            want, got = jax_run(root=root), port_run(root=root)
            rows = [[(f.rule, f.path, f.line, f.message) for f in r.findings]
                    for r in (want, got)]
            assert len(rows[0]) == n, tree
            assert rows[1] == rows[0], tree
            assert [f.as_dict() for f in got.suppressed] == \
                [f.as_dict() for f in want.suppressed], tree
    finally:
        _clear_caches()


def _cli(*args, cwd=REPO):
    proc = subprocess.run(
        [sys.executable, "-m", "multiverso_tpu_torch.analysis", *args],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=REPO))
    return proc.returncode, proc.stdout


def test_cli_exit_codes_and_json(tmp_path, capsys):
    rc, out = _cli()
    assert rc == 0, out
    assert re.search(r"mvlint: 0 finding\(s\), \d+ suppressed, 10 rule\(s\)",
                     out), out
    rc, out = _cli("--root", os.path.join(FIXTURES, "bad"))
    assert rc == 1 and "[never-collective]" in out, out
    rc, out = _cli("--rules", "no-such-rule")
    assert rc == 2 and "usage error" in out, out
    diag = tmp_path / "diag"
    rc, out = _cli("--json", "--diag-dir", str(diag))
    payload = json.loads(out)
    assert rc == 0 and payload["clean"] is True
    assert payload["package_root"] == PORT
    assert sorted(payload["rules"]) == sorted(TEN)
    assert payload["findings"] == [] and len(payload["suppressed"]) >= 9
    with open(diag / "analysis_rank0.json") as f:
        assert json.load(f) == payload
    # the rest of the contract in process (each subprocess pays the
    # package import)
    from multiverso_tpu_torch.analysis.cli import main
    capsys.readouterr()
    assert main(["--rules", ","]) == 2
    assert main(["--root", str(tmp_path / "absent")]) == 2
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("occupied")
    assert main(["--json", "--diag-dir", str(blocker)]) == 2
    capsys.readouterr()
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert {ln.split(":")[0] for ln in out.splitlines()} == TEN
    assert main(["--json", "--root", os.path.join(FIXTURES, "bad")]) == 1
    assert json.loads(capsys.readouterr().out)["clean"] is False
