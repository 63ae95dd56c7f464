"""mvlint framework core: package index, checker registry, suppressions.

Counterpart of ``multiverso_tpu/analysis/core.py``. The registry
(:data:`CHECKERS`) is the port's own, so both packages' checkers load in
one process, and :func:`default_root` is the ``multiverso_tpu_torch``
directory.

The analysis plane turns this build's load-bearing conventions (DESIGN.md
§16) into machine-checked laws: every checker parses the package once
(``PackageIndex``), reports :class:`Finding` records, and the runner
applies the inline suppression contract before anything reaches the CLI
or the tier-1 baseline test.

Suppression contract
--------------------
A finding is suppressed ONLY by an inline comment that names the rule
and carries a reason::

    x = GetFlag("foo")   # mv-lint: ok(hot-path-flag-cache): cold init path

The comment may trail the offending line or sit on its own line(s)
directly above it (stacking — one rule per comment). A marker binds
to the SIMPLE STATEMENT its line belongs to, like ``noqa`` on a
logical line: it excuses every finding of its rule within that
statement — so a marker trailing the closing line of a call that
spans lines still lands on the finding anchored at the call's first
line, and two violations sharing a statement (both arms of a one-line
ternary) need one reason that speaks for both; the checkers report
each distinctly beforehand, so nothing is hidden unreviewed.
Compound-statement headers (``if``/``for``/...) keep exact-line
scope — a marker there must not quietly excuse the whole block.
Three failure modes are themselves findings, so the suppression
inventory can never rot silently:

* ``mvlint-suppression`` — malformed marker (missing rule or reason),
* ``mvlint-suppression`` — unknown rule name,
* ``stale-suppression`` — a well-formed suppression that matched no
  finding in this run (the violation it excused is gone; delete it).

Stale detection only judges suppressions for rules that actually ran,
so ``--rules`` subsets never produce false staleness.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: marker grammar (leading hash elided here so this comment is not
#: itself a marker attempt): "mv-lint: ok(<rule>): <reason>"
_SUPPRESS_RE = re.compile(
    r"#\s*mv-lint:\s*ok\(\s*(?P<rule>[A-Za-z0-9_-]+)\s*\)\s*"
    r"(?::\s*(?P<reason>\S.*))?")
#: anything that LOOKS like a marker attempt, for malformed-marker errors
_SUPPRESS_ATTEMPT_RE = re.compile(r"#\s*mv-lint\b")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str           # rel posix path inside the scanned package
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


@dataclass
class Suppression:
    rule: str
    reason: str
    comment_line: int   # where the marker sits
    target_line: int    # the code line it excuses
    used: bool = False


#: statements WITHOUT a body — the suppression anchor unit. Compound
#: statements (if/for/with/def...) are excluded: a marker trailing an
#: `if` header must not quietly excuse the whole block.
_SIMPLE_STMTS = (ast.Expr, ast.Assign, ast.AugAssign, ast.AnnAssign,
                 ast.Return, ast.Delete, ast.Raise, ast.Assert,
                 ast.Import, ast.ImportFrom, ast.Global, ast.Nonlocal,
                 ast.Pass, ast.Break, ast.Continue)


@dataclass
class SourceFile:
    """One parsed module: text, AST, and its suppression table."""

    rel: str
    abspath: str
    text: str
    lines: List[str] = field(default_factory=list)
    tree: Optional[ast.AST] = None
    parse_error: Optional[str] = None
    suppressions: List[Suppression] = field(default_factory=list)
    #: malformed/unknown markers, reported as findings by the runner
    bad_markers: List[Tuple[int, str]] = field(default_factory=list)
    #: lazy (start, end) spans of every simple statement, for the
    #: multi-line-statement suppression match
    _spans: Optional[List[Tuple[int, int]]] = field(default=None,
                                                    repr=False)

    def _stmt_span(self, line: int) -> Optional[Tuple[int, int]]:
        """Smallest simple-statement span covering ``line``."""
        if self._spans is None:
            spans: List[Tuple[int, int]] = []
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    end = getattr(node, "end_lineno", None)
                    if isinstance(node, _SIMPLE_STMTS) and end:
                        spans.append((node.lineno, end))
            self._spans = spans
        best: Optional[Tuple[int, int]] = None
        for a, b in self._spans:
            if a <= line <= b and (best is None
                                   or (b - a) < (best[1] - best[0])):
                best = (a, b)
        return best

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        for s in self.suppressions:
            if s.rule != rule:
                continue
            if s.target_line == line:
                return s
            # a call spanning lines anchors its finding at call.lineno
            # while a trailing marker sits on the closing line (and an
            # own-line marker above targets the statement's first
            # line): the marker binds to the whole SIMPLE statement
            span = self._stmt_span(s.target_line)
            if span is not None and span[0] <= line <= span[1]:
                return s
        return None


def _comment_tokens(sf: SourceFile) -> List[Tuple[int, str, bool]]:
    """(line, comment_text, own_line) for every REAL comment token —
    tokenize-based so marker text inside strings/docstrings (this
    module's own documentation, say) is never mistaken for a marker."""
    out: List[Tuple[int, str, bool]] = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(sf.text).readline)
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                line = tok.start[0]
                before = sf.lines[line - 1][: tok.start[1]].strip()
                out.append((line, tok.string, not before))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass    # unparseable files surface via sf.parse_error
    return out


def _parse_suppressions(sf: SourceFile) -> None:
    """Fill ``sf.suppressions`` / ``sf.bad_markers`` from the comments.

    An own-line marker targets the next line that holds code (stacked
    markers and blank lines are skipped over); a trailing marker targets
    its own line.
    """
    n = len(sf.lines)
    for i, comment, own_line in _comment_tokens(sf):
        if not _SUPPRESS_ATTEMPT_RE.search(comment):
            continue
        m = _SUPPRESS_RE.search(comment)
        if not m:
            sf.bad_markers.append(
                (i, "malformed mv-lint marker — the grammar is "
                    "'# mv-lint: ok(<rule>): <reason>'"))
            continue
        rule, reason = m.group("rule"), m.group("reason")
        if not reason or not reason.strip():
            sf.bad_markers.append(
                (i, f"mv-lint suppression for {rule!r} carries no reason "
                    f"— suppressions must say why"))
            continue
        if not own_line:
            target = i
        else:
            target = 0
            j = i + 1
            while j <= n:
                nxt = sf.lines[j - 1].strip()
                if nxt and not nxt.startswith("#"):
                    target = j
                    break
                j += 1
            if target == 0:
                sf.bad_markers.append(
                    (i, f"mv-lint suppression for {rule!r} precedes no "
                        f"code line"))
                continue
        sf.suppressions.append(
            Suppression(rule=rule, reason=reason.strip(),
                        comment_line=i, target_line=target))


class PackageIndex:
    """Every ``*.py`` under one package root, parsed once."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.files: List[SourceFile] = []
        self._by_rel: Dict[str, SourceFile] = {}
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.endswith(".egg-info"))
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                abspath = os.path.join(dirpath, fn)
                rel = os.path.relpath(abspath, self.root).replace(os.sep, "/")
                try:
                    with open(abspath, encoding="utf-8") as f:
                        text = f.read()
                except (OSError, UnicodeDecodeError) as exc:
                    # an unreadable/undecodable module is a finding
                    # (mvlint-parse), never an uncaught traceback that
                    # exits 1 masquerading as "findings present"
                    sf = SourceFile(rel=rel, abspath=abspath, text="")
                    sf.parse_error = f"failed to read/decode: {exc}"
                    self.files.append(sf)
                    self._by_rel[rel] = sf
                    continue
                sf = SourceFile(rel=rel, abspath=abspath, text=text,
                                lines=text.splitlines())
                try:
                    sf.tree = ast.parse(text, filename=abspath)
                except SyntaxError as exc:
                    sf.parse_error = f"{exc.msg} (line {exc.lineno})"
                _parse_suppressions(sf)
                self.files.append(sf)
                self._by_rel[rel] = sf

    @property
    def rel_paths(self) -> Set[str]:
        return set(self._by_rel)

    def file(self, rel: str) -> Optional[SourceFile]:
        return self._by_rel.get(rel)


#: memoized indexes: the tier-1 baseline test and the two migrated lint
#: tests all analyze the same tree — parse it once per process
_INDEX_CACHE: Dict[str, PackageIndex] = {}


def load_package(root: Optional[str] = None) -> PackageIndex:
    """Index ``root`` (default: the installed multiverso_tpu_torch
    package)."""
    if root is None:
        root = default_root()
    root = os.path.abspath(root)
    idx = _INDEX_CACHE.get(root)
    if idx is None:
        idx = _INDEX_CACHE[root] = PackageIndex(root)
    return idx


def default_root() -> str:
    """The ``multiverso_tpu_torch`` directory this module sits in (found
    from the file, so no runtime module is imported)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Checker:
    """Base checker: subclass, set ``name``/``description``, implement
    :meth:`check`. ``ALLOW`` maps rel paths to the reason the whole file
    is exempt (the per-file allowlists the PR 2/3 regex lints carried);
    allowlisted files are skipped and excluded from ``scanned`` so the
    migrated tests keep their exact legacy semantics."""

    name: str = ""
    description: str = ""
    #: rel path -> why the whole file is exempt from this rule
    ALLOW: Dict[str, str] = {}

    def __init__(self) -> None:
        self.scanned: Set[str] = set()

    def iter_files(self, pkg: PackageIndex) -> Iterable[SourceFile]:
        for sf in pkg.files:
            if sf.rel in self.ALLOW:
                continue
            self.scanned.add(sf.rel)
            if sf.tree is None:
                continue    # parse errors surface via the runner
            yield sf

    def check(self, pkg: PackageIndex) -> List[Finding]:
        raise NotImplementedError


#: the registry the CLI and the tier-1 baseline iterate
CHECKERS: Dict[str, type] = {}


def register(cls):
    """Class decorator adding a checker to the registry."""
    assert cls.name and cls.name not in CHECKERS, cls
    CHECKERS[cls.name] = cls
    return cls


def all_checker_names() -> List[str]:
    return sorted(CHECKERS)


@dataclass
class AnalysisResult:
    findings: List[Finding]           # unsuppressed, sorted
    suppressed: List[Finding]         # excused by a valid marker
    checkers: List[Checker]           # instances that ran (scanned sets)
    package_root: str

    @property
    def clean(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {
            "package_root": self.package_root,
            "rules": [c.name for c in self.checkers],
            "clean": self.clean,
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [f.as_dict() for f in self.suppressed],
        }


def run_analysis(root: Optional[str] = None,
                 rules: Optional[List[str]] = None) -> AnalysisResult:
    """Run ``rules`` (default: every registered checker) over ``root``
    and apply the suppression contract. Checker modules register on
    import; import them before calling this with ``rules=None``."""
    # the sibling modules register their checkers at import time; pull
    # them in so a bare run_analysis() sees the full registry
    from multiverso_tpu_torch.analysis import (  # noqa: F401
        collective, concurrency, rules as _rules, threads)

    names = rules if rules is not None else all_checker_names()
    if rules is not None and not names:
        # a clean result means "every requested checker ran" — an
        # explicitly empty list (a filtered-to-nothing CI variable)
        # must not run zero checkers and read as a clean pass
        raise KeyError("empty rule list — pass rules=None to run "
                       "every checker")
    unknown = [n for n in names if n not in CHECKERS]
    if unknown:
        # validated BEFORE the package parse so a --rules typo fails
        # instantly instead of paying the full-tree index first
        raise KeyError(f"unknown rule(s): {', '.join(unknown)} — "
                       f"known: {', '.join(all_checker_names())}")
    pkg = load_package(root)
    checkers = [CHECKERS[n]() for n in names]

    raw: List[Finding] = []
    for c in checkers:
        raw.extend(c.check(pkg))

    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        sf = pkg.file(f.path)
        sup = sf.suppression_for(f.rule, f.line) if sf is not None else None
        if sup is not None:
            sup.used = True
            suppressed.append(f)
        else:
            findings.append(f)

    ran = {c.name for c in checkers}
    for sf in pkg.files:
        for line, msg in sf.bad_markers:
            findings.append(Finding("mvlint-suppression", sf.rel, line, msg))
        for sup in sf.suppressions:
            if sup.rule not in CHECKERS:
                findings.append(Finding(
                    "mvlint-suppression", sf.rel, sup.comment_line,
                    f"suppression names unknown rule {sup.rule!r} — "
                    f"known: {', '.join(all_checker_names())}"))
            elif sup.rule in ran and not sup.used:
                allow = getattr(CHECKERS[sup.rule], "ALLOW", {})
                if sf.rel in allow:
                    # the rule never scans this file, so the marker
                    # can never be used — say THAT, not "the
                    # violation is gone"
                    findings.append(Finding(
                        "stale-suppression", sf.rel, sup.comment_line,
                        f"suppression for {sup.rule!r} is redundant — "
                        f"the whole file is allowlisted for that rule "
                        f"({allow[sf.rel]}); delete the marker"))
                else:
                    findings.append(Finding(
                        "stale-suppression", sf.rel, sup.comment_line,
                        f"suppression for {sup.rule!r} matched no "
                        f"finding — the violation it excused is gone; "
                        f"delete it"))
        if sf.parse_error is not None:
            findings.append(Finding(
                "mvlint-parse", sf.rel, 1,
                f"module failed to parse: {sf.parse_error}"))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    suppressed.sort(key=lambda f: (f.path, f.line, f.rule))
    return AnalysisResult(findings=findings, suppressed=suppressed,
                          checkers=checkers, package_root=pkg.root)
