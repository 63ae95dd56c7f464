"""Concurrency-domain checkers over the thread inventory (docs/DESIGN.md
§18).

Counterpart of ``multiverso_tpu/analysis/concurrency.py``: the same four
laws and the same AST logic. The device-work law is keyed to the card
instead of jax. Its detector is configurable (:data:`DEVICE_MODULES`,
:data:`DEVICE_METHODS`, ``DeviceWorkDomainChecker.DEVICE_ZONES``), and
the port chooses:

* every dotted name at or under ``torch.cuda`` (``torch.cuda.synchronize``,
  ``torch.cuda.memory_allocated``, ``torch.cuda.Event``...), reached
  through ``import torch``, ``import torch.cuda as ...`` or
  ``from torch import cuda``;
* the tensor methods that move data between the host and the card or
  wait on it, whatever the receiver: ``.cuda()``, ``.cpu()``, ``.to()``,
  ``.item()``, ``.tolist()``, ``.synchronize()``, ``.pin_memory()``,
  ``.record_stream()``, ``.wait_stream()``, ``.wait_event()``. A static
  pass cannot tell a CUDA tensor from a CPU one or a numpy array, so a
  host-only call of these names reads as device work and is suppressed
  with its reason, never dropped from the list;
* the row kernels' modules (``ops/rows.py``, ``ops/cuda_rows.py``) and the
  tables' device-state getters, whole defs that are device work.

The JAX package's detector is the same machinery with
``DEVICE_MODULES = ("jax",)`` and no methods.

The four laws:

Four laws, each consuming :mod:`threads`' domain closures:

* ``cross-domain-state`` — an attribute written from >= 2 thread
  domains with no common lexical lock scope is a data race candidate.
  Conservative by construction: only ``self``/``cls`` attribute stores
  and declared-``global`` stores count as writes, ``__init__`` writes
  are exempt (construction happens-before thread start), and lock
  scopes match by NAME (``with self._lock:``), so two same-named locks
  on different objects can mask a true race (false-negative direction;
  the honesty limits are documented in DESIGN.md §18).
* ``device-work-domain`` — jax/jnp calls, the jit'd row-op kernels and
  the mirror-syncing table ``state`` property must be unreachable from
  sampling/handler/fan-out threads: PR 10's probe-never-syncs-mirror
  regression test generalized to the whole package.
* ``lock-order`` — per-function ``with``-nesting composed through the
  call graph into a lock acquisition-order graph; a cycle is a
  potential deadlock, and re-acquiring a non-reentrant ``Lock`` under
  itself is the one-lock form of the same bug.
* ``blocking-domain`` — the PR 3 bounded-blocking law upgraded from
  per-line regex to reachability: an unbounded ``.wait()``/``.join()``
  (or a ``.recv()``/``.accept()`` in a module that never arms a socket
  timeout) reachable from a handler or engine-thread root stalls a
  thread the runtime cannot afford to lose, even when a per-line
  ``unbounded-ok:`` justification makes it legal elsewhere.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from multiverso_tpu_torch.analysis import callgraph, threads
from multiverso_tpu_torch.analysis.core import (Checker, Finding,
                                                PackageIndex, register)

#: fields never walked: annotation expressions reference device types
#: without running device work
_SKIP_FIELDS = frozenset({"annotation", "returns"})

#: defs whose writes are construction, not concurrency (the instance is
#: not yet shared when they run)
_INIT_QUALS = frozenset({"__init__", "__new__", "__post_init__"})

_BLOCKING_ATTRS = frozenset({"wait", "join"})
_RECV_ATTRS = frozenset({"recv", "recv_into", "accept"})
_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                         "BoundedSemaphore"})
#: constructors whose product is NOT safely re-acquirable by the same
#: thread (threading.Lock/Condition deadlock on re-entry)
_NON_REENTRANT = frozenset({"Lock", "Condition"})


@dataclass(frozen=True)
class WriteSite:
    attr_key: Tuple[str, str]       #: (owner key "rel:Class", attr)
    line: int
    locks: FrozenSet[str]           #: lock NAMES held at the write


@dataclass
class DefFacts:
    """Concurrency-relevant facts of one top-level def."""

    node: str                       #: call-graph node id "rel:qual"
    rel: str
    qual: str
    line: int
    writes: List[WriteSite] = field(default_factory=list)
    #: qualified lock keys acquired anywhere in this def, with lines
    acquires: List[Tuple[str, int]] = field(default_factory=list)
    #: (outer key, inner key, line) lexical with-nesting pairs
    lex_pairs: List[Tuple[str, str, int]] = field(default_factory=list)
    #: (held lock key, called name, line) for call-composed ordering
    calls_under: List[Tuple[str, str, int]] = field(default_factory=list)
    #: (line, description) unbounded blocking sites
    blocking: List[Tuple[int, str]] = field(default_factory=list)
    #: (line, description) device touches
    device: List[Tuple[int, str]] = field(default_factory=list)


@dataclass
class ModuleFacts:
    rel: str
    defs: List[DefFacts] = field(default_factory=list)
    device_aliases: Dict[str, str] = field(default_factory=dict)
    has_settimeout: bool = False
    module_globals: Set[str] = field(default_factory=set)


#: device modules: a dotted name at or under one of these is device work
DEVICE_MODULES: Tuple[str, ...] = ("torch.cuda",)

#: tensor methods that move data between host and card or wait on the
#: card, flagged whatever their receiver (see the module docstring)
DEVICE_METHODS: FrozenSet[str] = frozenset({
    "cuda", "cpu", "to", "item", "tolist", "synchronize", "pin_memory",
    "record_stream", "wait_stream", "wait_event"})


def _under(dotted: str, mods) -> bool:
    return any(dotted == m or dotted.startswith(m + ".") for m in mods)


def _device_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local names an import binds to a device module, a symbol of one,
    or a package above one (``import torch`` binds ``torch``, whose
    ``torch.cuda.*`` chains are device work), each with its dotted
    origin (``import jax.numpy as jnp`` -> ``jnp: jax.numpy``)."""
    mods = DEVICE_MODULES

    def related(dotted: str) -> bool:
        return _under(dotted, mods) or any(m.startswith(dotted + ".")
                                           for m in mods)

    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if not related(alias.name):
                    continue
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    root = alias.name.split(".")[0]
                    out[root] = root
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mod = node.module or ""
            for alias in node.names:
                origin = f"{mod}.{alias.name}"
                if related(origin):
                    out[alias.asname or alias.name] = origin
    return out


def _has_settimeout(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("settimeout", "setdefaulttimeout"):
            if node.args and not (isinstance(node.args[0], ast.Constant)
                                  and node.args[0].value is None):
                return True
    return False


def _unbounded_blocking(call: ast.Call,
                        has_settimeout: bool) -> Optional[str]:
    """The bounded-blocking bound test, shared shape with
    rules.BoundedBlockingChecker: no argument, or every argument a
    literal ``None``, is the unbounded wait spelled out."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    if attr.lower() in _BLOCKING_ATTRS:
        bounds = [a for a in call.args
                  if not (isinstance(a, ast.Constant) and a.value is None)]
        bounds += [k for k in call.keywords
                   if not (isinstance(k.value, ast.Constant)
                           and k.value.value is None)]
        if not bounds:
            return f"unbounded .{attr}()"
        return None
    if attr in _RECV_ATTRS and not has_settimeout:
        return (f"possibly-unbounded .{attr}() (this module never arms "
                f"a socket timeout)")
    return None


def _lock_ref(expr: ast.AST, rel: str, cls: Optional[str],
              module_globals: Set[str]
              ) -> Optional[Tuple[str, Optional[str]]]:
    """(name, qualified-key-or-None) for a with-context expression that
    looks like a lock: a plain Name or a self/attr chain — Calls
    (``open(...)``, ``trace.span(...)``) are not locks. A bare Name
    qualifies as a module-level lock ONLY when it really is a module
    global: a LOCAL alias (``lk = self._a; with lk:``) keys by name
    alone, or two methods aliasing different member locks to one local
    name would merge into a single lock-order node and manufacture
    cycles."""
    if isinstance(expr, ast.Name):
        if expr.id in module_globals:
            return expr.id, f"{rel}:<module>.{expr.id}"
        return expr.id, None
    if isinstance(expr, ast.Attribute):
        chain = callgraph._attr_chain(expr)
        if chain is None:
            return expr.attr, None
        if chain[0] in ("self", "cls") and cls is not None \
                and len(chain) == 2:
            return chain[-1], f"{rel}:{cls}.{chain[-1]}"
        return chain[-1], None
    return None


def _children(node: ast.AST):
    for name, fld in ast.iter_fields(node):
        if name in _SKIP_FIELDS:
            continue
        if isinstance(fld, ast.AST):
            yield fld
        elif isinstance(fld, list):
            for x in fld:
                if isinstance(x, ast.AST):
                    yield x


def _scan_def(df: DefFacts, root: ast.AST, rel: str, cls: Optional[str],
              mf: ModuleFacts,
              lock_kinds: Dict[str, str]) -> None:
    """One recursive pass filling ``df``: writes with the lexical lock
    stack, acquisitions/nesting/calls-under-lock, blocking and device
    sites. Nested defs/lambdas stay attributed to this def (call-graph
    node granularity) but RESET the lock stack — their bodies run
    later, outside the lexically enclosing ``with``."""
    declared_globals: Set[str] = {
        n for node in ast.walk(root) if isinstance(node, ast.Global)
        for n in node.names}
    owner = f"{rel}:{cls}" if cls else f"{rel}:<module>"

    def _note_write(tgt: ast.AST, line: int, locks) -> None:
        if isinstance(tgt, ast.Attribute) \
                and isinstance(tgt.value, ast.Name) \
                and tgt.value.id in ("self", "cls") and cls is not None:
            df.writes.append(WriteSite((owner, tgt.attr), line,
                                       frozenset(n for n, _ in locks)))
        elif isinstance(tgt, ast.Subscript):
            _note_write(tgt.value, line, locks)
        elif isinstance(tgt, ast.Name) \
                and (tgt.id in declared_globals
                     or (tgt.id in mf.module_globals
                         and df.qual == "<module>")):
            df.writes.append(WriteSite(
                (f"{rel}:<module>", tgt.id), line,
                frozenset(n for n, _ in locks)))
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                _note_write(e, line, locks)

    def _note_lock_ctor(node: ast.Assign) -> None:
        v = node.value
        if not (isinstance(v, ast.Call)):
            return
        fn = v.func
        name = (fn.id if isinstance(fn, ast.Name)
                else fn.attr if isinstance(fn, ast.Attribute) else None)
        if name not in _LOCK_CTORS:
            return
        for t in node.targets:
            ref = None
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id in ("self", "cls") and cls is not None:
                ref = f"{rel}:{cls}.{t.attr}"
            elif isinstance(t, ast.Name) and df.qual == "<module>":
                ref = f"{rel}:<module>.{t.id}"
            if ref is not None:
                lock_kinds[ref] = name

    def _walk(node: ast.AST, locks: Tuple[Tuple[str, Optional[str]], ...]
              ) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for c in _children(node):
                _walk(c, ())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = []
            for item in node.items:
                ref = _lock_ref(item.context_expr, rel, cls,
                                mf.module_globals)
                if ref is not None:
                    name, key = ref
                    if key is not None:
                        df.acquires.append((key, node.lineno))
                        for _, held_key in locks:
                            if held_key is not None:
                                df.lex_pairs.append(
                                    (held_key, key, node.lineno))
                        for _, hk in new:
                            if hk is not None:
                                df.lex_pairs.append(
                                    (hk, key, node.lineno))
                    new.append((name, key))
                else:
                    _walk(item.context_expr, locks)
            inner = locks + tuple(new)
            for stmt in node.body:
                _walk(stmt, inner)
            return
        if isinstance(node, ast.Assign):
            _note_lock_ctor(node)
            for t in node.targets:
                _note_write(t, node.lineno, locks)
        elif isinstance(node, ast.AugAssign):
            _note_write(node.target, node.lineno, locks)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            _note_write(node.target, node.lineno, locks)
        elif isinstance(node, ast.Call):
            what = _unbounded_blocking(node, mf.has_settimeout)
            if what is not None:
                df.blocking.append((node.lineno, what))
            fn = node.func
            cname = (fn.id if isinstance(fn, ast.Name)
                     else fn.attr if isinstance(fn, ast.Attribute)
                     else None)
            if cname is not None:
                for _, key in locks:
                    if key is not None:
                        df.calls_under.append((key, cname, node.lineno))
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in DEVICE_METHODS:
            df.device.append((node.lineno, f".{node.func.attr}()"))
        if isinstance(node, ast.Attribute):
            chain = callgraph._attr_chain(node)
            origin = (mf.device_aliases.get(chain[0])
                      if chain is not None else None)
            if origin is not None and _under(
                    ".".join([origin] + chain[1:]), DEVICE_MODULES):
                df.device.append((node.lineno, ".".join(chain)))
                return      # the nested chain would double-report
        elif isinstance(node, ast.Name) \
                and _under(mf.device_aliases.get(node.id, ""),
                           DEVICE_MODULES) \
                and isinstance(getattr(node, "ctx", None), ast.Load):
            df.device.append((node.lineno, node.id))
        for c in _children(node):
            _walk(c, locks)

    _walk(root, ())


def _module_facts(sf, lock_kinds: Dict[str, str]) -> ModuleFacts:
    mf = ModuleFacts(rel=sf.rel)
    mf.device_aliases = _device_aliases(sf.tree)
    mf.has_settimeout = _has_settimeout(sf.tree)
    body = callgraph.flat_body(sf.tree.body)
    for node in body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    mf.module_globals.add(t.id)

    covered = set()
    for qual, cls_node, node in callgraph.iter_top_defs(sf.tree):
        covered.add(node)
        df = DefFacts(node=f"{sf.rel}:{qual}", rel=sf.rel, qual=qual,
                      line=node.lineno)
        _scan_def(df, node, sf.rel,
                  cls_node.name if cls_node is not None else None,
                  mf, lock_kinds)
        mf.defs.append(df)
    mod_df = DefFacts(node=f"{sf.rel}:<module>", rel=sf.rel,
                      qual="<module>", line=1)
    for node in body:
        if node not in covered and not isinstance(node, ast.ClassDef):
            _scan_def(mod_df, node, sf.rel, None, mf, lock_kinds)
    mf.defs.append(mod_df)
    return mf


@dataclass
class PackageFacts:
    pkg: PackageIndex
    by_rel: Dict[str, ModuleFacts]
    lock_kinds: Dict[str, str]      #: qualified lock key -> ctor name

    def defs(self, rels) -> List[DefFacts]:
        out: List[DefFacts] = []
        for rel in sorted(rels):
            mf = self.by_rel.get(rel)
            if mf is not None:
                out.extend(mf.defs)
        return out


_FACTS_CACHE: Dict[str, PackageFacts] = {}


def facts_for(pkg: PackageIndex) -> PackageFacts:
    # same staleness rule as callgraph.build_graph / threads
    # .inventory_for: a FRESH index for the same root (re-scan after a
    # source edit) must rebuild, never serve facts parsed from the old
    # source
    pf = _FACTS_CACHE.get(pkg.root)
    if pf is None or pf.pkg is not pkg:
        lock_kinds: Dict[str, str] = {}
        by_rel = {sf.rel: _module_facts(sf, lock_kinds)
                  for sf in pkg.files if sf.tree is not None}
        pf = _FACTS_CACHE[pkg.root] = PackageFacts(pkg, by_rel,
                                                   lock_kinds)
    return pf


def _fmt_key(attr_key: Tuple[str, str]) -> str:
    owner, attr = attr_key
    rel, _, cls = owner.partition(":")
    return f"{cls}.{attr}" if cls != "<module>" \
        else f"{rel.rsplit('/', 1)[-1]}:{attr}"


@register
class CrossDomainStateChecker(Checker):
    """Attributes written from >= 2 thread domains need one common
    lexical lock scope across EVERY write site."""

    name = "cross-domain-state"
    description = ("an attribute written from >= 2 thread domains with "
                   "no common lexical lock scope is a data-race "
                   "candidate")
    ALLOW = {
        # each wire instance is owned by exactly one thread per
        # (channel, rank); the class-level write aggregation the rule
        # performs is instance-blind there by design (DESIGN.md §18)
        "parallel/shm_wire.py":
            "single-owner wire instances; class-level aggregation is "
            "instance-blind",
        # same posture for the tcp wire, plus its accept loop: that
        # thread writes _conn/_accept_exc only during install, strictly
        # BEFORE any exchange runs (connect() joins it), under _lock
        "parallel/tcp_wire.py":
            "single-owner wire instances; the accept loop writes only "
            "during install, before any exchange, under the wire lock",
    }

    def check(self, pkg: PackageIndex) -> List[Finding]:
        inv = threads.inventory_for(pkg)
        pf = facts_for(pkg)
        eligible = {sf.rel for sf in self.iter_files(pkg)}
        groups: Dict[Tuple[str, str], List] = {}
        for df in pf.defs(eligible):
            tail = df.qual.rsplit(".", 1)[-1]
            if tail in _INIT_QUALS or df.qual == "<module>":
                continue
            doms = inv.domains_of(df.node)
            if not doms:
                continue
            for w in df.writes:
                groups.setdefault(w.attr_key, []).append((df, w, doms))
        out: List[Finding] = []
        for key in sorted(groups):
            sites = groups[key]
            domains = set()
            for _, _, doms in sites:
                domains |= doms
            if len(domains) < 2:
                continue
            common = None
            for _, w, _ in sites:
                common = w.locks if common is None else common & w.locks
            if common:
                continue
            sites.sort(key=lambda s: (s[0].rel, s[1].line))
            df0, w0, _ = sites[0]
            detail = "; ".join(
                f"{df.rel}:{w.line} in {df.qual} "
                f"[{','.join(sorted(doms))}]"
                + (f" under {','.join(sorted(w.locks))}" if w.locks
                   else " unlocked")
                for df, w, doms in sites[:6])
            more = f" (+{len(sites) - 6} more)" if len(sites) > 6 else ""
            out.append(Finding(
                self.name, df0.rel, w0.line,
                f"{_fmt_key(key)} is written from {len(domains)} thread "
                f"domains ({', '.join(sorted(domains))}) with no common "
                f"lock scope: {detail}{more} — guard every write with "
                f"one lock, or suppress with the reason the race is "
                f"benign"))
        return out


@register
class DeviceWorkDomainChecker(Checker):
    """No static path from a sampling/handler domain to device work —
    the probe-never-syncs-mirror law generalized."""

    name = "device-work-domain"
    description = ("device-work sinks (torch.cuda, host<->card tensor "
                   "calls, the row kernels) must be unreachable from "
                   "sampling/HTTP thread domains")

    #: domains that must stay off the device
    RESTRICTED = frozenset({"watchdog", "reporter", "ops-http", "fanout",
                            "replica-reader", "replica-serve",
                            "replica-hb", "policy"})
    #: in-package defs that ARE device work even without a lexical touch:
    #: (module-rel regex, qualname regex, label)
    DEVICE_ZONES: List[Tuple[str, str, str]] = [
        (r"^ops/rows\.py$", r".*", "row-op dispatch onto the row kernels"),
        (r"^ops/cuda_rows\.py$", r".*",
         "the row kernels' build, launch and error word"),
        (r"^tables/matrix_table\.py$",
         r"^MatrixServerTable\.(?:raw|_full_logical|device_fetch_rows)$",
         "device-state read (the table's rows off the card)"),
        (r"^tables/array_table\.py$",
         r"^ArrayServer\.(?:device_state|device_access)$",
         "device-state getter"),
        (r"^tables/kv_table\.py$",
         r"^KVServerTable\.(?:device_values|_items)$",
         "device-state getter"),
    ]

    def check(self, pkg: PackageIndex) -> List[Finding]:
        inv = threads.inventory_for(pkg)
        pf = facts_for(pkg)
        eligible = {sf.rel for sf in self.iter_files(pkg)}
        zones = [(re.compile(m), re.compile(q), label)
                 for m, q, label in self.DEVICE_ZONES]
        zone_live = [False] * len(zones)
        device: Dict[str, str] = {}
        for df in pf.defs(eligible):
            for zi, (mpat, qpat, label) in enumerate(zones):
                if mpat.search(df.rel):
                    zone_live[zi] = True
                    if qpat.search(df.qual):
                        device.setdefault(df.node, label)
            if df.device:
                line, what = df.device[0]
                device.setdefault(
                    df.node, f"touches {what} at line {line}")
        out: List[Finding] = []
        # the HOT_ZONES config-rot law, applied to the device-sink
        # inventory: a zone file pattern matching NO file means the
        # protected module moved — never retire the sink silently
        cfg = "analysis/concurrency.py"
        anchor = cfg if pkg.file(cfg) is not None else "<config>"
        for zi, live in enumerate(zone_live):
            if not live:
                mpat, _, label = self.DEVICE_ZONES[zi]
                out.append(Finding(
                    self.name, anchor, 1,
                    f"device-zone config rot: no file matches {mpat!r} "
                    f"({label}) — the protected module moved or was "
                    f"renamed; update DEVICE_ZONES or the rule is "
                    f"vacuous there"))
        seen = set()
        for domain in sorted(self.RESTRICTED & set(inv.closures)):
            hits = inv.closures[domain] & set(device)
            for node in sorted(hits):
                chain_nodes = inv.chain(domain, node)
                root = chain_nodes[0]
                if (root, node) in seen:
                    continue
                seen.add((root, node))
                rel, line = inv.graph.node_lines[root]
                chain = " -> ".join(chain_nodes)
                out.append(Finding(
                    self.name, rel, line,
                    f"{root} ({domain} domain: "
                    f"{inv.root_labels.get(root, 'thread root')}) "
                    f"statically reaches device work {node} "
                    f"({device[node]}): {chain} — sampling/handler/"
                    f"fan-out threads must never issue device ops"))
        return out


@register
class LockOrderChecker(Checker):
    """Compose per-function ``with``-nesting through the call graph
    into a lock acquisition-order graph; cycles are potential
    deadlocks.

    Honesty bound (the callgraph fallback's sibling, false-positive
    direction): a call under a lock composes by callee NAME against
    the def's resolved edges, so ``with self._a: x.sync()`` also picks
    up a *different* ``.sync`` target called elsewhere in the same def
    — an over-approximated edge can manufacture a cycle that cannot
    happen, never hide one that can. Cycles are "potential deadlock"
    findings to be read, and a wrong one is suppressed with its why."""

    name = "lock-order"
    description = ("lock acquisition-order cycles (lexical with-nesting "
                   "composed through the call graph) are potential "
                   "deadlocks")

    def check(self, pkg: PackageIndex) -> List[Finding]:
        graph = callgraph.build_graph(pkg)
        pf = facts_for(pkg)
        eligible = {sf.rel for sf in self.iter_files(pkg)}
        defs = pf.defs(eligible)
        acq_direct: Dict[str, Set[str]] = {}
        for df in defs:
            if df.acquires:
                acq_direct[df.node] = {k for k, _ in df.acquires}

        closure_cache: Dict[str, Set[str]] = {}

        def closure_acquires(node: str) -> Set[str]:
            got = closure_cache.get(node)
            if got is not None:
                return got
            closure_cache[node] = set()     # cycle guard
            seen, _ = graph.reachable([node])
            seen.add(node)
            acc: Set[str] = set()
            for n in seen:
                acc |= acq_direct.get(n, set())
            closure_cache[node] = acc
            return acc

        def _callee_name(node: str) -> str:
            return node.split(":", 1)[-1].rsplit(".", 1)[-1]

        #: (a, b) -> (rel, line, how) first evidence
        edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        for df in defs:
            for a, b, line in df.lex_pairs:
                edges.setdefault((a, b),
                                 (df.rel, line, f"nested with in "
                                                f"{df.qual}"))
            for held, cname, line in df.calls_under:
                for target in graph.edges.get(df.node, ()):
                    if target.startswith("<external>"):
                        continue
                    if _callee_name(target) != cname:
                        continue
                    for inner in closure_acquires(target):
                        edges.setdefault(
                            (held, inner),
                            (df.rel, line,
                             f"{df.qual} calls {target} while holding "
                             f"it"))
        out: List[Finding] = []
        adj: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            if a != b:
                adj.setdefault(a, set()).add(b)
        # self-loops: re-acquiring a non-reentrant lock under itself
        for (a, b), (rel, line, how) in sorted(edges.items()):
            if a == b and pf.lock_kinds.get(a) in _NON_REENTRANT:
                out.append(Finding(
                    self.name, rel, line,
                    f"lock {a} (threading."
                    f"{pf.lock_kinds[a]}) is re-acquired under itself "
                    f"({how}) — a non-reentrant lock self-deadlocks "
                    f"here"))
        # cycles across distinct locks: DFS with path reconstruction
        reported: Set[frozenset] = set()

        def _dfs(start: str) -> Optional[List[str]]:
            stack = [(start, [start])]
            seen_local = set()
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == start:
                        return path + [start]
                    if nxt not in seen_local:
                        seen_local.add(nxt)
                        stack.append((nxt, path + [nxt]))
            return None

        for start in sorted(adj):
            cyc = _dfs(start)
            if cyc is None:
                continue
            key = frozenset(cyc)
            if key in reported:
                continue
            reported.add(key)
            rel, line, how = edges[(cyc[0], cyc[1])]
            steps = []
            for i in range(len(cyc) - 1):
                erel, eline, ehow = edges[(cyc[i], cyc[i + 1])]
                steps.append(f"{cyc[i]} -> {cyc[i + 1]} "
                             f"({erel}:{eline}, {ehow})")
            out.append(Finding(
                self.name, rel, line,
                f"lock acquisition-order cycle (potential deadlock): "
                + "; ".join(steps)))
        return out


@register
class BlockingDomainChecker(Checker):
    """Unbounded blocking reachable from handler or engine-thread
    roots — reachability form of the PR 3 bounded-blocking law."""

    name = "blocking-domain"
    description = ("unbounded wait/join/recv reachable from handler or "
                   "engine-thread domains — these threads must bound "
                   "every wait")

    #: the threads the runtime cannot afford to park forever: engine
    #: verb/apply threads (a stuck engine wedges every rank), request
    #: handlers (a stuck handler leaks server threads), and the policy
    #: daemon (a parked actuator is a silent dead-man switch)
    RESTRICTED = frozenset({"engine-shard", "apply-pool", "ops-http",
                            "replica-serve", "replica-hb", "elastic",
                            "policy"})
    #: no exempt file: the JAX package's one (its Pallas DMA semaphore
    #: waits) has no Python counterpart in the port
    ALLOW: Dict[str, str] = {}

    def check(self, pkg: PackageIndex) -> List[Finding]:
        inv = threads.inventory_for(pkg)
        pf = facts_for(pkg)
        eligible = {sf.rel for sf in self.iter_files(pkg)}
        out: List[Finding] = []
        for df in pf.defs(eligible):
            if not df.blocking:
                continue
            doms = sorted(inv.domains_of(df.node) & self.RESTRICTED)
            if not doms:
                continue
            chain = " -> ".join(inv.chain(doms[0], df.node))
            for line, what in df.blocking:
                out.append(Finding(
                    self.name, df.rel, line,
                    f"{what} in {df.qual} is reachable from the "
                    f"{', '.join(doms)} domain(s) ({chain}) — handler "
                    f"and engine threads must bound every wait (a "
                    f"per-line 'unbounded-ok' justification does not "
                    f"cover these threads)"))
        return out
