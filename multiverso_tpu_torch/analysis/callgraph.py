"""Package-wide static call graph for the never-collective checker.

Counterpart of ``multiverso_tpu/analysis/callgraph.py``: the same
resolution and the same honesty bounds. Only
:data:`EXTERNAL_COLLECTIVE_ATTRS` is keyed to the port, which issues its
collectives through ``torch.distributed``.

Construction (and its honesty bounds, DESIGN.md §16): one AST pass per
module collects defs, classes (with in-package base resolution) and
import aliases; a second pass turns every call / callable reference in
every top-level def into edges. Resolution, strongest first:

1. dotted module chains through import aliases (``multihost.host_barrier``),
   following ``from X import f`` re-exports transitively;
2. ``self.``/``cls.`` methods through the class's in-package MRO;
3. ``ClassName.m`` / ``ClassName(...).m`` / local ``x = ClassName(...)``
   one-pass constructor type inference;
4. anything else that is still a method call falls back to EVERY
   in-package method of that name (dynamic-dispatch over-approximation —
   a path through a fallback edge can be a false positive, never a
   silently missed true one);
5. bare-name calls resolve through local defs and ``from``-imports only;
   an unresolved bare name (builtins, stdlib) drops out of the graph.

Lambdas and nested defs merge into their enclosing top-level def, so
``bounded(lambda: capped_exchange(...))`` correctly charges the caller.
Defs under module/class-level ``if``/``try``/``with`` scaffolding (the
version-shim idiom — parallel/mesh.py's ``shard_map``) are top-level
definitions too (:func:`flat_body`), not module code.
Non-call references to resolvable functions (callbacks passed by name)
also produce edges. What the graph cannot see: getattr-by-string,
property getters that do work, and calls that cross an actor mailbox
(a ``msg.reply``/queue hop ends the static chain — by design: the verb
stream discipline is about which THREAD issues a collective).

Node ids are ``"<rel>:<qualname>"`` (``zoo.py:Zoo._barrier_wait``,
``parallel/multihost.py:capped_exchange``, ``<module>`` for top-level
code). Calls to well-known external collective attributes (``all_gather``,
``barrier``...) produce ``<external>:<name>`` sink nodes.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from multiverso_tpu_torch.analysis.core import PackageIndex, SourceFile

#: attribute names that are collective primitives wherever they resolve:
#: the ``torch.distributed`` calls every rank of a group must enter
#: (the port's own ``parallel/multihost.py`` calls ``all_gather``,
#: ``barrier`` and ``new_group``; the rest are the surfaces it may grow
#: calls to), plus the rendezvous spelling of ``parallel/allreduce.py``.
#: ``gather``/``scatter``/``send``/``recv`` stay out: ``torch.gather``
#: and the socket calls share those names.
EXTERNAL_COLLECTIVE_ATTRS = frozenset({
    "all_reduce", "all_gather", "all_gather_object",
    "all_gather_into_tensor", "all_to_all", "all_to_all_single",
    "allreduce", "allgather", "alltoall", "barrier", "broadcast",
    "broadcast_object_list", "monitored_barrier", "new_group",
    "init_process_group", "reduce_scatter", "reduce_scatter_tensor",
})

_MODULE_NODE = "<module>"

#: method names that collide with builtin container/string/IO/threading
#: methods. An UNRESOLVED receiver calling one of these is almost always
#: a dict/list/file/lock — fanning out to every same-named package
#: method would wire `snap.get(...)` into MatrixTableHandler.get and
#: drown the graph in false paths. Such names resolve only through
#: typed receivers (self/cls, class names, constructor inference,
#: module attributes) — a documented honesty bound, DESIGN.md §16. The
#: package's own verb surfaces are capitalized (Add/Get/Wait/Join), so
#: the lowercase exclusions cost little.
_COMMON_METHOD_NAMES = frozenset({
    "get", "set", "add", "pop", "append", "extend", "insert", "remove",
    "discard", "clear", "copy", "update", "keys", "values", "items",
    "setdefault", "popitem", "sort", "reverse", "index", "count",
    "join", "split", "rsplit", "partition", "strip", "lstrip", "rstrip",
    "lower", "upper", "title", "format", "replace", "startswith",
    "endswith", "encode", "decode", "read", "readline", "readlines",
    "write", "writelines", "flush", "close", "open", "seek", "tell",
    "send", "recv", "put", "get_nowait", "put_nowait", "run", "start",
    "stop", "wait", "notify", "notify_all", "acquire", "release",
    "submit", "result", "cancel", "done", "shutdown", "connect",
    "bind", "listen", "accept", "fileno", "terminate", "kill", "poll",
    "communicate", "tobytes", "tolist", "item", "reshape", "astype",
    "mean", "sum", "max", "min", "all", "any", "group", "match",
    "search", "findall", "sub", "finditer", "fullmatch",
})


def walk_shallow(node: ast.AST):
    """ast.walk that does NOT descend into nested defs/lambdas — for
    passes where a nested callback's statements must not masquerade as
    the enclosing def's (e.g. a nested ``return Worker()`` is not the
    outer function's return value)."""
    stack = list(_shallow_children(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            stack.extend(_shallow_children(n))


def _shallow_children(node: ast.AST):
    for child in ast.iter_child_nodes(node):
        yield child


def iter_top_defs(tree: ast.AST):
    """(qualname, owning ClassDef or None, def node) for every
    top-level function and method — the ONE place that owns the
    graph-node granularity rule (flat_body guard flattening; nested
    defs/lambdas merge into the enclosing def)."""
    for node in flat_body(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, None, node
        elif isinstance(node, ast.ClassDef):
            for sub in flat_body(node.body):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", node, sub


def flat_body(body) -> "list":
    """Module/class-body statements with conditional/guard scaffolding
    flattened: a def under a module-level ``if``/``try``/``with`` (the
    version-shim and optional-dependency-fallback idioms —
    parallel/mesh.py's ``shard_map`` shim is the in-package example) is
    still a top-level definition for graph purposes. The guard's own
    expressions (``if`` tests, ``except`` types, ``with`` context
    expressions) are yielded too, so module-level guard code keeps its
    edges. Does NOT descend into defs/lambdas — nested defs stay merged
    into their enclosing def."""
    out = []
    for node in body:
        if isinstance(node, ast.If):
            out.append(node.test)
            out.extend(flat_body(node.body))
            out.extend(flat_body(node.orelse))
        elif isinstance(node, ast.Try):
            out.extend(flat_body(node.body))
            for h in node.handlers:
                if h.type is not None:
                    out.append(h.type)
                out.extend(flat_body(h.body))
            out.extend(flat_body(node.orelse))
            out.extend(flat_body(node.finalbody))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                out.append(item.context_expr)
            out.extend(flat_body(node.body))
        else:
            out.append(node)
    return out


@dataclass
class ClassInfo:
    name: str
    rel: str
    bases: List[Tuple[str, str]] = field(default_factory=list)  # (rel, name)
    methods: Dict[str, int] = field(default_factory=dict)       # name -> line
    #: instance-attribute types inferred from ``self.X = ClassName(...)``
    #: assignments in any method; a conflicting re-assignment poisons
    #: the entry (None) so a wrong type never resolves a chain
    attr_types: Dict[str, Optional[Tuple[str, str]]] = \
        field(default_factory=dict)


@dataclass
class ModuleInfo:
    rel: str
    dotted: str
    sf: SourceFile
    functions: Dict[str, int] = field(default_factory=dict)     # qual -> line
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    #: local name -> ("mod", rel) | ("sym", rel, name)
    imports: Dict[str, tuple] = field(default_factory=dict)


class CallGraph:
    def __init__(self, pkg: PackageIndex):
        self.pkg = pkg
        self.pkg_name = os.path.basename(pkg.root)
        self.modules: Dict[str, ModuleInfo] = {}
        self.dotted: Dict[str, str] = {}            # dotted -> rel
        self.edges: Dict[str, Set[str]] = {}
        self.node_lines: Dict[str, Tuple[str, int]] = {}  # node -> (rel, line)
        #: method name -> every "<rel>:<Class.m>" node (fallback targets)
        self.methods_by_name: Dict[str, Set[str]] = {}
        #: def node -> the in-package class its calls return
        self.ret_types: Dict[str, Tuple[str, str]] = {}
        self.stats = {"calls": 0, "resolved": 0, "fallback": 0,
                      "dropped": 0}
        self._build()

    # ---------------------------------------------------------- building

    def _build(self) -> None:
        for sf in self.pkg.files:
            if sf.tree is None:
                continue
            rel = sf.rel
            parts = rel[:-3].split("/")     # strip .py
            if parts[-1] == "__init__":
                parts = parts[:-1]
            dotted = ".".join([self.pkg_name] + parts)
            mi = ModuleInfo(rel=rel, dotted=dotted, sf=sf)
            self.modules[rel] = mi
            self.dotted[dotted] = rel
        for mi in self.modules.values():
            self._collect_defs(mi)
        for mi in self.modules.values():
            self._collect_imports(mi)
        # base-class names resolve only after every module's defs exist
        for mi in self.modules.values():
            self._resolve_bases(mi)
        # return types feed attr types (self.x = factory()) which feed
        # the edge pass — strict order
        for mi in self.modules.values():
            self._infer_return_types(mi)
        for mi in self.modules.values():
            self._infer_attr_types(mi)
        for mi in self.modules.values():
            self._collect_edges(mi)

    def _collect_defs(self, mi: ModuleInfo) -> None:
        for node in flat_body(mi.sf.tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mi.functions[node.name] = node.lineno
            elif isinstance(node, ast.ClassDef):
                ci = ClassInfo(name=node.name, rel=mi.rel)
                mi.classes[node.name] = ci
                for sub in flat_body(node.body):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        ci.methods[sub.name] = sub.lineno
                        qual = f"{node.name}.{sub.name}"
                        mi.functions[qual] = sub.lineno
                        nid = f"{mi.rel}:{qual}"
                        self.methods_by_name.setdefault(
                            sub.name, set()).add(nid)
        for qual, line in mi.functions.items():
            self.node_lines[f"{mi.rel}:{qual}"] = (mi.rel, line)
        self.node_lines[f"{mi.rel}:{_MODULE_NODE}"] = (mi.rel, 1)

    def _collect_imports(self, mi: ModuleInfo) -> None:
        pkg_prefix = self.pkg_name + "."
        for node in ast.walk(mi.sf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.name
                    if name != self.pkg_name \
                            and not name.startswith(pkg_prefix):
                        # external module: record it (with its dotted
                        # origin) so attribute calls on it
                        # (subprocess.run, np.sum) resolve to
                        # "external" and DON'T hit the method-name
                        # fallback — stdlib receivers must not fan out
                        # to every same-named package method
                        local = alias.asname or name.split(".")[0]
                        mi.imports.setdefault(local, ("ext", name))
                        continue
                    rel = self._dotted_rel(name)
                    if rel is None:
                        continue
                    if alias.asname:
                        mi.imports[alias.asname] = ("mod", rel)
                    else:
                        # "import a.b.c" binds "a"; chains walk down
                        root_rel = self._dotted_rel(name.split(".")[0])
                        if root_rel is not None:
                            mi.imports[name.split(".")[0]] = \
                                ("mod", root_rel)
            elif isinstance(node, ast.ImportFrom):
                target = self._from_target(mi, node)
                if target is None:
                    if node.level == 0:
                        # external from-import: the external marker
                        # keeps the source module AND original symbol
                        # name, so an aliased `from threading import
                        # Thread as Worker` still reads as a spawn
                        for alias in node.names:
                            mi.imports.setdefault(
                                alias.asname or alias.name,
                                ("ext", node.module or "", alias.name))
                    continue
                for alias in node.names:
                    local = alias.asname or alias.name
                    sub_rel = self._dotted_rel(
                        f"{target}.{alias.name}")
                    if sub_rel is not None:
                        mi.imports[local] = ("mod", sub_rel)
                    else:
                        rel = self._dotted_rel(target)
                        if rel is not None:
                            mi.imports[local] = ("sym", rel, alias.name)

    def _from_target(self, mi: ModuleInfo,
                     node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            mod = node.module or ""
            if mod == self.pkg_name or mod.startswith(self.pkg_name + "."):
                return mod
            return None
        # relative import: climb from this module's dotted package
        base = mi.dotted.split(".")
        if not mi.rel.endswith("__init__.py"):
            base = base[:-1]
        climb = node.level - 1
        if climb > len(base):
            return None
        base = base[: len(base) - climb] if climb else base
        return ".".join(base + ([node.module] if node.module else []))

    def _dotted_rel(self, dotted: str) -> Optional[str]:
        return self.dotted.get(dotted)

    def _resolve_bases(self, mi: ModuleInfo) -> None:
        for node in flat_body(mi.sf.tree.body):
            if not isinstance(node, ast.ClassDef):
                continue
            ci = mi.classes[node.name]
            for b in node.bases:
                ref = self._lookup_class(mi, b)
                if ref is not None:
                    ci.bases.append(ref)

    def _ann_class(self, mi: ModuleInfo,
                   ann: Optional[ast.AST]) -> Optional[Tuple[str, str]]:
        """Resolve a return annotation to an in-package class:
        ``-> Monitor``, ``-> "Monitor"`` (forward ref),
        ``-> Optional[KvIndex]`` / ``-> KvIndex | None`` unwrap."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return self._class_by_name(mi, ann.value)
        if isinstance(ann, ast.Name):
            return self._class_by_name(mi, ann.id)
        if isinstance(ann, ast.Attribute):
            return self._lookup_class(mi, ann)
        if isinstance(ann, ast.Subscript):
            # Optional[X]: unwrap; other generics (List[X]...) are NOT
            # the instance itself — skip them
            base = ann.value
            name = (base.id if isinstance(base, ast.Name)
                    else base.attr if isinstance(base, ast.Attribute)
                    else None)
            if name == "Optional":
                return self._ann_class(mi, ann.slice)
            return None
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            left = self._ann_class(mi, ann.left)
            if left is not None:
                return left
            return self._ann_class(mi, ann.right)
        return None

    def _infer_return_types(self, mi: ModuleInfo) -> None:
        """Factory-return inference: a def whose return ANNOTATION
        names an in-package class (Optional unwrapped), or whose every
        class-typed ``return`` agrees on one class (directly or through
        a ``x = ClassName(...)`` local), types its call results — so
        ``mon = Dashboard.Get(name)`` resolves ``mon.Add`` through the
        real Monitor instead of the dynamic-dispatch fallback."""
        def _infer(qual: str, node: ast.AST) -> None:
            cref = self._ann_class(mi, node.returns)
            if cref is None:
                # SHALLOW walks: a nested callback's assignments and
                # returns are not the enclosing def's (a nested
                # `return Worker()` must not type the outer call)
                local_types: Dict[str, Tuple[str, str]] = {}
                for sub in walk_shallow(node):
                    if isinstance(sub, ast.Assign) \
                            and isinstance(sub.value, ast.Call) \
                            and isinstance(sub.value.func, ast.Name):
                        c = self._class_by_name(mi, sub.value.func.id)
                        if c is not None:
                            for tgt in sub.targets:
                                if isinstance(tgt, ast.Name):
                                    local_types[tgt.id] = c
                seen: set = set()
                for sub in walk_shallow(node):
                    if not isinstance(sub, ast.Return) \
                            or sub.value is None:
                        continue
                    v = sub.value
                    if isinstance(v, ast.Call) \
                            and isinstance(v.func, ast.Name):
                        seen.add(self._class_by_name(mi, v.func.id))
                    elif isinstance(v, ast.Name):
                        seen.add(local_types.get(v.id))
                    elif isinstance(v, ast.Constant) and v.value is None:
                        continue
                    else:
                        seen.add(None)
                if len(seen) == 1:
                    cref = seen.pop()
            if cref is not None:
                self.ret_types[f"{mi.rel}:{qual}"] = cref

        for qual, _, node in iter_top_defs(mi.sf.tree):
            _infer(qual, node)

    def _call_result_type(self, mi: ModuleInfo, call: ast.Call,
                          local_types=None, own_class=None
                          ) -> Optional[Tuple[str, str]]:
        """The in-package class a call returns: a constructor call, or
        a call to a def with an inferred return type."""
        fn = call.func
        if isinstance(fn, ast.Name):
            cref = self._class_by_name(mi, fn.id)
            if cref is not None:
                return cref
            state = self._resolve_symbol(mi.rel, fn.id)
        elif isinstance(fn, ast.Attribute):
            chain = _attr_chain(fn)
            if chain is None:
                return None
            state = self._chain_resolve(mi, chain, local_types, own_class)
        else:
            return None
        if state is not None and state[0] == "class":
            return (state[1], state[2])
        if state is not None and state[0] == "func":
            return self.ret_types.get(f"{state[1]}:{state[2]}")
        return None

    def _infer_attr_types(self, mi: ModuleInfo) -> None:
        """One-pass instance-attribute type inference:
        ``self.X = ClassName(...)`` (or ``mod.ClassName(...)``) in ANY
        method types attribute ``X`` for the class, so later chains
        (``self.store.get(...)``) resolve through the real class
        instead of dropping to the dynamic-dispatch name fallback.
        Conflicting re-assignments poison the entry — a wrong type must
        never resolve a chain."""
        for _, cls_node, sub in iter_top_defs(mi.sf.tree):
            if cls_node is None:
                continue
            ci = mi.classes[cls_node.name]
            for st in ast.walk(sub):
                if not (isinstance(st, ast.Assign)
                        and isinstance(st.value, ast.Call)):
                    continue
                cref = self._call_result_type(mi, st.value)
                for tgt in st.targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    attr = tgt.attr
                    if attr in ci.attr_types:
                        if ci.attr_types[attr] != cref:
                            ci.attr_types[attr] = None  # conflict
                    else:
                        ci.attr_types[attr] = cref

    def _mro_attr_type(self, rel: str, cname: str, attr: str,
                       _seen=None) -> Optional[Tuple[str, str]]:
        seen = _seen or set()
        if (rel, cname) in seen:
            return None
        seen.add((rel, cname))
        mi = self.modules.get(rel)
        if mi is None or cname not in mi.classes:
            return None
        ci = mi.classes[cname]
        if attr in ci.attr_types:
            return ci.attr_types[attr]
        for brel, bname in ci.bases:
            got = self._mro_attr_type(brel, bname, attr, seen)
            if got is not None:
                return got
        return None

    def _lookup_class(self, mi: ModuleInfo,
                      expr: ast.AST) -> Optional[Tuple[str, str]]:
        """Resolve a base-class expression to an in-package (rel, name)."""
        if isinstance(expr, ast.Name):
            return self._class_by_name(mi, expr.id)
        if isinstance(expr, ast.Attribute):
            chain = _attr_chain(expr)
            if chain is None:
                return None
            state = self._chain_resolve(mi, chain)
            if state is not None and state[0] == "class":
                return (state[1], state[2])
        return None

    def _class_by_name(self, mi: ModuleInfo,
                       name: str, _seen=None) -> Optional[Tuple[str, str]]:
        if name in mi.classes:
            return (mi.rel, name)
        imp = mi.imports.get(name)
        if imp is None:
            return None
        if imp[0] == "sym":
            tgt = self.modules.get(imp[1])
            if tgt is None:
                return None
            seen = _seen or set()
            if (imp[1], imp[2]) in seen:
                return None
            seen.add((imp[1], imp[2]))
            return self._class_by_name(tgt, imp[2], seen)
        return None

    # ------------------------------------------------------ symbol lookup

    def _resolve_symbol(self, rel: str, name: str,
                        _seen=None) -> Optional[tuple]:
        """Resolve ``name`` inside module ``rel`` to
        ("func", rel, qual) | ("class", rel, cname) | ("mod", rel)."""
        mi = self.modules.get(rel)
        if mi is None:
            return None
        if name in mi.classes:
            return ("class", rel, name)
        if name in mi.functions and "." not in name:
            return ("func", rel, name)
        imp = mi.imports.get(name)
        if imp is None:
            return None
        if imp[0] == "ext":
            return imp      # carries (module, origin-symbol) when known
        if imp[0] == "mod":
            return ("mod", imp[1])
        seen = _seen or set()
        if (imp[1], imp[2]) in seen:
            return None
        seen.add((imp[1], imp[2]))
        return self._resolve_symbol(imp[1], imp[2], seen)

    def _chain_resolve(self, mi: ModuleInfo, chain: List[str],
                       local_types: Optional[Dict[str, Tuple[str, str]]]
                       = None,
                       own_class: Optional[ClassInfo] = None
                       ) -> Optional[tuple]:
        """Walk a dotted name chain to a ("func"|"class"|"mod") state."""
        head, rest = chain[0], chain[1:]
        state: Optional[tuple]
        if head in ("self", "cls") and own_class is not None:
            state = ("class", own_class.rel, own_class.name)
        elif local_types and head in local_types:
            crel, cname = local_types[head]
            state = ("class", crel, cname)
        else:
            state = self._resolve_symbol(mi.rel, head)
        for part in rest:
            if state is None:
                return None
            kind = state[0]
            if kind == "ext":
                continue        # external chains stay external
            if kind == "mod":
                sub = self.modules.get(state[1])
                if sub is None:
                    return None
                nxt = self._dotted_rel(f"{sub.dotted}.{part}")
                if nxt is not None:
                    state = ("mod", nxt)
                else:
                    state = self._resolve_symbol(state[1], part)
            elif kind == "class":
                m = self._mro_method(state[1], state[2], part)
                if m is None:
                    # not a method: a typed instance attribute keeps
                    # the chain resolving (self.store.get -> the real
                    # SnapshotStore.get, not the name fallback)
                    at = self._mro_attr_type(state[1], state[2], part)
                    m = ("class", at[0], at[1]) if at is not None \
                        else None
                state = m           # ("func", rel, Class.m) or None
            else:
                return None         # attribute of a function: opaque
        return state

    def _mro_method(self, rel: str, cname: str, method: str,
                    _seen=None) -> Optional[tuple]:
        seen = _seen or set()
        if (rel, cname) in seen:
            return None
        seen.add((rel, cname))
        mi = self.modules.get(rel)
        if mi is None or cname not in mi.classes:
            return None
        ci = mi.classes[cname]
        if method in ci.methods:
            return ("func", rel, f"{cname}.{method}")
        for brel, bname in ci.bases:
            got = self._mro_method(brel, bname, method, seen)
            if got is not None:
                return got
        return None

    # ---------------------------------------------------------- edge pass

    def _collect_edges(self, mi: ModuleInfo) -> None:
        mod_owner = f"{mi.rel}:{_MODULE_NODE}"
        for node in flat_body(mi.sf.tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._edges_for_def(mi, f"{mi.rel}:{node.name}", node, None)
            elif isinstance(node, ast.ClassDef):
                ci = mi.classes[node.name]
                for sub in flat_body(node.body):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        owner = f"{mi.rel}:{node.name}.{sub.name}"
                        self._edges_for_def(mi, owner, sub, ci)
            else:
                # everything else (incl. flattened guard expressions)
                # is module-level code
                self._edges_for_def(mi, mod_owner, node, None)

    def spawn_kind(self, rel: str, call: ast.Call) -> Optional[str]:
        """"Thread"/"Timer" when ``call`` constructs an EXTERNAL
        (threading) Thread/Timer — in-package classes sharing the name
        (the utils Timer stopwatch) resolve through the import table
        and return None, and an ALIASED from-import (``from threading
        import Thread as Worker``) still reads as a spawn through the
        import record's origin symbol."""
        fn = call.func
        if isinstance(fn, ast.Name):
            state = self._resolve_symbol(rel, fn.id)
            if state is not None and state[0] == "ext" \
                    and len(state) >= 3 and state[1] == "threading" \
                    and state[2] in ("Thread", "Timer"):
                return state[2]
            if fn.id in ("Thread", "Timer") \
                    and (state is None or state[0] == "ext"):
                return fn.id
            return None
        if isinstance(fn, ast.Attribute) and fn.attr in ("Thread",
                                                         "Timer"):
            chain = _attr_chain(fn)
            if chain is None:
                return None
            state = self._resolve_symbol(rel, chain[0])
            if state is None or state[0] == "ext":
                return fn.attr
        return None

    def _edges_for_def(self, mi: ModuleInfo, owner: str, root: ast.AST,
                       own_class: Optional[ClassInfo]) -> None:
        local_types: Dict[str, Tuple[str, str]] = {}
        # pass 1: one-shot constructor type inference (x = ClassName(...))
        # plus the THREAD-BOUNDARY CUT: the target= callback of a
        # threading.Thread/Timer spawn (and every RegisterHandler
        # argument) runs on the NEW/actor thread, not this one — like
        # a mailbox hop, the static chain must end at the spawn (the
        # thread inventory classifies the target's domain explicitly).
        # The cut covers the callback expression's WHOLE subtree, so a
        # lambda or functools.partial wrapper is cut too, not just a
        # bare name/attribute ref. Without the cut, every spawner's
        # domain swallows its spawned thread's closure.
        spawn_callbacks: set = set()

        def _cut(expr: ast.AST) -> None:
            spawn_callbacks.update(ast.walk(expr))

        for node in ast.walk(root):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                cref = self._call_result_type(mi, node.value,
                                              local_types, own_class)
                if cref is not None:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            local_types[tgt.id] = cref
            if not isinstance(node, ast.Call):
                continue
            kind = self.spawn_kind(mi.rel, node)
            if kind is not None:
                for kw in node.keywords:
                    if kw.arg in ("target", "function"):
                        _cut(kw.value)
                if len(node.args) >= 2:
                    # positional callbacks: Thread(group, target, ...)
                    # and Timer(interval, function, ...) both carry the
                    # callable at args[1]; args[0] evaluates on THIS
                    # thread and keeps its edges
                    _cut(node.args[1])
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "RegisterHandler":
                for arg in node.args:
                    _cut(arg)
                for kw in node.keywords:
                    _cut(kw.value)
        # pass 2: calls + callable references
        for node in ast.walk(root):
            if node in spawn_callbacks:
                continue
            if isinstance(node, ast.Call):
                self._edge_for_call(mi, owner, node, local_types, own_class)
            elif isinstance(node, (ast.Name, ast.Attribute)) \
                    and isinstance(getattr(node, "ctx", None), ast.Load):
                self._edge_for_ref(mi, owner, node, local_types, own_class)

    def _add_edge(self, owner: str, target: str) -> None:
        self.edges.setdefault(owner, set()).add(target)

    def _edge_for_call(self, mi: ModuleInfo, owner: str, call: ast.Call,
                       local_types, own_class) -> None:
        self.stats["calls"] += 1
        func = call.func
        if isinstance(func, ast.Name):
            state = self._resolve_symbol(mi.rel, func.id)
            if (state is None or state[0] == "ext") \
                    and func.id in EXTERNAL_COLLECTIVE_ATTRS:
                # `from torch.distributed import all_gather`
                # then a bare-name call: still a collective sink — an
                # in-package def of the same name resolves first and
                # wins (its body is scanned instead)
                self._add_edge(owner, f"<external>:{func.id}")
                self.stats["resolved"] += 1
                return
            self._edge_for_state(owner, state, mi)
            return
        if isinstance(func, ast.Attribute):
            attr = func.attr
            chain = _attr_chain(func)
            state = None
            if chain is not None:
                state = self._chain_resolve(mi, chain, local_types,
                                            own_class)
            elif isinstance(func.value, ast.Call) \
                    and isinstance(func.value.func, ast.Name):
                if func.value.func.id == "super" \
                        and own_class is not None:
                    # super().m(...): resolve through the bases only —
                    # without this, super().ProcessGet used to take the
                    # name fallback and wire the caller into EVERY
                    # table's ProcessGet
                    for brel, bname in own_class.bases:
                        state = self._mro_method(brel, bname, attr)
                        if state is not None:
                            break
                else:
                    # ClassName(...).method(...) — or a typed factory
                    # call result
                    cref = self._class_by_name(mi, func.value.func.id)
                    if cref is None:
                        cref = self._call_result_type(
                            mi, func.value, local_types, own_class)
                    if cref is not None:
                        state = self._mro_method(cref[0], cref[1], attr)
            if state is not None and state[0] != "ext":
                self._edge_for_state(owner, state, mi)
                return
            if attr in EXTERNAL_COLLECTIVE_ATTRS:
                self._add_edge(owner, f"<external>:{attr}")
                self.stats["resolved"] += 1
                return
            if state is not None:       # ("ext",): known-external receiver
                self.stats["dropped"] += 1
                return
            targets = self.methods_by_name.get(attr)
            if targets and not attr.startswith("__") \
                    and attr not in _COMMON_METHOD_NAMES:
                self.stats["fallback"] += 1
                for t in targets:
                    self._add_edge(owner, t)
            else:
                self.stats["dropped"] += 1

    def _edge_for_state(self, owner: str, state: Optional[tuple],
                        mi: ModuleInfo) -> None:
        if state is None:
            self.stats["dropped"] += 1
            return
        kind = state[0]
        if kind == "func":
            self.stats["resolved"] += 1
            self._add_edge(owner, f"{state[1]}:{state[2]}")
        elif kind == "class":
            init = self._mro_method(state[1], state[2], "__init__")
            self.stats["resolved"] += 1
            if init is not None:
                self._add_edge(owner, f"{init[1]}:{init[2]}")
        else:
            self.stats["dropped"] += 1

    def _edge_for_ref(self, mi: ModuleInfo, owner: str, node: ast.AST,
                      local_types, own_class) -> None:
        """Callback references: a bare/dotted name resolving to an
        in-package function creates an edge even without a call."""
        if isinstance(node, ast.Name):
            state = self._resolve_symbol(mi.rel, node.id)
        else:
            chain = _attr_chain(node)
            if chain is None:
                return
            state = self._chain_resolve(mi, chain, local_types, own_class)
        if state is not None and state[0] == "func":
            self._add_edge(owner, f"{state[1]}:{state[2]}")

    # ------------------------------------------------------- reachability

    def reachable(self, roots: List[str]
                  ) -> Tuple[Set[str], Dict[str, str]]:
        """BFS closure + parent map (for path reconstruction)."""
        seen: Set[str] = set()
        parent: Dict[str, str] = {}
        frontier = [r for r in roots if r in self.node_lines
                    or r in self.edges]
        seen.update(frontier)
        while frontier:
            nxt = []
            for n in frontier:
                for t in self.edges.get(n, ()):
                    if t not in seen:
                        seen.add(t)
                        parent[t] = n
                        nxt.append(t)
            frontier = nxt
        return seen, parent

    def path_to(self, parent: Dict[str, str], node: str) -> List[str]:
        out = [node]
        while node in parent:
            node = parent[node]
            out.append(node)
        return list(reversed(out))

    def has_node(self, node: str) -> bool:
        return node in self.node_lines


def _attr_chain(node: ast.Attribute) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None when the chain root is not a
    plain name (subscripts, calls, literals)."""
    parts = [node.attr]
    cur = node.value
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return list(reversed(parts))
    return None


_GRAPH_CACHE: Dict[str, CallGraph] = {}


def build_graph(pkg: PackageIndex) -> CallGraph:
    g = _GRAPH_CACHE.get(pkg.root)
    if g is None or g.pkg is not pkg:
        g = _GRAPH_CACHE[pkg.root] = CallGraph(pkg)
    return g
