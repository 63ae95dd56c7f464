"""The four AST checkers (the call-graph one lives in collective.py).

Counterpart of ``multiverso_tpu/analysis/rules.py``: the same checkers,
with ``HOT_ZONES`` keyed to the port's engine, row ops, tables, flight
record and codec predicates.

Each rule is the machine-checked form of a convention an earlier PR
established by hand:

* ``no-bare-print`` — PR 2: all output rides the leveled logger.
* ``bounded-blocking`` — PR 3: every ``.wait()``/``.join()`` either
  takes a timeout or carries an ``unbounded-ok:`` justification.
* ``hot-path-flag-cache`` — PR 8/9: flag reads on engine verb/window/
  apply hot paths go through the listener-cached accessors
  (utils/configure.cached_*_flag), never a GetFlag registry walk.
* ``spmd-stream-guard`` — PR 10's drill lesson: verb-submitting calls
  must not sit under rank-dependent conditions; a rank-guarded verb
  diverges the SPMD lockstep verb streams and the next exchange waits
  forever.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Tuple

from multiverso_tpu_torch.analysis.callgraph import iter_top_defs
from multiverso_tpu_torch.analysis.core import (Checker, Finding,
                                                PackageIndex, SourceFile,
                                                register)


def _defs_with_quals(tree: ast.AST) -> Iterable[Tuple[str, ast.AST]]:
    """(qualname, def-node) for every top-level function and method —
    including defs under module/class-level ``if``/``try`` scaffolding;
    nested defs/lambdas stay inside their enclosing def's subtree
    (callgraph.iter_top_defs owns the granularity rule)."""
    for qual, _, node in iter_top_defs(tree):
        yield qual, node


@register
class NoBarePrintChecker(Checker):
    """AST upgrade of the PR 2 regex lint: a bare ``print(...)`` call
    anywhere in the package bypasses the leveled logger (and its
    sink/level contract). Unlike the regex, the AST form cannot be
    fooled by strings containing ``print(`` and cannot miss a call
    split across lines."""

    name = "no-bare-print"
    description = ("route output through utils/log.py or the telemetry "
                   "exporters, never bare print()")
    #: the logger's own sinks are the one legitimate print site
    ALLOW = {"utils/log.py": "the logger's own stdout/stderr sinks"}

    def check(self, pkg: PackageIndex) -> List[Finding]:
        out: List[Finding] = []
        for sf in self.iter_files(pkg):
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id == "print":
                    out.append(Finding(
                        self.name, sf.rel, node.lineno,
                        "bare print() — route output through "
                        "utils/log.py or the telemetry exporters"))
        return out


@register
class BoundedBlockingChecker(Checker):
    """AST upgrade of the PR 3 regex lint: every no-argument
    ``.wait()`` / ``.join()`` (any capitalization — the package's own
    primitives are ``Waiter.Wait`` / ``ASyncBuffer.Join``) must carry
    an ``unbounded-ok:`` justification within the 3 preceding lines.
    The AST form resolves attribute chains and multi-line calls the
    regex missed (``a.b.c.wait(\\n)``), and skips strings/comments by
    construction. A call with a positional argument or a ``timeout=``
    keyword is bounded and passes — unless every argument is a literal
    ``None`` (``t.join(None)`` / ``evt.wait(timeout=None)`` block
    forever by stdlib semantics; the spelled-out-None form is the same
    unbounded wait and needs the same justification)."""

    name = "bounded-blocking"
    description = ("no unbounded .wait()/.join() without a "
                   "timeout-capable path or an 'unbounded-ok:' "
                   "justification")
    #: the JAX package exempts its Pallas DMA semaphore waits; the port's
    #: kernels are CUDA sources, so no Python file is exempt
    ALLOW: Dict[str, str] = {}
    _BLOCKING = frozenset({"wait", "join"})
    #: how far above the call the justification may sit (legacy contract)
    JUSTIFY_WINDOW = 3

    def check(self, pkg: PackageIndex) -> List[Finding]:
        out: List[Finding] = []
        for sf in self.iter_files(pkg):
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr.lower() in self._BLOCKING):
                    continue
                bounds = [a for a in node.args
                          if not (isinstance(a, ast.Constant)
                                  and a.value is None)]
                bounds += [k for k in node.keywords
                           if not (isinstance(k.value, ast.Constant)
                                   and k.value.value is None)]
                if bounds:
                    continue        # a real bound is present —
                                    # join(None)/wait(timeout=None) is
                                    # the unbounded wait spelled out
                line = node.lineno
                lo = max(0, line - 1 - self.JUSTIFY_WINDOW)
                context = sf.lines[lo:line]
                if any("unbounded-ok:" in ln for ln in context):
                    continue
                out.append(Finding(
                    self.name, sf.rel, line,
                    f"unbounded .{node.func.attr}() — use a "
                    f"timeout-capable path or justify with "
                    f"'unbounded-ok: <why>' within "
                    f"{self.JUSTIFY_WINDOW} lines above"))
        return out


@register
class HotPathFlagCacheChecker(Checker):
    """Flag reads inside engine/verb/apply hot paths must go through
    the listener-cached accessors (``cached_*_flag``), not a
    ``GetFlag``/``HasFlag`` registry walk: the registry takes an RLock
    per read, and the PR 9 measurements put blocking verb dispatch at
    ~3k verbs/s GIL-bound — a lock per verb is real money. The hot
    zones are configured explicitly below; everything else (init,
    construction, CLI, teardown) may read the registry freely."""

    name = "hot-path-flag-cache"
    description = ("GetFlag/HasFlag inside engine/verb/apply hot paths "
                   "— use utils.configure.cached_*_flag accessors")
    _FLAG_READS = frozenset({"GetFlag", "HasFlag"})

    #: per-HOT_ZONES-entry matched-def counts from the last check() —
    #: the tier-1 baseline asserts every entry is live on the real
    #: package, so a renamed module can never silently retire a zone
    zone_hits: List[int]

    #: (module-rel regex, def-qualname regex, zone label). A def whose
    #: qualname matches in a module whose rel matches is a hot zone.
    HOT_ZONES: List[Tuple[str, str, str]] = [
        (r"^sync/server\.py$",
         r"^(?:Server|ShardedServer|SyncServer|_EngineShard)\."
         r"(?:_mh_|_pl_|_local_window|_admit|_get_entry|_add_entry|"
         r"_process_add_run|Process|Receive|receive_multi|_push_multi|"
         r"_expand_multi|_dispatch|_count_adds|_route_push|_slot_for|"
         r"_verb|_multi_entry_bsp|_get_dedup_key|_apply_delay|"
         r"_ensure_apply_pool|"
         r"_fence_entry|_fs_wrap_reply|_flight_exchanged|_note_|_ph_)",
         "engine verb/window/apply machinery"),
        (r"^sync/server\.py$",
         r"^(?:_ExchangeStage\.(?:_main|_loop|_exchange_one|_gate|"
         r"_wait_applied|feed|note_applied)|_ApplyPool\.(?:submit|_loop))",
         "pipelined exchange stage / apply pool"),
        (r"^ops/rows\.py$",
         r"^(?:gather_rows|scatter_set_rows|update_rows|"
         r"update_gather_rows|dedup_rows|scatter_add_rows|_segments|"
         r"_lengths)$",
         "row-op dispatch run per verb"),
        (r"^ops/cuda_rows\.py$",
         r"^(?:plan_rows|launch_plan|_c_plan|_sms|_vec|_count|_check|"
         r"_stream|_raise_on|gather_rows|scatter_set_rows|update_rows)",
         "row-kernel launch planning and wrappers run per verb"),
        (r"^tables/.*\.py$",
         r"\.(?:Add|Get|AddAsync|GetAsync|AddRows|GetRows|AddFireForget|"
         r"_wc_try_buffer|_gc_probe)$|\._?[Aa]pply",
         "worker verb paths (write combining, the Get cache) / server "
         "applies"),
        (r"^telemetry/flight\.py$", r"^(?:FlightRecorder\.)?record$",
         "flight record rides every verb"),
        (r"^parallel/multihost\.py$",
         r"^(?:capped_exchange|_all_gather|host_allgather_objects_capped|"
         r"merge_collective_add|sum_collective_add|host_payloads|"
         r"collective_write|device_writes|_write_wire)$",
         "the host collectives every window and collective write rides"),
        (r"^parallel/device_wire\.py$",
         r"^(?:active|DeviceWire\.(?:next_write|stage_writes|settle_writes|"
         r"gather_writes|_own_slot|_agree_sizes|_source))$",
         "the device wire's application channel rides every collective "
         "write"),
        (r"^serving/frontend\.py$",
         r"^(?:ServingFrontend\.(?:lookup_async|lookup|_loop|_drain|"
         r"_serve_guarded|_serve_batch)|LookupTicket\.(?:_fill|Wait))$",
         "serving lookups and the micro-batch dispatcher"),
        # the codec layer's enable/opt-in predicates and pack/unpack
        # entry points ride every window exchange and serve frame
        (r"^parallel/compress\.py$",
         r"^(?:enabled|lossy_opted|pack_payload|unpack_payload|"
         r"pack_window_values|materialize_window|pack_serve_rows|"
         r"decode_array)$",
         "compression codecs ride every hot byte path"),
    ]

    def check(self, pkg: PackageIndex) -> List[Finding]:
        zones = [(re.compile(m), re.compile(q), label)
                 for m, q, label in self.HOT_ZONES]
        self.zone_hits = [0] * len(zones)
        zone_files: Dict[int, str] = {}    # zone index -> first file hit
        out: List[Finding] = []
        for sf in self.iter_files(pkg):
            mine = [(zi, q, label) for zi, (m, q, label) in enumerate(zones)
                    if m.search(sf.rel)]
            if not mine:
                continue
            for zi, _, _ in mine:
                zone_files.setdefault(zi, sf.rel)
            for qual, node in _defs_with_quals(sf.tree):
                labels = []
                for zi, q, label in mine:
                    if q.search(qual):
                        labels.append(label)
                        self.zone_hits[zi] += 1
                if not labels:
                    continue
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    fn = sub.func
                    name = (fn.id if isinstance(fn, ast.Name)
                            else fn.attr if isinstance(fn, ast.Attribute)
                            else None)
                    if name in self._FLAG_READS:
                        out.append(Finding(
                            self.name, sf.rel, sub.lineno,
                            f"{name}() inside hot path {qual} "
                            f"({labels[0]}) — cache it with "
                            f"utils.configure.cached_*_flag"))
        out.extend(self._config_rot(pkg, zone_files))
        return out

    def _config_rot(self, pkg: PackageIndex,
                    zone_files: Dict[int, str]) -> List[Finding]:
        """A module matched by a zone's file pattern in which NO zone
        sharing that pattern matches any def is config rot: a wholesale
        rename of the protected classes/methods would otherwise retire
        the rule silently while the baseline stays green (the same law
        collective.py applies to its root/sink inventory). A file
        pattern matching NO file at all is the module-level form of
        the same rot (sync/server.py renamed away), anchored — like
        collective.py's — at the config source, since that is the
        file the fix edits. Grouped by file pattern so fixture trees
        that mirror a module without every one of its internals stay
        drivable; per-entry liveness on the real package is pinned by
        the tier-1 baseline via :attr:`zone_hits`."""
        by_pattern: Dict[str, List[int]] = {}
        for zi, (mpat, _, _) in enumerate(self.HOT_ZONES):
            by_pattern.setdefault(mpat, []).append(zi)
        cfg = "analysis/rules.py"
        anchor = cfg if pkg.file(cfg) is not None else None
        out: List[Finding] = []
        for mpat, zis in sorted(by_pattern.items()):
            hit_files = [zone_files[zi] for zi in zis if zi in zone_files]
            labels = ", ".join(self.HOT_ZONES[zi][2] for zi in zis)
            if not hit_files:
                # keep the path field path-shaped for annotators even
                # when the config source itself is outside the tree
                out.append(Finding(
                    self.name, anchor or "<config>", 1,
                    f"hot-zone config rot: no file matches {mpat!r} "
                    f"({labels}) — the protected module moved or was "
                    f"renamed; update HOT_ZONES or the rule is vacuous "
                    f"there"))
                continue
            if any(self.zone_hits[zi] for zi in zis):
                continue
            out.append(Finding(
                self.name, hit_files[0], 1,
                f"hot-zone config rot: no def in files matching "
                f"{mpat!r} matches any of its zone qualname patterns "
                f"({labels}) — the protected code moved; update "
                f"HOT_ZONES or the rule is vacuous here"))
        return out


@register
class SpmdStreamGuardChecker(Checker):
    """Verb-submitting calls lexically guarded by a rank-dependent
    condition: the diverged-verb-stream bug class. Every rank must
    issue the same verb stream in the same order (DESIGN.md §14's SPMD
    collective contract); ``if rank == 0: table.Add(...)`` admits a
    verb on one rank only, and the next window exchange waits out its
    full deadline (exactly how the PR 10 drill flake died). Both arms
    of a rank-guarded ``if`` are suspect — the else-branch runs on a
    rank-dependent subset too. The guard-clause spelling is the same
    bug (``if rank != 0: return`` then ``table.Add(...)``), so verbs
    downstream of a rank-dependent early exit in the same block are
    flagged too; a rank-dependent ``raise`` is NOT treated as an exit
    (an error path crashes loudly on the ranks it hits — it does not
    silently diverge the stream the way a quiet return does). In a
    boolean chain only the operands AFTER the first rank-dependent one
    are conditionally evaluated (short-circuit order), so a verb ahead
    of the rank test runs on every rank and passes. Comprehensions are
    the same law in clause order: a rank-dependent ``if`` filter (or a
    rank-dependent ``for`` iterable) makes the element expression and
    every later clause run a rank-dependent number of times, so
    ``[t.Add(d) for d in batch if rank == 0]`` is the lexical-guard
    bug in disguise — while a verb in the FIRST iterable evaluates on
    every rank before any rank clause and passes. Statement ``for``
    loops are the iteration form of the same law: a rank-dependent
    iterable (``for i in range(rank):``) runs the body a
    rank-dependent number of times; the ``else`` clause is exempt (it
    runs exactly once per rank however many iterations preceded
    it)."""

    name = "spmd-stream-guard"
    description = ("verb submissions under rank-dependent guards "
                   "diverge the SPMD verb streams")
    ALLOW = {
        # the collective transports themselves legitimately branch on
        # rank INSIDE one collective's implementation (peer segment
        # layout, master-side merge); the verb-stream law binds the
        # layers that SUBMIT verbs, not the wire that carries windows
        "parallel/multihost.py": "collective internals branch on rank",
        "parallel/shm_wire.py": "peer-indexed ring layout",
    }
    #: method names that submit verbs into the engine stream — the row
    #: and handle spellings wrap AddAsync/GetAsync and submit just the
    #: same (tables/matrix_table.py), so they are the same law
    VERB_ATTRS = frozenset({"Add", "Get", "AddAsync", "GetAsync",
                            "AddRows", "GetRows", "AddAsyncHandle",
                            "GetAsyncHandle", "AddFireForget",
                            "Barrier"})
    #: module-level verb surfaces
    VERB_NAMES = frozenset({"MV_Barrier", "MV_Aggregate",
                            "MV_PublishSnapshot", "MV_SaveCheckpoint",
                            "MV_LoadCheckpoint", "MV_MultiAdd",
                            "MV_MultiAddAsync", "MV_MultiGet",
                            "MV_MultiGetAsync", "MV_ElasticSync"})
    RANK_TOKENS = frozenset({"rank", "my_rank", "world_rank", "dist_rank",
                             "local_rank", "node_rank", "rank_id",
                             "worker_id", "server_id", "process_id",
                             "process_index", "MV_Rank", "MV_WorkerId",
                             "MV_ServerId"})

    def _rank_dependent(self, test: ast.AST) -> bool:
        for node in ast.walk(test):
            if isinstance(node, ast.Name) and node.id in self.RANK_TOKENS:
                return True
            if isinstance(node, ast.Attribute) \
                    and node.attr in self.RANK_TOKENS:
                return True
        return False

    def _verb_calls(self, nodes) -> Iterable[ast.Call]:
        for root in nodes:
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if isinstance(fn, ast.Attribute) \
                        and fn.attr in self.VERB_ATTRS:
                    yield node
                elif isinstance(fn, ast.Name) \
                        and fn.id in self.VERB_NAMES:
                    yield node

    #: statements that quietly leave the block (``raise`` is excluded:
    #: error paths fail loudly rather than diverging the stream)
    _EXITS = (ast.Return, ast.Continue, ast.Break)

    def _block_exits(self, stmts) -> bool:
        return any(isinstance(s, self._EXITS) for s in stmts)

    def _guard_tails(self, stmts) -> Iterable[Tuple[int, list]]:
        """(guard_line, trailing_stmts) for each rank-dependent guard
        clause: an ``if`` whose one arm quietly exits the block while
        the other falls through, making everything after it run on a
        rank-dependent subset. Both-arms-exit is dead tail for every
        rank (no divergence); neither-arm-exits falls through on every
        rank (the in-body handling already covers the arms)."""
        for i, st in enumerate(stmts):
            if isinstance(st, ast.If) and self._rank_dependent(st.test) \
                    and self._block_exits(st.body) \
                    != self._block_exits(st.orelse):
                yield st.lineno, stmts[i + 1:]

    def check(self, pkg: PackageIndex) -> List[Finding]:
        # nested/stacked rank guards reach the same call node from
        # several ancestors — one violation must count once, keyed on
        # the call itself (line alone would collapse DISTINCT calls
        # sharing a line, e.g. both arms of a ternary). ast.walk
        # visits outer guards first, so the surviving finding names
        # the outermost guard — the one to fix.
        seen = set()
        out: List[Finding] = []

        def emit(sf, call, guard_line):
            key = (sf.rel, call.lineno, call.col_offset)
            if key not in seen:
                seen.add(key)
                out.append(self._finding(sf, call, guard_line))

        for sf in self.iter_files(pkg):
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.If, ast.While)):
                    if not self._rank_dependent(node.test):
                        continue
                    guarded = list(node.body)
                    if isinstance(node, ast.If):
                        guarded += node.orelse
                    for call in self._verb_calls(guarded):
                        emit(sf, call, node.lineno)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    # rank-dependent iteration count; else-clause
                    # exempt (runs once per rank regardless)
                    if not self._rank_dependent(node.iter):
                        continue
                    for call in self._verb_calls(node.body):
                        emit(sf, call, node.lineno)
                elif isinstance(node, ast.IfExp):
                    if not self._rank_dependent(node.test):
                        continue
                    for call in self._verb_calls([node.body, node.orelse]):
                        emit(sf, call, node.lineno)
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.DictComp, ast.GeneratorExp)):
                    # clauses evaluate left-to-right (gen0.iter,
                    # gen0.ifs, gen1.iter, ...) with the element
                    # innermost-last, so everything after the first
                    # rank-dependent clause runs a rank-dependent
                    # number of times
                    clauses = []
                    for gen in node.generators:
                        clauses.append(gen.iter)
                        clauses.extend(gen.ifs)
                    first = next((i for i, c in enumerate(clauses)
                                  if self._rank_dependent(c)), None)
                    if first is None:
                        continue
                    elts = ([node.key, node.value]
                            if isinstance(node, ast.DictComp)
                            else [node.elt])
                    for call in self._verb_calls(clauses[first + 1:]
                                                 + elts):
                        emit(sf, call, node.lineno)
                elif isinstance(node, ast.BoolOp):
                    # short-circuit order: operands BEFORE the first
                    # rank-dependent one evaluate on every rank
                    first = next((i for i, v in enumerate(node.values)
                                  if self._rank_dependent(v)), None)
                    if first is None:
                        continue
                    for call in self._verb_calls(node.values[first + 1:]):
                        emit(sf, call, node.lineno)
            for block in self._stmt_blocks(sf.tree):
                for guard_line, tail in self._guard_tails(block):
                    for call in self._verb_calls(tail):
                        emit(sf, call, guard_line)
        return out

    @staticmethod
    def _stmt_blocks(tree: ast.AST) -> Iterable[list]:
        for node in ast.walk(tree):
            for fld in ("body", "orelse", "finalbody"):
                block = getattr(node, fld, None)
                if isinstance(block, list) and block:
                    yield block

    def _finding(self, sf: SourceFile, call: ast.Call,
                 guard_line: int) -> Finding:
        fn = call.func
        what = (fn.attr if isinstance(fn, ast.Attribute) else fn.id)
        return Finding(
            self.name, sf.rel, call.lineno,
            f"verb-submitting call {what}() under the rank-dependent "
            f"guard at line {guard_line} — every rank must issue the "
            f"same verb stream (diverged streams deadlock the next "
            f"window exchange)")
