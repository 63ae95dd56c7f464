"""Thread-root inventory: every thread this package spawns, classified
into named concurrency DOMAINS (docs/DESIGN.md §18).

Counterpart of ``multiverso_tpu/analysis/threads.py``: the same
inventory law, with :data:`INVENTORY` keyed to the port's spawns.

The runtime outgrew the reference's one-thread-per-actor story: engine
shard actors, the pipelined exchange stage, a parallel apply pool, the
watchdog/reporter samplers, ops HTTP handlers, the serving dispatcher,
the tcp wire's accept loop, the bounded-call runner, chaos timers and
the apps' loader threads all share state. Every cross-thread law the
repo enforces (probe-never-syncs-mirror, handler-never-RPC, bounded
blocking) needs ONE ground truth for "which code runs on which
thread" — this module is that inventory, and the checkers in
:mod:`concurrency` consume it.

A DOMAIN is a named family of threads with one spawn discipline (all
engine shard loops are one domain; every ops HTTP connection thread is
one domain). Domain membership of a function = BFS reachability from
any of the domain's configured root nodes over the static call graph.
The same honesty bounds as :mod:`collective` apply — mailbox hops end
chains, callback refs over-approximate — plus one more: reachability
is DOMAIN-granular, so two threads of the SAME domain racing each
other (e.g. two worker threads) are out of scope here (the table layer
owns that contract).

Config-rot law (same as the never-collective root/sink inventory and
HOT_ZONES): an inventory entry whose root pattern matches no def, or
whose SPAWN SITE (the ``threading.Thread(target=...)`` call that
starts the domain's threads) has disappeared, is itself a finding —
a refactor can move a thread, never silently retire its
classification. The law also runs forward: a ``threading.Thread`` /
``threading.Timer`` spawn site the inventory does not claim is an
UNCLASSIFIED thread — new threads must declare their domain here
before the analysis plane can vouch for them.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from multiverso_tpu_torch.analysis import callgraph
from multiverso_tpu_torch.analysis.core import (Checker, Finding,
                                                PackageIndex, register)

#: where the inventory lives — config-rot findings anchor here (the
#: file the fix edits), falling back to a path-shaped placeholder on
#: trees that do not carry the analysis package
CONFIG_REL = "analysis/threads.py"


@dataclass(frozen=True)
class DomainRoot:
    """One inventory entry: a family of graph nodes that run on the
    domain's threads, plus (when the domain is thread-spawned) the
    lexical spawn site that starts them."""

    domain: str
    rel: str                      #: module holding the root defs
    qual: Optional[str]           #: anchored regex over qualnames;
                                  #: None = spawn-claim-only entry
    label: str
    #: (rel, enclosing-def qualname) of the ``Thread``/``Timer`` call
    #: that spawns this domain's threads; None for roots that are not
    #: thread-spawned (handler entries dispatched by a server loop,
    #: the process main thread)
    spawn: Optional[Tuple[str, str]] = None


#: the domain inventory, keyed to the port. Domains (docs/DESIGN.md
#: §18): engine-shard (actor mailbox loops + the exchange stage + engine
#: message handlers), apply-pool, watchdog, reporter, ops-http,
#: serving-dispatch, tcp-wire (the install-time accept loop), worker (the
#: public API surface + model-layer loader threads — the "worker/main"
#: domain; deliberately MANY threads, see the domain-granularity bound
#: above), helper (bounded-call runner + chaos redelivery timers, whose
#: payloads are caller-defined), elastic (coordinator RPC dispatch +
#: member heartbeats), standby (the op-log shipper and the standby
#: process's threads), policy (the alert->action daemon). The JAX
#: package's fanout and replica-* domains come back with their plane.
INVENTORY: List[DomainRoot] = [
    # -- engine side
    DomainRoot("engine-shard", "actor.py", r"^Actor\._main$",
               "actor mailbox loop (the server engine thread)",
               spawn=("actor.py", "Actor.Start")),
    DomainRoot("engine-shard", "sync/server.py",
               r"^_ExchangeStage\._main$",
               "pipelined exchange-stage thread",
               spawn=("sync/server.py", "_ExchangeStage.__init__")),
    DomainRoot("engine-shard", "sync/server.py",
               r"^(?:Server|SyncServer|_EngineShard)\."
               r"(?:_get_entry|_add_entry|_store_load_entry|"
               r"ProcessFinishTrain|_fence_entry)$",
               "engine verb/cut handlers (Actor dispatch targets)"),
    DomainRoot("apply-pool", "sync/server.py", r"^_ApplyPool\._loop$",
               "parallel apply-pool worker",
               spawn=("sync/server.py", "_ApplyPool.__init__")),
    # -- sampling / observability side
    DomainRoot("watchdog", "telemetry/watchdog.py", r"^Watchdog\._run$",
               "watchdog tick daemon",
               spawn=("telemetry/watchdog.py", "Watchdog.start")),
    DomainRoot("reporter", "telemetry/export.py",
               r"^StatsReporter\._run$",
               "-stats_interval_s reporter thread",
               spawn=("telemetry/export.py", "StatsReporter.__init__")),
    DomainRoot("ops-http", "telemetry/ops.py", r"^_OpsHandler\.do_GET$",
               "ops HTTP handler (per-connection server threads)",
               spawn=("telemetry/ops.py", "OpsServer.__init__")),
    # -- serving plane
    DomainRoot("serving-dispatch", "serving/frontend.py",
               r"^ServingFrontend\._loop$",
               "serving micro-batch dispatcher",
               spawn=("serving/frontend.py",
                      "ServingFrontend._ensure_thread")),
    # -- worker/main: the STEADY-STATE concurrent surfaces only. The
    # cut-riding API calls (checkpoint save/load, snapshot publish) and
    # the setup/teardown calls (MV_Init, MV_CreateTable, MV_ShutDown)
    # are deliberately NOT roots: their payloads run on the engine
    # thread at a fenced stream position (Zoo.CallOnEngine) or in
    # join-ordered quiesced phases, and the static graph merges those
    # payload closures into the caller — a documented honesty bound
    # (docs/DESIGN.md §18), so including them would attribute
    # engine-thread writes to the worker domain.
    DomainRoot("worker", "api.py",
               r"^MV_(?:Barrier|Aggregate|ServingLookup|"
               r"PinVersion|UnpinVersion|Multi(?:Add|Get)(?:Async)?)$",
               "public API steady-state verb surface (user threads)"),
    DomainRoot("worker", "models/logreg/logreg.py", r"^LogReg\._train$",
               "logreg training loop (app main thread)"),
    DomainRoot("worker", "models/wordembedding/distributed.py",
               r"^DistributedWordEmbedding\.train$",
               "wordembedding training loop (app main thread)"),
    DomainRoot("worker", "models/logreg/data.py", r"^WindowReader\._run$",
               "logreg async window reader",
               spawn=("models/logreg/data.py", "WindowReader.__init__")),
    DomainRoot("worker", "models/wordembedding/data.py",
               r"^start_loader$",
               "wordembedding corpus loader thread",
               spawn=("models/wordembedding/data.py", "start_loader")),
    DomainRoot("worker", "utils/async_buffer.py", None,
               "async prefetch fill thread (target: the caller's fill "
               "callable — an attribute, so claim-only)",
               spawn=("utils/async_buffer.py", "ASyncBuffer._launch")),
    # -- elastic plane
    DomainRoot("elastic", "elastic/coordinator.py",
               r"^Coordinator\._dispatch$",
               "coordinator RPC dispatch (per-connection threads)",
               spawn=("elastic/coordinator.py", "Coordinator.serve")),
    DomainRoot("elastic", "elastic/coordinator.py",
               r"^MemberClient\.start_heartbeats$",
               "member heartbeat thread (the _beat closure)",
               spawn=("elastic/coordinator.py",
                      "MemberClient.start_heartbeats")),
    # -- coordinator HA: the op-log replication threads. Their own
    # "standby" domain, NOT "elastic": the shipper's ack wait and the
    # standby's replay hold plain locks by design (control plane, never
    # on a verb path), so they must not inherit the elastic domain's
    # blocking restriction.
    DomainRoot("standby", "elastic/standby.py",
               r"^LogShipper\._ack_loop$",
               "primary-side op-log ack reader (standby watermark)",
               spawn=("elastic/standby.py", "LogShipper.__init__")),
    DomainRoot("standby", "elastic/standby.py",
               r"^LogShipper\._ping_loop$",
               "primary-side takeover-lease keepalive",
               spawn=("elastic/standby.py", "LogShipper.__init__")),
    DomainRoot("standby", "elastic/standby.py",
               r"^StandbyServer\._feed$",
               "standby op-log intake (per-stream server threads)",
               spawn=("elastic/standby.py", "StandbyServer.__init__")),
    DomainRoot("standby", "elastic/standby.py",
               r"^StandbyServer\._watch$",
               "standby takeover-lease monitor",
               spawn=("elastic/standby.py", "StandbyServer.__init__")),
    # -- policy plane: the alert->action daemon. Its watchdog-listener
    # intake (PolicyEngine.on_watchdog_tick) runs on the WATCHDOG thread
    # and is enqueue-only by contract; the decision and staging work all
    # hangs off _run. Actuation across processes happens at
    # MV_PolicySync on app threads (deliberately NOT a root, like the
    # other cut-riding API calls).
    DomainRoot("policy", "policy/engine.py", r"^PolicyEngine\._run$",
               "policy evaluation daemon (alert->action loop)",
               spawn=("policy/engine.py", "PolicyEngine.start")),
    # -- tcp wire: the only thread the transport owns is the
    # install-time accept loop — it collects the mesh's inbound dials,
    # closes the listeners and EXITS; steady-state exchanges run
    # entirely on the caller's thread (the selectors loop), so no
    # exchange-side root exists to register
    DomainRoot("tcp-wire", "parallel/tcp_wire.py",
               r"^TcpWire\._accept_loop$",
               "tcp wire mesh accept loop (install-time, exits once "
               "the mesh is up)",
               spawn=("parallel/tcp_wire.py", "TcpWire.connect")),
    # -- infrastructure helpers
    DomainRoot("helper", "failsafe/deadline.py", r"^_Runner\._loop$",
               "bounded-call runner thread",
               spawn=("failsafe/deadline.py", "_Runner.__init__")),
    DomainRoot("helper", "failsafe/chaos.py", r"^schedule_redelivery$",
               "chaos redelivery timer (the _redeliver closure)",
               spawn=("failsafe/chaos.py", "schedule_redelivery")),
]


def all_domains() -> List[str]:
    return sorted({e.domain for e in INVENTORY})


@dataclass(frozen=True)
class SpawnSite:
    rel: str
    qual: str       #: enclosing top-level def ("<module>" at module level)
    line: int
    what: str       #: "Thread" | "Timer"
    target: str     #: unparsed target= expression ("" when none)


def _spawn_sites(pkg: PackageIndex,
                 graph: callgraph.CallGraph) -> List[SpawnSite]:
    """Every ``threading.Thread(...)`` / ``threading.Timer(...)`` call,
    attributed to its enclosing top-level def (nested defs and closures
    merge into the enclosing def, matching the call-graph node
    granularity). In-package classes that merely SHARE the name (the
    utils Timer stopwatch) resolve through the import table and are
    skipped — only external (threading) spawns count."""
    out: List[SpawnSite] = []
    for rel, mi in graph.modules.items():

        def _scan(owner_qual: str, root: ast.AST) -> None:
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                what = graph.spawn_kind(rel, node)
                if what is None:
                    continue
                target = ""
                for kw in node.keywords:
                    # Thread spells it target=, Timer also accepts
                    # function= — the callgraph cut handles both, the
                    # finding's hint must too
                    if kw.arg in ("target", "function"):
                        target = ast.unparse(kw.value)
                if not target and len(node.args) >= 2:
                    # positional callbacks — Thread(group, target, ...)
                    # / Timer(interval, function, args=None): the
                    # callable is args[1], never the trailing
                    # args/kwargs lists
                    target = ast.unparse(node.args[1])
                out.append(SpawnSite(rel=rel, qual=owner_qual,
                                     line=node.lineno, what=what,
                                     target=target))

        covered = set()
        for qual, _, node in callgraph.iter_top_defs(mi.sf.tree):
            covered.add(node)
            _scan(qual, node)
        for node in callgraph.flat_body(mi.sf.tree.body):
            if node not in covered and not isinstance(node, ast.ClassDef):
                _scan("<module>", node)
    return out


class ThreadInventory:
    """The expanded inventory over one package: per-domain root nodes,
    per-domain BFS closures (+ parent maps for chain reconstruction),
    the detected spawn sites, and the config-rot record."""

    def __init__(self, pkg: PackageIndex):
        self.pkg = pkg
        self.graph = callgraph.build_graph(pkg)
        self.spawns = _spawn_sites(pkg, self.graph)
        self.roots: Dict[str, Set[str]] = {}        # domain -> nodes
        self.root_labels: Dict[str, str] = {}       # node -> label
        self.closures: Dict[str, Set[str]] = {}
        self.parents: Dict[str, Dict[str, str]] = {}
        #: (message, anchor-rel-or-None, line) config-rot records
        self.rot: List[Tuple[str, Optional[str], int]] = []
        self.unclaimed: List[SpawnSite] = []
        self._expand()
        self._bfs()

    def _expand(self) -> None:
        node_quals = [(n, n.split(":", 1)[0], n.split(":", 1)[1])
                      for n in self.graph.node_lines]
        #: (rel, qual) -> number of inventory entries claiming it; a
        #: def holding MORE spawns than claims reports the surplus, so
        #: a second thread added beside a claimed spawn cannot ride
        #: the existing entry unclassified
        claimed: Dict[Tuple[str, str], int] = {}
        for entry in INVENTORY:
            if entry.qual is not None:
                pat = re.compile(entry.qual)
                hits = [n for n, rel, q in node_quals
                        if rel == entry.rel and pat.search(q)]
                if not hits:
                    self.rot.append((
                        f"thread-domain config rot: root pattern "
                        f"{entry.qual!r} in {entry.rel!r} "
                        f"({entry.domain}: {entry.label}) matches no "
                        f"def — the code moved; update "
                        f"analysis/threads.py INVENTORY, never retire "
                        f"the classification", None, 1))
                else:
                    s = self.roots.setdefault(entry.domain, set())
                    s.update(hits)
                    for n in hits:
                        self.root_labels.setdefault(n, entry.label)
            if entry.spawn is not None:
                claimed[entry.spawn] = claimed.get(entry.spawn, 0) + 1
                if not any(sp.rel == entry.spawn[0]
                           and sp.qual == entry.spawn[1]
                           for sp in self.spawns):
                    self.rot.append((
                        f"thread-domain config rot: spawn site "
                        f"{entry.spawn[1]!r} in {entry.spawn[0]!r} "
                        f"({entry.domain}: {entry.label}) no longer "
                        f"spawns a thread — the spawn moved; update "
                        f"analysis/threads.py INVENTORY", None, 1))
        by_site: Dict[Tuple[str, str], List[SpawnSite]] = {}
        for sp in self.spawns:
            by_site.setdefault((sp.rel, sp.qual), []).append(sp)
        for key, sites in sorted(by_site.items()):
            n_claims = claimed.get(key, 0)
            if n_claims >= len(sites):
                continue
            # claims cover the FIRST spawns in source order; the
            # surplus (a new thread added beside a claimed spawn)
            # reports unclassified
            sites.sort(key=lambda s: s.line)
            self.unclaimed.extend(sites[n_claims:])

    def _bfs(self) -> None:
        for domain, roots in self.roots.items():
            seen, parent = self.graph.reachable(sorted(roots))
            self.closures[domain] = seen
            self.parents[domain] = parent

    def domains_of(self, node: str) -> Set[str]:
        return {d for d, seen in self.closures.items() if node in seen}

    def chain(self, domain: str, node: str) -> List[str]:
        return self.graph.path_to(self.parents.get(domain, {}), node)

    def domain_root_for(self, domain: str, node: str) -> str:
        """The root whose BFS tree holds ``node`` (chain head)."""
        return self.chain(domain, node)[0]


_INV_CACHE: Dict[str, ThreadInventory] = {}


def inventory_for(pkg: PackageIndex) -> ThreadInventory:
    inv = _INV_CACHE.get(pkg.root)
    if inv is None or inv.pkg is not pkg:
        inv = _INV_CACHE[pkg.root] = ThreadInventory(pkg)
    return inv


@register
class ThreadDomainsChecker(Checker):
    """The inventory's own law: every configured root/spawn is live
    (config rot otherwise), and every detected thread spawn is claimed
    by a domain entry (an unclassified thread is a finding — new
    threads must be classified before PR N+1 piles actuators on
    them)."""

    name = "thread-domains"
    description = ("thread spawn sites must be classified into a "
                   "concurrency domain (analysis/threads.py INVENTORY) "
                   "and the inventory must stay live (config rot)")

    def check(self, pkg: PackageIndex) -> List[Finding]:
        inv = inventory_for(pkg)
        self.scanned.update(pkg.rel_paths)
        anchor = CONFIG_REL if pkg.file(CONFIG_REL) is not None \
            else "<config>"
        out: List[Finding] = []
        for msg, rel, line in inv.rot:
            out.append(Finding(self.name, rel or anchor, line, msg))
        for sp in inv.unclaimed:
            tgt = f" (target={sp.target})" if sp.target else ""
            out.append(Finding(
                self.name, sp.rel, sp.line,
                f"unclassified thread spawn: threading.{sp.what} in "
                f"{sp.qual}{tgt} — every spawned thread needs a "
                f"DomainRoot entry in analysis/threads.py so the "
                f"concurrency checkers know whose thread runs it"))
        return out
