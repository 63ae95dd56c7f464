"""never-collective: no static path from a restricted root to a collective.

Counterpart of ``multiverso_tpu/analysis/collective.py``, with the roots
and sinks keyed to the port.

The PR 2 law ("reporter threads never issue collectives" —
telemetry/export.py's module docstring) generalized: a timer/handler
thread that issues a collective interleaves with the engine's window
exchanges and corrupts the SPMD verb stream. The restricted ROOTS are
every entry point that runs on such a thread; the SINKS are every
collective primitive this build owns plus the well-known external
collective attributes (callgraph.EXTERNAL_COLLECTIVE_ATTRS). Any
statically reachable root→sink path is a finding, reported with the
full call chain.

Config rot is itself an error: a configured root or sink that no
longer names a graph node fails the run, so a refactor can't silently
retire the protection (the tier-1 baseline test also re-derives that
the root set covers the conventions DESIGN.md documents).

Deliberately NOT a root: ``Dashboard.DisplayAll`` and
``metrics.Registry.snapshot_all_hosts`` are the package's two
*explicitly* collective observability surfaces — every process must
call them at the same point, like MV_Barrier. The law protects the
surfaces that run on sampling/handler threads, where nobody
coordinates ranks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from multiverso_tpu_torch.analysis import callgraph
from multiverso_tpu_torch.analysis.core import (Checker, Finding,
                                                PackageIndex, register)

#: restricted roots: node id -> the convention it encodes
DEFAULT_ROOTS: Dict[str, str] = {
    "telemetry/ops.py:_OpsHandler.do_GET":
        "ops HTTP handler (serves on the HTTP thread, engine unquiesced)",
    "telemetry/watchdog.py:Watchdog._run":
        "watchdog daemon loop",
    "telemetry/watchdog.py:Watchdog.tick":
        "watchdog tick (also called from /alerts handlers)",
    "telemetry/export.py:StatsReporter._run":
        "-stats_interval_s reporter thread",
    "telemetry/export.py:StatsReporter.emit":
        "reporter emit (also the final flush on stop)",
    "telemetry/accounting.py:memory_report":
        "memory ledger probe (sampled from watchdog/ops threads)",
    "telemetry/accounting.py:refresh":
        "ledger gauge refresh (/metrics scrape path)",
    "utils/dashboard.py:Dashboard.Display":
        "local dashboard render (DisplayAll is the collective sibling)",
    "utils/dashboard.py:Dashboard._ops_lines":
        "dashboard [Ops] line (renders during teardown)",
    # the replica plane: the reader process's serve loop (that process
    # has no SPMD stream at all) and the trainer's fan-out thread (it runs
    # beside the engine; its ring a reader is point to point to a process
    # outside the world, with a reasoned marker at the def in
    # replica/publisher.py)
    "replica/replica.py:_LookupHandler.handle":
        "replica lookup serve loop (reader process)",
    "replica/publisher.py:ReplicaPublisher._run":
        "replica fan-out thread (ships beside the engine stream)",
    # the fleet plane's two legs: rollup builds run on lease heartbeat
    # daemons (a collective there deadlocks the beat against the engine
    # stream), and the coordinator-side fold runs on RPC handler threads
    # serving members that are mid-collective
    "telemetry/fleet.py:build_rollup":
        "fleet rollup build (lease heartbeat daemon threads)",
    "telemetry/fleet.py:FleetAccumulator.ingest":
        "coordinator-side fleet rollup fold (RPC handler threads)",
    # the policy plane's evaluation daemon: it STAGES actions (local
    # queue / coordinator RPC) and, single-process, installs at an
    # engine cut (a mailbox hand-off), never a collective; the
    # collective drain leg lives in MV_PolicySync on app threads by
    # construction, and this root keeps it there
    "policy/engine.py:PolicyEngine._run":
        "policy evaluation daemon (alert->action loop)",
    "policy/engine.py:PolicyEngine.step":
        "policy evaluation step (also driven directly by tests)",
    # coordinator HA: the standby's takeover replays the op log and
    # serves INSIDE a standby process that has no SPMD stream: a
    # collective reachable from it would hang the successor forever
    "elastic/standby.py:StandbyServer.force_takeover":
        "standby lease takeover (log replay + successor bind, "
        "standby process)",
}

#: collective primitives: node id -> what it is. The JAX package's
#: ``broadcast_from_master`` and ``union_collective_ids`` have no port.
DEFAULT_SINKS: Dict[str, str] = {
    "parallel/multihost.py:_all_gather":
        "the one torch.distributed all_gather every host collective rides",
    "parallel/multihost.py:capped_exchange":
        "the engine's one host-byte collective",
    "parallel/multihost.py:host_barrier": "cross-host barrier",
    "parallel/multihost.py:host_allreduce_sum": "allreduce",
    "parallel/multihost.py:host_allgather_bytes": "allgather",
    "parallel/multihost.py:host_allgather_objects": "object allgather",
    "parallel/multihost.py:host_allgather_objects_capped":
        "capped object allgather",
    "parallel/multihost.py:merge_collective_add": "collective row merge",
    "parallel/multihost.py:collective_write":
        "collective device write (the device wire's application channel)",
    "parallel/multihost.py:sum_collective_add": "collective value sum",
    "parallel/multihost.py:Group.exchange": "membership-group exchange",
    "parallel/multihost.py:Group.barrier": "membership-group barrier",
    "parallel/shm_wire.py:ShmWire.exchange": "shm-wire exchange",
    "parallel/tcp_wire.py:TcpWire.exchange": "tcp-wire exchange",
    "parallel/allreduce.py:RendezvousAllreduce.allreduce":
        "MV_Aggregate rendezvous (every worker thread, then the "
        "cross-process reduce)",
    "zoo.py:Zoo._barrier_wait": "zoo rendezvous barrier leg",
}


@register
class NeverCollectiveChecker(Checker):
    name = "never-collective"
    description = ("no statically reachable path from a restricted root "
                   "(HTTP handler / watchdog / reporter / ledger probe / "
                   "dashboard render) to a collective primitive")

    def __init__(self,
                 roots: Optional[Dict[str, str]] = None,
                 sinks: Optional[Dict[str, str]] = None) -> None:
        super().__init__()
        self.roots = DEFAULT_ROOTS if roots is None else roots
        self.sinks = DEFAULT_SINKS if sinks is None else sinks
        #: filled by check(): root node -> set of reachable nodes
        self.closures: Dict[str, set] = {}

    def check(self, pkg: PackageIndex) -> List[Finding]:
        graph = callgraph.build_graph(pkg)
        self.scanned.update(pkg.rel_paths)
        out: List[Finding] = []

        def _cfg_finding(node: str, what: str, label: str) -> Finding:
            # anchor to where the stale config entry LIVES (this
            # module), not to the vanished module or an arbitrary
            # package file — that is the file the fix edits
            cfg = "analysis/collective.py"
            path = cfg if pkg.file(cfg) is not None \
                else node.split(":", 1)[0]
            return Finding(
                self.name, path, 1,
                f"configured {what} {node!r} ({label}) names no graph "
                f"node — the refactor that moved it must update "
                f"analysis/collective.py, not retire the protection")

        sink_nodes = set()
        for node, label in self.sinks.items():
            if not graph.has_node(node):
                out.append(_cfg_finding(node, "collective sink", label))
            else:
                sink_nodes.add(node)
        # external collective attrs are sinks wherever they appear
        external = {t for targets in graph.edges.values()
                    for t in targets if t.startswith("<external>:")}
        sink_nodes |= external

        for root, label in sorted(self.roots.items()):
            if not graph.has_node(root):
                out.append(_cfg_finding(root, "restricted root", label))
                continue
            seen, parent = graph.reachable([root])
            self.closures[root] = seen
            rel, line = graph.node_lines[root]
            for sink in sorted(seen & sink_nodes):
                chain = " -> ".join(graph.path_to(parent, sink))
                sink_label = self.sinks.get(
                    sink, "external collective attribute")
                out.append(Finding(
                    self.name, rel, line,
                    f"{root} ({label}) statically reaches collective "
                    f"{sink} ({sink_label}): {chain}"))
        return out
