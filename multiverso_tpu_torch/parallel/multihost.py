"""Multi-process worlds over ``torch.distributed`` (gloo) and the host wires.

Counterpart of ``multiverso_tpu/parallel/multihost.py``. The reference scales
across machines with MPI/ZMQ messaging; the JAX package runs one SPMD
process per host, and so does the port: every process runs worker and
server actors, and table verbs follow the COLLECTIVE contract — every
process issues the same Get/Add sequence, and the engine exchanges each
window of verbs between the processes (``sync/server.py``).

What this module provides:

* ``maybe_initialize`` — bring up ``torch.distributed`` (gloo) from the
  flags ``-dist_coordinator/-dist_rank/-dist_size``, from
  ``MV_NetBind``/``MV_NetConnect``, from ``-machine_file`` (line N is rank
  N), or from a torchrun environment (``RANK``/``WORLD_SIZE``/
  ``MASTER_ADDR``); ``-multihost=auto`` starts a world only when one of
  these asks for it, ``on`` always, ``off`` never. The process group's
  timeout (``-mv_dist_timeout_s``) bounds every collective, so a lost or
  diverged peer fails instead of hanging; a peer that is only slow (longer
  than the timeout in local work before its next collective) is treated
  as lost too;
* identity: ``process_index``/``process_count`` (the boot world),
  ``world_rank``/``world_size`` (the current membership view);
* the host collectives: ``host_barrier``, ``host_allreduce_sum``,
  ``host_allgather_bytes``/``host_allgather_objects`` and the
  standing-cap window exchange ``capped_exchange``;
* the application threads' lockstep rounds: ``host_allgather_objects_capped``
  (a tagged agreement: every rank passes the same call-site key, and a
  rank at another key fails the CHECK on every rank), and the merges of
  one collective device write, ``merge_collective_add`` (row or key
  payloads concatenated in rank order) and ``sum_collective_add``
  (whole-table deltas summed in rank order), each CHECKing that the
  ranks' Add options agree. ``STATS`` keeps their seconds and counts.

Two gloo groups carry them. The ENGINE group carries what the engine
issues (the window and head-marker exchanges); the CONTROL group carries
what application threads issue (``MV_Barrier``, ``MV_Aggregate``'s
cross-process leg, the checkpoint's barriers, table-creation agreements).
Each group's collectives are issued
in one agreed order by one thread at a time on every rank, so an
application barrier never interleaves with an engine exchange in a
different order on different ranks. Blobs ride as CPU ``uint8`` tensors
through the list forms of ``all_gather``.

Every function degrades to the identity (or a no-op) in a single-process
world, so the one-process world runs the same code paths.

Elastic membership (``elastic/``): an epoch installs a :class:`Group`, the
subset of boot ranks now in the world (``install_group``), and every host
collective above routes through it: a singleton group takes the identity
path (no collective at all, which keeps a survivor sound after a peer died
mid-collective: the abandoned gloo stream and the wire are never touched
again), and a multi-member group takes the coordinator relay, never gloo
and never a wire whose segments a departed member owns.
``process_index``/``process_count`` keep their boot meaning (the device,
forensic identity); membership-aware code asks ``world_rank``/
``world_size``. ``collective_isolation`` makes the collectives answer as a
one-member world while a transition rebuilds the tables, and
``mark_boot_world_broken`` makes ``net_finalize`` skip the gloo barrier
and the group teardown once a boot member has died.

The host wire (``-mv_wire``, ``maybe_install_wire``): the engine's window
and head-marker exchanges ride a wire of their own when one comes up, as
in the JAX package. ``auto`` (the default) installs the shared-memory
wire (``parallel/shm_wire.py``) when every rank reports the same host
(``host_label``: ``-mv_wire_hostname`` or the hostname), the TCP wire
(``parallel/tcp_wire.py``) when the hosts differ and the engine asks for
more than one channel, and stays on gloo otherwise; ``shm`` and ``tcp``
require their wire, ``gloo`` refuses both. The install is a voted
sequence of control-group rounds (hostnames and rank 0's session token,
then segment creation or the listeners' endpoints, peer attach or the
mesh, a smoke exchange): a failure on any rank degrades the WHOLE world
to gloo under ``auto``, loudly, and fails a CHECK under ``shm``/``tcp``.
A wire offers independent channels (``wire_channels``), one per engine
shard, which lets ``-mv_engine_shards`` exceed 1 across processes; gloo
is one ordered stream. The application threads' agreements, collective
writes and barriers stay on the gloo control group.
"""

from __future__ import annotations

import datetime
import os
import pickle
import secrets
import socket
import threading
import time
from typing import Optional

import numpy as np

from multiverso_tpu_torch.failsafe import deadline as fdeadline
from multiverso_tpu_torch.parallel.mesh import next_bucket
from multiverso_tpu_torch.utils.configure import (GetFlag, MV_DEFINE_int,
                                                  MV_DEFINE_string,
                                                  cached_float_flag)
from multiverso_tpu_torch.utils.log import CHECK, Log

MV_DEFINE_string("multihost", "auto", "multi-process init: auto / on / off")
MV_DEFINE_string("machine_file", "",
                 "hosts file, one endpoint per line = rank order "
                 "(reference ZMQ -machine_file)")
MV_DEFINE_int("port", 55555,
              "default port when a machine-file line has none "
              "(reference ZMQ -port)")
MV_DEFINE_string("dist_coordinator", "",
                 "rank 0's address host:port (the process group's "
                 "rendezvous)")
MV_DEFINE_int("dist_rank", -1, "this process's rank")
MV_DEFINE_int("dist_size", -1, "total process count")
MV_DEFINE_string("mv_wire", "auto",
                 "windowed-engine host wire: auto (shm when every rank "
                 "shares a host; tcp when hosts differ and >1 channel "
                 "is needed; else gloo) / shm (require) / tcp "
                 "(require) / gloo")
MV_DEFINE_string("mv_wire_hostname", "",
                 "override this rank's host identity in wire selection "
                 "(loopback cross-host worlds fake distinct hosts on one "
                 "box; dialing still rides real endpoints). Empty = the "
                 "real hostname")
MV_DEFINE_int("mv_shm_ring_bytes", 4 << 20,
              "shared-memory wire: per-(channel, rank) data area bytes "
              "(frames larger than this chunk through it; the tcp wire's "
              "chunk cap too)")
MV_DEFINE_int("mv_dist_timeout_s", 120,
              "timeout of every collective of the process groups, seconds: "
              "a lost, diverged or slower peer fails past it instead of "
              "hanging")
#: the same bound, read per window exchange through a listener cache
_dist_timeout_flag = cached_float_flag("mv_dist_timeout_s", 120.0)

_INF = float("inf")

_initialized = False
_owns_runtime = False      # True only when this module created the world
_engine_pg = None
_ctrl_pg = None

#: the application threads' lockstep rounds, host clock: tagged agreements
#: (``agree``), the all-gathers of collective device writes (``write``; on
#: the device route the metadata rounds and the handle swaps), the
#: device->host copies of their payloads (``d2h``), the host merge in rank
#: order (``merge``) and the apply on the replica (``apply``; the tables
#: add it). The device route's own (``collective_write``): the staging of
#: this rank's deltas into its slot with the wait for it (``stage``), the
#: copies of every rank's deltas out of the slots (``copy``, a call a
#: write), the merge on the device (``dmerge``; the tables add it).
#: ``*_s`` are seconds, ``*_n`` counts; beside them ``stage_bytes`` (this
#: rank's staged deltas), ``copy_peer_n`` / ``copy_peer_bytes`` (the copies
#: out of a peer's slot and their bytes), ``copy_ms`` (the copies' device
#: time by CUDA events on the card, 0.0 on the CPU), ``swap_n`` (handle-swap
#: rounds) and ``d2h_bytes`` (what crossed device to host: every device
#: delta and ride on the host route, the rides alone on the device route).
#: ``reset_stats`` zeroes them.
STATS: dict = {}


def reset_stats() -> None:
    for k in ("agree", "write", "d2h", "merge", "apply", "stage", "copy",
              "dmerge"):
        STATS[f"{k}_s"] = 0.0
        STATS[f"{k}_n"] = 0
    STATS.update(stage_bytes=0, copy_peer_n=0, copy_peer_bytes=0,
                 copy_ms=0.0, swap_n=0, d2h_bytes=0)


reset_stats()

#: host collective rounds this process issued (every all-gather and
#: barrier, on either group), for a check that a path issues none (the
#: serving lookups); never reset
_rounds = 0
_rounds_lock = threading.Lock()


def collective_rounds() -> int:
    """Host collective rounds issued by this process so far."""
    return _rounds


def _note_round() -> None:
    global _rounds
    with _rounds_lock:
        _rounds += 1


def note_collective(n: int = 1) -> None:
    """Count ``n`` host collective rounds issued outside this module."""
    global _rounds
    with _rounds_lock:
        _rounds += n


#: timing of the calling thread's latest engine ``capped_exchange``: the
#: engine's phase stamps read it right after their window exchange, on the
#: same thread, to split the seconds BLOCKED IN THE COLLECTIVE (``coll_s``)
#: from local staging, and to anchor the cross-rank clock alignment on the
#: exchange-done wall stamp (every rank leaves one exchange at about the
#: same instant; telemetry/critpath.py). Kept per thread: the shards of a
#: sharded engine exchange at the same time, each on its own thread and
#: channel, and each must read its own exchange.
_exchange_tls = threading.local()
_EXCHANGE_NONE = {"enter_m": 0.0, "done_m": 0.0, "done_w": 0.0,
                  "coll_s": 0.0}


def _stamp_exchange(enter_m: float, coll_s: float, done_m: float,
                    done_w: float) -> None:
    _exchange_tls.last = {"enter_m": enter_m, "done_m": done_m,
                          "done_w": done_w, "coll_s": coll_s}


def last_exchange_stats() -> dict:
    """Timing of the calling thread's most recent engine exchange:
    ``enter_m``/``done_m`` (perf_counter), ``done_w`` (wall clock at the
    collective's exit) and ``coll_s`` (seconds inside the collective)."""
    return getattr(_exchange_tls, "last", _EXCHANGE_NONE)


# -- elastic membership groups (elastic/) -----------------------------------

class Group:
    """One membership epoch's view of the world.

    ``members`` are boot ranks, sorted; ``exchange(blob, key)`` is the
    group's all-gather of bytes (None for a singleton group, which takes
    the identity path); ``barrier(name)`` its rendezvous."""

    def __init__(self, epoch: int, members, exchange=None, barrier=None):
        self.epoch = int(epoch)
        self.members = tuple(sorted(int(m) for m in members))
        self._exchange = exchange
        self._barrier = barrier

    @property
    def size(self) -> int:
        return len(self.members)

    def rank(self) -> int:
        """This process's position in the member list, -1 if departed."""
        try:
            return self.members.index(process_index())
        except ValueError:
            return -1

    def _require_member(self, what: str) -> None:
        if self.rank() < 0:
            from multiverso_tpu_torch.failsafe.errors import \
                MembershipChanged
            raise MembershipChanged(
                f"{what} from a departed member", epoch=self.epoch,
                members=self.members, departed=(process_index(),))

    def exchange(self, blob: bytes, key) -> list:
        if self.size <= 1 and self.rank() >= 0:
            return [blob]
        self._require_member("collective exchange")
        CHECK(self._exchange is not None,
              "multi-member elastic group without an exchange transport")
        _note_round()
        return self._exchange(blob, key)

    def barrier(self, name: str) -> None:
        if self.size <= 1 and self.rank() >= 0:
            return
        self._require_member("collective barrier")
        CHECK(self._barrier is not None,
              "multi-member elastic group without a barrier transport")
        _note_round()
        self._barrier(name)


_group: Optional[Group] = None

#: collective isolation (``elastic/rebalance.rebuild_world``): the host
#: collectives answer as a one-member world while a transition fence
#: rebuilds tables, whose constructors may re-run boot-time agreements
#: with no matched peer round inside the fence. world_rank/world_size are
#: NOT isolated: the rebuilt tables bind the new view's identity.
_isolated = False

#: a boot-world member DIED (an elastic shrink): the gloo groups hold a
#: dead peer, so net_finalize skips their closing barrier and teardown
_boot_world_broken = False


class collective_isolation:
    def __enter__(self):
        global _isolated
        self._prev = _isolated
        _isolated = True
        return self

    def __exit__(self, *exc):
        global _isolated
        _isolated = self._prev


def mark_boot_world_broken() -> None:
    global _boot_world_broken
    if not _boot_world_broken:
        _boot_world_broken = True
        Log.Error("multihost: a boot-world member died — the gloo process "
                  "groups will not be torn down cleanly (survivors skip "
                  "their closing barrier)")


def install_group(group: Optional[Group]) -> None:
    """Install the membership view every host collective routes through
    from now on (None restores the boot world). Called by the elastic
    plane at an epoch transition, on the engine thread at the fenced
    stream position, so no exchange is in flight across the swap."""
    global _group
    _group = group
    if group is not None:
        Log.Info("multihost: membership epoch %d installed — members %s "
                 "(this process %s)", group.epoch, list(group.members),
                 "rank %d" % group.rank() if group.rank() >= 0
                 else "DEPARTED")


def current_group() -> Optional[Group]:
    return _group


def membership_epoch() -> int:
    """The installed membership epoch (0 = the boot world)."""
    return _group.epoch if _group is not None else 0


def note(kind: str, seconds: float) -> None:
    """Add one round of ``kind`` (a ``STATS`` key stem) taking
    ``seconds``."""
    STATS[f"{kind}_s"] += seconds
    STATS[f"{kind}_n"] += 1


# -- identity ----------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def process_index() -> int:
    return _dist().get_rank() if _initialized else 0


def process_count() -> int:
    return _dist().get_world_size() if _initialized else 1


def world_rank() -> int:
    """This process's rank in the CURRENT world ordering (the boot rank
    until an elastic epoch is installed); -1 once this process departed."""
    if _group is not None:
        return _group.rank()
    return process_index()


def world_size() -> int:
    """Active members of the CURRENT world (the boot process count until
    an elastic epoch is installed)."""
    if _group is not None:
        return _group.size
    return process_count()


def _wire_mode() -> str:
    mode = str(GetFlag("mv_wire")).lower()
    CHECK(mode in ("auto", "shm", "tcp", "gloo"),
          f"-mv_wire must be auto/shm/tcp/gloo, got {mode!r}")
    return mode


# -- the host wire (shm same-host, tcp cross-host) ----------------------------

#: the installed wire behind the engine's ``capped_exchange`` (None = gloo)
_wire = None


def active_wire():
    """The installed host wire (``ShmWire`` or ``TcpWire``), or None when
    the engine's exchanges ride gloo."""
    return _wire


def wire_name() -> str:
    """The transport the engine's exchanges ride: ``relay`` while a
    multi-member elastic group is installed, ``shm``, ``tcp``, ``gloo``,
    or ``local`` in a one-process world."""
    if _group is not None and _group.size > 1:
        return "relay"
    if _wire is not None:
        return _wire.name
    return "gloo" if (_initialized and process_count() > 1) else "local"


def host_label() -> str:
    """This rank's host identity for wire selection:
    ``-mv_wire_hostname`` when set (loopback cross-host worlds fake
    distinct hosts on one box; dialing still rides real endpoints), else
    the hostname."""
    v = str(GetFlag("mv_wire_hostname"))
    if v:
        return v
    try:
        return socket.gethostname()
    except OSError:
        return "localhost"


def wire_channels() -> int:
    """Independent exchange channels the engine's transport offers: one
    per channel of an installed wire, one on gloo (a single ordered
    collective stream)."""
    return _wire.channels if _wire is not None else 1


class _Vote:
    """One wire install's voted setup: every rank runs the SAME control
    rounds whatever fails locally, so a local failure is a False vote,
    never a skipped round (which would leave the peers off by one on the
    control group's stream)."""

    def __init__(self, mode: str, kind: str):
        self.mode, self.kind = mode, kind
        self.wire = None
        self.exc: Optional[BaseException] = None

    def run(self, fn) -> None:
        """Run ``fn`` unless an earlier step failed here; keep its
        failure for the vote."""
        if self.exc is None:
            try:
                fn()
            except Exception as exc:    # becomes this rank's False vote
                self.exc = exc

    def agree(self, step: str, votes=None) -> bool:
        """The world's vote after ``step``: True when every rank
        succeeded. On a failure every rank closes its wire; ``auto``
        falls back to gloo, loudly, and a required wire fails a CHECK."""
        if votes is None:
            votes = host_allgather_objects(self.exc is None)
        if all(votes):
            return True
        if self.wire is not None:
            self.wire.close()
        CHECK(self.mode != self.kind,
              f"-mv_wire={self.kind} but the wire failed to come up at "
              f"{step}: {self.exc!r} (votes {votes})")
        Log.Error("multihost: %s wire setup failed at %s on rank(s) %s "
                  "(%r here): falling back to gloo", self.kind, step,
                  [i for i, v in enumerate(votes) if not v], self.exc)
        return False

    def smoke(self, exchange) -> None:
        """A hello through the new wire: every rank's, in rank order."""
        hello = b"mv-%s-hello-%d" % (self.kind.encode(), process_index())
        got = exchange(hello)
        CHECK(got == [b"mv-%s-hello-%d" % (self.kind.encode(), r)
                      for r in range(process_count())],
              f"{self.kind} wire smoke exchange returned {got!r}")


def maybe_install_wire(channels: int) -> str:
    """Select and install the host wire of this world (``Zoo.Start``, after
    the process groups are up, before the engine starts; the JAX package's
    ``maybe_install_wire``). One control round exchanges (host label,
    nonce): a same-host world rides the shm wire; a world whose hosts
    differ takes the tcp wire when more than one channel is asked for
    (``-mv_wire=tcp`` forces it); gloo is the fallback. Either wire is
    proven by a smoke exchange before the engine uses it, and a setup
    failure on any rank degrades the WHOLE world to gloo (a CHECK under
    ``-mv_wire=shm``/``tcp``). Returns the transport's name."""
    global _wire
    mode = _wire_mode()
    if not _initialized or process_count() <= 1 or mode == "gloo":
        return wire_name()
    if _wire is not None:
        return _wire.name
    channels = max(1, int(channels))
    info = host_allgather_objects((host_label(), secrets.token_hex(4),
                                   os.getpid()))
    hosts = [h for h, _, _ in info]
    token = info[0][1]          # rank 0's nonce names the session
    spans_hosts = any(h != hosts[0] for h in hosts)
    if mode == "tcp" or (spans_hosts and mode == "auto" and channels > 1):
        return _install_tcp_wire(mode, token, channels, hosts)
    if spans_hosts:
        CHECK(mode != "shm", f"-mv_wire=shm but ranks span hosts: {hosts}")
        Log.Debug("multihost: ranks span hosts (%s) and %d channel(s) "
                  "suffice: staying on gloo (-mv_wire=tcp forces the tcp "
                  "wire)", hosts, channels)
        return "gloo"
    from multiverso_tpu_torch.parallel import shm_wire
    v = _Vote(mode, "shm")

    def create():
        # payload_crc off: every engine blob arrives sealed
        # (parallel/seal.py) and is checked before parsing
        v.wire = shm_wire.ShmWire(
            token, process_index(), process_count(), channels,
            int(GetFlag("mv_shm_ring_bytes")), payload_crc=False,
            peer_pids=[pid for _, _, pid in info])

    v.run(create)
    if not v.agree("segment create"):
        return "gloo"
    v.run(v.wire.attach_peers)
    if not v.agree("peer attach"):
        return "gloo"
    v.run(lambda: v.smoke(lambda b: v.wire.exchange(b, 0)))
    if not v.agree("smoke exchange"):
        return "gloo"
    _wire = v.wire
    Log.Info("multihost: same-host shared-memory wire up: %d channel(s) "
             "x %d MiB (token %s)", _wire.channels, _wire.cap >> 20, token)
    return "shm"


def _install_tcp_wire(mode: str, token: str, channels: int, hosts) -> str:
    """The tcp leg of ``maybe_install_wire``: bind the listeners,
    all-gather (ok, endpoints) in ONE control round, dial the mesh, vote,
    and smoke-exchange before the install."""
    global _wire
    from multiverso_tpu_torch.parallel import tcp_wire
    v = _Vote(mode, "tcp")

    def bind():
        v.wire = tcp_wire.TcpWire(
            token, process_index(), process_count(), channels,
            int(GetFlag("mv_shm_ring_bytes")), payload_crc=False)

    v.run(bind)
    votes = host_allgather_objects(
        (v.exc is None, v.wire.listen_endpoints() if v.wire else None))
    if not v.agree("listener bind", [ok for ok, _ in votes]):
        return "gloo"
    world_eps = {r: eps for r, (_, eps) in enumerate(votes)}
    v.run(lambda: v.wire.connect(world_eps, timeout_s=30.0))
    if not v.agree("mesh connect"):
        return "gloo"
    v.run(lambda: v.smoke(lambda b: v.wire.exchange(b, 0, timeout_s=30.0)))
    if not v.agree("smoke exchange"):
        return "gloo"
    _wire = v.wire
    Log.Info("multihost: cross-host tcp wire up: %d channel(s) x %d KiB "
             "chunks, hosts %s (token %s)", _wire.channels,
             _wire.chunk >> 10, sorted(set(hosts)), token)
    return "tcp"


def close_wire() -> None:
    """Tear the installed wire down (``Zoo.Stop``, ``net_reset``), so the
    next world picks its wire again. Idempotent; own shm segments are
    unlinked."""
    global _wire
    w, _wire = _wire, None
    if w is not None:
        w.close()


class wire_bypass:
    """Run the body on the gloo exchange while a host wire is installed
    (a wire-against-gloo comparison in one world). Collective: every rank
    enters and leaves at the same stream position, with the engine
    quiesced, or the two transports' streams interleave differently on
    different ranks."""

    def __enter__(self):
        global _wire
        self._saved = _wire
        _wire = None
        return self

    def __exit__(self, *exc):
        global _wire
        _wire = self._saved


# -- explicit-endpoint bring-up (MV_NetBind / MV_NetConnect) ----------------

_net_rank: Optional[int] = None
_net_endpoint: Optional[str] = None
_net_world: Optional[dict] = None   # rank -> endpoint


def net_bind(rank: int, endpoint: str) -> int:
    """Declare THIS process's rank and endpoint (reference
    ZMQNetWrapper::Bind, zmq_net.h:64-81). Must precede MV_Init. Rank 0's
    endpoint is the rendezvous address of the whole world. 0 on success,
    -1 on error."""
    global _net_rank, _net_endpoint, _net_world
    if _initialized:
        Log.Error("MV_NetBind after the distributed runtime is up")
        return -1
    try:
        rank, endpoint = int(rank), str(endpoint)
    except (TypeError, ValueError):
        return -1
    if rank < 0 or not endpoint:
        return -1
    _net_rank = rank
    _net_endpoint = endpoint
    # a re-bind invalidates a declared world: require a fresh connect
    _net_world = None
    return 0


def net_connect(ranks, endpoints) -> int:
    """Declare the full world as parallel (ranks, endpoints) lists
    (reference ZMQNetWrapper::Connect, zmq_net.h:83-110). Requires a prior
    net_bind whose rank appears in ``ranks``; the next MV_Init brings the
    world up from this wiring. 0 on success, -1 on error."""
    global _net_world
    if _initialized:
        Log.Error("MV_NetConnect after the distributed runtime is up")
        return -1
    if _net_rank is None:
        Log.Error("MV_NetConnect before MV_NetBind")
        return -1
    try:
        ranks = [int(r) for r in ranks]
        endpoints = [str(e) for e in endpoints]
    except (TypeError, ValueError):
        return -1
    if len(ranks) != len(endpoints) or not ranks:
        return -1
    if sorted(ranks) != list(range(len(ranks))):
        Log.Error("MV_NetConnect ranks must be exactly 0..n-1, got %s",
                  ranks)
        return -1
    world = dict(zip(ranks, endpoints))
    if _net_rank not in world:
        Log.Error("MV_NetConnect world must contain the bound rank")
        return -1
    if _net_rank == 0 and world[0] != _net_endpoint:
        Log.Error("rank 0 bind endpoint %s != connect entry %s",
                  _net_endpoint, world[0])
        return -1
    _net_world = world
    return 0


def net_reset() -> None:
    """Forget the explicit wiring and close the host wire (a new world
    selects its own)."""
    global _net_rank, _net_endpoint, _net_world, _group
    _net_rank = _net_endpoint = _net_world = None
    _group = None       # a new world starts at epoch 0 (boot membership)
    close_wire()


def net_finalize() -> None:
    """Forget the declarations and tear down the process groups when THIS
    module brought the world up (a world the caller initialized is left
    alone). The ranks meet at a control barrier first, so no rank closes
    its connections while a peer still finishes a collective; a failed
    barrier (a dead peer) is logged and the teardown goes on."""
    global _initialized, _owns_runtime, _engine_pg, _ctrl_pg
    net_reset()
    if not _initialized:
        return
    dist = _dist()
    if _boot_world_broken:
        # a dead boot member can never reach the closing barrier, and its
        # gloo connections are gone: leave the groups to process exit
        Log.Info("net_finalize: boot world broken — skipping the gloo "
                 "closing barrier and teardown")
        _initialized = _owns_runtime = False
        _engine_pg = _ctrl_pg = None
        _OBJ_CAPS.clear()
        return
    try:
        host_barrier("mv_finalize")
    except Exception as exc:
        Log.Error("net_finalize: the closing barrier failed (%r); tearing "
                  "down anyway", exc)
    try:
        if _owns_runtime:
            dist.destroy_process_group()
        else:
            for pg in (_engine_pg, _ctrl_pg):
                dist.destroy_process_group(pg)
    except Exception as exc:
        Log.Error("net_finalize: destroy_process_group failed: %r", exc)
    _initialized = _owns_runtime = False
    _engine_pg = _ctrl_pg = None
    _OBJ_CAPS.clear()


# -- machine file -------------------------------------------------------------

def _split_endpoint(ep: str):
    """host[:port] -> (host, port_or_None); IPv6 uses [addr]:port."""
    if ep.startswith("["):
        host, _, rest = ep[1:].partition("]")
        return host, (rest[1:] if rest.startswith(":") else None)
    host, sep, port = ep.rpartition(":")
    if sep and port.isdigit() and ":" not in host:
        return host, port
    return ep, None


def _parse_machine_file(path: str) -> list:
    """Hosts file -> rank-ordered endpoint list (reference
    ParseMachineFile, zmq_net.h:236-258): one host[:port] per line (IPv6 as
    [addr]:port), blanks and comments skipped, ``-port`` filling missing
    ports. A missing or empty file is a loud error."""
    default_port = int(GetFlag("port"))
    CHECK(os.path.exists(path), f"-machine_file not found: {path!r}")
    endpoints = []
    with open(path) as f:
        for line in f:
            ep = line.strip()
            if not ep or ep.startswith("#"):
                continue
            host, port = _split_endpoint(ep)
            if port is None:
                port = default_port
            endpoints.append(f"[{host}]:{port}" if ":" in host
                             else f"{host}:{port}")
    CHECK(endpoints, f"-machine_file {path!r} lists no endpoints")
    return endpoints


def _match_local_rank(endpoints: list):
    """This host's rank: the unique machine-file line resolving to a local
    address (reference net_util). None when no line, or more than one,
    matches (same-host worlds need ``-dist_rank``)."""
    local = {"127.0.0.1", "::1"}
    try:
        local.update(info[4][0] for info in socket.getaddrinfo(
            socket.gethostname(), None))
    except OSError:
        pass
    matches = []
    for i, ep in enumerate(endpoints):
        host = _split_endpoint(ep)[0]
        try:
            addrs = {info[4][0] for info in socket.getaddrinfo(host, None)}
        except OSError:
            continue
        if addrs & local or host == socket.gethostname():
            matches.append(i)
    return matches[0] if len(matches) == 1 else None


def _env_says_multiprocess() -> bool:
    """A torchrun-style environment of more than one process."""
    try:
        size = int(os.environ.get("WORLD_SIZE", "1"))
    except ValueError:
        return False
    return (size > 1 and "RANK" in os.environ
            and bool(os.environ.get("MASTER_ADDR")))


def _init_method(coordinator: str) -> str:
    host, port = _split_endpoint(coordinator)
    CHECK(port is not None,
          f"the coordinator address {coordinator!r} has no port")
    host = f"[{host}]" if ":" in host else host
    return f"tcp://{host}:{port}"


def maybe_initialize() -> bool:
    """Bring up the process groups per flags and environment; True when a
    multi-process world is (already or newly) up. Idempotent."""
    global _initialized, _owns_runtime, _engine_pg, _ctrl_pg
    mode = str(GetFlag("multihost")).lower()
    CHECK(mode in ("auto", "on", "off"),
          f"-multihost must be auto/on/off, got {mode!r}")
    if mode == "off":
        return False
    if _initialized:
        return True
    coordinator = str(GetFlag("dist_coordinator"))
    rank = int(GetFlag("dist_rank"))
    size = int(GetFlag("dist_size"))
    explicit = bool(coordinator) and rank >= 0 and size > 0
    if not explicit and _net_world is not None:
        # MV_NetBind/MV_NetConnect wiring: rank 0's endpoint rendezvouses
        coordinator, rank, size = (_net_world[0], _net_rank,
                                   len(_net_world))
        explicit = True
    if not explicit and str(GetFlag("machine_file")):
        endpoints = _parse_machine_file(str(GetFlag("machine_file")))
        mf_rank = rank if rank >= 0 else _match_local_rank(endpoints)
        CHECK(mf_rank is not None and 0 <= mf_rank < len(endpoints),
              f"-machine_file: cannot infer this process's rank (give "
              f"-dist_rank); endpoints={endpoints}")
        coordinator, rank, size = endpoints[0], mf_rank, len(endpoints)
        explicit = True
    dist = _dist()
    adopt = dist.is_available() and dist.is_initialized()
    if (not explicit and mode != "on" and not _env_says_multiprocess()
            and not (adopt and dist.get_world_size() > 1)):
        return False
    _wire_mode()
    timeout = datetime.timedelta(seconds=int(GetFlag("mv_dist_timeout_s")))
    try:
        if adopt:
            # a world the caller (or a launcher) brought up: join it with
            # groups of our own, leave it up at finalize
            _owns_runtime = False
        elif explicit:
            dist.init_process_group("gloo",
                                    init_method=_init_method(coordinator),
                                    rank=rank, world_size=size,
                                    timeout=timeout)
            _owns_runtime = True
        else:
            dist.init_process_group("gloo", init_method="env://",
                                    timeout=timeout)
            _owns_runtime = True
        _engine_pg = dist.new_group(backend="gloo", timeout=timeout)
        _ctrl_pg = dist.new_group(backend="gloo", timeout=timeout)
    except Exception as exc:
        CHECK(False, f"multihost requested but torch.distributed failed: "
                     f"{exc!r}")
    _initialized = True
    Log.Info("multihost: torch.distributed (gloo) up — process %d of %d",
             dist.get_rank(), dist.get_world_size())
    return True


# -- host collectives ---------------------------------------------------------

def _pg(engine: bool):
    return _engine_pg if engine else _ctrl_pg


def _all_gather(t, engine: bool = True) -> list:
    """Every rank's tensor ``t`` (same shape and dtype on every rank), in
    rank order."""
    import torch
    dist = _dist()
    out = [torch.empty_like(t) for _ in range(process_count())]
    _note_round()
    dist.all_gather(out, t, group=_pg(engine))
    return out


def host_barrier(name: str = "mv_barrier") -> None:
    """Block until every member of the CURRENT world reaches this point
    (no-op in one process). Collective on the control group, or the
    elastic group (reference controller barrier, controller.cpp:12-36)."""
    if _isolated:
        return
    if _group is not None:
        _group.barrier(name)
        return
    if process_count() <= 1:
        return
    _note_round()
    _dist().barrier(group=_ctrl_pg)


def host_allreduce_sum(data: np.ndarray) -> np.ndarray:
    """Elementwise sum of ``data`` across the processes, summed in rank
    order on every rank (identity in one process). Collective on the
    control group, or the elastic group."""
    if _isolated:
        return data
    if _group is not None:
        if _group.size <= 1:
            return data
        parts = host_allgather_objects(np.asarray(data))
        out = parts[0].copy()
        for p in parts[1:]:
            out += p
        return out.astype(data.dtype, copy=False)
    if process_count() <= 1:
        return data
    import torch
    arr = np.ascontiguousarray(data)
    parts = _all_gather(torch.from_numpy(arr), engine=False)
    out = parts[0].numpy().copy()
    for p in parts[1:]:
        out += p.numpy()
    return out.astype(data.dtype, copy=False)


def host_allgather_bytes(data: bytes) -> list:
    """Every process's byte blob in rank order (``[data]`` in one
    process), on the control group: the lengths first, then the payloads
    padded to the ladder rung of the longest (an elastic group's relay
    carries them in one keyed round)."""
    if _isolated:
        return [data]
    if _group is not None:
        return _group.exchange(data, "HAB")
    if process_count() <= 1:
        return [data]
    import torch
    lens = _all_gather(torch.tensor([len(data)], dtype=torch.int64),
                       engine=False)
    lens = [int(x.item()) for x in lens]
    cap = max(lens)
    if cap == 0:
        return [b""] * process_count()
    cap = next_bucket(cap, min_bucket=1024)
    buf = np.zeros(cap, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    parts = _all_gather(torch.from_numpy(buf), engine=False)
    return [p.numpy()[:n].tobytes() for p, n in zip(parts, lens)]


def capped_exchange(blob: bytes, caps: dict, key, engine: bool = True,
                    channel: int = 0) -> list:
    """Every process's byte blob in ONE collective round in steady state,
    on the engine's transport (``engine=False``: the gloo control group).

    With a host wire installed, an engine exchange is the wire's
    length-framed exchange on ``channel`` (an independent stream per
    engine shard), and ``caps`` are not used. On gloo, each exchange
    rides a standing per-``key`` capacity that every rank evolves
    identically from exchanged data: a blob that fits travels inline in
    the capped buffer (a fit flag byte and an ``<i8`` length header), and
    if ANY rank overflowed, every rank runs one more round at the ladder
    rung of the now-known longest blob. The standing cap then snaps to
    that rung, so steady windows headed by the same verb stay on the
    one-round path. Gloo is one ordered stream: only channel 0.

    In an elastic epoch the exchange rides the group's coordinator relay
    (length-framed, ``caps`` unused), whose whole wall is the collective.
    """
    if _isolated:
        return [blob]
    if _group is not None:
        t0 = time.perf_counter()
        out = _group.exchange(blob, key)
        done_m = time.perf_counter()
        if engine:
            _stamp_exchange(t0, done_m - t0, done_m, time.time())
        return out
    if process_count() <= 1:
        return [blob]
    if engine and _wire is not None:
        _note_round()
        # the bound of a gloo collective, unless -mv_deadline_s is tighter
        t0 = time.perf_counter()
        out = _wire.exchange(blob, channel, timeout_s=min(
            fdeadline.timeout_or_none() or _INF,
            _dist_timeout_flag()))
        # a length-framed wire: the whole call is the collective
        done_m, done_w = time.perf_counter(), time.time()
        _stamp_exchange(t0, done_m - t0, done_m, done_w)
        return out
    CHECK(channel == 0,
          f"the gloo exchange is one ordered collective stream: channel "
          f"{channel} needs a multi-channel wire (-mv_wire=shm or tcp)")
    import torch
    n = process_count()
    t_enter = time.perf_counter()
    need = len(blob) + 9
    cap = caps.get(key, 4096)
    buf = np.zeros(cap, np.uint8)
    buf[0] = 1 if need <= cap else 0
    buf[1:9] = np.array([len(blob)], "<i8").view(np.uint8)
    if need <= cap and blob:
        buf[9:9 + len(blob)] = np.frombuffer(blob, np.uint8)
    tc = time.perf_counter()
    gathered = [p.numpy() for p in _all_gather(torch.from_numpy(buf),
                                               engine)]
    done_m, done_w = time.perf_counter(), time.time()
    coll_s = done_m - tc
    lens = [int(np.frombuffer(g[1:9].tobytes(), "<i8")[0]) for g in gathered]
    fits = [bool(g[0]) for g in gathered]
    caps[key] = next_bucket(max(lens) + 9, min_bucket=4096)
    if all(fits):
        out = [g[9:9 + m].tobytes() for g, m in zip(gathered, lens)]
    else:
        big = caps[key]
        buf2 = np.zeros(big, np.uint8)
        if blob:
            buf2[:len(blob)] = np.frombuffer(blob, np.uint8)
        tc = time.perf_counter()
        gathered = [p.numpy() for p in _all_gather(torch.from_numpy(buf2),
                                                   engine)]
        done_m, done_w = time.perf_counter(), time.time()
        coll_s += done_m - tc
        out = [gathered[i][:lens[i]].tobytes() for i in range(n)]
    if engine:
        _stamp_exchange(t_enter, coll_s, done_m, done_w)
    return out


def host_allgather_objects(obj) -> list:
    """Every process's picklable object in rank order (``[obj]`` in one
    process). Collective on the control group, or the elastic group."""
    if world_size() <= 1:
        return [obj]
    return [pickle.loads(b) for b in host_allgather_bytes(pickle.dumps(obj))]


def union_collective_ids(ids: np.ndarray) -> Optional[np.ndarray]:
    """The sorted union of every member's id set of one collective call
    (None in a one-member world, where the caller keeps its local path).
    Collective."""
    if world_size() <= 1:
        return None
    return np.unique(np.concatenate(host_allgather_objects(ids)))


def broadcast_from_master(data: np.ndarray) -> np.ndarray:
    """The value of the CURRENT world's lowest-rank member, on every
    member (identity in a one-member world). Collective on the control
    group, or the elastic group."""
    if _isolated or world_size() <= 1:
        return data
    return np.asarray(host_allgather_objects(np.asarray(data))[0])


# -- the application threads' lockstep rounds (control group) ----------------

#: standing caps of host_allgather_objects_capped, per call-site key: every
#: tagged call site is collective, so the caps evolve identically on every
#: rank
_OBJ_CAPS: dict = {}


def host_allgather_objects_capped(obj, key: str, stat: str = "agree"
                                  ) -> list:
    """``host_allgather_objects`` through the standing-cap one-round
    exchange, on the control group. ``key`` names the call site
    (``"lr_pop"``, ``"we_pop"``, ...): every rank must pass the same key
    at this lockstep point, and the key travels with the payload, so a
    rank at another call site fails the CHECK on every rank instead of
    pairing unrelated payloads. ``stat`` is the ``STATS`` stem the round's
    seconds go to."""
    if world_size() <= 1:
        return [obj]
    t0 = time.perf_counter()
    blobs = capped_exchange(pickle.dumps((key, obj), protocol=5),
                            _OBJ_CAPS, key, engine=False)
    parts = [pickle.loads(b) for b in blobs]
    keys = [k for k, _ in parts]
    CHECK(all(k == key for k in keys),
          f"lockstep rounds diverge across processes: the ranks are at "
          f"call sites {keys} — every rank must issue the same agreements "
          f"and collective writes in the same order")
    note(stat, time.perf_counter() - t0)
    return [o for _, o in parts]


def _agree_options(option, parts) -> None:
    opts = [p[-1] for p in parts]
    CHECK(all(o == opts[0] for o in opts),
          f"collective Add options diverge across processes: {opts}")


def host_payloads(deltas: list, ride=None):
    """The host copies of one collective write's deltas (device tensors
    or host arrays) and of its ``ride`` (a float or a device scalar), with
    ONE device->host copy for all the device tensors: -> (list of float32
    arrays shaped like the deltas, ride as a float or None)."""
    import torch
    dev = [d for d in deltas if isinstance(d, torch.Tensor)]
    if isinstance(ride, torch.Tensor):
        dev.append(ride)
    host = {}
    if dev:
        t0 = time.perf_counter()
        flat = torch.cat([d.detach().reshape(-1).to(torch.float32)
                          for d in dev]).cpu().numpy()
        note("d2h", time.perf_counter() - t0)
        STATS["d2h_bytes"] += flat.nbytes
        off = 0
        for d in dev:
            host[id(d)] = flat[off: off + d.numel()].reshape(tuple(d.shape))
            off += d.numel()
    out = [host[id(d)] if isinstance(d, torch.Tensor)
           else np.asarray(d, np.float32) for d in deltas]
    if ride is not None:
        ride = float(host[id(ride)]) if isinstance(ride, torch.Tensor) \
            else float(ride)
    return out, ride


def merge_collective_add(option, *arrays, key: str):
    """Merge every process's payload of one collective row or key Add: one
    all-gather tagged ``key`` of ``(arrays..., option)``, a CHECK that the
    option agrees on every rank (divergent scalars would apply different
    updates to the replicas), and per-position concatenations in rank
    order. Identity in one process."""
    if world_size() <= 1:
        return arrays
    parts = host_allgather_objects_capped(tuple(arrays) + (option,), key,
                                          stat="write")
    _agree_options(option, parts)
    t0 = time.perf_counter()
    merged = tuple(np.concatenate([p[i] for p in parts])
                   for i in range(len(arrays)))
    note("merge", time.perf_counter() - t0)
    return merged


def sum_collective_add(option, values: np.ndarray, key: str) -> np.ndarray:
    """Sum every process's delta of one collective whole-table Add in rank
    order (the same option CHECK as ``merge_collective_add``). Identity in
    one process."""
    if world_size() <= 1:
        return values
    parts = host_allgather_objects_capped((values, option), key,
                                          stat="write")
    _agree_options(option, parts)
    t0 = time.perf_counter()
    out = parts[0][0].copy()
    for p in parts[1:]:
        out += p[0]
    note("merge", time.perf_counter() - t0)
    return out.astype(values.dtype, copy=False)


# -- the device route of the collective writes -------------------------------

def _write_wire():
    """The route of the application threads' collective writes, decided
    identically on every rank: the world's device wire while it has one
    and no elastic group is installed (``device_wire.active()``), else
    None, the host route (``host_payloads`` and the tagged all-gathers of
    ``merge_collective_add`` / ``sum_collective_add``)."""
    if world_size() <= 1:
        return None
    from multiverso_tpu_torch.parallel import device_wire
    return device_wire.active()


def device_writes() -> bool:
    """Whether this world's collective writes take the device route."""
    return _write_wire() is not None


def collective_write(key: str, meta, option, deltas: list, device,
                     ride=None, stat: str = "write"):
    """One collective write on the device route (``device_writes()``):
    this rank's ``deltas`` (tensors of one dtype) stay on the card. They
    are staged into this rank's slot of the device wire's application
    channel; one round tagged ``key`` (``host_allgather_objects_capped``,
    its seconds to ``STATS`` stem ``stat``) carries ``meta`` (small host
    data: row ids, KV slots), the deltas' shapes, ``ride`` (a float or a
    device scalar, as a float32-rounded float) and ``option``, which must
    agree on every rank; then every rank copies every rank's deltas card
    to card. Returns (every rank's ``meta`` in rank order, every rank's
    deltas in rank order as views of one tensor of their dtype on
    ``device``, every rank's ride)."""
    import torch
    wire = _write_wire()
    CHECK(wire is not None, f"collective write {key!r}: this world's "
          f"writes take the host route (no device wire)")
    ride_v = None
    if isinstance(ride, torch.Tensor):
        t0 = time.perf_counter()
        host = ride.detach().reshape(-1).to(torch.float32).cpu()
        note("d2h", time.perf_counter() - t0)
        STATS["d2h_bytes"] += host.numel() * host.element_size()
        ride_v = float(host[0])
    elif ride is not None:
        ride_v = float(ride)
    deltas = [d.detach().contiguous() for d in deltas]
    seq = wire.next_write()
    t0 = time.perf_counter()
    STATS["stage_bytes"] += wire.stage_writes(seq, deltas)
    note("stage", time.perf_counter() - t0)
    specs = [(str(d.dtype), tuple(d.shape)) for d in deltas]
    parts = host_allgather_objects_capped((meta, specs, ride_v, option),
                                          key, stat=stat)
    _agree_options(option, parts)
    dtypes = {dt for p in parts for dt, _ in p[1]}
    CHECK(len(dtypes) <= 1, f"collective write {key!r}: the ranks' deltas "
          f"have different dtypes {sorted(dtypes)}")
    metas = [p[0] for p in parts]
    rides = [p[2] for p in parts]
    if not dtypes:
        return metas, [[] for _ in parts], rides
    dtype = getattr(torch, dtypes.pop().split(".")[-1])
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = [[int(np.prod(shape, dtype=np.int64)) * item
               for _, shape in p[1]] for p in parts]
    rounds, _ = wire.settle_writes(seq, nbytes, lambda blob: (
        host_allgather_objects_capped(blob, f"{key}/swap", stat=stat)))
    STATS["swap_n"] += rounds
    t0 = time.perf_counter()
    flat, peer_n, peer_bytes, ms = wire.gather_writes(seq, nbytes, dtype,
                                                      device)
    note("copy", time.perf_counter() - t0)
    STATS["copy_peer_n"] += peer_n
    STATS["copy_peer_bytes"] += peer_bytes
    STATS["copy_ms"] += ms
    views, at = [], 0
    for p in parts:
        mine = []
        for _, shape in p[1]:
            n = int(np.prod(shape, dtype=np.int64))
            mine.append(flat[at: at + n].view(shape))
            at += n
        views.append(mine)
    return metas, views, rides
