"""Multi-process worlds over ``torch.distributed`` with the gloo backend.

Counterpart of ``multiverso_tpu/parallel/multihost.py`` (the boot world:
no elastic groups, no shared-memory or TCP wire). The reference scales
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
* identity: ``process_index``/``process_count``,
  ``world_rank``/``world_size``, and ``require_one_process`` for the paths
  whose multi-process branch is not ported yet;
* the host collectives: ``host_barrier``, ``host_allreduce_sum``,
  ``host_allgather_bytes``/``host_allgather_objects`` and the
  standing-cap window exchange ``capped_exchange``.

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

``-mv_wire``: ``auto`` and ``gloo`` resolve to gloo; ``shm`` and ``tcp`` are
not ported yet and fail a CHECK that says so.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
from typing import Optional

import numpy as np

from multiverso_tpu_torch.parallel.mesh import next_bucket
from multiverso_tpu_torch.utils.configure import (GetFlag, MV_DEFINE_int,
                                                  MV_DEFINE_string)
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
                 "the windowed engine's host wire: auto / gloo (the port's "
                 "one wire; shm and tcp are not ported yet)")
MV_DEFINE_int("mv_dist_timeout_s", 120,
              "timeout of every collective of the process groups, seconds: "
              "a lost, diverged or slower peer fails past it instead of "
              "hanging")

_initialized = False
_owns_runtime = False      # True only when this module created the world
_engine_pg = None
_ctrl_pg = None


# -- identity ----------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def process_index() -> int:
    return _dist().get_rank() if _initialized else 0


def process_count() -> int:
    return _dist().get_world_size() if _initialized else 1


def world_rank() -> int:
    """This process's rank in the world (the boot rank: the port has no
    elastic membership)."""
    return process_index()


def world_size() -> int:
    return process_count()


def require_one_process(what: str) -> None:
    """``what`` has no multi-process branch in the port yet: in a world of
    several processes it raises on every rank instead of running a
    single-process program in each (which would let the replicas drift
    apart)."""
    if process_count() > 1:
        raise NotImplementedError(
            f"{what} in a multi-process world ({process_count()} processes) "
            f"is not ported yet (ROADMAP.md §1)")


def wire_channels() -> int:
    """Independent exchange streams of the wire: gloo is one ordered
    stream."""
    return 1


def _resolve_wire() -> str:
    wire = str(GetFlag("mv_wire")).lower()
    CHECK(wire in ("auto", "gloo", "shm", "tcp"),
          f"-mv_wire must be auto/gloo/shm/tcp, got {wire!r}")
    CHECK(wire in ("auto", "gloo"),
          f"-mv_wire={wire} is not ported yet: the port's only host wire "
          f"is gloo (-mv_wire=auto or gloo)")
    return "gloo"


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
    """Forget the explicit wiring."""
    global _net_rank, _net_endpoint, _net_world
    _net_rank = _net_endpoint = _net_world = None


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
    _resolve_wire()
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
    dist.all_gather(out, t, group=_pg(engine))
    return out


def host_barrier(name: str = "mv_barrier") -> None:
    """Block until every process reaches this point (no-op in one process).
    Collective on the control group (reference controller barrier,
    controller.cpp:12-36)."""
    if process_count() <= 1:
        return
    _dist().barrier(group=_ctrl_pg)


def host_allreduce_sum(data: np.ndarray) -> np.ndarray:
    """Elementwise sum of ``data`` across the processes, summed in rank
    order on every rank (identity in one process). Collective on the
    control group."""
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
    padded to the ladder rung of the longest."""
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


def capped_exchange(blob: bytes, caps: dict, key) -> list:
    """Every process's byte blob in ONE collective round in steady state,
    on the engine group.

    Each exchange rides a standing per-``key`` capacity that every rank
    evolves identically from exchanged data: a blob that fits travels
    inline in the capped buffer (a fit flag byte and an ``<i8`` length
    header), and if ANY rank overflowed, every rank runs one more round at
    the ladder rung of the now-known longest blob. The standing cap then
    snaps to that rung, so steady windows headed by the same verb stay on
    the one-round path. Gloo is one ordered stream: the multi-channel
    wires' per-shard channels are not ported.
    """
    if process_count() <= 1:
        return [blob]
    import torch
    n = process_count()
    need = len(blob) + 9
    cap = caps.get(key, 4096)
    buf = np.zeros(cap, np.uint8)
    buf[0] = 1 if need <= cap else 0
    buf[1:9] = np.array([len(blob)], "<i8").view(np.uint8)
    if need <= cap and blob:
        buf[9:9 + len(blob)] = np.frombuffer(blob, np.uint8)
    gathered = [p.numpy() for p in _all_gather(torch.from_numpy(buf))]
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
        gathered = [p.numpy() for p in _all_gather(torch.from_numpy(buf2))]
        out = [gathered[i][:lens[i]].tobytes() for i in range(n)]
    return out


def host_allgather_objects(obj) -> list:
    """Every process's picklable object in rank order (``[obj]`` in one
    process). Collective on the control group."""
    if process_count() <= 1:
        return [obj]
    return [pickle.loads(b) for b in host_allgather_bytes(pickle.dumps(obj))]
