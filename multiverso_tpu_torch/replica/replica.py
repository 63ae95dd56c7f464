"""Replica reader process: an out-of-process serving tier fed by fan-out.

The port's own copy of ``multiverso_tpu/replica/replica.py``. Run as
``python -m multiverso_tpu_torch.replica.replica --addr HOST:PORT``
against a trainer started with ``-mv_replica_fanout=true``. The process:

1. **joins** the trainer's coordinator as a ``role=replica`` member: a
   heartbeat lease like an SPMD member's, but no verb stream and no epoch
   membership. It loads torch with the package but never makes a CUDA
   context (:func:`main` CHECKs it once the reader is up, and the status
   file says ``cuda_initialized``): readers beside a trainer add no
   context to its card;
2. **receives** base and delta blobs (same host over a dedicated shm ring,
   two processes point to point; cross-host over a dedicated tcp stream,
   whose listener this reader binds BEFORE joining so the publisher can
   dial it; or through the coordinator's relay mailbox) and applies them
   to its :class:`~multiverso_tpu_torch.replica.delta.MirrorStore`;
3. **installs** each applied version into its own ``SnapshotStore`` (the
   class the trainer serves from, so the retention and pin contract,
   newest ``-mv_serving_keep`` live and pins nesting, carries over) and
   **serves** lookups through a reused ``ServingFrontend``: the admission
   bound, micro-batch coalescing into one union read, typed
   ``ServingOverloaded`` shedding, all as in-process serving, on host
   snapshots only;
4. **answers** a length-prefixed FLAT-framed TCP protocol
   (:class:`ReplicaClient`): ``lookup`` / ``status`` / ``pin`` / ``unpin``
   / ``trace_dump``. The frames ride :mod:`multiverso_tpu_torch.parallel.
   flat` (header + raw array segments + the versioned CRC trailer): id
   vectors cross as raw segments and result rows decode zero-copy.

The lifecycle is lease-symmetric: the trainer evicts a reader whose lease
expires; the reader exits when its heartbeats report eviction or the
coordinator stays unreachable past the hold window (the trainer is gone).
Neither side ever blocks the SPMD stream on the other.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import struct
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from multiverso_tpu_torch.elastic import dialer as _dialer
from multiverso_tpu_torch.elastic.coordinator import (MemberClient,
                                                      _recv_exact)
from multiverso_tpu_torch.failsafe.errors import TransientError
from multiverso_tpu_torch.parallel import compress, flat
from multiverso_tpu_torch.replica import delta as rdelta
from multiverso_tpu_torch.serving.frontend import ServingFrontend
from multiverso_tpu_torch.serving.store import SnapshotStore
from multiverso_tpu_torch.telemetry import fleet as tfleet
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.utils.configure import SetCMDFlag
from multiverso_tpu_torch.utils.log import CHECK, Log

#: hold window for an UNREACHABLE coordinator: floor seconds and a
#: multiple of the lease, whichever is longer. A coordinator failover (the
#: standby's lease expiry, the log replay, clients walking the endpoint
#: list) fits inside; a trainer that is really gone still ends the reader,
#: just not at the first refused connect. Eviction is another verdict: an
#: "evicted" ANSWER exits at once.
_HOLD_FLOOR_S = 20.0
_HOLD_LEASES = 6.0


def unreachable_verdict(silent_s: float, hold_s: float) -> str:
    """The hold-vs-die boundary as a pure function: an unreachable
    coordinator means **hold** (keep retrying: a failover window looks
    exactly like this) until the silence reaches ``hold_s``, and then
    **die**. Exactly at the boundary is "die" (a closed bound, like the
    lease)."""
    return "die" if silent_s >= hold_s else "hold"


#: how long the shm attach retries while the publisher discovers this
#: subscription and creates its ring segment
_ATTACH_TIMEOUT_S = 60.0

_FLEN = struct.Struct("<I")

#: cap of one lookup frame (keeps a garbage length prefix from becoming a
#: gigabyte allocation, as the coordinator's frames do)
_MAX_LOOKUP_FRAME = 1 << 31


def _cuda_initialized() -> bool:
    """Whether this process made a CUDA context (torch is loaded with the
    package; a context is made only by a device call)."""
    import torch
    return bool(torch.cuda.is_initialized())


def _send_flat(sock: socket.socket, obj) -> None:
    """One length-prefixed flat protocol frame (parallel/flat.py: header +
    raw array segments + the versioned seal): array bytes are written
    once and the far side decodes them zero-copy."""
    blob = flat.encode_frame(obj)
    sock.sendall(_FLEN.pack(len(blob)) + blob)


def _recv_flat(sock: socket.socket):
    n = _FLEN.unpack(_recv_exact(sock, 4))[0]
    CHECK(0 < n < _MAX_LOOKUP_FRAME,
          f"replica lookup frame length insane: {n}")
    return flat.decode_frame(_recv_exact(sock, n))


class _LookupServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    replica: "Replica"


class _LookupHandler(socketserver.BaseRequestHandler):
    """The reader's lookup serve loop, the read tier's QPS surface. A
    never-collective ROOT (analysis/collective.py): this process has no
    SPMD stream at all, and the handler keeps it that way (snapshot reads
    through the reused front-end only).

    Connections are PERSISTENT (frame in, frame out, until the client
    closes): a connect a lookup would cap a client at the TCP handshake
    rate."""

    def handle(self):
        while True:
            try:
                req = _recv_flat(self.request)
            except (ConnectionError, OSError):
                return          # the client closed: the normal end
            try:
                resp = self.server.replica._serve_op(req)
            except Exception as exc:
                resp = {"err": type(exc).__name__, "msg": str(exc)}
            try:
                _send_flat(self.request, resp)
            except OSError:
                return


class Replica:
    def __init__(self, host: str, port: int, *, mode: str = "shm",
                 serve_port: int = 0, ring_bytes: int = 8 << 20,
                 lease_s: float = 5.0, endpoints=None):
        CHECK(mode in ("shm", "tcp", "relay"),
              f"unknown replica mode {mode!r}")
        self.mode = mode
        self.ring_bytes = int(ring_bytes)
        self.lease_s = float(lease_s)
        self.hold_s = max(_HOLD_FLOOR_S, _HOLD_LEASES * self.lease_s)
        self.client = MemberClient(host, port, 0, self.lease_s,
                                   endpoints=endpoints)
        self.store = SnapshotStore()
        self.frontend = ServingFrontend(self.store)
        self.mirrors = rdelta.MirrorStore()
        self.rid: Optional[int] = None
        self.latest_known = -1
        #: guards latest_known and exit_code: the heartbeat thread and the
        #: apply loop both advance latest_known with a read-max-write; a
        #: stale unlocked read could regress it and fire a spurious lag
        self._state_lock = threading.Lock()
        self.applies = 0
        self._wire = None
        self._serve_port = int(serve_port)
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._stop = threading.Event()
        self.exit_code: Optional[int] = None
        # registered eagerly: the family scrapes at zero from the start
        self._t_lag = tmetrics.gauge("replica.lag_versions")
        self._t_apply = tmetrics.histogram("replica.apply_s")
        self._t_applies = tmetrics.counter("replica.applies")
        self._t_recv = tmetrics.counter("replica.recv_bytes")
        self._t_mirror = tmetrics.gauge("mem.replica.mirror_bytes")
        self._d_serve = tmetrics.digest("digest.replica.serve_s")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        token = ""
        stamp = f"{int(time.time() * 1e3) & 0xFFFF:x}"
        if self.mode == "shm":
            from multiverso_tpu_torch.parallel.shm_wire import ShmWire
            # the token carries this pid (publisher.token_pid): the
            # publisher's ring probes it, so a dead reader fails a ship at
            # once instead of waiting out the ring's bound
            token = f"{os.getpid():x}p{stamp}"
            # our (rank 1) segment exists BEFORE the join lands, so the
            # publisher's first ship can attach at once
            self._wire = ShmWire(token, rank=1, nprocs=2, channels=1,
                                 data_bytes=self.ring_bytes,
                                 payload_crc=False)
        elif self.mode == "tcp":
            from multiverso_tpu_torch.parallel.tcp_wire import TcpWire
            session = f"{os.getpid():x}{stamp}"
            # our (rank 1) listener is bound BEFORE the join lands, so the
            # publisher's first ship can dial at once. The endpoint rides
            # the join's token verbatim (session@host:port); assigned
            # through a local so self._wire keeps ONE inferred type
            wire = TcpWire(session, rank=1, nprocs=2, channels=1,
                           data_bytes=self.ring_bytes,
                           payload_crc=False)
            ep_host, ep_port = wire.listen_endpoints()[0]
            token = f"{session}@{ep_host}:{ep_port}"
            self._wire = wire
        resp = self.client.call_retry("replica_join", attempts=50,
                                      mode=self.mode, token=token,
                                      ring_bytes=self.ring_bytes,
                                      lease_s=self.lease_s)
        self.rid = int(resp["rid"])
        self.latest_known = int(resp.get("latest", -1))
        ttrace.set_process_label(f"multiverso replica r{self.rid}")
        self._start_serve_server()
        threading.Thread(target=self._hb_loop, name="mv-replica-hb",
                         daemon=True).start()
        Log.Info("replica r%d up: mode=%s, serving on 127.0.0.1:%d",
                 self.rid, self.mode, self.serve_port)

    @property
    def serve_port(self) -> int:
        return self._server.server_address[1] if self._server else -1

    def _die(self, code: int, why: str) -> None:
        Log.Error("replica r%s exiting (%d): %s", self.rid, code, why)
        with self._state_lock:
            self.exit_code = code
        self._stop.set()
        # the receive loop may be parked in an shm exchange with nothing
        # arriving: only a hard exit unblocks a standalone reader
        os._exit(code)

    def _hb_loop(self) -> None:
        first_fail: Optional[float] = None
        period = max(0.05, self.lease_s / 3.0)
        while not self._stop.wait(period):
            try:
                # the fleet rollup rides the lease beat that flows anyway;
                # telemetry must never cost the lease: a failure sends an
                # empty blob
                rollup = tfleet.encode_rollup(tfleet.build_rollup(
                    f"replica:{self.rid}", "replica"))
            except Exception:
                rollup = b""
            try:
                resp = self.client.call("replica_hb", rid=self.rid,
                                        rollup=rollup, timeout=5.0)
            except Exception:
                # UNREACHABLE is not EVICTED: a coordinator failover looks
                # exactly like this from here. Hold (and keep dialing the
                # endpoint list, which finds the successor) until the hold
                # window says the trainer is gone
                now = time.monotonic()
                if first_fail is None:
                    first_fail = now
                if unreachable_verdict(now - first_fail,
                                       self.hold_s) == "die":
                    self._die(3, "coordinator unreachable for "
                                 f"{now - first_fail:.1f}s — trainer "
                                 "gone")
                continue
            first_fail = None
            if resp.get("evicted"):
                self._die(4, "subscription evicted by the trainer")
            self._advance_latest(int(resp.get("latest", -1)))
            self._refresh_lag()

    def _advance_latest(self, version: int) -> None:
        """Monotonic max-merge of the newest version this reader has
        HEARD OF, written by the heartbeat thread (the coordinator's
        answer) and the apply loop (an applied bundle): the read-max-write
        is atomic, or a stale read regresses it."""
        with self._state_lock:
            self.latest_known = max(self.latest_known, version)

    def _refresh_lag(self) -> None:
        if self.latest_known >= 0:
            self._t_lag.set(float(max(
                0, self.latest_known - self.mirrors.version)))

    # -- the fan-in (apply) loop --------------------------------------------

    def _attach_ring(self) -> None:
        deadline = time.monotonic() + _ATTACH_TIMEOUT_S
        last: Exception = FileNotFoundError("never attempted")
        while time.monotonic() <= deadline:
            try:
                self._wire.attach_peers()
                return
            except Exception as exc:
                # the publisher creates its segment at the first ship (one
                # roster poll after the join), and an attach may land
                # between the segment's creation and its magic store (a
                # transient foreign-layout CHECK): both resolve by retrying
                last = exc
                time.sleep(0.02)
        self._die(5, f"publisher never opened the fan-out ring "
                     f"(last attach error: {last!r})")

    def _await_publisher_dial(self) -> None:
        """tcp mode: rank 1 of 2 dials nobody; wait (bounded) for the
        publisher's dial, which lands at its first ship."""
        try:
            self._wire.connect(None, timeout_s=_ATTACH_TIMEOUT_S)
        except Exception as exc:
            self._die(5, f"publisher never dialed the tcp fan-out "
                         f"stream ({exc!r})")

    def recv_loop(self) -> None:
        """Receive and apply until stopped. Runs on the main thread; the
        lookup server and the heartbeats ride their own daemons."""
        if self.mode == "shm":
            self._attach_ring()
        elif self.mode == "tcp":
            self._await_publisher_dial()
        while not self._stop.is_set():
            if self.mode in ("shm", "tcp"):
                # parked between publishes; eviction and the trainer's
                # death are the heartbeat thread's exit paths
                blob = self._wire.exchange(b"", 0)[0]
            else:
                try:
                    resp = self.client.call("replica_fetch",
                                            rid=self.rid, timeout=10.0)
                except (TransientError, ConnectionError, OSError):
                    continue        # a quiet interval: keep parking
                if resp.get("evicted"):
                    self._die(4, "subscription evicted by the trainer")
                blob = resp["blob"]
            if blob:
                self._apply(blob)

    def _apply(self, blob: bytes) -> None:
        t0 = time.perf_counter()
        self._t_recv.inc(len(blob))
        bundle = rdelta.decode(blob)
        version = int(bundle["version"])
        if version <= self.mirrors.version:
            # an idempotent re-delivery (a publisher retry after an ack it
            # never saw): re-ack, never re-apply
            self._ack(self.mirrors.version)
            return
        snap = self.mirrors.apply(bundle)
        self.store.install(snap)
        self.applies += 1
        self._advance_latest(version)
        self._t_applies.inc()
        self._t_apply.observe(time.perf_counter() - t0)
        self._t_mirror.set(float(self.mirrors.mirror_bytes()))
        self._refresh_lag()
        self._ack(version)
        Log.Debug("replica r%s: applied %s v%d (%d tables)", self.rid,
                  bundle["kind"], version, len(snap.tables))

    def _ack(self, version: int) -> None:
        try:
            self.client.call_retry("replica_ack", rid=self.rid,
                                   version=version, timeout=5.0)
        except Exception as exc:    # the lease owns liveness
            Log.Error("replica r%s: ack v%d failed: %r", self.rid,
                      version, exc)

    # -- the lookup serve surface -------------------------------------------

    def _start_serve_server(self) -> None:
        self._server = _LookupServer(("127.0.0.1", self._serve_port),
                                     _LookupHandler)
        self._server.replica = self
        threading.Thread(target=self._server.serve_forever,
                         kwargs={"poll_interval": 0.05},
                         name="mv-replica-serve", daemon=True).start()

    def _serve_op(self, req: dict) -> dict:
        # the optional trace context is popped BEFORE dispatch, so the op
        # handlers see only the verb's keys; when present the dispatch
        # span parents under the caller's client span
        tctx = req.pop(flat.TRACE_KEY, None)
        parent = (ttrace.SpanContext(int(tctx[0]), int(tctx[1]))
                  if tctx else None)
        op = req.get("op")
        t0 = time.perf_counter()
        with ttrace.span(f"replica.{op}", parent=parent, cat="server"):
            try:
                return self._dispatch_op(op, req)
            finally:
                self._d_serve.observe(time.perf_counter() - t0)

    def _dispatch_op(self, op, req: dict) -> dict:
        if op == "lookup":
            ids = req.get("ids")
            tid = int(req["table_id"])
            rows = self.frontend.lookup(
                tid,
                None if ids is None else np.asarray(ids),
                version=req.get("version"),
                deadline=req.get("deadline"))
            # -mv_compress + a lossy-opted table: the f32 rows ride a bf16
            # envelope (flat 'q' tag); the client's flat decode hands back
            # a plain ndarray either way
            return {"rows": compress.pack_serve_rows(tid, rows)}
        if op == "status":
            return self.status()
        if op == "pin":
            return {"version": self.store.pin(int(req["version"]))}
        if op == "unpin":
            self.store.unpin(int(req["version"]))
            return {"ok": True}
        if op == "trace_dump":
            # this process's span buffer as Chrome trace JSON text (an
            # offline artifact, not a hot-path payload)
            return {"trace_json": json.dumps(ttrace.to_chrome_trace())}
        CHECK(False, f"replica serve: unknown op {op!r}")

    def status(self) -> dict:
        return {
            "rid": self.rid, "mode": self.mode,
            "latest": self.store.latest_version(),
            "live_versions": self.store.live_versions(),
            "latest_known": self.latest_known,
            "lag_versions": (max(0, self.latest_known
                                 - self.mirrors.version)
                             if self.latest_known >= 0 else None),
            "applies": self.applies,
            "mirror_bytes": self.mirrors.mirror_bytes(),
            "jax_free": "jax" not in sys.modules,
        }


class ReplicaClient:
    """Client of a reader's lookup surface (tests, the smoke script).
    Holds ONE persistent connection (a connect a lookup would cap the
    throughput at the TCP handshake rate); reconnects once on a broken
    stream. An instance serializes its calls under a lock: give each
    client thread its own (the server micro-batches across connections).

    ``lookup`` ships its id vector as a raw array segment, and the
    returned rows are a READ-ONLY zero-copy view into the receive buffer
    (copy before mutating)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)
        # the shared dialer: bounded connect retries with jittered
        # backoff, and the typed CoordinatorUnreachable when exhausted
        self._dialer = _dialer.Dialer([(host, int(port))],
                                      what=f"replica-lookup:{port}")
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def close(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _call(self, timeout: float = 30.0, **req) -> dict:
        with ttrace.span(f"replica.{req.get('op')}", cat="client") as ctx:
            if ctx is not None:
                # the trace context rides the frame as an OPTIONAL dict
                # entry; with tracing off the key is absent
                req[flat.TRACE_KEY] = [ctx.trace_id, ctx.span_id]
            with self._lock:
                resp = None
                for attempt in (0, 1):
                    if self._sock is None:
                        self._sock = self._dialer.dial(
                            deadline_s=min(timeout,
                                           self._dialer.deadline_s))
                    try:
                        self._sock.settimeout(timeout)
                        _send_flat(self._sock, req)
                        resp = _recv_flat(self._sock)
                        break
                    except (ConnectionError, OSError):
                        # the server restarted or an idle stream dropped:
                        # one retry on a fresh connection, then it is real
                        self.close()
                        if attempt:
                            raise
        err = resp.get("err") if isinstance(resp, dict) else None
        if err is not None:
            raise RuntimeError(
                f"replica serve error {err}: {resp.get('msg')}")
        return resp

    def lookup(self, table_id: int, ids=None, *,
               version: Optional[int] = None,
               deadline: Optional[float] = None) -> np.ndarray:
        # the ids ride as a raw array segment; the dtype is NOT coerced
        # here: the server's admission owns id typing (a float id vector
        # fails THERE with the typed message)
        ids_a = None if ids is None else np.ascontiguousarray(
            np.asarray(ids).ravel())
        return self._call(op="lookup", table_id=int(table_id),
                          ids=ids_a, version=version,
                          deadline=deadline)["rows"]

    def status(self) -> dict:
        return self._call(op="status")

    def pin(self, version: int) -> int:
        return self._call(op="pin", version=int(version))["version"]

    def unpin(self, version: int) -> None:
        self._call(op="unpin", version=int(version))

    def trace_dump(self) -> dict:
        """The reader's Chrome trace object (run it with ``--trace``)."""
        return json.loads(self._call(op="trace_dump")["trace_json"])


def _write_status(path: str, rep: Replica) -> None:
    """The status file: rid, serve port, pid and whether this process made
    a CUDA context (never, by design); written atomically."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"rid": rep.rid, "serve_port": rep.serve_port,
                   "pid": os.getpid(),
                   "cuda_initialized": _cuda_initialized()}, f)
    os.replace(tmp, path)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m multiverso_tpu_torch.replica.replica",
        description="replica reader: join a trainer's replica plane, "
                    "mirror published versions, serve lookups (no CUDA "
                    "context)")
    p.add_argument("--addr", required=True,
                   help="trainer replica coordinator endpoint list "
                        "host:port[,host:port] — primary first, "
                        "standby successor endpoints after")
    p.add_argument("--mode", choices=("shm", "tcp", "relay"),
                   default="shm",
                   help="fan-out transport: shm (same host), tcp "
                        "(remote: bundles ride a direct framed stream "
                        "from the publisher), or the coordinator socket "
                        "relay (remote fallback)")
    p.add_argument("--serve-port", type=int, default=0,
                   help="lookup TCP port (0 = ephemeral)")
    p.add_argument("--ring-bytes", type=int, default=8 << 20)
    p.add_argument("--lease", type=float, default=5.0,
                   help="heartbeat lease seconds")
    p.add_argument("--keep", type=int, default=2,
                   help="version retention (the -mv_serving_keep "
                        "contract)")
    p.add_argument("--status-file", default="",
                   help="write {rid, serve_port, pid, cuda_initialized} "
                        "JSON here once up (discovery by drills)")
    p.add_argument("--compress", action="store_true",
                   help="enable the tagged serve-frame codecs "
                        "(-mv_compress) in this reader; lookup rows "
                        "compress only for tables named in "
                        "--compress-lossy")
    p.add_argument("--trace", action="store_true",
                   help="arm -trace span recording in this reader; fetch "
                        "the buffer with the trace_dump serve op")
    p.add_argument("--compress-lossy", default="",
                   help="comma-separated table ids (or 'all') whose "
                        "serve rows may ride the lossy bf16 codec "
                        "(-mv_compress_lossy)")
    p.add_argument("--chaos-spec", default="",
                   help="arm -chaos_spec fault injection in this reader "
                        "only (serving.delay:1@0.05 makes THIS reader the "
                        "deterministic p99 outlier /fleet must name)")
    p.add_argument("--chaos-seed", type=int, default=0,
                   help="-chaos_seed of the reader's injector streams")
    args = p.parse_args(argv)
    endpoints = _dialer.parse_endpoints(args.addr)
    host, port_n = endpoints[0]
    SetCMDFlag("mv_serving_keep", args.keep)
    if args.trace:
        SetCMDFlag("trace", True)
    if args.compress:
        SetCMDFlag("mv_compress", True)
    if args.compress_lossy:
        SetCMDFlag("mv_compress_lossy", args.compress_lossy)
    if args.chaos_spec:
        SetCMDFlag("chaos_spec", args.chaos_spec)
        SetCMDFlag("chaos_seed", args.chaos_seed)
    rep = Replica(host, port_n, mode=args.mode,
                  serve_port=args.serve_port,
                  ring_bytes=args.ring_bytes, lease_s=args.lease,
                  endpoints=endpoints)
    rep.start()
    # the reader runs beside the ranks that own the card: once it is up
    # (wire, join, serve and heartbeat threads) it must hold no CUDA
    # context, or four readers would be four more contexts on the card
    CHECK(not _cuda_initialized(),
          "the replica reader made a CUDA context: something on its "
          "path touched the device")
    if args.status_file:
        _write_status(args.status_file, rep)
    rep.recv_loop()
    return rep.exit_code or 0


if __name__ == "__main__":
    sys.exit(main())
