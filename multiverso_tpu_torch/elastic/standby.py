"""Standby coordinator: the replicated op log and the lease takeover.

The port's own copy of ``multiverso_tpu/elastic/standby.py``. The
membership authority (``elastic/coordinator.py``) is a deterministic state
machine: every durable mutation is one of a small set of record kinds
(the op-log grammar: the coordinator's ``_ap_*`` methods). This module
holds both halves of its replication:

* :class:`LogShipper` runs INSIDE the primary's process. The coordinator
  appends a sealed, sequence-numbered record under its own state lock (so
  log order is mutation order), the shipper streams it to the standby over
  one TCP connection, and an ack-reader thread advances the acked
  watermark the dispatch-level replication barrier waits on. A keepalive
  ping (seq 0, never stored) feeds the standby's takeover lease while the
  world idles. Any shipper failure degrades the primary to solo, loudly,
  instead of stalling the control plane: availability over replication.

* :class:`StandbyServer` is the standby process. It accepts the log
  stream, acks every record, and holds a **takeover lease** on the
  primary: when the stream goes silent for ``lease_s`` it replays the
  stored records into a fresh, quiescent
  :class:`~multiverso_tpu_torch.elastic.coordinator.Coordinator`
  (``replay``: the SAME ``_ap_*`` effects the live primary ran, so the
  replayed state is the live state, pinned by ``state_digest``), re-bases
  every lease and ack clock (``rebase_clocks``: no spurious evictions out
  of the outage), then binds the successor endpoint and serves. Clients
  find it by walking their ordered ``-mv_coordinator`` endpoint list.

Heartbeat records (``hb``/``replica_hb``) are compacted in place (only the
newest per member or replica is stored), so a long-lived standby's memory
is bounded by state size plus real transition history, not by heartbeat
rate.

The standby is a control-plane process: it must never touch a card. The
import path loads torch (the package ``__init__``) but never initializes
CUDA; ``main`` checks that and the status file records it
(``cuda_initialized``). ``--primary`` hosts a PRIMARY coordinator instead,
for worlds that want the authority out of rank 0's process, which is also
what lets the failover drills ``kill -9`` a real primary process.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import threading
import time
from typing import Optional, Tuple

from multiverso_tpu_torch.elastic import coordinator as _coord
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.log import CHECK, Log

#: socket send/ack bound on the shipper's stream — past this the link
#: is declared dead (the primary degrades to solo)
_SHIP_TIMEOUT_S = 2.0

#: record kinds compacted to newest-per-key in the standby's store
#: (their only durable effect is a clock the takeover re-bases anyway)
_COMPACT_KINDS = ("hb", "replica_hb")


class LogShipper:
    """Primary-side op-log stream to one standby. ``append`` is called
    under the coordinator's state lock; the shipper serializes seq
    assignment + socket send under its own reentrant lock so records
    hit the wire in seq order."""

    def __init__(self, host: str, port: int, lease_s: float = 5.0,
                 on_degrade=None):
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._seq = 0
        self._acked = 0
        self._dead = False
        self._stop = threading.Event()
        self._on_degrade = on_degrade
        self.ping_s = max(0.05, float(lease_s) / 3.0)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=5.0)
        self._sock.settimeout(_SHIP_TIMEOUT_S)
        self._ack_thread = threading.Thread(
            target=self._ack_loop, name="mv-standby-ack", daemon=True)
        self._ack_thread.start()
        self._ping_thread = threading.Thread(
            target=self._ping_loop, name="mv-standby-ping", daemon=True)
        self._ping_thread.start()

    @property
    def alive(self) -> bool:
        return not self._dead

    @property
    def acked_seq(self) -> int:
        with self._lock:
            return self._acked

    def append(self, kind: str, data: dict) -> Optional[int]:
        """Ship one record; returns its seq, or None when the link is
        (or just went) dead — the caller's degrade path owns that."""
        with self._lock:
            if self._dead:
                return None
            seq = self._seq + 1
            try:
                _coord._send_frame(
                    self._sock, {"seq": seq, "kind": kind, "data": data})
            except (ConnectionError, OSError) as exc:
                self._die(f"append failed: {exc!r}")
                return None
            self._seq = seq
            return seq

    def wait_acked(self, seq: int, timeout: float) -> bool:
        """Bounded wait for the standby's cumulative ack to reach
        ``seq``. False on timeout or link death."""
        deadline = time.monotonic() + float(timeout)
        with self._cv:
            while self._acked < seq and not self._dead:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.1))
            return self._acked >= seq

    def _ack_loop(self) -> None:
        try:
            while True:
                self._sock.settimeout(None)
                resp = _coord._recv_frame(self._sock)
                with self._cv:
                    self._acked = max(self._acked,
                                      int(resp.get("acked", 0)))
                    self._cv.notify_all()
        except Exception as exc:
            self._die(f"ack stream closed: {exc!r}")

    def _ping_loop(self) -> None:
        # seq-0 keepalive: feeds the standby's takeover lease while
        # the world idles; never stored, never acked
        while not self._stop.wait(self.ping_s):
            with self._lock:
                if self._dead:
                    return
                try:
                    _coord._send_frame(
                        self._sock, {"seq": 0, "kind": "ping",
                                     "data": {}})
                except (ConnectionError, OSError) as exc:
                    self._die(f"ping failed: {exc!r}")
                    return

    def _die(self, why: str) -> None:
        with self._cv:
            if self._dead:
                return
            self._dead = True
            self._cv.notify_all()
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        cb = self._on_degrade
        if cb is not None:
            cb(why)

    def close(self) -> None:
        """Orderly teardown (primary shutdown / degrade): no degrade
        callback re-entry."""
        with self._cv:
            self._on_degrade = None
        self._die("closed")

    def abandon(self) -> None:
        """Chaos kill path: drop the link with NO goodbye and NO
        callback — the standby must find out from its lease."""
        with self._cv:
            self._on_degrade = None
        self._die("abandoned (simulated kill)")


class StandbyServer:
    """The standby process: log-stream listener + takeover lease
    monitor + (after takeover) the successor coordinator."""

    def __init__(self, listen: Tuple[str, int],
                 serve_addr: Tuple[str, int], lease_s: float = 5.0,
                 coord_lease_s: Optional[float] = None):
        self._lock = threading.RLock()
        self._records: list = []
        self._slots: dict = {}          # compaction index for hb kinds
        self._last_feed = time.monotonic()
        self._primary_seen = False
        self._feeds: set = set()        # live log-stream sockets
        self.lease_s = float(lease_s)
        self.coord_lease_s = float(coord_lease_s
                                   if coord_lease_s is not None
                                   else lease_s)
        self.serve_addr = (str(serve_addr[0]), int(serve_addr[1]))
        self.successor: Optional[_coord.Coordinator] = None
        self.takeover_ms: Optional[float] = None
        self.takeover_digest: Optional[str] = None
        self._stop = threading.Event()

        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._feed(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((str(listen[0]), int(listen[1])),
                               _Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="mv-standby-log", daemon=True)
        self._thread.start()
        self._monitor = threading.Thread(
            target=self._watch, name="mv-standby-takeover", daemon=True)
        self._monitor.start()
        Log.Info("elastic: standby up — log stream at :%d, successor "
                 "endpoint %s:%d, takeover lease %.1fs", self.port,
                 self.serve_addr[0], self.serve_addr[1], self.lease_s)

    # -- log intake ----------------------------------------------------------

    def _feed(self, sock) -> None:
        """One primary connection: store + ack records until the peer
        (or this standby's takeover) ends the stream."""
        with self._lock:
            self._primary_seen = True
            self._last_feed = time.monotonic()
            self._feeds.add(sock)
        try:
            while True:
                rec = _coord._recv_frame(sock)
                with self._lock:
                    if self.successor is not None:
                        # a zombie primary past our takeover: refuse
                        # the stream — there is one authority now
                        return
                    self._last_feed = time.monotonic()
                    if rec.get("kind") == "ping":
                        continue
                    self._store(rec)
                    acked = int(rec["seq"])
                _coord._send_frame(sock, {"acked": acked})
        except (ConnectionError, OSError):
            return
        except Exception as exc:    # corrupt frame: drop the stream —
            Log.Error("elastic: standby log stream error: %r", exc)
            return                  # the primary degrades to solo
        finally:
            with self._lock:
                self._feeds.discard(sock)

    def _store(self, rec: dict) -> None:
        kind = rec.get("kind")
        if kind in _COMPACT_KINDS:
            key = (kind, rec["data"].get("rank",
                                         rec["data"].get("rid")))
            i = self._slots.get(key)
            if i is not None:
                self._records[i] = rec
                return
            self._slots[key] = len(self._records)
        self._records.append(rec)

    def record_count(self) -> int:
        with self._lock:
            return len(self._records)

    def records(self) -> list:
        with self._lock:
            return list(self._records)

    # -- takeover ------------------------------------------------------------

    def _lease_expired(self, now: float) -> bool:
        """Pure takeover-boundary predicate (unit-pinned): the lease
        expires when a primary WAS seen and the log stream has been
        silent for >= lease_s. Never before first contact (a standby
        booted ahead of its primary must wait), never after a
        takeover already happened."""
        with self._lock:
            if not self._primary_seen or self.successor is not None:
                return False
            return now - self._last_feed >= self.lease_s

    def _watch(self) -> None:
        period = max(0.02, min(0.1, self.lease_s / 4.0))
        while not self._stop.wait(period):
            if self._lease_expired(time.monotonic()):
                self.force_takeover("takeover lease expired "
                                    f"({self.lease_s:g}s silent)")

    def force_takeover(self, why: str = "forced") -> "_coord.Coordinator":
        """Replay the stored log into a quiescent Coordinator, re-base
        its clocks, bind the successor endpoint, serve. Idempotent."""
        with self._lock:
            if self.successor is not None:
                return self.successor
            records = list(self._records)
            t0 = time.monotonic()
            Log.Error("elastic: STANDBY TAKEOVER (%s) — replaying %d "
                      "op-log records", why, len(records))
            coord = _coord.Coordinator(self.serve_addr[0],
                                       self.serve_addr[1],
                                       self.coord_lease_s, serve=False)
            coord.replay(records)
            coord.rebase_clocks()
            # the replayed state's digest before any client reaches it:
            # what the dead primary's state_digest() must equal
            self.takeover_digest = coord.state_digest()
            coord.serve()
            self.successor = coord
            self.takeover_ms = 1e3 * (time.monotonic() - t0)
            tmetrics.counter("elastic.takeovers").inc()
            tmetrics.gauge("elastic.takeover_replay_ms").set(
                self.takeover_ms)
            Log.Error("elastic: successor serving at %s:%d (%.1fms "
                      "replay of %d records)", self.serve_addr[0],
                      coord.port, self.takeover_ms, len(records))
            return coord

    def stop(self) -> None:
        self._stop.set()
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:       # pragma: no cover - teardown race
            pass
        # drop live log streams too — a stopped standby must LOOK dead
        # to its primary (degrade-to-solo), not leave it acking into a
        # half-closed socket
        with self._lock:
            feeds, self._feeds = set(self._feeds), set()
        for sock in feeds:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        with self._lock:
            succ = self.successor
        if succ is not None:
            succ.stop()


# -- process entry point (no CUDA context) --------------------------------


def _cuda_initialized() -> bool:
    """Whether this process created a CUDA context (torch is loaded with
    the package; a context is made only by a device call)."""
    import torch
    return bool(torch.cuda.is_initialized())


def _parse_addr(spec: str) -> Tuple[str, int]:
    host, _, port = str(spec).rpartition(":")
    CHECK(host and port.isdigit(),
          f"address must be host:port, got {spec!r}")
    return host, int(port)


def _write_status(path: str, payload: dict) -> None:
    """The status file: ``payload`` with this process's pid and whether it
    created a CUDA context (never, by design)."""
    if not path:
        return
    payload = dict(payload, pid=os.getpid(),
                   cuda_initialized=_cuda_initialized())
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)       # atomic: readers never see a torn file


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m multiverso_tpu_torch.elastic.standby",
        description="standby membership coordinator (op-log receiver "
                    "+ lease takeover), or a standalone primary host")
    p.add_argument("--listen", default="127.0.0.1:0",
                   help="op-log stream endpoint the primary ships to "
                        "(standby role)")
    p.add_argument("--serve", default="127.0.0.1:0",
                   help="successor coordinator endpoint bound at "
                        "takeover — list it in every client's "
                        "-mv_coordinator")
    p.add_argument("--lease", type=float, default=5.0,
                   help="takeover lease: log-stream silence past this "
                        "makes the standby take over")
    p.add_argument("--coord-lease", type=float, default=0.0,
                   help="member heartbeat lease of the hosted/"
                        "successor coordinator (default: --lease)")
    p.add_argument("--status-file", default="",
                   help="atomically rewritten JSON status "
                        "(role/ports/pid) for discovery by drills "
                        "and operators")
    p.add_argument("--primary", default="",
                   help="host a PRIMARY coordinator at this host:port "
                        "instead of standing by (ships its op log to "
                        "--standby when given)")
    p.add_argument("--standby", default="",
                   help="with --primary: the standby's --listen "
                        "endpoint to replicate to")
    args = p.parse_args(argv)
    CHECK(not _cuda_initialized(),
          "the standby coordinator must never create a CUDA context: it "
          "runs beside the ranks that own the card")

    if args.primary:
        host, port = _parse_addr(args.primary)
        coord = _coord.Coordinator(host, port,
                                   args.coord_lease or args.lease,
                                   serve=False)
        if args.standby:                # attached before any client op
            coord.attach_standby(args.standby)
        coord.serve()
        _write_status(args.status_file,
                      {"role": "primary", "port": coord.port,
                       "standby": coord.standby_state})
        while True:             # killed by the operator (or the drill)
            time.sleep(0.5)
            _write_status(args.status_file,
                          {"role": "primary", "port": coord.port,
                           "standby": coord.standby_state})

    srv = StandbyServer(_parse_addr(args.listen),
                        _parse_addr(args.serve), lease_s=args.lease,
                        coord_lease_s=args.coord_lease or None)
    _write_status(args.status_file,
                  {"role": "standby", "log_port": srv.port})
    announced = False
    while True:
        time.sleep(0.1)
        if srv.successor is not None and not announced:
            announced = True
            _write_status(args.status_file,
                          {"role": "successor",
                           "port": srv.successor.port,
                           "records": srv.record_count(),
                           "takeover_ms": srv.takeover_ms,
                           "digest": srv.takeover_digest})


if __name__ == "__main__":      # pragma: no cover - process entry
    raise SystemExit(main())
