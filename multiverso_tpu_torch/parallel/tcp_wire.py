"""Cross-host TCP wire for the windowed engine's exchange.

The port's own copy of ``multiverso_tpu/parallel/tcp_wire.py``: one framed
TCP stream per (channel, peer), so a sharded engine's shards get the
independent exchange channels that gloo's one ordered collective stream
cannot offer, across hosts.

Frame grammar (per stream; a stream carries one (channel, peer) pair, so
frames never interleave across channels):

* ``[u32 sealed_len][sealed]`` where ``sealed`` is
  ``seal.seal_frame(header | chunk)``: the CRC32C seal
  (``parallel/seal.py``) is the integrity layer, so a flipped bit anywhere
  (the length prefix, the header, the body, the seal's own tag byte)
  raises ``WireCorruption`` before any field is trusted. A corrupted
  length prefix is bounded: ``sealed_len`` may never exceed the chunk cap,
  so the reader refuses it instead of waiting for bytes that never come.
* ``header`` packs ``(magic, sender, round, total, off, len, channel,
  blob_crc)``. ``round`` counts exchanges per channel in lockstep on every
  rank, so a rank re-entering an exchange alone fails with a round
  mismatch. ``blob_crc`` covers the WHOLE blob (``seal.fast_crc``),
  checked after reassembly when ``payload_crc`` is on; the engine turns
  it off, as its blobs arrive sealed.
* A blob larger than the chunk cap rides several frames; an empty blob
  still sends one zero-length frame, so a reader always has a header.

Liveness: a peer that closes its streams (killed, or shut down) raises
``ActorDied`` at once (under ``-mv_elastic`` the engine's lease consult
turns it into ``MembershipChanged`` when the peer's lease expired); a
stalled exchange asks the membership authority for a dead peer a few
times a second under ``-mv_elastic`` (the lease probe: a powered-off host
sends no reset); everything else is bounded by ``-mv_deadline_s``
(or the caller's ``timeout_s``), whose expiry raises ``DeadlineExceeded``
(the stream position is then unsound: the caller scraps the wire).

Mesh bring-up: each rank binds one listener per channel at construction;
``listen_endpoints()`` is what the install rendezvous all-gathers, and
``connect()`` dials every HIGHER rank's listeners while a short-lived
accept thread takes the inbound dials of LOWER ranks. Every accepted
stream opens with a sealed hello naming (channel, rank, session token);
a foreign dialer is rejected without harming the mesh. The accept thread
exits once the mesh is up: an exchange runs on the caller's thread, a
selectors loop interleaving sends and receives over every peer, so
frames of many chunks cannot deadlock on flow control.

Selection lives in ``multihost.maybe_install_wire``. Chaos as in the JAX
wire (``failsafe/chaos.py``), consulted once per exchange: ``tcp.delay``
sleeps before the frame train, ``tcp.drop`` swallows the final frame
toward the lowest peer (that peer's deadline converts the stall),
``tcp.partition`` severs every stream of the channel (``ActorDied`` on
both ends).
"""

from __future__ import annotations

import selectors
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from multiverso_tpu_torch.failsafe import chaos as fchaos
from multiverso_tpu_torch.failsafe import deadline as fdeadline
from multiverso_tpu_torch.failsafe.errors import ActorDied, WireCorruption
from multiverso_tpu_torch.parallel import seal
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.log import CHECK, Log

#: frame header: magic u32 | sender u32 | round u64 | total u64 |
#: off u64 | len u32 | channel u32 | blob_crc u32
_HDR_FMT = "<IIQQQIII"
_HDR_LEN = struct.calcsize(_HDR_FMT)

_MAGIC = 0x4D565443        # "MVTC"
_HELLO_MAGIC = 0x4D564849  # "MVHI"

#: how often a stalled exchange asks the elastic authority for a dead
#: peer (the shm wire's period and wait)
_PROBE_PERIOD_S = 0.25


def _peer_loss_probe(what: str):
    """The shm wire's lease probe (``shm_wire._peer_loss_probe``)."""
    from multiverso_tpu_torch.parallel import shm_wire
    return shm_wire._peer_loss_probe(what)


#: bound of the mesh bring-up when neither timeout_s nor -mv_deadline_s
#: is set: a half-up mesh must never hang the install
_CONNECT_TIMEOUT_S = 30.0

_SEND_SLICE = 1 << 18
_RECV_SLICE = 1 << 20

#: hello frames are tiny (header + token); anything bigger is foreign
_HELLO_CAP = 4096


def _dial_host() -> str:
    """The address this host advertises in ``listen_endpoints()``.
    ``-mv_wire_hostname`` does not redirect it: the label may be faked
    for loopback cross-host worlds, but dialing rides a reachable
    address: the hostname's address when it is one of this host's (it
    binds), else the loopback address."""
    try:
        addr = socket.gethostbyname(socket.gethostname())
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind((addr, 0))
        return addr
    except OSError:
        return "127.0.0.1"


class TcpWire:
    """Cross-host all-gather of bytes over framed TCP streams.

    One instance per process per world; ``exchange(blob, channel)`` is
    collective per channel: every rank calls it for the same channel in
    the same per-channel order. Construction binds the listeners;
    ``connect()`` (after the endpoint rendezvous) builds the mesh.
    Different channels may be driven from different threads at once; they
    share no state but the counts ``stats()`` reads under a lock."""

    #: transport label (multihost.wire_name reads it off the instance)
    name = "tcp"

    def __init__(self, token: str, rank: int, nprocs: int,
                 channels: int, data_bytes: int,
                 payload_crc: bool = True):
        CHECK(nprocs >= 2, "TcpWire needs a multi-process world")
        CHECK(channels >= 1, "TcpWire needs at least one channel")
        self.token = token
        self.rank = rank
        self.nprocs = nprocs
        self.channels = channels
        #: chunk cap a frame: a large blob rides several frames, so a
        #: corrupted length prefix can never demand an unbounded read
        self.chunk = max(4096, min(int(data_bytes), 4 << 20))
        self._max_frame = _HDR_LEN + self.chunk + 64
        self.payload_crc = bool(payload_crc)
        #: established streams: (channel, peer rank) -> socket
        self._conn: Dict[Tuple[int, int], socket.socket] = {}
        #: per-stream inbound buffers: one recv may pull the tail of this
        #: round together with the head of the peer's NEXT round, whose
        #: bytes must survive into the next exchange
        self._inbuf: Dict[Tuple[int, int], bytearray] = {}
        self._round = [0] * channels
        #: one reusable receive buffer a channel (channels run on
        #: different threads at once)
        self._scratch = [bytearray(_RECV_SLICE) for _ in range(channels)]
        self._closed = False
        self._lock = threading.Lock()
        self._accept_exc: Optional[BaseException] = None
        self._accept_thread: Optional[threading.Thread] = None
        #: the counts stats() reads, under the lock
        self._bytes_out = 0
        self._crc_failures = 0
        self.frame_hw_bytes = 0
        self.stall_s = 0.0
        self._t_crc = tmetrics.counter("tcp_wire.crc_failures")
        self._t_rounds = tmetrics.counter("tcp_wire.exchanges")
        self._t_bytes = tmetrics.counter("tcp_wire.bytes_out")
        self._t_stall = tmetrics.counter("tcp_wire.stall_s")
        self._t_connects = tmetrics.counter("tcp_wire.connects")
        self._t_hw = tmetrics.gauge("tcp_wire.frame_hw_bytes")
        self._listeners: List[socket.socket] = []
        self._endpoints: List[Tuple[str, int]] = []
        host = _dial_host()
        try:
            for _ch in range(channels):
                ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                self._listeners.append(ls)
                ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                ls.bind(("0.0.0.0", 0))
                ls.listen(max(8, nprocs))
                self._endpoints.append((host, ls.getsockname()[1]))
        except OSError:
            for ls in self._listeners:
                ls.close()
            raise

    # -- wiring --------------------------------------------------------------

    def listen_endpoints(self) -> List[Tuple[str, int]]:
        """This rank's (host, port) per channel: what the install
        rendezvous all-gathers so every rank can dial every listener."""
        return list(self._endpoints)

    def connect(self, world_endpoints,
                timeout_s: Optional[float] = None) -> None:
        """Build the full mesh: dial every HIGHER rank's listeners (one
        stream a channel, opened with a sealed hello naming (channel,
        rank, token)) while the accept thread takes the LOWER ranks'
        dials. ``world_endpoints`` maps rank -> [(host, port) a channel].
        Bounded by ``timeout_s`` / ``-mv_deadline_s`` / 30 s; an
        incomplete mesh raises instead of hanging, and the wire must then
        be scrapped."""
        CHECK(not self._closed, "tcp wire used after close")
        deadline = (timeout_s if timeout_s is not None
                    else (fdeadline.timeout_or_none()
                          or _CONNECT_TIMEOUT_S))
        t_end = time.monotonic() + deadline
        expected = self.rank * self.channels     # lower ranks dial us
        self._accept_exc = None
        self._accept_thread = threading.Thread(
            target=self._accept_loop, args=(expected, t_end),
            name=f"mvt-tcpwire-accept-r{self.rank}", daemon=True)
        self._accept_thread.start()
        try:
            for r in range(self.rank + 1, self.nprocs):
                eps = world_endpoints[r]
                CHECK(len(eps) >= self.channels,
                      f"tcp wire rank {r} advertised {len(eps)} "
                      f"endpoints for {self.channels} channels")
                for ch in range(self.channels):
                    host, port = eps[ch]
                    remaining = t_end - time.monotonic()
                    if remaining <= 0:
                        fdeadline.raise_deadline(
                            f"tcp wire mesh connect (dial rank {r} "
                            f"channel {ch})", deadline, fatal=True)
                    try:
                        s = socket.create_connection(
                            (host, int(port)),
                            timeout=max(0.1, remaining))
                    except OSError as e:
                        raise ActorDied(
                            f"tcp wire peer rank {r} (dial "
                            f"{host}:{port}, channel {ch})", e)
                    s.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
                    hello = struct.pack(
                        "<III", _HELLO_MAGIC, ch, self.rank
                    ) + self.token.encode("utf-8")
                    sealed = seal.seal_frame(hello)
                    s.sendall(struct.pack("<I", len(sealed)) + sealed)
                    with self._lock:
                        self._conn[(ch, r)] = s
        except BaseException:
            self.close()
            raise
        self._accept_thread.join(max(0.0, t_end - time.monotonic()) + 1.0)
        total = (self.nprocs - 1) * self.channels
        if self._accept_exc is not None or len(self._conn) != total:
            exc = self._accept_exc
            self.close()
            if isinstance(exc, (WireCorruption, ActorDied)):
                raise exc
            fdeadline.raise_deadline(
                f"tcp wire mesh connect: {len(self._conn)}/{total} "
                f"streams up before the bound"
                + (f" ({exc!r})" if exc else ""), deadline, fatal=True)
        self._t_connects.inc(len(self._conn))
        for (ch, r), s in self._conn.items():
            s.setblocking(False)
            self._inbuf.setdefault((ch, r), bytearray())
        Log.Debug("tcp wire rank %d: mesh up, %d streams across %d "
                  "channels", self.rank, len(self._conn), self.channels)

    def _accept_loop(self, expected: int, t_end: float) -> None:
        """Install time only: accept ``expected`` inbound dials, map each
        stream by its sealed hello, then close the listeners and exit."""
        sel = selectors.DefaultSelector()
        try:
            for ls in self._listeners:
                ls.setblocking(False)
                sel.register(ls, selectors.EVENT_READ)
            got = 0
            while got < expected:
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    raise socket.timeout(
                        f"tcp wire accept: {got}/{expected} inbound "
                        f"streams before the connect bound")
                for key, _ in sel.select(timeout=min(0.25, remaining)):
                    try:
                        conn, _addr = key.fileobj.accept()
                    except OSError:
                        continue
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    ch, r = self._read_hello(conn, t_end)
                    if ch is None:
                        continue        # a foreign dialer, rejected
                    with self._lock:
                        self._conn[(ch, r)] = conn
                    got += 1
        except BaseException as exc:    # reported by connect()
            self._accept_exc = exc
        finally:
            sel.close()
            for ls in self._listeners:
                ls.close()
            self._listeners = []

    def _read_hello(self, conn: socket.socket, t_end: float):
        """Check one inbound stream's sealed hello. A garbled or foreign
        hello (wrong token, magic or seal) closes THAT stream and returns
        (None, None): one stray dialer never harms the mesh."""
        try:
            (ln,) = struct.unpack("<I", self._recv_exact(conn, 4, t_end))
            if ln > _HELLO_CAP:
                raise WireCorruption(
                    f"tcp wire hello claims {ln} bytes (cap "
                    f"{_HELLO_CAP}): refused unread")
            body = seal.open_frame(self._recv_exact(conn, ln, t_end))
            magic, ch, r = struct.unpack_from("<III", body, 0)
            token = bytes(body[12:]).decode("utf-8", "replace")
            if (magic != _HELLO_MAGIC or token != self.token
                    or not 0 <= ch < self.channels
                    or not 0 <= r < self.nprocs or r == self.rank):
                raise WireCorruption(
                    f"tcp wire hello is foreign: magic {magic:#x}, "
                    f"channel {ch}, rank {r}, token match "
                    f"{token == self.token}")
            return ch, r
        except (OSError, ValueError, struct.error) as exc:
            Log.Error("tcp wire rank %d: rejected an inbound dialer: %r",
                      self.rank, exc)
            conn.close()
            return None, None

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int, t_end: float) -> bytes:
        """Blocking bounded read of exactly ``n`` bytes (hellos only;
        exchanges read non-blocking)."""
        out = bytearray()
        while len(out) < n:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("tcp wire hello read timed out")
            conn.settimeout(min(1.0, remaining))
            data = conn.recv(n - len(out))
            if not data:
                raise ConnectionResetError(
                    "tcp wire stream closed during hello")
            out += data
        return bytes(out)

    def close(self) -> None:
        """Close every stream and listener. Idempotent."""
        if self._closed:
            return
        self._closed = True
        with self._lock:
            conns = list(self._conn.values())
            self._conn.clear()
        for s in conns + self._listeners:
            s.close()
        self._listeners = []
        t = self._accept_thread
        if t is not None and t.is_alive():
            t.join(1.0)
        self._inbuf.clear()

    # -- the exchange --------------------------------------------------------

    def _frames(self, blob: bytes, rnd: int, channel: int,
                crc: int) -> Tuple[bytearray, List[int]]:
        """The outbound frame train, the same toward every peer, built in
        ONE pass: header, chunk and streamed seal trailer go straight into
        the send buffer, so the blob is copied once whatever its chunk
        count. Returns the buffer and each frame's bytes (chaos
        ``tcp.drop`` trims the final frame off a peer's send limit)."""
        mv = memoryview(blob)
        plan = ([(0, 0)] if not blob else
                [(off, min(self.chunk, len(blob) - off))
                 for off in range(0, len(blob), self.chunk)])
        out = bytearray()
        sizes = []
        for off, ln in plan:
            hdr = struct.pack(_HDR_FMT, _MAGIC, self.rank, rnd,
                              len(blob), off, ln, channel, crc)
            chunk = mv[off:off + ln]
            trailer = seal.seal_trailer((hdr, chunk))
            flen = _HDR_LEN + ln + len(trailer)
            out += struct.pack("<I", flen)
            out += hdr
            out += chunk
            out += trailer
            sizes.append(4 + flen)
        return out, sizes

    def exchange(self, blob: bytes, channel: int,
                 timeout_s: Optional[float] = None) -> List[bytes]:
        """Every rank's blob of this channel's next round, in rank order.
        Collective per channel; bounded by ``-mv_deadline_s`` or
        ``timeout_s``. A failed exchange leaves the channel's round
        counter advanced: the caller scraps the wire, never retries the
        round."""
        CHECK(not self._closed, "tcp wire used after close")
        CHECK(0 <= channel < self.channels,
              f"tcp wire channel {channel} out of range "
              f"(wire has {self.channels})")
        rnd = self._round[channel]
        self._round[channel] += 1
        crc = ((seal.fast_crc(blob) & 0xFFFFFFFF)
               if self.payload_crc else 0)
        peers = [r for r in range(self.nprocs) if r != self.rank]
        inj = fchaos.get()
        if inj is not None:
            d = inj.tcp_delay()
            if d > 0:
                time.sleep(d)
            if inj.tcp_partition():
                self._partition(channel)
        out, frame_sizes = self._frames(blob, rnd, channel, crc)
        out_view = memoryview(out)
        out_limit = {r: len(out) for r in peers}
        if inj is not None and inj.tcp_drop():
            # swallow the final frame toward the lowest peer: it stalls on
            # bytes that never arrive, and its deadline converts the stall
            out_limit[peers[0]] = len(out) - frame_sizes[-1]
        st = {r: {"buf": self._inbuf.setdefault((channel, r),
                                                bytearray()),
                  "out_pos": 0, "asm": None, "total": None,
                  "chunks": 0, "crc": 0, "crc_latch": 0,
                  "done_r": False}
              for r in peers}
        deadline = (timeout_s if timeout_s is not None
                    else fdeadline.timeout_or_none())
        t0 = time.perf_counter()
        last_probe = t0
        stall_s = 0.0
        sel = selectors.DefaultSelector()
        try:
            for r in peers:
                s = st[r]
                # bytes buffered by the previous round's recv may already
                # complete this peer's frame train
                self._drain_frames(r, channel, rnd, s)
                sock = self._conn.get((channel, r))
                if sock is None:
                    raise ActorDied(
                        f"tcp wire peer rank {r} (channel {channel}, "
                        f"round {rnd})",
                        ConnectionResetError("stream severed"))
                events = 0
                if not s["done_r"]:
                    events |= selectors.EVENT_READ
                if s["out_pos"] < out_limit[r]:
                    events |= selectors.EVENT_WRITE
                if events:
                    try:
                        sel.register(sock, events, r)
                    except (ValueError, OSError) as e:
                        # a severed stream (chaos tcp.partition)
                        raise ActorDied(
                            f"tcp wire peer rank {r} (channel {channel}, "
                            f"round {rnd})", e)
            while not all(s["done_r"] and s["out_pos"] >= out_limit[r]
                          for r, s in st.items()):
                iter_t0 = time.perf_counter()
                progressed = False
                for key, mask in sel.select(timeout=0.05):
                    r = key.data
                    s = st[r]
                    sock = key.fileobj
                    if mask & selectors.EVENT_WRITE:
                        progressed |= self._pump_send(
                            sock, s, out_view, out_limit[r], r, channel,
                            rnd, sel)
                    if mask & selectors.EVENT_READ and not s["done_r"]:
                        progressed |= self._pump_recv(
                            sock, s, r, channel, rnd, sel, out_limit[r])
                if progressed:
                    continue
                now = time.perf_counter()
                stall_s += now - iter_t0
                if now - last_probe > _PROBE_PERIOD_S:
                    last_probe = now
                    dead = _peer_loss_probe(
                        f"tcp wire exchange (channel {channel}, round "
                        f"{rnd}): peer silent")
                    if dead is not None:
                        raise dead
                if deadline is not None and now - t0 > deadline:
                    fdeadline.raise_deadline(
                        f"tcp wire exchange (channel {channel}, round "
                        f"{rnd}): a peer never sent or consumed its "
                        f"frame train", deadline, fatal=True)
        finally:
            sel.close()
        with self._lock:
            self._bytes_out += len(blob) * len(peers)
            self.stall_s += stall_s
            if len(blob) > self.frame_hw_bytes:
                self.frame_hw_bytes = len(blob)
                self._t_hw.set(float(len(blob)))
        self._t_rounds.inc()
        self._t_bytes.inc(len(blob) * len(peers))
        if stall_s > 0.0:
            self._t_stall.inc(stall_s)
        return [blob if r == self.rank else bytes(st[r]["asm"])
                for r in range(self.nprocs)]

    def _partition(self, channel: int) -> None:
        """Chaos ``tcp.partition``: sever every stream of this channel.
        The peers see EOF (``ActorDied``); this rank's next socket
        operation fails the same way."""
        with self._lock:
            severed = [(k, s) for k, s in self._conn.items()
                       if k[0] == channel]
        for _, sock in severed:
            try:
                sock.close()
            except OSError:
                pass
        Log.Error("tcp wire rank %d: chaos tcp.partition severed %d "
                  "streams on channel %d", self.rank, len(severed),
                  channel)

    def _pump_send(self, sock, s, out_view, limit, r, channel, rnd,
                   sel) -> bool:
        if s["out_pos"] >= limit:
            self._downgrade(sel, sock, s, r, limit)
            return False
        try:
            n = sock.send(out_view[s["out_pos"]:
                                   min(s["out_pos"] + _SEND_SLICE, limit)])
        except (BlockingIOError, InterruptedError):
            return False
        except OSError as e:
            raise ActorDied(
                f"tcp wire peer rank {r} (channel {channel}, round "
                f"{rnd}, send)", e)
        s["out_pos"] += n
        if s["out_pos"] >= limit:
            self._downgrade(sel, sock, s, r, limit)
        return n > 0

    def _pump_recv(self, sock, s, r, channel, rnd, sel, limit) -> bool:
        scratch = self._scratch[channel]
        try:
            n = sock.recv_into(scratch)
        except (BlockingIOError, InterruptedError):
            return False
        except OSError as e:
            raise ActorDied(
                f"tcp wire peer rank {r} (channel {channel}, round "
                f"{rnd}, recv)", e)
        if not n:
            raise ActorDied(
                f"tcp wire peer rank {r} (channel {channel}, round "
                f"{rnd})",
                ConnectionResetError(
                    "stream closed mid-exchange (peer died or was "
                    "killed)"))
        s["buf"] += memoryview(scratch)[:n]
        self._drain_frames(r, channel, rnd, s)
        if s["done_r"]:
            self._downgrade(sel, sock, s, r, limit)
        return True

    @staticmethod
    def _downgrade(sel, sock, s, r, limit) -> None:
        """Shrink a stream's selector interest to what is still pending;
        unregister it when both directions are done (a done stream must
        not be read: the peer's NEXT round may already be arriving and
        belongs to the next exchange)."""
        events = 0
        if not s["done_r"]:
            events |= selectors.EVENT_READ
        if s["out_pos"] < limit:
            events |= selectors.EVENT_WRITE
        try:
            if events:
                sel.modify(sock, events, r)
            else:
                sel.unregister(sock)
        except (KeyError, ValueError):
            pass

    def _drain_frames(self, r: int, channel: int, rnd: int,
                      s: dict) -> None:
        """Parse complete frames out of the stream buffer, stopping once
        this round's blob is assembled: bytes beyond it belong to the
        peer's next round and stay buffered."""
        buf = s["buf"]
        consumed = self._parse_frames(r, channel, rnd, s,
                                      memoryview(buf), len(buf))
        if consumed:
            del buf[:consumed]

    def _corrupt(self, msg: str) -> WireCorruption:
        with self._lock:
            self._crc_failures += 1
        self._t_crc.inc()
        return WireCorruption(msg)

    def _parse_frames(self, r: int, channel: int, rnd: int, s: dict,
                      view, size: int) -> int:
        pos = 0
        while not s["done_r"]:
            if size - pos < 4:
                return pos
            (flen,) = struct.unpack_from("<I", view, pos)
            if flen > self._max_frame or flen < _HDR_LEN:
                raise self._corrupt(
                    f"tcp wire frame from rank {r} claims {flen} "
                    f"bytes (cap {self._max_frame}): a corrupted length "
                    f"prefix is refused, never awaited")
            if size - pos < 4 + flen:
                return pos
            sealed = view[pos + 4:pos + 4 + flen]
            pos += 4 + flen
            try:
                body = seal.open_frame(sealed)
            except WireCorruption as exc:
                raise self._corrupt(str(exc)) from None
            magic, sender, frnd, total, off, ln, fch, fcrc = \
                struct.unpack_from(_HDR_FMT, body, 0)
            if magic != _MAGIC or sender != r or fch != channel:
                raise self._corrupt(
                    f"tcp wire frame header is foreign: magic "
                    f"{magic:#x}, sender {sender}, channel {fch} on "
                    f"the (channel {channel}, peer {r}) stream")
            if frnd != rnd:
                raise WireCorruption(
                    f"tcp wire desync on channel {channel}: rank {r} "
                    f"is at exchange round {frnd}, rank {self.rank} "
                    f"at {rnd}: a rank re-entered the exchange "
                    f"alone; the stream cannot be trusted")
            chunk = body[_HDR_LEN:]
            if s["asm"] is None:
                s["asm"] = bytearray(total)
                s["total"] = total
                s["crc_latch"] = fcrc
            if (total != s["total"] or off + ln > s["total"]
                    or len(chunk) != ln):
                raise self._corrupt(
                    f"tcp wire frame from rank {r} truncated/"
                    f"inconsistent: total {total} vs {s['total']}, "
                    f"chunk [{off}:{off + ln}] carrying "
                    f"{len(chunk)} bytes")
            if ln:
                s["asm"][off:off + ln] = chunk
                if self.payload_crc:
                    s["crc"] = seal.fast_crc(chunk, s["crc"])
            s["chunks"] += 1
            if s["chunks"] >= max(1, -(-s["total"] // self.chunk)):
                if self.payload_crc and \
                        (s["crc"] & 0xFFFFFFFF) != s["crc_latch"]:
                    raise self._corrupt(
                        f"tcp wire frame from rank {r} failed its "
                        f"whole-blob CRC (round {rnd}, {s['total']} "
                        f"bytes)")
                s["done_r"] = True
        return pos

    # -- diagnostics ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"token": self.token, "rank": self.rank,
                    "nprocs": self.nprocs, "channels": self.channels,
                    "chunk_bytes": self.chunk,
                    "rounds": [int(r) for r in self._round],
                    "streams": len(self._conn),
                    "endpoints": list(self._endpoints),
                    "bytes_out": self._bytes_out,
                    "crc_failures": self._crc_failures,
                    "stall_s": round(self.stall_s, 6),
                    "frame_hw_bytes": self.frame_hw_bytes}
