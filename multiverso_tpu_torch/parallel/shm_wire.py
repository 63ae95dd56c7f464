"""Same-host shared-memory wire for the windowed engine's exchange.

The port's own copy of ``multiverso_tpu/parallel/shm_wire.py``. gloo's
all-gather moves a window between two processes of one machine through
the socket stack; this wire moves it with memcpys. Every rank owns one
POSIX shared-memory segment per (channel, rank), and an exchange round is
one copy in and N-1 copies out per chunk.

Protocol (per channel; channels are INDEPENDENT exchange streams, one per
engine shard, so a sharded engine's shards exchange concurrently without
sharing a collective order):

* A segment is ``header | consumed[nprocs] | data[cap]``. The owning rank
  publishes a frame as one or more chunks of at most ``cap`` bytes; the
  header carries ``(seq, round, total, chunk_off, chunk_len, crc32)`` and
  is finalized by the ``seq`` store, so a reader accepts a chunk only once
  ``seq`` reaches the value it expects (x86-TSO store order; the header
  CRC is the backstop).
* ``seq`` counts chunks per segment; ``round`` counts exchanges per
  channel. Both advance in lockstep on every rank (the exchange is
  collective), so a rank re-entering an exchange alone fails loudly with a
  round mismatch (``WireCorruption``) instead of pairing different
  windows.
* Flow control: ``consumed[j]`` (written by reader j into the writer's
  segment) is the last chunk seq rank j consumed. The writer reuses its one
  data area only after every reader consumed the previous chunk. Readers
  and the writer interleave inside one exchange call, so frames of many
  chunks cannot deadlock.
* The header CRC is always checked. ``crc32`` covers the WHOLE blob and is
  checked after reassembly when ``payload_crc`` is on (the engine turns it
  off: its window blobs arrive sealed, ``parallel/seal.py``); a mismatch or
  a ``total`` the chunks never reach raises ``WireCorruption``.

Liveness: shared memory has no connection a dead peer could break. A
stalled wait checks the peers' processes (``peer_pids``, the same host by
construction) a few times a second and raises ``ActorDied`` once one has
exited; under ``-mv_elastic`` it first asks the membership authority
whether a peer's lease expired (``_peer_loss_probe``, the JAX package's
probe) and raises the typed ``MembershipChanged``, and an ``ActorDied``
reaches the engine's lease consult too (``Server._bounded_collective``),
never the fatal path while a transition is possible. Every wait is also bounded by ``timeout_s`` or
``-mv_deadline_s`` (``failsafe/deadline.py``), whose expiry raises
``DeadlineExceeded``; with neither, the wait blocks, as the gloo
collective would, backing off to short sleeps (the engine's exchanges
pass the process groups' ``-mv_dist_timeout_s``). Own segments are
unlinked at ``close()`` and, for a wire never closed, at interpreter exit.

Selection lives in ``multihost.maybe_install_wire``. Not ported: the
``shm_wire.*`` telemetry counters, which ``stats()`` keeps as plain counts.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
import weakref
from multiprocessing import shared_memory
from typing import Dict, List, Optional

import numpy as np

from multiverso_tpu_torch.failsafe import deadline as fdeadline
from multiverso_tpu_torch.failsafe.errors import ActorDied, WireCorruption
# both ends of a ring are one build on one host, so they pick the same
# checksum engine
from multiverso_tpu_torch.parallel.seal import fast_crc
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils.log import CHECK

#: header field offsets (little-endian u64 unless noted)
_OFF_SEQ = 0          # chunks written to this segment, monotonic
_OFF_ROUND = 8        # exchange round of the current frame
_OFF_TOTAL = 16       # whole-blob byte length of the current frame
_OFF_CHUNK_OFF = 24   # byte offset of the current chunk within the blob
_OFF_CHUNK_LEN = 32   # byte length of the current chunk
_OFF_CRC = 40         # u32: crc32 of the WHOLE blob (payload_crc mode)
_OFF_MAGIC = 44       # u32: segment layout magic
_OFF_HCRC = 48        # u32: crc32 of the frame header fields + seq
_HDR = 64

_MAGIC = 0x4D56_5348  # "MVSH"

#: hot spins before the waiter starts sleeping (a peer is usually
#: microseconds away; sleeping at once would add scheduler latency to
#: every chunk)
_HOT_SPINS = 400
_SLEEP_S = 50e-6

#: how often a stalled wait checks that its peers' processes live (and,
#: under -mv_elastic, asks for their leases)
_PROBE_PERIOD_S = 0.25

#: the lease probe's wait for a verdict: a stalled exchange must not sit
#: in the coordinator while its peer arrives; the blocking consult is the
#: engine's error path (Server._bounded_collective)
_PROBE_WAIT_S = 0.05


def _peer_loss_probe(what: str):
    """A stalled exchange asks the elastic authority whether a peer is
    DEAD (lease expired). Returns the typed MembershipChanged to raise, or
    None (no elastic plane, every lease fresh, the probe failed: keep
    waiting; the deadline still bounds the wait)."""
    try:
        from multiverso_tpu_torch import elastic
        if not elastic.enabled():
            return None
        return elastic.peer_loss(what, wait_s=_PROBE_WAIT_S)
    except Exception:
        return None

#: wires not closed yet: their own segments are unlinked at exit
_LIVE: "weakref.WeakSet[ShmWire]" = weakref.WeakSet()


def _close_live() -> None:
    for w in list(_LIVE):
        w.close()


atexit.register(_close_live)


def _process_gone(pid: int) -> bool:
    """Whether process ``pid`` (of this host) has exited: no such process,
    or a zombie its parent has not reaped yet."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            # the state follows the parenthesised command name
            return f.read().rsplit(b")", 1)[1].split()[0] in (b"Z", b"X")
    except FileNotFoundError:
        return True
    except (OSError, IndexError):   # no procfs: ask the kernel
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except PermissionError:
            pass
        return False


def _header_crc(seq: int, rnd: int, total: int, off: int, ln: int,
                crc: int) -> int:
    """CRC over the frame header's fields, the seq value the chunk
    publishes under included: always checked (a torn header mis-sizes the
    copy), ~50 bytes a chunk."""
    return fast_crc(b"%d|%d|%d|%d|%d|%d"
                    % (seq, rnd, total, off, ln, crc)) & 0xFFFFFFFF


def segment_name(token: str, channel: int, rank: int) -> str:
    """POSIX shm name of (channel, rank)'s segment: short (the POSIX limit
    is system-dependent) and unique per world through ``token``."""
    return f"mv{token}c{channel}r{rank}"


def _attach(name: str) -> shared_memory.SharedMemory:
    """Attach an existing segment WITHOUT handing its lifetime to this
    process's resource tracker (before Python 3.13 an attachment is
    registered too, and the tracker would unlink the owner's segment when
    this process exits)."""
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:       # Python < 3.13: no track parameter
        # suppress the registration of this attach only (unregistering
        # after it would also drop the creator's entry when both ends live
        # in one process, as in the protocol tests)
        from multiprocessing import resource_tracker
        orig = resource_tracker.register

        def _no_shm_register(name_, rtype):
            if rtype != "shared_memory":
                orig(name_, rtype)

        resource_tracker.register = _no_shm_register
        try:
            return shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig


class _Segment:
    """One (channel, rank) segment and its numpy field views."""

    def __init__(self, shm: shared_memory.SharedMemory, nprocs: int,
                 cap: int, owned: bool):
        self.shm = shm
        self.owned = owned
        self.cap = cap
        buf = shm.buf
        self.u64 = np.frombuffer(buf, np.uint64, count=_HDR // 8)
        self.u32 = np.frombuffer(buf, np.uint32, count=_HDR // 4)
        self.consumed = np.frombuffer(buf, np.uint64, count=nprocs,
                                      offset=_HDR)
        self.data = np.frombuffer(buf, np.uint8,
                                  count=cap, offset=_HDR + 8 * nprocs)

    def seq(self) -> int:
        return int(self.u64[_OFF_SEQ // 8])

    def close(self) -> None:
        # the numpy views first: SharedMemory.close() refuses while
        # exported memoryviews are alive
        self.u64 = self.u32 = self.consumed = self.data = None
        try:
            self.shm.close()
        except BufferError:     # a view still exported: the unlink below
            pass                # still frees the name
        if self.owned:
            try:
                self.shm.unlink()
            except FileNotFoundError:   # already unlinked
                pass


class ShmWire:
    """Same-host all-gather of bytes over shared memory.

    One instance per process per world; ``exchange(blob, channel)`` is
    collective per channel: every rank calls it for the same channel in
    the same per-channel order (the engine's window stream guarantees
    that, per shard). Different channels may be driven from different
    threads at once; they share no state but the counts ``stats()``
    reads under a lock."""

    #: transport label (multihost.wire_name reads it off the instance)
    name = "shm"

    def __init__(self, token: str, rank: int, nprocs: int,
                 channels: int, data_bytes: int,
                 payload_crc: bool = True, peer_pids=None):
        CHECK(nprocs >= 2, "ShmWire needs a multi-process world")
        #: every rank's process id (None: no liveness check), which a
        #: stalled wait checks
        self.peer_pids = None if peer_pids is None else list(peer_pids)
        CHECK(channels >= 1, "ShmWire needs at least one channel")
        #: whole-blob CRC a frame; the engine's install turns it off
        #: because every window and head-marker blob already carries its
        #: seal, checked before parsing. Headers are always checked, and
        #: a truncation shows in the total/chunk accounting either way.
        self.payload_crc = bool(payload_crc)
        self.token = token
        self.rank = rank
        self.nprocs = nprocs
        self.channels = channels
        self.cap = max(int(data_bytes), 4096)
        self._size = _HDR + 8 * nprocs + self.cap
        #: own (writer) segments, one per channel, created here; peers
        #: attach after a world round proves creation on every rank
        self._own: Dict[int, _Segment] = {}
        #: attached peer segments: (channel, rank) -> _Segment
        self._peer: Dict[tuple, _Segment] = {}
        #: per-channel exchange round and chunk-seq cursors
        self._round = [0] * channels
        self._wseq = [0] * channels
        self._rseq: Dict[tuple, int] = {}
        self._closed = False
        #: the counts stats() reads; every channel's exchange adds to
        #: them under the lock
        self._lock = threading.Lock()
        self._bytes_out = 0
        self._crc_failures = 0
        self.writer_stall_s = 0.0
        self.frame_hw_bytes = 0
        # the JAX wire's instruments, under its names: the watchdog's
        # shm_backpressure rule reads exchanges and writer_stall_s
        self._t_crc = tmetrics.counter("shm_wire.crc_failures")
        self._t_rounds = tmetrics.counter("shm_wire.exchanges")
        self._t_bytes = tmetrics.counter("shm_wire.bytes_out")
        self._t_wstall = tmetrics.counter("shm_wire.writer_stall_s")
        self._t_hw = tmetrics.gauge("shm_wire.frame_hw_bytes")
        self._t_occ = tmetrics.gauge("shm_wire.ring_occupancy_pct")
        try:
            for ch in range(channels):
                seg = _Segment(shared_memory.SharedMemory(
                    name=segment_name(token, ch, rank), create=True,
                    size=self._size), nprocs, self.cap, owned=True)
                self._own[ch] = seg
                seg.u64[:] = 0
                seg.consumed[:] = 0
                seg.u32[_OFF_MAGIC // 4] = _MAGIC
        except BaseException:
            # unlink what was created: a half-built wire leaks nothing
            self.close()
            raise
        _LIVE.add(self)

    # -- wiring --------------------------------------------------------------

    def attach_peers(self) -> None:
        """Attach every peer's segments (after a world round that proves
        creation completed on every rank)."""
        for ch in range(self.channels):
            for r in range(self.nprocs):
                if r == self.rank:
                    continue
                seg = _Segment(_attach(segment_name(self.token, ch, r)),
                               self.nprocs, self.cap, owned=False)
                self._peer[(ch, r)] = seg
                self._rseq[(ch, r)] = 0
                CHECK(int(seg.u32[_OFF_MAGIC // 4]) == _MAGIC,
                      f"shm wire segment {segment_name(self.token, ch, r)} "
                      f"has a foreign layout")

    def close(self) -> None:
        """Detach everything and unlink the own segments. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for seg in self._peer.values():
            seg.close()
        for seg in self._own.values():
            seg.close()
        self._peer.clear()
        self._own.clear()

    # -- the exchange --------------------------------------------------------

    def _chunks(self, blob: bytes) -> List[tuple]:
        """(offset, length) chunk plan: at least one chunk, so an empty
        frame still publishes a header readers can consume."""
        if not blob:
            return [(0, 0)]
        return [(off, min(self.cap, len(blob) - off))
                for off in range(0, len(blob), self.cap)]

    def _corrupt(self, msg: str) -> WireCorruption:
        with self._lock:
            self._crc_failures += 1
        self._t_crc.inc()
        return WireCorruption(msg)

    def exchange(self, blob: bytes, channel: int,
                 timeout_s: Optional[float] = None) -> List[bytes]:
        """Every rank's blob of this channel's next round, in rank order.
        Collective per channel; bounded by ``-mv_deadline_s``, or by
        ``timeout_s`` when given. A failed exchange leaves the channel's
        round counter advanced: the caller scraps the wire, never retries
        the round."""
        CHECK(not self._closed, "shm wire used after close")
        CHECK(0 <= channel < self.channels,
              f"shm wire channel {channel} out of range "
              f"(wire has {self.channels})")
        rnd = self._round[channel]
        self._round[channel] += 1
        own = self._own[channel]
        crc = (fast_crc(blob) & 0xFFFFFFFF) if self.payload_crc else 0
        plan = self._chunks(blob)
        blob_view = memoryview(blob)
        peers = [r for r in range(self.nprocs) if r != self.rank]
        # reader state per peer: [assembled bytearray|None, total|None,
        # chunks read, done, frame crc (latched), running crc]
        rstate = {r: [None, None, 0, False, 0, 0] for r in peers}
        wseq0 = self._wseq[channel]
        wi = 0                        # next own chunk to write
        deadline = (timeout_s if timeout_s is not None
                    else fdeadline.timeout_or_none())
        t0 = time.perf_counter()
        last_probe = t0
        spins = 0
        wstall_s = 0.0          # the writer blocked on readers' acks
        while True:
            progressed = False
            # write side: publish the next chunk once every reader
            # consumed the previous one (one data area, reused)
            if wi < len(plan):
                floor = wseq0 + wi      # the consumed level required
                if all(int(own.consumed[r]) >= floor for r in peers):
                    off, ln = plan[wi]
                    if ln:
                        own.data[:ln] = np.frombuffer(
                            blob_view[off:off + ln], np.uint8)
                    seq_next = wseq0 + wi + 1
                    own.u64[_OFF_ROUND // 8] = rnd
                    own.u64[_OFF_TOTAL // 8] = len(blob)
                    own.u64[_OFF_CHUNK_OFF // 8] = off
                    own.u64[_OFF_CHUNK_LEN // 8] = ln
                    own.u32[_OFF_CRC // 4] = crc
                    own.u32[_OFF_HCRC // 4] = _header_crc(
                        seq_next, rnd, len(blob), off, ln, crc)
                    # seq LAST: the store that makes the chunk visible
                    own.u64[_OFF_SEQ // 8] = seq_next
                    wi += 1
                    progressed = True
            # read side: drain whatever the peers published
            for r in peers:
                st = rstate[r]
                if st[3]:
                    continue
                seg = self._peer[(channel, r)]
                want = self._rseq[(channel, r)] + 1
                if seg.seq() < want:
                    continue
                peer_round = int(seg.u64[_OFF_ROUND // 8])
                if peer_round != rnd:
                    raise WireCorruption(
                        f"shm wire desync on channel {channel}: rank "
                        f"{r} is at exchange round {peer_round}, rank "
                        f"{self.rank} at {rnd}: a rank re-entered the "
                        f"exchange alone; the stream cannot be trusted")
                total = int(seg.u64[_OFF_TOTAL // 8])
                off = int(seg.u64[_OFF_CHUNK_OFF // 8])
                ln = int(seg.u64[_OFF_CHUNK_LEN // 8])
                frame_crc = int(seg.u32[_OFF_CRC // 4])
                if int(seg.u32[_OFF_HCRC // 4]) != _header_crc(
                        want, peer_round, total, off, ln, frame_crc):
                    raise self._corrupt(
                        f"shm wire frame header from rank {r} failed "
                        f"its CRC32 (round {rnd}, chunk seq {want})")
                if st[0] is None:
                    st[0] = bytearray(total)
                    st[1] = total
                    # latch the frame CRC before any ack: once the last
                    # chunk is acked the writer may overwrite the header
                    # with the next round's
                    st[4] = frame_crc
                if total != st[1] or off + ln > st[1] or ln > self.cap:
                    raise self._corrupt(
                        f"shm wire frame from rank {r} truncated/"
                        f"inconsistent: total {total} vs {st[1]}, "
                        f"chunk [{off}:{off + ln}]")
                if ln:
                    # one copy, straight from the segment; the CRC runs
                    # over the copied bytes, safe from any later write
                    st[0][off:off + ln] = seg.data[:ln].data
                    if self.payload_crc:
                        st[5] = fast_crc(
                            memoryview(st[0])[off:off + ln], st[5])
                st[2] += 1
                self._rseq[(channel, r)] = want
                # ack AFTER the copy: the writer may now overwrite
                seg.consumed[self.rank] = want
                if st[2] >= max(1, -(-st[1] // self.cap)):
                    if self.payload_crc and (st[5] & 0xFFFFFFFF) != st[4]:
                        raise self._corrupt(
                            f"shm wire frame from rank {r} failed its "
                            f"CRC32 (round {rnd}, {st[1]} bytes)")
                    st[3] = True
                progressed = True
            if wi >= len(plan) and all(st[3] for st in rstate.values()):
                break
            if progressed:
                spins = 0
                continue
            spins += 1
            if spins > _HOT_SPINS:
                time.sleep(_SLEEP_S)
                if wi < len(plan):
                    # chunks left to publish: a reader has not acked the
                    # previous one (backpressure on the ring)
                    wstall_s += _SLEEP_S
                now = time.perf_counter()
                if now - last_probe > _PROBE_PERIOD_S:
                    last_probe = now
                    dead = _peer_loss_probe(
                        f"shm wire exchange (channel {channel}, round "
                        f"{rnd}): peer silent")
                    if dead is not None:
                        raise dead
                    self._check_peers(channel, rnd)
                if deadline is not None and now - t0 > deadline:
                    fdeadline.raise_deadline(
                        f"shm wire exchange (channel {channel}, round "
                        f"{rnd}): a peer never published or consumed its "
                        f"frame", deadline, fatal=True)
        self._wseq[channel] += len(plan)
        with self._lock:
            self._bytes_out += len(blob)
            self.writer_stall_s += wstall_s
            if len(blob) > self.frame_hw_bytes:
                self.frame_hw_bytes = len(blob)
                self._t_hw.set(float(len(blob)))
                self._t_occ.set(min(100.0, 100.0 * len(blob) / self.cap))
        self._t_rounds.inc()
        self._t_bytes.inc(len(blob))
        if wstall_s > 0.0:
            self._t_wstall.inc(wstall_s)
        return [blob if r == self.rank else bytes(rstate[r][0])
                for r in range(self.nprocs)]

    def _check_peers(self, channel: int, rnd: int) -> None:
        """Raise ``ActorDied`` when a peer's process has exited."""
        if self.peer_pids is None:
            return
        for r, pid in enumerate(self.peer_pids):
            if r != self.rank and _process_gone(pid):
                raise ActorDied(
                    f"shm wire peer rank {r} (pid {pid}; channel "
                    f"{channel}, round {rnd})",
                    ProcessLookupError("the peer process exited"))

    # -- diagnostics ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"token": self.token, "rank": self.rank,
                    "nprocs": self.nprocs, "channels": self.channels,
                    "cap_bytes": self.cap,
                    "rounds": [int(r) for r in self._round],
                    "bytes_out": self._bytes_out,
                    "crc_failures": self._crc_failures,
                    "writer_stall_s": round(self.writer_stall_s, 6),
                    "frame_hw_bytes": self.frame_hw_bytes}

    def mem_bytes(self) -> dict:
        """This process's shm footprint: the segments it OWNS (created)
        and the peer segments it maps (owned elsewhere), and the largest
        frame it published."""
        return {"segment_bytes": len(self._own) * self._size,
                "peer_mapped_bytes": len(self._peer) * self._size,
                "frame_hw_bytes": self.frame_hw_bytes}
