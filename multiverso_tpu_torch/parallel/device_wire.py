"""The device window transport's exchange: deferred Add values move card to
card between the ranks of one host.

The port's counterpart of the JAX package's device-parts placement
(``multiverso_tpu/parallel/mesh.py`` ``place_parts`` / ``parts_bucket``):
there a rank's Add values ride XLA collectives (ICI on a pod); here they
ride CUDA IPC between the processes of one host, which may share one card
or sit on cards with peer access. The windowed engine
(``sync/server.py``) defers an eligible Add's values at pack time
(``-window_transport=device``, or ``auto`` at ``-window_device_min_bytes``
and above): the window blob carries only the values' dtype and shape (the
flat codec's ``v`` tag, ``flat.DeferredArray``), so the blob stays the JAX
package's bytes, and the values go through this module.

Staging. Each rank owns two staging slots per engine channel. Slot
``seq % 2`` carries window ``seq``'s deferred values, laid out in window
order at offsets rounded up to ``ALIGN`` bytes (``layout``). Every rank
decodes every rank's window, so every rank computes every peer's offsets
from the exchanged shapes (``settle``) and copies a peer's values straight
out of the peer's slot (``gather``).

Why two slots are enough. Device-wire windows are fenced (the engine's
fence cause ``device_wire``): a rank's exchange stage issues no collective
after such a window until its apply stage has applied it. A rank packs, and
so writes slot ``seq % 2`` again, for window ``seq + 2`` only after its
exchange ``seq + 1`` has completed; that exchange completes only after
every peer has entered it, which each peer does only after it finished
applying window ``seq`` (its fence). A peer's apply of window ``seq``
finishes only after its copies out of the slot have completed: ``gather``
synchronises on its copies before it returns, inside the apply. So no
rank overwrites a slot a peer may still read, and the slot of window
``seq + 1`` is the other one.

Ordering. The writer's host-to-device copies into its slot complete
(``stage`` synchronises them) before it enters the exchange, and the
exchange is the edge that lets a peer see the values: a peer copies only
after it decoded the window.

Growth. A slot grows in powers of two (``slot_bytes``, at least
``MIN_SLOT``). The writer grows its own slot in ``stage`` when the window
needs more; every rank sees every rank's need in the exchanged shapes and
keeps every rank's slot size, so all ranks reach the same decision. When
any rank grew a slot, all ranks run the handle swap in ``settle``, before
any copy of that window: one round on the engine's own channel (the
window stream's order; the control group carries the application threads'
rounds and would interleave differently on different ranks) in which each
grower sends its new slot's handle and every peer closes its mapping of
the old slot and opens the new one; then, when a replaced slot existed,
one more round after which every peer has closed the old mapping, and the
owner frees the old slot.

The card API (``ipc``): ``csrc/ipc.cu`` binds ``cudaMalloc`` (one
allocation a slot, so a handle covers the slot alone), ``cudaIpcGetMemHandle``
/ ``cudaIpcOpenMemHandle`` / ``cudaIpcCloseMemHandle`` and
``cudaMemcpyAsync`` to a plain C interface (built with nvcc into
``build/torch_kernels/<hash>/libmvt_ipc.so``, its own cache key, and loaded
with ctypes). The host-to-device staging copies run on a stream of the
wire's own; a peer's copies run on the applying thread's current stream,
timed with CUDA events (``STATS["copy_ms"]``). A failed open, copy or
allocation raises and stops the rank: it never switches to the plain
version or to the host wire.

The plain version (``shm-plain``), selected by the tables' device
(``-mv_device=cpu``) and never because IPC failed: the same protocol over
``multiprocessing.shared_memory`` segments (a handle is the segment's
name; a copy is a memcpy). The tier-1 tests run it.

Availability (``install``, once a world, at ``Zoo.Start``): one control
round collects every rank's host (``multihost.host_label``), table device
type and card, and every rank's ``-window_transport``. The device wire
exists only when every rank is on one host, the tables of every rank live
on one device type, and, on the card, every rank's card can reach every
peer's (the same card, or peer access). ``name()`` is then ``ipc`` or
``shm-plain``, else ``none``. A world that asks for ``device`` on any rank
and has no wire fails a CHECK on every rank naming why; ``auto`` there
defers nothing (logged once).

After an elastic transition (``multihost.install_group``) the windows ride
the group transport, as the host wire does: ``active()`` is None while a
group is installed, and the engine defers nothing.

The application channel (``APP``). The application threads' collective
writes (``multihost.collective_write``: the device plane's row batches,
whole-array deltas and KV slot batches, the JAX package's ``place_parts``
sites) ride the same wire on a channel of their own, beside the engine's
integer channels; its sequence number (``next_write``) counts the writes,
which every rank issues in lockstep, so it agrees on every rank. A write
stages this rank's deltas, device tensors, into slot ``seq % 2`` of the
channel (``stage_writes``: on the card a device-to-device
``cudaMemcpyAsync`` on the caller's current stream, the stream that made
the deltas, waited for before the agreement round; on ``shm-plain`` a
memcpy), then one tagged agreement round on the control group carries
every rank's host metadata and delta shapes; every rank locates every
rank's deltas from those shapes by the same ``offsets`` rule, runs the
handle swap when a slot grew (``settle_writes``: the swap rounds are
tagged rounds of ``multihost.host_allgather_objects_capped`` on the
control group, where the application threads' rounds are ordered; never
the engine channel), and copies every rank's deltas out in rank order
(``gather_writes``, in the deltas' own dtype).

Why two slots are enough on the application channel. A rank stages write
``seq + 2`` (slot ``seq % 2`` again) only after write ``seq + 1``'s
agreement round has completed on it. That round completes only after
every peer entered it, and a peer enters it only after its
``gather_writes`` of write ``seq`` has synchronised its copies out of
that slot (the writes are collectives, issued one after another by every
rank). So no rank overwrites a slot a peer may still read.

The two channels share one backend and this rank's tables of slots: the
engine thread and an application thread may use one ``DeviceWire`` at
once, so every write of those tables is under the wire's lock (never held
across a round).
"""

from __future__ import annotations

import ctypes
import pickle
import secrets
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.parallel.flat import DeferredArray
from multiverso_tpu_torch.utils.log import CHECK, Log

#: a deferred value's offset in a slot rounds up to this many bytes
ALIGN = 256
#: the smallest slot a rank allocates
MIN_SLOT = 1 << 20
#: the application channel's key, beside the engine's integer channels
APP = "app"
#: the IPC binding's source
IPC_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "ipc.cu"

#: the transport's counts since ``reset_stats``: values staged into this
#: rank's slots (``staged``, ``staged_bytes``, ``stage_s`` host seconds
#: with the synchronise), values read out of a peer's slot (``copies``,
#: ``copy_bytes``; ``copy_ms``: their device time by CUDA events on the
#: card, 0.0 on the CPU), handle-swap rounds and slots grown; the engine's
#: channels only (the application channel's writes count in
#: ``multihost.STATS``)
STATS: Dict[str, float] = {}
_stats_lock = threading.Lock()


def reset_stats() -> None:
    with _stats_lock:
        STATS.update(staged=0, staged_bytes=0, stage_s=0.0, copies=0,
                     copy_bytes=0, copy_ms=0.0, swaps=0, grows=0)


reset_stats()


def _note(**kw) -> None:
    with _stats_lock:
        for k, v in kw.items():
            STATS[k] += v


def slot_bytes(need: int) -> int:
    """The size of a slot that holds ``need`` bytes: a power of two, at
    least ``MIN_SLOT``."""
    n = max(int(need), MIN_SLOT)
    return 1 << (n - 1).bit_length()


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def offsets(nbytes) -> Tuple[List[int], int]:
    """The slot offsets of values of ``nbytes`` bytes each, laid out in
    order at ``ALIGN``-byte boundaries, and the bytes they need."""
    out, off = [], 0
    for n in nbytes:
        out.append(off)
        off += _align(n)
    return out, off


def layout(records) -> Tuple[List[Tuple[DeferredArray, int]], int]:
    """A window's deferred values in window order with their slot offsets,
    and the bytes the window needs: every ``(kind, table, payload)``
    record whose ``values`` is a ``DeferredArray``. The writer lays its
    slot out by this rule and every reader finds the values by it."""
    values = [p.get("values") for _, _, p in records]
    values = [v for v in values if isinstance(v, DeferredArray)]
    offs, need = offsets(v.nbytes for v in values)
    return list(zip(values, offs)), need


# -- the card: CUDA IPC through csrc/ipc.cu -----------------------------------

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _ipc_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from multiverso_tpu_torch.ops import cuda_rows
            lib = ctypes.CDLL(str(cuda_rows.build(IPC_SOURCE,
                                                  "libmvt_ipc.so")))
            p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            pp = ctypes.POINTER(ctypes.c_void_p)
            lib.mvt_ipc_handle_bytes.argtypes = []
            lib.mvt_ipc_error.argtypes = [i]
            lib.mvt_ipc_error.restype = ctypes.c_char_p
            lib.mvt_ipc_alloc.argtypes = [i, sz, pp]
            lib.mvt_ipc_free.argtypes = [i, p]
            lib.mvt_ipc_get_handle.argtypes = [i, p, p]
            lib.mvt_ipc_open.argtypes = [i, p, pp]
            lib.mvt_ipc_close.argtypes = [i, p]
            lib.mvt_ipc_copy.argtypes = [i, p, p, sz, p]
            for fn in (lib.mvt_ipc_handle_bytes, lib.mvt_ipc_alloc,
                       lib.mvt_ipc_free, lib.mvt_ipc_get_handle,
                       lib.mvt_ipc_open, lib.mvt_ipc_close,
                       lib.mvt_ipc_copy):
                fn.restype = i
            _lib = lib
        return _lib


class _Card:
    """The ``ipc`` backend: slots are ``cudaMalloc`` allocations on the
    tables' card, a handle is a ``cudaIpcMemHandle_t``, a copy a
    ``cudaMemcpyAsync``."""

    name = "ipc"

    def __init__(self, device):
        import torch
        self.device = device
        self.index = device.index if device.index is not None else \
            torch.cuda.current_device()
        #: the staging copies' own stream
        self.stream = torch.cuda.Stream(device)

    @property
    def lib(self) -> ctypes.CDLL:
        # built and loaded at the first slot, so a world that never
        # defers never builds it
        return _ipc_lib()

    def _ok(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self.lib.mvt_ipc_error(rc).decode(errors="replace")
            raise RuntimeError(f"device wire (ipc): {what} failed on "
                               f"cuda:{self.index}: CUDA error {rc} ({msg})")

    def alloc(self, nbytes: int):
        ptr = ctypes.c_void_p()
        self._ok(self.lib.mvt_ipc_alloc(self.index, nbytes,
                                        ctypes.byref(ptr)), "cudaMalloc")
        handle = ctypes.create_string_buffer(self.lib.mvt_ipc_handle_bytes())
        self._ok(self.lib.mvt_ipc_get_handle(self.index, ptr, handle),
                 "cudaIpcGetMemHandle")
        return ptr.value, handle.raw

    def free(self, slot) -> None:
        self._ok(self.lib.mvt_ipc_free(self.index, slot), "cudaFree")

    def open(self, handle: bytes):
        ptr = ctypes.c_void_p()
        self._ok(self.lib.mvt_ipc_open(self.index, handle, ctypes.byref(ptr)),
                 "cudaIpcOpenMemHandle")
        return ptr.value

    def close(self, mapped) -> None:
        self._ok(self.lib.mvt_ipc_close(self.index, mapped),
                 "cudaIpcCloseMemHandle")

    def stage(self, slot, items) -> None:
        """Copy ``(host array, offset)`` items into ``slot`` and wait for
        the copies (the exchange that follows publishes them)."""
        s = self.stream.cuda_stream
        for arr, off in items:
            self._ok(self.lib.mvt_ipc_copy(self.index, slot + off,
                                           arr.ctypes.data, arr.nbytes, s),
                     "the staging copy")
        self.stream.synchronize()

    def stage_tensors(self, slot, items) -> None:
        """Copy ``(contiguous card tensor, offset)`` items into ``slot`` on
        the caller's current stream (the one that made them) and wait for
        the copies (the agreement round that follows publishes them)."""
        import torch
        stream = torch.cuda.current_stream(self.device)
        for t, off in items:
            CHECK(t.is_cuda, "device wire (ipc): a collective write's "
                             "delta is not on the card")
            self._ok(self.lib.mvt_ipc_copy(
                self.index, slot + off, t.data_ptr(),
                t.numel() * t.element_size(), stream.cuda_stream),
                "the staging copy")
        stream.synchronize()

    def gather(self, dst, pieces) -> float:
        """``pieces``: ``(dst byte offset, source pointer, nbytes)``, copied
        into the tensor ``dst`` on the current stream; returns the copies'
        device milliseconds, after they completed."""
        import torch
        stream = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        base = dst.data_ptr()
        for doff, src, n in pieces:
            self._ok(self.lib.mvt_ipc_copy(self.index, base + doff, src, n,
                                           stream.cuda_stream),
                     "the peer copy")
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end)

    @staticmethod
    def address(slot, off: int):
        return slot + off


# -- the plain version: shared-memory segments --------------------------------

class _Shm:
    """The ``shm-plain`` backend: slots are shared-memory segments, a
    handle is a segment's name, a copy a memcpy."""

    name = "shm-plain"

    def __init__(self, token: str, rank: int):
        self.prefix = f"mvtdw_{token}_{rank}"
        self.gen = 0
        # the engine thread and an application thread both allocate
        self._gen_lock = threading.Lock()

    def alloc(self, nbytes: int):
        from multiprocessing import shared_memory
        with self._gen_lock:
            self.gen += 1
            name = f"{self.prefix}_{self.gen}"
        seg = shared_memory.SharedMemory(name=name, create=True, size=nbytes)
        return seg, seg.name.encode()

    @staticmethod
    def free(seg) -> None:
        seg.close()
        seg.unlink()

    @staticmethod
    def open(handle: bytes):
        from multiverso_tpu_torch.parallel import shm_wire
        return shm_wire._attach(handle.decode())

    @staticmethod
    def close(seg) -> None:
        seg.close()

    @staticmethod
    def stage(seg, items) -> None:
        for arr, off in items:
            np.frombuffer(seg.buf, np.uint8, arr.nbytes, off)[:] = \
                arr.reshape(-1).view(np.uint8)

    @staticmethod
    def stage_tensors(seg, items) -> None:
        import torch
        for t, off in items:
            raw = t.reshape(-1).view(torch.uint8).numpy()
            np.frombuffer(seg.buf, np.uint8, raw.size, off)[:] = raw

    @staticmethod
    def gather(dst, pieces) -> float:
        out = dst.numpy().view(np.uint8)
        for doff, (seg, off), n in pieces:
            out[doff: doff + n] = np.frombuffer(seg.buf, np.uint8, n, off)
        return 0.0

    @staticmethod
    def address(seg, off: int):
        return seg, off


# -- the wire -----------------------------------------------------------------

class DeviceWire:
    """One world's device wire: this rank's slots, its mappings of its
    peers' slots and every rank's slot sizes, per channel (the engine's
    and the application channel ``APP``)."""

    def __init__(self, backend, rank: int, size: int):
        self.backend = backend
        self.name = backend.name
        self.rank = rank
        self.size = size
        #: guards every write of the tables below: the engine thread and
        #: an application thread use them at once (never held across a
        #: round or a copy)
        self._lock = threading.Lock()
        #: (channel, k) -> this rank's slot, its size
        self._mine: Dict[tuple, tuple] = {}
        #: (channel, k) -> the slot a grow replaced, freed after the swap
        self._retired: Dict[tuple, object] = {}
        #: (channel, k, rank) -> this rank's mapping of that peer's slot
        self._peer: Dict[tuple, object] = {}
        #: (channel, k) -> every rank's slot size, identical on every rank
        self._sizes: Dict[tuple, List[int]] = {}
        #: (channel, k) -> the handle of this rank's slot, for the swap
        self._handles: Dict[tuple, bytes] = {}
        #: the application channel's next write (only application threads
        #: issue writes, one after another)
        self._app_seq = 0

    def _own_slot(self, key: tuple, need: int):
        """This rank's slot ``key``, grown first when ``need`` bytes do
        not fit (the slot it replaces is retired until the swap)."""
        slot, cap = self._mine.get(key, (None, 0))
        if need > cap:
            cap = slot_bytes(need)
            new, handle = self.backend.alloc(cap)
            with self._lock:
                if slot is not None:
                    self._retired[key] = slot
                self._handles[key] = handle
                self._mine[key] = (new, cap)
            slot = new
        return slot

    def stage(self, channel: int, seq: int, local) -> None:
        """Before window ``seq``'s exchange: this rank's deferred values
        of ``local`` (its packed records) into slot ``seq % 2``, grown
        first when they do not fit, and the copies complete."""
        placed, need = layout(local)
        if not placed:
            return
        t0 = time.perf_counter()
        slot = self._own_slot((channel, seq % 2), need)
        items = []
        for v, off in placed:
            CHECK(v.local is not None,
                  "device wire: a deferred value of this rank lost its "
                  "local array (engine bug)")
            items.append((np.ascontiguousarray(v.local), off))
        self.backend.stage(slot, items)
        _note(staged=len(items), staged_bytes=sum(a.nbytes for a, _ in items),
              stage_s=time.perf_counter() - t0)

    def settle(self, channel: int, seq: int, windows, swap) -> None:
        """After window ``seq``'s exchange, before any copy: every rank's
        deferred values located in its slot (``DeferredArray.where``), and
        the handle swap when any rank's slot grew. ``swap(blob)`` is one
        round of the engine channel's exchange (every rank's blob, in rank
        order)."""
        needs = []
        for r, window in enumerate(windows):
            placed, need = layout(window)
            for v, off in placed:
                v.where = (channel, seq % 2, r, off)
            needs.append(need)
        rounds, grows = self._agree_sizes((channel, seq % 2), needs, swap)
        if grows:
            _note(swaps=rounds, grows=grows)

    def _agree_sizes(self, key: tuple, needs, swap) -> Tuple[int, int]:
        """Every rank's size of slot ``key`` after a use that needs
        ``needs`` bytes of each rank (the same decision on every rank),
        and the handle swap when any rank's slot grew: each grower sends
        its new slot's handle, every peer closes its mapping of the old
        slot and opens the new one; when a replaced slot existed, one more
        round after which every peer has closed the old mapping, and the
        owner frees the old slot. Returns (swap rounds, slots grown)."""
        sizes = self._sizes.setdefault(key, [0] * self.size)
        grew, replaced = [], False
        for r, need in enumerate(needs):
            if need > sizes[r]:
                replaced = replaced or sizes[r] > 0
                sizes[r] = slot_bytes(need)
                grew.append(r)
        if not grew:
            return 0, 0
        mine = self._handles[key] if self.rank in grew else None
        handles = [pickle.loads(b) for b in swap(pickle.dumps(mine))]
        for r in grew:
            if r == self.rank:
                continue
            old = self._peer.pop(key + (r,), None)
            if old is not None:
                self.backend.close(old)
            mapped = self.backend.open(handles[r])
            with self._lock:
                self._peer[key + (r,)] = mapped
        rounds = 1
        if replaced:
            # every peer has closed its mapping of a replaced slot once
            # this round completes on every rank
            swap(b"")
            rounds += 1
            old = self._retired.pop(key, None)
            if old is not None:
                self.backend.free(old)
        return rounds, len(grew)

    def gather(self, values, device):
        """One flat float32 tensor on ``device``: ``values`` (deferred
        values located by ``settle``, or host arrays that crossed the host
        wire) concatenated in order. Returns after every copy out of a
        peer's slot completed."""
        import torch
        sizes = [int(v.size) for v in values]
        dst = torch.empty(sum(sizes), dtype=torch.float32, device=device)
        pieces, peer_bytes, peer_n, off = [], 0, 0, 0
        for v, n in zip(values, sizes):
            if not isinstance(v, DeferredArray):
                dst[off: off + n] = torch.from_numpy(
                    np.asarray(v, np.float32).reshape(-1))
            else:
                # the tables defer only their own float32 values
                CHECK(v.dtype == np.float32,
                      f"device wire: a deferred {v.dtype} value (the "
                      f"tables hold float32)")
                CHECK(getattr(v, "where", None) is not None,
                      "device wire: a deferred value was never located "
                      "(engine bug)")
                channel, k, r, at = v.where
                pieces.append((off * 4, self._source((channel, k), r, at),
                               v.nbytes))
                if r != self.rank:
                    peer_bytes += v.nbytes
                    peer_n += 1
            off += n
        ms = self.backend.gather(dst, pieces) if pieces else 0.0
        _note(copies=peer_n, copy_bytes=peer_bytes, copy_ms=ms)
        return dst

    def _source(self, key: tuple, r: int, off: int):
        """The address of ``off`` in rank ``r``'s slot ``key``."""
        if r == self.rank:
            slot = self._mine[key][0]
        else:
            slot = self._peer[key + (r,)]
        return self.backend.address(slot, off)

    # -- the application channel (multihost.collective_write) --------------

    def next_write(self) -> int:
        """The sequence number of the next collective write."""
        seq = self._app_seq
        self._app_seq += 1
        return seq

    def stage_writes(self, seq: int, tensors) -> int:
        """Before write ``seq``'s agreement round: this rank's deltas
        (contiguous tensors on the wire's device) into slot ``seq % 2`` of
        the application channel at ``offsets``, grown first when they do
        not fit, and the copies complete. Returns the bytes staged."""
        nbytes = [t.numel() * t.element_size() for t in tensors]
        offs, need = offsets(nbytes)
        if need:
            slot = self._own_slot((APP, seq % 2), need)
            self.backend.stage_tensors(slot, list(zip(tensors, offs)))
        return sum(nbytes)

    def settle_writes(self, seq: int, nbytes, swap) -> Tuple[int, int]:
        """After write ``seq``'s agreement round: every rank's slot size
        from ``nbytes`` (each rank's deltas' bytes, in rank order) and the
        handle swap when a slot grew; ``swap(blob)`` is one tagged round
        on the control group. Returns (swap rounds, slots grown)."""
        return self._agree_sizes((APP, seq % 2),
                                 [offsets(n)[1] for n in nbytes], swap)

    def gather_writes(self, seq: int, nbytes, dtype, device):
        """Every rank's deltas of write ``seq`` (``nbytes``: each rank's
        deltas' bytes, in rank order) copied out of the slots into one
        flat tensor of ``dtype`` on ``device``, rank by rank in order.
        Returns (the tensor, peer copies, their bytes, their device ms);
        the copies have completed."""
        import torch
        item = torch.empty((), dtype=dtype).element_size()
        total = sum(sum(n) for n in nbytes)
        dst = torch.empty(total // item, dtype=dtype, device=device)
        pieces, peer_n, peer_bytes, at = [], 0, 0, 0
        for r, sizes in enumerate(nbytes):
            for n, off in zip(sizes, offsets(sizes)[0]):
                if n:
                    pieces.append((at, self._source((APP, seq % 2), r, off),
                                   n))
                    if r != self.rank:
                        peer_n += 1
                        peer_bytes += n
                at += n
        ms = self.backend.gather(dst, pieces) if pieces else 0.0
        return dst, peer_n, peer_bytes, ms

    def close(self) -> None:
        """Close every mapping of a peer's slot, then free this rank's
        slots (the engine has stopped: the last windows were applied on
        every rank before the drain's exchange completed)."""
        for mapped in self._peer.values():
            try:
                self.backend.close(mapped)
            except Exception as exc:     # shutdown goes on
                Log.Error("device wire: closing a peer slot failed: %r", exc)
        self._peer.clear()
        slots = [s for s, _ in self._mine.values()]
        slots += list(self._retired.values())
        self._mine.clear()
        self._retired.clear()
        for slot in slots:
            try:
                self.backend.free(slot)
            except Exception as exc:
                Log.Error("device wire: freeing a slot failed: %r", exc)


# -- the world's wire ---------------------------------------------------------

_wire: Optional[DeviceWire] = None
_name = "none"
_why = ""
_group_logged = False
_group_lock = threading.Lock()


def name() -> str:
    """The installed device wire: ``ipc``, ``shm-plain`` or ``none``."""
    return _name


def why_none() -> str:
    """Why this world has no device wire ("" when it has one)."""
    return _why


def active() -> Optional[DeviceWire]:
    """The wire the engine and the collective writes stage through now, or
    None: no wire, or an elastic group installed (the windows and the
    writes ride the group transport)."""
    global _group_logged
    if _wire is None:
        return None
    if multihost.current_group() is not None:
        with _group_lock:   # the engine and the application threads ask
            first, _group_logged = not _group_logged, True
        if first:
            Log.Info("device wire: an elastic group is installed — the "
                     "windows ride the group transport, Add values "
                     "included")
        return None
    return _wire


def current() -> DeviceWire:
    """The installed wire, for a table's apply of a deferred Add (whose
    values this wire staged and located)."""
    CHECK(_wire is not None,
          "a deferred Add reached its apply with no device wire installed "
          "(engine bug)")
    return _wire


def _card_of(device) -> str:
    """A card's identity across processes (its UUID where the torch has
    it), so two ranks can tell whether they share one."""
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    return str(getattr(props, "uuid", "") or f"cuda:{index}")


def _cards_reach(device, cards) -> bool:
    """Whether this rank's card (``device``) can read every peer's card:
    the same card, or one of this process's visible cards with peer
    access."""
    import torch
    mine = _card_of(device)
    visible = {}
    for i in range(torch.cuda.device_count()):
        visible[_card_of(torch.device("cuda", i))] = i
    here = visible[mine]
    for card in cards:
        if card == mine:
            continue
        there = visible.get(card)
        if there is None or not torch.cuda.can_device_access_peer(here,
                                                                  there):
            return False
    return True


def install(device, mode: str) -> str:
    """Decide, rank-agreed, whether this world has a device wire, and
    install it (``Zoo.Start``, after the host wire, before the engine).
    ``mode`` is this rank's ``-window_transport``. One control round in a
    multi-process world, whatever the mode; CHECK-fails on every rank when
    any rank asked for ``device`` and the world has no wire."""
    global _wire, _name, _why, _group_logged
    close()
    _group_logged = False
    if multihost.world_size() <= 1:
        return _name
    import torch
    kind = torch.device(device).type
    card = _card_of(torch.device(device)) if kind == "cuda" else ""
    info = multihost.host_allgather_objects(
        (multihost.host_label(), kind, card, mode, secrets.token_hex(4)))
    hosts = [h for h, _, _, _, _ in info]
    kinds = {k for _, k, _, _, _ in info}
    cards = [c for _, _, c, _, _ in info]
    modes = [m for _, _, _, m, _ in info]
    why = ""
    if any(h != hosts[0] for h in hosts):
        why = f"ranks span hosts {hosts}"
    elif len(kinds) > 1:
        why = f"the ranks' tables live on different devices {sorted(kinds)}"
    elif kind == "cuda":
        reach = multihost.host_allgather_objects(
            _cards_reach(torch.device(device), cards))
        if not all(reach):
            why = f"no IPC between these cards {cards}"
    CHECK(not why or "device" not in modes,
          f"-window_transport=device needs a device wire, and this world "
          f"has none: {why} (every Add value would ride the host wire; run "
          f"-window_transport=auto or host)")
    if why:
        _why = why
        if "auto" in modes:
            Log.Info("device wire: none (%s) — -window_transport=auto "
                     "defers nothing; every Add value rides the host wire",
                     why)
        return _name
    rank = multihost.world_rank()
    backend = _Card(torch.device(device)) if kind == "cuda" else \
        _Shm(info[0][4], rank)
    _wire = DeviceWire(backend, rank, multihost.world_size())
    _name, _why = backend.name, ""
    Log.Info("device wire: %s between %d ranks on %s (%s)", _name,
             _wire.size, device, hosts[0])
    return _name


def close() -> None:
    """Tear the world's wire down (``Zoo.Stop``, after the engine)."""
    global _wire, _name, _why
    w, _wire = _wire, None
    _name, _why = "none", ""
    if w is not None:
        w.close()
