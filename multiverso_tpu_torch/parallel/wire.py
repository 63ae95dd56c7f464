"""The window frames of the multi-process engine's exchange.

The port's own copy of ``multiverso_tpu/parallel/wire.py``: the frame
kinds, the exchange SEQ stamp and the Add/GetOption record tags, layered
over the flat value grammar (``parallel/flat.py``) and sealed by
``parallel/seal.py``. The bytes are the JAX package's for every tag the
port sends.

Wire format (all little-endian):

* blob[0] — ``KIND_WINDOW`` for a verb window, ``KIND_HEAD_BARRIER`` for
  the marker a rank exchanges when its window head is a non-verb message,
  so that a verb-vs-barrier head mismatch across ranks fails a loud CHECK
  instead of deadlocking;
* u32 exchange sequence number: each rank stamps its position in the
  window-exchange stream, and the engine CHECKs that every received frame
  carries its own (a rank that re-entered the exchange alone pairs with
  its peers' NEXT round as a loud desync error);
* u32 verb count, then per verb: u8 kind char, u32 table id, u8 entry
  count, then per entry: u8 key length + key utf8, then the value;
* the seal trailer, verified BEFORE parsing (``WireCorruption``).

Option tags::

    o  AddOption  (i64 worker_id, f64 momentum/learning_rate/rho/lambda_)
    g  GetOption  (i64 worker_id)
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from multiverso_tpu_torch.parallel.flat import (Extension, _Cursor,
                                                decode_value, encode_value)
from multiverso_tpu_torch.parallel.seal import check_crc, seal_frame
from multiverso_tpu_torch.updaters.base import AddOption, GetOption

KIND_WINDOW = 0x57        # 'W'
KIND_HEAD_BARRIER = 0x42  # 'B'

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_VERB = struct.Struct("<BIB")      # kind char, table id, entry count
_ADD_OPT = struct.Struct("<qdddd")


class _OptionExt(Extension):
    """The updater-option record tags."""

    def encode(self, parts: list, v) -> bool:
        if type(v) is AddOption:
            parts.append(b"o")
            parts.append(_ADD_OPT.pack(
                int(v.worker_id), float(v.momentum),
                float(v.learning_rate), float(v.rho), float(v.lambda_)))
            return True
        if type(v) is GetOption:
            parts.append(b"g")
            parts.append(_I64.pack(int(v.worker_id)))
            return True
        return False

    def decode(self, tag: bytes, cur: _Cursor):
        if tag == b"o":
            wid, mom, lr, rho, lam = cur.unpack(_ADD_OPT)
            return True, AddOption(worker_id=wid, momentum=mom,
                                   learning_rate=lr, rho=rho, lambda_=lam)
        if tag == b"g":
            return True, GetOption(worker_id=cur.unpack(_I64)[0])
        return False, None


_EXT = _OptionExt()


def payload_nbytes(payload: dict) -> int:
    """Array bytes a verb payload carries: the engine's window byte
    budget counts these."""
    total = 0
    for v in payload.values():
        if isinstance(v, np.ndarray):
            total += v.nbytes
        elif isinstance(v, dict):       # compressed row payloads
            total += sum(a.nbytes for a in v.values()
                         if isinstance(a, np.ndarray))
    return total


def encode_window(verbs: List[Tuple[str, int, dict]],
                  seq: int = 0) -> bytes:
    """``[(kind, table_id, payload), ...]`` -> sealed wire bytes; ``kind``
    is 'A' or 'G', ``seq`` the sender's window-exchange position."""
    parts: list = [_U8.pack(KIND_WINDOW), _U32.pack(seq & 0xFFFFFFFF),
                   _U32.pack(len(verbs))]
    for kind, table_id, payload in verbs:
        if len(payload) > 255:
            raise ValueError("wire payload too wide")
        parts.append(_VERB.pack(ord(kind), table_id, len(payload)))
        for key in sorted(payload):
            kb = key.encode("utf-8")
            if len(kb) > 255:
                raise ValueError("wire payload key too long")
            parts.append(_U8.pack(len(kb)))
            parts.append(kb)
            encode_value(parts, payload[key], _EXT)
    return seal_frame(b"".join(parts))


def decode_window_seq(blob: bytes):
    """Wire bytes -> ``(seq, [(kind, table_id, payload), ...])``. Array
    entries are zero-copy read-only views into ``blob``; the seal is
    verified first."""
    check_crc(blob)
    cur = _Cursor(blob)
    (magic,) = cur.unpack(_U8)
    if magic != KIND_WINDOW:
        raise ValueError(f"not a window blob (leading byte {magic:#x})")
    (seq,) = cur.unpack(_U32)
    (count,) = cur.unpack(_U32)
    out = []
    for _ in range(count):
        kind, table_id, n_entries = cur.unpack(_VERB)
        payload = {}
        for _ in range(n_entries):
            (klen,) = cur.unpack(_U8)
            key = bytes(cur.take(klen)).decode("utf-8")
            payload[key] = decode_value(cur, _EXT)
        out.append((chr(kind), table_id, payload))
    return seq, out


def encode_head_barrier(msg_type: int) -> bytes:
    """Marker blob of a rank whose window head is a non-verb message."""
    return seal_frame(_U8.pack(KIND_HEAD_BARRIER) + _I64.pack(int(msg_type)))


def decode_head_kind(blob: bytes):
    """First-byte dispatch: ``('window', None)`` or ``('barrier',
    msg_type)``; anything else raises. Barrier markers are verified here,
    window blobs by ``decode_window_seq``."""
    if not blob:
        raise ValueError("empty wire blob")
    lead = blob[0]
    if lead == KIND_WINDOW:
        return "window", None
    if lead == KIND_HEAD_BARRIER:
        check_crc(blob)
        return "barrier", _I64.unpack_from(blob, 1)[0]
    raise ValueError(f"unknown wire blob kind {lead:#x}")
