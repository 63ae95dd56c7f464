"""Checkpoint and resume of every server table, with its updater aux state.

Counterpart of ``multiverso_tpu/checkpoint.py``. The reference has only
the per-table ``Serializable::Store/Load`` (table_interface.h:61-70),
data only; this driver saves every registered server table AND its
updater aux state (momentum's smoothing, AdaGrad's history, DC-ASGD's
backups) in one call, so a resumed run continues exactly.

Format, the JAX package's bytes both ways (through ``utils/io.py``'s
``StreamFactory``, so any registered scheme can hold a checkpoint):

    magic "MVTCKPT1", num_tables
    per table: table_id, type name, length-framed Store() payload,
               num aux leaves, per leaf: keypath, dtype, shape, bytes

Data and aux are written in the LOGICAL layout (``aux_to_logical`` strips
the trash rows and pad columns), so a file written by either package, on
any device, loads in either. Aux leaves are named as
``jax.tree_util.keystr`` names a dict leaf, ``['smooth']``, in sorted key
order. Every frame is checked on load: the table's type name, the whole
payload consumed, each leaf known with its shape and dtype; a failed
check raises ``FatalError``. Restored leaves go onto the live leaf's
device.

Multi-process worlds (the JAX package's rule): every process calls the
verb at the same stream position; only rank 0 writes the file, and a
barrier makes the file complete before any rank goes on. The replicas are
equal, so rank 0 serializes its own and the other ranks serialize nothing;
a load reads the file on every rank (``uri`` must name storage every rank
sees).
"""

from __future__ import annotations

import io as _io

import numpy as np
import torch

from multiverso_tpu_torch.message import MsgType
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.utils.io import Stream, StreamFactory
from multiverso_tpu_torch.utils.log import CHECK, Log

_MAGIC = "MVTCKPT1"


def _barrier(name: str) -> None:
    """The processes' alignment barrier (a no-op in one process)."""
    multihost.host_barrier(name)


def _writes_file() -> bool:
    """Whether this process streams the checkpoint to storage (rank 0)."""
    return multihost.process_index() == 0


def _keystr(name: str) -> str:
    return f"[{name!r}]"


def _aux_leaves(table):
    """[(keypath, leaf)] of the table's updater aux state, in the order
    and spelling of ``jax.tree_util.tree_leaves_with_path`` over a flat
    dict."""
    state = getattr(table, "state", None)
    if not isinstance(state, dict) or "aux" not in state:
        return []
    aux = state["aux"]
    return [(_keystr(name), aux[name]) for name in sorted(aux)]


def _to_logical(table, leaf) -> np.ndarray:
    if hasattr(table, "aux_to_logical"):
        return table.aux_to_logical(leaf)
    return leaf.detach().cpu().numpy()


def _from_logical(table, arr: np.ndarray) -> np.ndarray:
    if hasattr(table, "aux_from_logical"):
        return table.aux_from_logical(arr)
    return arr


def _write_table(stream: Stream, table_id: int, table) -> None:
    stream.WriteInt(table_id)
    stream.WriteStr(type(table).__name__)
    buf = _io.BytesIO()
    table.Store(Stream(buf, f"<table {table_id}>"))
    payload = buf.getvalue()
    stream.WriteInt(len(payload))
    stream.Write(payload)
    leaves = _aux_leaves(table)
    stream.WriteInt(len(leaves))
    for keypath, leaf in leaves:
        host = _to_logical(table, leaf)
        stream.WriteStr(keypath)
        stream.WriteStr(str(host.dtype))
        stream.WriteInt(host.ndim)
        for d in host.shape:
            stream.WriteInt(d)
        stream.Write(np.ascontiguousarray(host).tobytes())


def _read_table(stream: Stream, table) -> None:
    type_name = stream.ReadStr()
    CHECK(type_name == type(table).__name__,
          f"checkpoint table type mismatch: {type_name} vs "
          f"{type(table).__name__}")
    payload_len = stream.ReadInt()
    payload = stream.Read(payload_len)
    payload_stream = Stream(_io.BytesIO(payload), "<table payload>")
    table.Load(payload_stream)
    CHECK(payload_stream._f.tell() == payload_len,
          f"table {type_name} consumed {payload_stream._f.tell()} of "
          f"{payload_len} checkpoint bytes — dtype/config drift")
    n_leaves = stream.ReadInt()
    if n_leaves == 0:
        return
    live = dict(_aux_leaves(table))
    restored = {}
    for _ in range(n_leaves):
        keypath = stream.ReadStr()
        dtype = np.dtype(stream.ReadStr())
        ndim = stream.ReadInt()
        shape = tuple(stream.ReadInt() for _ in range(ndim))
        raw = stream.Read(int(np.prod(shape)) * dtype.itemsize if shape
                          else dtype.itemsize)
        arr = np.frombuffer(raw, dtype).reshape(shape)
        CHECK(keypath in live, f"unknown aux leaf {keypath} in checkpoint")
        live_logical = _to_logical(table, live[keypath])
        CHECK(live_logical.shape == arr.shape,
              f"aux leaf {keypath} shape mismatch: checkpoint {arr.shape} "
              f"vs live {live_logical.shape}")
        CHECK(live_logical.dtype == arr.dtype,
              f"aux leaf {keypath} dtype mismatch: checkpoint {arr.dtype} "
              f"vs live {live_logical.dtype}")
        restored[keypath] = _from_logical(table, arr)
    # every restored leaf goes onto the live leaf's device
    aux = dict(table.state["aux"])
    for name, leaf in aux.items():
        key = _keystr(name)
        if key in restored:
            aux[name] = torch.as_tensor(np.array(restored[key]),
                                        device=leaf.device)
    table.state = dict(table.state, aux=aux)


def write_table_frame(table, table_id: int = 0) -> bytes:
    """ONE table's whole logical state (Store payload and aux leaves) as a
    self-contained frame: one table's slice of a checkpoint file."""
    buf = _io.BytesIO()
    _write_table(Stream(buf, f"<frame {table_id}>"), table_id, table)
    return buf.getvalue()


def read_table_frame(table, blob: bytes) -> None:
    """Restore ``table`` from a :func:`write_table_frame` blob."""
    stream = Stream(_io.BytesIO(blob), "<frame>")
    stream.ReadInt()                    # table_id (the caller's bookkeeping)
    _read_table(stream, table)


def _write_all(stream: Stream, tables) -> None:
    stream.WriteStr(_MAGIC)
    stream.WriteInt(len(tables))
    for table_id, table in enumerate(tables):
        _write_table(stream, table_id, table)


def _serialize_to_bytes(uri: str, tables) -> bytes:
    """Every table serialized in memory: what the engine thread runs at
    the cut, so storage I/O never holds up the verb stream. Ranks other
    than 0 write nothing and serialize nothing (their replicas equal rank
    0's)."""
    if not _writes_file():
        return b""
    buf = _io.BytesIO()
    _write_all(Stream(buf, uri), tables)
    return buf.getvalue()


def save_checkpoint(uri: str, zoo=None) -> int:
    """Store every registered server table (and its updater aux) to
    ``uri``; returns the number of tables written.

    The serialization runs ON the engine thread at the current stream
    position (``CallOnEngine`` with a ``Request_StoreLoad`` cut): every
    Add admitted before the call is in the checkpoint and none after, on
    every engine shard. The bytes then go to storage on the caller's
    thread. Without an engine (``-ma``) nothing is in flight and the
    caller's thread serializes."""
    from multiverso_tpu_torch.zoo import Zoo
    zoo = zoo or Zoo.Get()
    tables = zoo.server_tables
    if zoo.server_engine is None:
        _barrier("mv_checkpoint_quiesce")
        payload = _serialize_to_bytes(uri, tables)
    else:
        payload = zoo.CallOnEngine(MsgType.Request_StoreLoad,
                                   lambda: _serialize_to_bytes(uri, tables),
                                   "checkpoint save cut")
    if _writes_file():
        with StreamFactory.GetStream(uri, "w") as stream:
            stream.Write(payload)
    _barrier("mv_checkpoint_save")
    Log.Info("checkpoint: saved %d tables to %s", len(tables), uri)
    return len(tables)


def load_checkpoint(uri: str, zoo=None) -> int:
    """Restore every registered server table from ``uri``. The same tables
    (count, order, types, shapes) must be registered; the device may
    differ from the writer's. The engine drains first, so every Add
    admitted before the call applies before the restore."""
    from multiverso_tpu_torch.zoo import Zoo
    zoo = zoo or Zoo.Get()
    tables = zoo.server_tables
    zoo.DrainServer()
    _barrier("mv_checkpoint_quiesce")
    with StreamFactory.GetStream(uri, "r") as stream:
        CHECK(stream.ReadStr() == _MAGIC, "not a multiverso_tpu checkpoint")
        n = stream.ReadInt()
        CHECK(n == len(tables),
              f"checkpoint has {n} tables, registry has {len(tables)}")
        for _ in range(n):
            table_id = stream.ReadInt()
            CHECK(0 <= table_id < len(tables), "bad table id in checkpoint")
            _read_table(stream, tables[table_id])
    Log.Info("checkpoint: restored %d tables from %s", n, uri)
    return n
