"""Carry state from the JAX package into port tables.

The JAX package hands its state over as numpy (this module imports no JAX):

* ``load_matrix_state(server_table, data, aux)`` takes a matrix table's
  logical ``(num_rows, num_cols)`` data — what the JAX
  ``MatrixServerTable.raw()`` returns — and, optionally, its logical aux
  leaves by name — what ``MatrixServerTable.aux_to_logical`` returns for
  each leaf of ``state["aux"]`` — and writes the port's storage layout
  (padded columns and trash row included).
* ``load_wordembedding_state(comm, ie, eo, ie_g2, eo_g2)`` loads input and
  output embeddings (and the AdaGrad accumulators) into a WordEmbedding
  ``Communicator``'s tables.
* ``load_array_state(table, data, aux)`` takes an array table's logical
  ``(size,)`` data — the first ``size`` values of the JAX
  ``ArrayServer.raw()`` — and its logical aux leaves by name — what
  ``ArrayServer.aux_to_logical`` returns.
* ``load_kv_state(table, keys, values)`` takes a KV table's keys and their
  values in slot order (slot i holds ``keys[i]``) — what the JAX
  ``KVServerTable.Store`` writes.
* ``load_sparse_matrix_state(table, data, aux, up_to_date)`` is
  ``load_matrix_state`` plus the ``(num_workers, num_rows)`` freshness
  bits of the JAX ``SparseMatrixServerTable.up_to_date``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from multiverso_tpu_torch.utils.log import CHECK


def load_matrix_state(table, data: np.ndarray,
                      aux: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Load logical data (and aux leaves) into a port MatrixServerTable
    (or a worker table, whose server half is used)."""
    table = _server(table)
    data = np.asarray(data, table.dtype)
    CHECK(data.shape == (table.num_rows, table.num_cols),
          f"matrix state shape {data.shape} != table "
          f"{(table.num_rows, table.num_cols)}")
    ctx = table._ctx
    table.state["data"] = ctx.place(table._to_storage(data))
    for name, leaf in (aux or {}).items():
        CHECK(name in table.state["aux"],
              f"aux leaf {name!r} not held by updater "
              f"{table.updater.name!r}")
        storage = table.aux_from_logical(np.asarray(leaf, table.dtype))
        CHECK(storage.shape == tuple(table.state["aux"][name].shape),
              f"aux leaf {name!r} shape mismatch")
        table.state["aux"][name] = ctx.place(storage)


def _server(table):
    return table.server() if hasattr(table, "server") else table


def load_array_state(table, data: np.ndarray,
                     aux: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Load logical data (and aux leaves) into a port ArrayServer (or a
    worker table, whose server half is used)."""
    table = _server(table)
    data = np.array(data, table.dtype).ravel()
    CHECK(data.size == table.size,
          f"array state size {data.size} != table {table.size}")
    ctx = table._ctx
    state = {"data": ctx.place(table.aux_from_logical(data)),
             "aux": dict(table.state["aux"])}
    for name, leaf in (aux or {}).items():
        CHECK(name in state["aux"],
              f"aux leaf {name!r} not held by updater "
              f"{table.updater.name!r}")
        storage = table.aux_from_logical(np.array(leaf, table.dtype))
        CHECK(storage.shape == tuple(state["aux"][name].shape),
              f"aux leaf {name!r} shape mismatch")
        state["aux"][name] = ctx.place(storage)
    table.device_set_state(state)


def load_kv_state(table, keys: np.ndarray, values: np.ndarray) -> None:
    """Load keys and their values into a port KVServerTable (or a worker
    table), slot i holding ``keys[i]``."""
    _server(table).load_items(keys, values)


def load_sparse_matrix_state(table, data: np.ndarray,
                             aux: Optional[Dict[str, np.ndarray]] = None,
                             up_to_date: Optional[np.ndarray] = None
                             ) -> None:
    """``load_matrix_state`` plus the freshness bits."""
    table = _server(table)
    load_matrix_state(table, data, aux)
    if up_to_date is not None:
        bits = np.asarray(up_to_date, bool)
        CHECK(bits.shape == table.up_to_date.shape,
              f"freshness bits {bits.shape} != {table.up_to_date.shape}")
        table.up_to_date = bits.copy()


def load_wordembedding_state(comm, ie: np.ndarray, eo: np.ndarray,
                             ie_g2: Optional[np.ndarray] = None,
                             eo_g2: Optional[np.ndarray] = None) -> None:
    """Load embeddings (and AdaGrad sums) into a Communicator's tables."""
    load_matrix_state(comm.input_table, ie)
    load_matrix_state(comm.output_table, eo)
    if ie_g2 is not None or eo_g2 is not None:
        CHECK(comm.ie_g2_table is not None,
              "AdaGrad state given for a run without -use_adagrad")
        load_matrix_state(comm.ie_g2_table, ie_g2)
        load_matrix_state(comm.eo_g2_table, eo_g2)
