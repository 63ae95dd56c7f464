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
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from multiverso_tpu_torch.utils.log import CHECK


def load_matrix_state(table, data: np.ndarray,
                      aux: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Load logical data (and aux leaves) into a port MatrixServerTable
    (or a worker table, whose server half is used)."""
    if hasattr(table, "server"):
        table = table.server()
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
