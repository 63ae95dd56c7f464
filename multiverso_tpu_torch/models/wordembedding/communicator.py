"""App-level communicator: the WordEmbedding parameter tables.

Counterpart of ``multiverso_tpu/models/wordembedding/communicator.py``
(reference communicator.h/.cpp): owns the input- and output-embedding
matrix tables, the two AdaGrad sum-of-squares tables when AdaGrad is on,
and the int64 word-count KV table. ``request_parameter`` fetches a block's
touched rows; ``add_delta_parameter`` pushes ``trained - fetched`` so
concurrent workers' progress merges additively on the default ``+=``
updater.

Two planes:

* host plane — rows travel through the engine as numpy (one batched
  ``MV_MultiGetAsync`` per block, fire-and-forget delta pushes);
* device plane — rows are gathered by the gather kernel straight out of
  the tables, trained, and the deltas applied by the fused update kernel,
  never leaving the device in one process. The caller owns the tables
  while training (the block loop is sequential). In a multi-process world
  the fetch reads this rank's replica and the block's deltas of all four
  tables go out as ONE collective write (``device_apply_rows_many``): one
  device->host copy, one all-gather, every rank's rows merged in rank
  order on every replica.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multiverso_tpu_torch import api as mv
from multiverso_tpu_torch.models.wordembedding.model import (TrainState,
                                                             init_embedding)
from multiverso_tpu_torch.tables import KVTableOption, MatrixTableOption
from multiverso_tpu_torch.tables.matrix_table import device_apply_rows_many
from multiverso_tpu_torch.zoo import Zoo

WORD_COUNT_KEY = 0


class Communicator:
    def __init__(self, option, vocab_size: int):
        self.opt = option
        self.vocab_size = vocab_size
        self.device = Zoo.Get().device_ctx.device
        dim = option.embedding_size
        seed = option.seed
        # output-embedding rows: HS uses vocab_size-1 inner nodes but both
        # modes allocate vocab_size, like the reference
        self.input_table = mv.MV_CreateTable(MatrixTableOption(
            num_rows=vocab_size, num_cols=dim,
            initializer=lambda shape: init_embedding(shape[0], shape[1], seed)))
        self.output_table = mv.MV_CreateTable(MatrixTableOption(
            num_rows=vocab_size, num_cols=dim))  # zeros like word2vec syn1
        self.ie_g2_table = None
        self.eo_g2_table = None
        if option.use_adagrad:
            self.ie_g2_table = mv.MV_CreateTable(MatrixTableOption(
                num_rows=vocab_size, num_cols=dim))
            self.eo_g2_table = mv.MV_CreateTable(MatrixTableOption(
                num_rows=vocab_size, num_cols=dim))
        self.word_count_table = mv.MV_CreateTable(KVTableOption(dtype=np.int64))

    def _row_specs(self, input_rows, output_rows):
        specs = [("ie", self.input_table, input_rows),
                 ("eo", self.output_table, output_rows)]
        if self.opt.use_adagrad:
            specs += [("ie_g2", self.ie_g2_table, input_rows),
                      ("eo_g2", self.eo_g2_table, output_rows)]
        return specs

    # -- host plane -------------------------------------------------------------

    def request_parameter(self, input_rows: np.ndarray,
                          output_rows: np.ndarray) -> Tuple[TrainState, dict]:
        """Fetch the block's rows; returns (device state, fetched host
        copy)."""
        return self.wait_parameter(
            self.request_parameter_async(input_rows, output_rows))

    def request_parameter_async(self, input_rows: np.ndarray,
                                output_rows: np.ndarray) -> dict:
        """Issue the block's row Gets as ONE batched submission (pipeline
        prefetch, reference distributed_wordembedding.cpp:203-215)."""
        specs = self._row_specs(np.asarray(input_rows, np.int32),
                                np.asarray(output_rows, np.int32))
        call = mv.MV_MultiGetAsync([(table, {"row_ids": ids})
                                    for _, table, ids in specs])
        return {"call": call, "names": [name for name, _, _ in specs]}

    def wait_parameter(self, handles: dict) -> Tuple[TrainState, dict]:
        # unbounded-ok: MultiCall.Wait honors -mv_deadline_s internally
        fetched = dict(zip(handles["names"], handles["call"].Wait()))
        dev = {k: torch.from_numpy(v.copy()).to(self.device)
               for k, v in fetched.items()}
        state = TrainState(ie=dev["ie"], eo=dev["eo"],
                           ie_g2=dev.get("ie_g2"), eo_g2=dev.get("eo_g2"))
        return state, fetched

    def add_delta_parameter(self, state: TrainState, fetched: dict,
                            input_rows: np.ndarray,
                            output_rows: np.ndarray) -> None:
        """Push trained - fetched (reference AddDeltaParameter,
        communicator.cpp:157-206)."""
        for name, table, ids in self._row_specs(input_rows, output_rows):
            trained = getattr(state, name).cpu().numpy()
            table.AddFireForget(trained - fetched[name], row_ids=ids)

    # -- device plane (rows never leave the device) --------------------------

    def request_parameter_device(self, input_rows: np.ndarray,
                                 output_rows: np.ndarray
                                 ) -> Tuple[TrainState, dict]:
        """Gather the block's rows out of the tables on the device. The
        train step updates its state in place, so the state gets its own
        copies (``clone``; the JAX package took ``jnp.copy``) and the
        fetched originals survive for the delta push."""
        rows, train = {}, {}
        for name, table, ids in self._row_specs(input_rows, output_rows):
            rows[name] = table.server().device_fetch_rows(ids)
            train[name] = rows[name].clone()
        state = TrainState(ie=train["ie"], eo=train["eo"],
                           ie_g2=train.get("ie_g2"), eo_g2=train.get("eo_g2"))
        return state, rows

    def add_delta_parameter_device(self, state: TrainState, fetched: dict,
                                   input_rows: np.ndarray,
                                   output_rows: np.ndarray) -> None:
        """Push trained - fetched: the deltas are computed on the card and
        applied by the fused update kernel, all four tables as one write
        (collective in a multi-process world)."""
        device_apply_rows_many([
            (table.server(), ids, getattr(state, name) - fetched[name])
            for name, table, ids in self._row_specs(input_rows,
                                                    output_rows)])

    # -- word count (lr decay coordination) -----------------------------------

    def add_word_count(self, count: int) -> None:
        self.word_count_table.Add([WORD_COUNT_KEY], [count])

    def get_word_count(self) -> int:
        return int(self.word_count_table.Get([WORD_COUNT_KEY])[0])

    # -- export ---------------------------------------------------------------

    def pull_embeddings(self, batch: int = 4096) -> np.ndarray:
        """Whole input-embedding matrix via batched row gets (reference
        SaveEmbedding, distributed_wordembedding.cpp:263-306)."""
        rows = []
        for start in range(0, self.vocab_size, batch):
            ids = np.arange(start, min(start + batch, self.vocab_size),
                            dtype=np.int32)
            rows.append(self.input_table.GetRows(ids))
        return np.vstack(rows)
