"""Local and parameter-server models for LogisticRegression.

Counterpart of ``multiverso_tpu/models/logreg/model.py`` (reference
Applications/LogisticRegression/src/model/model.cpp and ps_model.cpp):

* Local mode (``use_ps=false``): W (or FTRL's z, n) lives on the device
  the port's device rule gives ``config.platform`` (the card unless the CPU
  is asked for); each minibatch's step runs there.
* PS dense: the weights live in an ArrayTable, flat and output-major (the
  reference key layout); the worker trains on a device copy, pushes flat
  lr-scaled deltas fire-and-forget and pulls every ``sync_frequency``
  minibatches, optionally one pull ahead (``pipeline``, ps_model.cpp:228-
  259). The server rule is sgd (``data -= delta``, ps_model.cpp:24).
* PS sparse: the weights live in a MatrixTable; each window pulls its
  unique keys' rows, trains on them with window-local key indices, and
  pushes the summed row deltas.
* FTRL: (z, n) state in two KVTables keyed ``feature*output_size + o``;
  the KV server adds, so the negated deltas are pushed, n then z.
* ``device_plane=true``: whole windows train on the device against the
  tables' storage (``device_plane.py``); in a multi-process world FTRL's
  device plane stays single-process (its KV device writes are not
  collectives yet) and FTRL rides the collective host KV verbs instead,
  as in the JAX package.

Multi-process worlds: every rank's verbs are collectives (the engine's
window exchange on the host plane, the collective device writes on the
device plane); the warm start is one collective push in which rank 0
carries the loaded weights and every other rank zeros.

``compress=sparse|1bit`` compresses the sparse PS table's row pushes on
the host plane (the MatrixTable's compressed wire, which in a
multi-process world crosses the processes inside the engine's windows);
the device plane applies its window deltas on the device and sends
nothing, as in the JAX package.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from multiverso_tpu_torch import api as mv_api
from multiverso_tpu_torch.models.logreg import objective as obj
from multiverso_tpu_torch.models.logreg.data import SampleBatch, Window
from multiverso_tpu_torch.models.logreg.updater import create_client_updater
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.parallel.mesh import resolve_device
from multiverso_tpu_torch.tables import (ArrayTableOption, KVTableOption,
                                         MatrixTableOption)
from multiverso_tpu_torch.utils.log import CHECK, Log
from multiverso_tpu_torch.utils.timer import Timer


class Model:
    """Base/local model (reference model/model.h + model.cpp)."""

    def __init__(self, config):
        self.config = config
        self.device = self._device()
        self.updater = create_client_updater(config)
        self.ftrl = config.objective_type == "ftrl"
        self.computation_time_ms = 0.0
        self.compute_count = 0
        self._timer = Timer()
        self._dense_predict = obj.make_dense_predict_fn(config)
        self._sparse_predict = obj.make_sparse_predict_fn(config)
        shape = (config.input_size, config.output_size)
        if self.ftrl:
            self._ftrl_grad = obj.make_ftrl_grad_fn(config)
            self._ftrl_weights = obj.make_ftrl_weights_fn(config)
            self.z = self._zeros(shape)
            self.n = self._zeros(shape)
        elif config.sparse:
            self._sparse_grad = obj.make_sparse_grad_fn(config)
            self.W = self._zeros(shape)
        else:
            self._dense_grad = obj.make_dense_grad_fn(config)
            self.W = self._zeros(shape)

    def _device(self) -> torch.device:
        return resolve_device([self.config.platform])

    def _zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _t(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """Host array -> tensor on the model's device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=dtype)

    def _sparse_inputs(self, batch: SampleBatch, keys: np.ndarray):
        return (self._t(keys, torch.int64), self._t(batch.values),
                self._t(batch.mask), self._t(batch.labels),
                self._t(batch.weights))

    def _dense_inputs(self, batch: SampleBatch):
        # staged in the compute dtype (bf16 halves the upload)
        return (self._t(batch.dense, obj.compute_dtype(self.config)),
                self._t(batch.labels), self._t(batch.weights))

    # -- factory (reference model.cpp:208) ----------------------------------

    @staticmethod
    def Get(config) -> "Model":
        if config.use_ps:
            return PSModel(config)
        return Model(config)

    # -- training -----------------------------------------------------------

    def train_window(self, window: Window) -> float:
        """Train on one window of minibatches; returns summed train loss
        (reference Model::Update, model.cpp:64-110)."""
        losses = []
        for batch in window.batches:
            self._timer.Start()
            lr = self.updater.learning_rate()
            if self.ftrl:
                dz, dn, loss = self._ftrl_grad(
                    self.z, self.n, *self._sparse_inputs(batch, batch.keys))
                self.z, self.n = self.z - dz, self.n - dn
            elif self.config.sparse:
                grad, loss = self._sparse_grad(
                    self.W, *self._sparse_inputs(batch, batch.keys))
                self.W = self.W - lr * grad
            else:
                grad, loss = self._dense_grad(self.W,
                                              *self._dense_inputs(batch))
                self.W = self.W - lr * grad
            self.updater.tick()
            losses.append(loss)   # device scalar: fetched once per window
            self.computation_time_ms += self._timer.elapse_ms()
            self.compute_count += 1
        return float(torch.stack(losses).sum()) if losses else 0.0

    # -- inference ----------------------------------------------------------

    def weights(self) -> np.ndarray:
        """(input, output) weight matrix (derived for FTRL)."""
        if self.ftrl:
            return self._ftrl_weights(self.z, self.n).cpu().numpy()
        return self.W.cpu().numpy()

    def predict_batch(self, batch: SampleBatch,
                      W: Optional[np.ndarray] = None) -> np.ndarray:
        """Pass a pre-pulled ``W`` when scoring many batches — for PS models
        ``weights()`` is a full server pull per call."""
        W = self._t(self.weights() if W is None else W, torch.float32)
        if batch.sparse:
            pred = self._sparse_predict(W, self._t(batch.keys, torch.int64),
                                        self._t(batch.values),
                                        self._t(batch.mask))
        else:
            pred = self._dense_predict(W, self._t(batch.dense))
        return pred.cpu().numpy()[: batch.count]

    def DisplayTime(self) -> None:
        if self.compute_count:
            Log.Info("average computation time: %.3fms",
                     self.computation_time_ms / self.compute_count)
            self.computation_time_ms = 0.0
            self.compute_count = 0

    # -- checkpoint (binary: dims header + output-major f32 weights,
    #    matching the reference's flat output-major key layout) -------------

    def Store(self, path: str) -> None:
        W = self.weights()
        with open(path, "wb") as f:
            f.write(struct.pack("<qq", self.config.input_size,
                                self.config.output_size))
            f.write(np.ascontiguousarray(W.T, np.float32).tobytes())

    def Load(self, path: str) -> None:
        with open(path, "rb") as f:
            n_in, n_out = struct.unpack("<qq", f.read(16))
            CHECK(n_in == self.config.input_size and
                  n_out == self.config.output_size, "model file shape mismatch")
            flat = np.frombuffer(f.read(n_in * n_out * 4), np.float32)
        W = flat.reshape(n_out, n_in).T.copy()
        if self.ftrl:
            Log.Error("FTRL warm-start from derived weights is lossy; "
                      "starting z from scaled weights")
            self.z = self._t(-W * (self.config.beta / self.config.alpha +
                                   self.config.lambda2), torch.float32)
            self.n = torch.zeros_like(self.z)
        else:
            self.W = self._t(W)


class PSModel(Model):
    """Parameter-server model (reference model/ps_model.cpp)."""

    def __init__(self, config):
        super().__init__(config)
        # server-side rule is sgd (data -= delta); the client pre-scales
        # (reference ps_model.cpp:24 forces updater_type=sgd)
        if self.ftrl:
            self.z_table = mv_api.MV_CreateTable(KVTableOption())
            self.n_table = mv_api.MV_CreateTable(KVTableOption())
        elif config.sparse:
            self.table = mv_api.MV_CreateTable(MatrixTableOption(
                num_rows=config.input_size, num_cols=config.output_size,
                updater_type="sgd", compress=config.compress or None))
        else:
            self.table = mv_api.MV_CreateTable(ArrayTableOption(
                size=config.input_size * config.output_size,
                updater_type="sgd"))
        self._batch_count = 0
        self._pending_get: Optional[int] = None   # pipelined pull handle
        self._device_trainer = None
        if config.device_plane and self.ftrl \
                and multihost.process_count() > 1:
            Log.Info("ftrl device_plane: a multi-process world rides the "
                     "collective host KV verbs")
        elif config.device_plane:
            from multiverso_tpu_torch.models.logreg.device_plane import (
                DeviceWindowTrainer)
            self._device_trainer = DeviceWindowTrainer(config, self)
        if config.init_model_file:
            self.Load(config.init_model_file)
            self._push_initial_model()
        if not config.sparse and not self.ftrl:
            self._pull_dense()

    def _device(self) -> torch.device:
        """The world's device: the tables live there."""
        from multiverso_tpu_torch.zoo import Zoo
        return Zoo.Get().device_ctx.device

    # -- dense path ---------------------------------------------------------

    def _set_flat_dense(self, flat: np.ndarray) -> None:
        self.W = self._t(flat.reshape(self.config.output_size,
                                      self.config.input_size).T)

    def _pull_dense(self) -> None:
        self._set_flat_dense(self.table.Get())

    def _push_initial_model(self) -> None:
        """Warm start: worker 0 pushes loaded weights as a delta
        (reference ps_model.cpp:117-152). Every rank's worker 0 joins ONE
        collective push, which the table sums over the ranks: rank 0
        carries the weights and the others zeros, so the table starts at
        W (not at the number of ranks times W) and no rank skips a verb
        its peers issue."""
        if mv_api.MV_WorkerId() != 0:
            return
        # zeros on every rank but rank 0
        keep = np.float32(1.0 if multihost.process_index() == 0 else 0.0)
        if self.ftrl:
            flat = self._flat_keys(np.arange(self.config.input_size,
                                             dtype=np.int64))
            self.z_table.Add(flat, keep * self.z.cpu().numpy().ravel())
            self.n_table.Add(flat, keep * self.n.cpu().numpy().ravel())
            return
        # the weights Load() set, not a pull of the still-empty table (the
        # JAX package's self.weights() here pulls and pushes zeros)
        W = keep * Model.weights(self)
        if self.config.sparse:
            self.table.AddRows(np.arange(self.config.input_size,
                                         dtype=np.int32),
                               -W.astype(np.float32))
        else:
            # the server does -=
            self.table.Add(np.ascontiguousarray(-W.T, np.float32).ravel())

    def train_window(self, window: Window):
        if self._device_trainer is not None:
            # the whole window on the device; returns a DEVICE loss scalar
            # (a host float, global, for a collective window)
            return self._device_trainer.train_window(
                window, agreed=getattr(window, "_dp_agreed", None))
        if self.ftrl:
            return self._train_window_ftrl(window)
        if self.config.sparse:
            return self._train_window_sparse(window)
        return self._train_window_dense(window)

    def _train_window_dense(self, window: Window) -> float:
        cfg = self.config
        loss_total = 0.0
        for batch in window.batches:
            self._timer.Start()
            lr = self.updater.learning_rate()
            grad, loss = self._dense_grad(self.W, *self._dense_inputs(batch))
            delta = np.ascontiguousarray(
                (lr * grad.cpu().numpy()).T, np.float32).ravel()
            self.table.AddFireForget(delta)
            self.updater.tick()
            loss_total += float(loss)
            self.computation_time_ms += self._timer.elapse_ms()
            self.compute_count += 1
            self._batch_count += 1
            if self._batch_count % cfg.sync_frequency == 0:
                self._sync_dense()
        return loss_total

    def _sync_dense(self) -> None:
        """Pull the merged model (reference DoesNeedSync + PullModel,
        ps_model.cpp:172-181; pipelined variant GetPipelineTable :228-259:
        train on the pull issued one sync earlier, issue the next)."""
        if self.config.pipeline:
            if self._pending_get is not None:
                self._set_flat_dense(self.table.Wait(self._pending_get))
            self._pending_get = self.table.GetAsyncHandle()
        else:
            self._pull_dense()

    # -- sparse path ----------------------------------------------------------

    def _train_window_sparse(self, window: Window) -> float:
        keys = window.keys.astype(np.int32)
        if keys.size == 0:
            return 0.0
        rows = self.table.GetRows(keys)          # (R, out)
        W_rows = self._t(rows)
        loss_total = 0.0
        delta_rows = np.zeros_like(rows)
        for batch in window.batches:
            self._timer.Start()
            lr = self.updater.learning_rate()
            local_keys = np.searchsorted(keys, batch.keys)
            grad, loss = self._sparse_grad(
                W_rows, *self._sparse_inputs(batch, local_keys))
            delta_rows += lr * grad.cpu().numpy()
            self.updater.tick()
            loss_total += float(loss)
            self.computation_time_ms += self._timer.elapse_ms()
            self.compute_count += 1
            self._batch_count += 1
        self.table.AddFireForget(delta_rows, row_ids=keys)
        return loss_total

    # -- ftrl path ------------------------------------------------------------

    def _flat_keys(self, keys: np.ndarray) -> np.ndarray:
        out = self.config.output_size
        return (keys[:, None] * out + np.arange(out)[None, :]).ravel()

    def _train_window_ftrl(self, window: Window) -> float:
        keys = window.keys
        if keys.size == 0:
            return 0.0
        flat = np.asarray(self._flat_keys(keys), np.int64)
        out = self.config.output_size
        # one batched round trip for both tables, in submission order
        z_raw, n_raw = mv_api.MV_MultiGet([(self.z_table, {"keys": flat}),
                                           (self.n_table, {"keys": flat})])
        z_rows = self._t(np.asarray(z_raw).reshape(-1, out))
        n_rows = self._t(np.asarray(n_raw).reshape(-1, out))
        loss_total = 0.0
        dz_acc = np.zeros((len(keys), out), np.float32)
        dn_acc = np.zeros((len(keys), out), np.float32)
        for batch in window.batches:
            self._timer.Start()
            local_keys = np.searchsorted(keys, batch.keys)
            dz, dn, loss = self._ftrl_grad(
                z_rows, n_rows, *self._sparse_inputs(batch, local_keys))
            dz_acc += dz.cpu().numpy()
            dn_acc += dn.cpu().numpy()
            self.updater.tick()
            loss_total += float(loss)
            self.computation_time_ms += self._timer.elapse_ms()
            self.compute_count += 1
            self._batch_count += 1
        # deltas are signed for subtraction; the KV server adds, so push
        # the negation (z += g - sigma*w, n += g^2), n then z
        mv_api.MV_MultiAdd([
            (self.n_table, {"keys": flat,
                            "values": (-dn_acc).ravel().astype(np.float32)}),
            (self.z_table, {"keys": flat,
                            "values": (-dz_acc).ravel().astype(np.float32)})])
        return loss_total

    def weights(self) -> np.ndarray:
        if self.ftrl:
            # derive from the current server state over all features
            flat = self._flat_keys(np.arange(self.config.input_size,
                                             dtype=np.int64))
            out = self.config.output_size
            z = self._t(self.z_table.Get(flat).reshape(-1, out))
            n = self._t(self.n_table.Get(flat).reshape(-1, out))
            return self._ftrl_weights(z, n).cpu().numpy()
        if self.config.sparse:
            return self.table.Get()
        self._flush()
        return self.W.cpu().numpy()

    def _flush(self) -> None:
        if self._pending_get is not None:
            self.table.Wait(self._pending_get)
            self._pending_get = None
        self._pull_dense()
