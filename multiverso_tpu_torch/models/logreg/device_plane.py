"""On-device window training for the LogisticRegression app
(``device_plane=true``).

Counterpart of ``multiverso_tpu/models/logreg/device_plane.py``. The host
plane (model.py) moves the MODEL across the host boundary every window:
the flat weight vector per sync (dense), the window's row block both ways
(sparse). The device plane trains a whole window against the PS tables'
device storage and uploads only the window's samples:

* dense — the ArrayTable's flat output-major vector viewed as W (in, out);
  every batch's gradient at the window-start W in one batched product; the
  lr-scaled sum applied once through the table's sgd updater
  (``device_update``);
* sparse — the window's unique keys' rows fetched from the MatrixTable
  (``device_fetch_rows``: the row gather kernel), every batch's gradient
  at those rows with host-remapped window-local key indices, the summed
  lr-scaled row deltas applied once (``device_apply_rows``: the fused
  update kernel, sgd sign);
* FTRL — the window's (z, n) values gathered from both KVTables
  (``device_slots``/``device_gather_slots``), the per-batch closed-form
  deltas at the window-start state, their negated sums scatter-added back
  (``device_scatter_add_slots``).

Semantics are the host plane's: every batch's gradient is taken at the
window-start weights, and the server rule is linear, so per-batch pushes
sum to the window's one application. Ragged final windows pad with zero-
lr, zero-weight batches. The JAX package scans the batches one by one;
here the window is one batched computation, so sums round in another order
(the parity tests hold it to a tolerance). The lane convention is the JAX
package's: pad lanes of a sample (key 0, mask 0) and of the window's K
extension point at ``searchsorted(keys, 0)`` and count as touched for the
regularizer.

Loss scalars stay on the device: ``train_window`` returns a 0-d tensor and
``LogReg`` fetches once per epoch. Staged window tensors are cached on the
Window objects the epoch cache keeps alive, up to a quarter of the card's
memory (``torch.cuda.mem_get_info``). The caller owns the tables while
training (the device-plane single-writer contract).

Multi-process worlds: windows are COLLECTIVE and lockstep (``LogReg``'s
``pop_window`` agrees before each one and feeds a finished rank empty
filler windows). Each rank computes its own window's summed lr-scaled
delta on its replica, and the write is the tables' collective device
verb: every rank's delta and window loss meet in one all-gather, summed
in rank order (dense: ``device_update``) or merged by row id in rank
order (sparse: ``device_apply_rows``), and the same update applies on
every replica. The server rule is linear, so this is the JAX package's
global scan over every rank's batches up to rounding. The window loss
rides in the write's payload, so it comes back global as a host float.
A sparse window uses the agreed K (the JAX package's shared lane count)
and, when it has no keys (a filler), key 0 with zero deltas. FTRL's
device plane stays single-process (``model.py``).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from multiverso_tpu_torch.models.logreg import objective as obj
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.updaters.base import AddOption
from multiverso_tpu_torch.utils.log import CHECK


class DeviceWindowTrainer:
    """Owns the window computations; constructed by PSModel when
    ``config.device_plane`` is set."""

    def __init__(self, config, model):
        self.config = config
        self.model = model
        self.device = model.device
        # ftrl models keep their state in two KVTables (z, n) instead of
        # one weight table
        self.table = getattr(model, "table", None)
        self._opt = AddOption().as_tensors()
        self._sparse_delta = obj.make_sparse_window_delta_fn(config)
        # id-keyed (Window is unhashable); weakref.finalize releases an
        # entry when its window dies; a running total keeps the budget
        # check O(1) per attach
        self._staged_live: dict = {}
        self._staged_total = 0
        self._staged_budget = self._device_staging_budget(self.device)

    @staticmethod
    def _device_staging_budget(device: torch.device) -> int:
        """Bytes the epoch cache may pin on the device: a quarter of the
        card's memory (1 GB on the CPU)."""
        if device.type == "cuda":
            _, total = torch.cuda.mem_get_info(device)
            return max(total // 4, 64 << 20)
        return 1 << 30

    def _release_staged(self, wid: int) -> None:
        n = self._staged_live.pop(wid, None)
        if n:
            self._staged_total -= n

    def _attach_staged(self, window, attr: str, staged: tuple) -> None:
        """Pin ``staged`` on the window for epoch replay only while the
        staging budget holds; past it the window re-uploads next epoch."""
        nbytes = sum(a.numel() * a.element_size() for a in staged[1:]
                     if isinstance(a, torch.Tensor))
        wid = id(window)
        prev = self._staged_live.get(wid, 0)
        if self._staged_total - prev + nbytes <= self._staged_budget:
            setattr(window, attr, staged)
            if wid not in self._staged_live:
                weakref.finalize(window, self._release_staged, wid)
            self._staged_total += nbytes - prev
            self._staged_live[wid] = nbytes
        elif prev:
            self._release_staged(wid)
            if hasattr(window, attr):
                delattr(window, attr)

    def _t(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=dtype)

    def _zero_loss(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.device)

    # -- host-side window staging -------------------------------------------

    def train_window(self, window, agreed=None) -> torch.Tensor:
        """One Window on the device; returns the summed window loss as a
        DEVICE scalar, or, for a collective window (several processes),
        the global loss as a host float. ``agreed`` is ``pop_window``'s
        (shared K, key count)."""
        if multihost.process_count() > 1:
            CHECK(agreed is not None,
                  "multi-process device_plane windows must come through "
                  "LogReg's collective pop protocol (a direct call would "
                  "stop pairing the ranks' writes on ragged shards)")
            CHECK(not self.model.ftrl,
                  "ftrl device_plane is single-process: a multi-process "
                  "world rides the collective host KV verbs")
        nb = max(1, self.config.sync_frequency)
        batches = window.batches
        # per-batch decayed lr, ticking ONLY real batches (pad batches get
        # lr 0: their whole delta contribution is scaled out)
        lrs = np.zeros(nb, np.float32)
        for i in range(len(batches)):
            lrs[i] = self.model.updater.learning_rate()
            self.model.updater.tick()
        self.model._batch_count += len(batches)
        self.model.compute_count += len(batches)
        if self.model.ftrl:
            return self._train_ftrl(window, nb)
        if self.config.sparse:
            return self._train_sparse(window, nb, lrs, agreed)
        return self._train_dense(window, nb, lrs)

    def _stage_sparse(self, window, nb: int, K: int, keys: np.ndarray):
        """Window-local lanes: (nb, B, K) key indices into ``keys`` (pad
        lanes -> searchsorted(keys, 0), mask 0), values, mask, and (nb, B)
        labels and weights, on the device."""
        B = self.config.minibatch_size
        bkeys = np.zeros((nb, B, K), np.int64)
        values = np.zeros((nb, B, K), np.float32)
        mask = np.zeros((nb, B, K), np.float32)
        labels = np.zeros((nb, B), np.int32)
        weights = np.zeros((nb, B), np.float32)
        for i, b in enumerate(window.batches):
            kb = b.keys.shape[1]
            bkeys[i, :, :kb] = np.searchsorted(keys, b.keys)
            bkeys[i, :, kb:] = np.searchsorted(keys, 0)
            values[i, :, :kb] = b.values
            mask[i, :, :kb] = b.mask
            labels[i] = b.labels
            weights[i] = b.weights
        return tuple(self._t(a) for a in (bkeys, values, mask, labels,
                                          weights))

    def _train_dense(self, window, nb: int, lrs: np.ndarray):
        cfg = self.config
        srv = self.table.server()
        staged = getattr(window, "_staged_dense", None)
        if staged is None or staged[0] != nb:
            B = cfg.minibatch_size
            X = np.zeros((nb, B, cfg.input_size), np.float32)
            labels = np.zeros((nb, B), np.int32)
            weights = np.zeros((nb, B), np.float32)
            for i, b in enumerate(window.batches):
                X[i] = b.dense
                labels[i] = b.labels
                weights[i] = b.weights
            # staged in the compute dtype: bf16 halves the upload and the
            # bytes the cache pins
            Xc = torch.from_numpy(X).to(obj.compute_dtype(cfg))
            staged = (nb, Xc.to(self.device), self._t(labels),
                      self._t(weights))
            self._attach_staged(window, "_staged_dense", staged)
        n_in, n_out = cfg.input_size, cfg.output_size
        state = srv.device_state()
        # the ArrayTable stores the flat OUTPUT-MAJOR weights (reference
        # key layout); W is (in, out)
        W = state["data"][: n_in * n_out].view(n_out, n_in).t()
        grads, loss = self.model._dense_grad(W, *staged[1:])     # (nb, in, out)
        delta = torch.sum(self._t(lrs)[:, None, None] * grads, dim=0)
        padded = torch.zeros_like(state["data"])
        padded[: n_in * n_out] = delta.t().reshape(-1)
        # the loss rides the write (summed over the ranks when collective)
        new, loss = srv.device_update(state, padded, self._opt, ride=loss)
        srv.device_set_state(new)
        return loss

    def _train_sparse(self, window, nb: int, lrs: np.ndarray, agreed=None):
        srv = self.table.server()
        keys = window.keys                       # unique, sorted (np.unique)
        if agreed is not None:
            # a collective window: the agreed K, and a filler (or keyless)
            # window still joins the write with key 0 and zero deltas
            K = agreed[0]
            if keys.size == 0:
                keys = np.zeros(1, np.int64)
        elif keys.size == 0:
            return self._zero_loss()
        else:
            K = max(b.keys.shape[1] for b in window.batches)
        staged = getattr(window, "_staged_sparse", None)
        if staged is None or staged[0] != (nb, K):
            staged = ((nb, K), keys.astype(np.int32)) + self._stage_sparse(
                window, nb, K, keys)
            self._attach_staged(window, "_staged_sparse", staged)
        ids = staged[1]
        W_rows = srv.device_fetch_rows(ids)                   # (R, out)
        delta, loss = self._sparse_delta(W_rows, *staged[2:], self._t(lrs))
        return srv.device_apply_rows(ids, delta, ride=loss)

    def _train_ftrl(self, window, nb: int):
        """Gather the window keys' (z, n) from both KVTables, take every
        batch's closed-form deltas at the window-start state (the host
        path's convention, model.py ``_train_window_ftrl``), scatter-add
        their negated sums back."""
        model = self.model
        zsrv = model.z_table.server()
        nsrv = model.n_table.server()
        keys = window.keys
        if keys.size == 0:
            return self._zero_loss()
        out = self.config.output_size
        R = len(keys)
        K = max(b.keys.shape[1] for b in window.batches)
        # slot vectors stage WITH the window; the key covers the table
        # capacities (growth moves the trash slot), and KV slots are
        # append-only, so unchanged capacities mean unchanged slots
        staged = getattr(window, "_staged_ftrl", None)
        if staged is None or staged[0] != (nb, K, R, zsrv.capacity,
                                           nsrv.capacity):
            # resolve BEFORE taking device_values (creation may grow and
            # replace the values); re-read the capacities after
            flat = model._flat_keys(keys)
            zslots = zsrv.device_slots(flat, create=True)
            nslots = nsrv.device_slots(flat, create=True)
            staged = ((nb, K, R, zsrv.capacity, nsrv.capacity),
                      zsrv.device_place_slots(zslots),
                      nsrv.device_place_slots(nslots)) + self._stage_sparse(
                window, nb, K, keys)
            self._attach_staged(window, "_staged_ftrl", staged)
        gz, gn = staged[1], staged[2]
        z_vals, n_vals = zsrv.device_values(), nsrv.device_values()
        z_rows = zsrv.device_gather_slots(z_vals, gz)[: R * out].view(R, out)
        n_rows = nsrv.device_gather_slots(n_vals, gn)[: R * out].view(R, out)
        dz, dn, loss = model._ftrl_grad(z_rows, n_rows, *staged[3:])
        # the host path pushes the NEGATED sums through the KV += rule;
        # pad slot lanes carry zero
        z_delta = torch.zeros(gz.shape[0], dtype=torch.float32,
                              device=self.device)
        z_delta[: R * out] = -torch.sum(dz, dim=0).reshape(-1)
        n_delta = torch.zeros(gn.shape[0], dtype=torch.float32,
                              device=self.device)
        n_delta[: R * out] = -torch.sum(dn, dim=0).reshape(-1)
        zsrv.device_set_values(zsrv.device_scatter_add_slots(z_vals, gz,
                                                             z_delta))
        nsrv.device_set_values(nsrv.device_scatter_add_slots(n_vals, gn,
                                                             n_delta))
        return loss
