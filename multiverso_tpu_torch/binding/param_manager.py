"""Model-parameter synchronization managers.

Counterpart of ``multiverso_tpu/binding/param_manager.py``:

* ``MVModelParamManager``, the generic manager (reference
  binding/python/multiverso/theano_ext/param_manager.py:9-82): one
  ArrayTableHandler a model; ``sync_all_param`` pushes the delta (current
  - last synced) and pulls the merged state, so each worker's local
  training between syncs lands on the server exactly once.
* ``TorchParamManager``: a torch ``nn.Module``'s parameters, flattened
  into ONE float32 vector in one ArrayTable (one Get and one Add a sync).
  The parameters stay on the model's device; the flat vector is copied
  to the host for the table's verbs and back onto that device after.
* ``SyncCallback``: a training-loop hook syncing every ``freq`` batches.

The JAX package's ``JaxParamManager`` (a JAX pytree) has no counterpart:
this package does not import jax (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

import multiverso_tpu_torch.binding as mv


class MVModelParamManager:
    """Generic delta-sync manager over a flat float32 parameter vector."""

    def __init__(self, get_params: Callable[[], np.ndarray],
                 set_params: Callable[[np.ndarray], None], table=None):
        """``get_params()`` returns the current flat parameter vector;
        ``set_params(vec)`` installs one. ``table`` shares an existing
        ArrayTableHandler: in-process worker threads share ONE table (each
        process of a multi-process job creates its own handler)."""
        self._get = get_params
        self._set = set_params
        if table is None:
            init = np.asarray(self._get(), np.float32)
            self.tbh = mv.ArrayTableHandler(init.size, init_value=init)
        else:
            self.tbh = table
        mv.barrier()
        self.last_synced = self.tbh.get().copy()
        self._set(self.last_synced)

    def sync_all_param(self) -> None:
        """Push local progress as a delta, pull the merged model
        (reference param_manager.py:67-82)."""
        current = np.asarray(self._get(), np.float32)
        self.tbh.add(current - self.last_synced)
        merged = self.tbh.get()
        self.last_synced = merged.copy()
        self._set(merged)


class TorchParamManager(MVModelParamManager):
    """Sync a torch ``nn.Module``'s parameters, on whatever device the
    model lives."""

    def __init__(self, model: torch.nn.Module, table=None):
        self._model = model
        self._params = list(model.parameters())
        super().__init__(self._get_flat, self._set_flat, table=table)

    def _get_flat(self) -> np.ndarray:
        with torch.no_grad():
            flat = torch.cat([p.detach().reshape(-1).to(torch.float32)
                              for p in self._params])
        return flat.cpu().numpy()

    def _set_flat(self, vec: np.ndarray) -> None:
        with torch.no_grad():
            off = 0
            for p in self._params:
                n = p.numel()
                src = torch.from_numpy(np.array(vec[off:off + n], np.float32))
                p.copy_(src.to(p.device).view_as(p))
                off += n


class SyncCallback:
    """Train-loop hook syncing every ``freq`` batches (reference
    binding/python/multiverso/theano_ext/keras_ext/callbacks.py:8-39);
    ``on_train_end()`` syncs once more."""

    def __init__(self, param_manager: MVModelParamManager, freq: int = 1):
        self.param_manager = param_manager
        self.freq = max(int(freq), 1)
        self._batch = 0

    def on_batch_end(self, *_args, **_kw) -> None:
        self._batch += 1
        if self._batch % self.freq == 0:
            self.param_manager.sync_all_param()

    def on_train_end(self, *_args, **_kw) -> None:
        self.param_manager.sync_all_param()
