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
  With ``device_plane=True`` it takes the device route instead
  (``DeviceTableParams``).
* ``DeviceTableParams``: a module's parameters held IN tables on the
  tables' device plane, in groups: whole groups in ArrayTables, stacks of
  equally sized parameter sets as the rows of a MatrixTable (one row an
  expert), a 2-D parameter as a MatrixTable's rows (an embedding). The
  parameters are views of the tables' state, so the module computes on
  it; ``push`` hands each group's scaled gradient to the table's updater
  (``device_update``; ``device_apply_rows`` on the rows asked for) and
  re-points the parameters at the new state. No parameter or gradient
  byte leaves the card.
* ``SyncCallback``: a training-loop hook syncing every ``freq`` batches.

The JAX package's ``JaxParamManager`` (a JAX pytree) has no counterpart:
this package does not import jax (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

import multiverso_tpu_torch.binding as mv
from multiverso_tpu_torch import api
from multiverso_tpu_torch.tables import ArrayTableOption, MatrixTableOption
from multiverso_tpu_torch.updaters.base import AddOption
from multiverso_tpu_torch.utils.log import CHECK

#: a table's elements are addressed by int32 offsets
MAX_TABLE_ELEMENTS = 2 ** 31 - 1


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
    model lives.

    ``device_plane=True`` keeps the parameters in tables on the device
    plane instead (``DeviceTableParams``; ``groups`` its keyword arguments,
    by default one ArrayTable a top-level child module or parameter):
    ``sync_all_param`` then pushes ``lr`` times each parameter's ``.grad``
    to the tables' updater (``option`` rides along), zeroes the gradients,
    and the module computes on the updated tables, with no host copy. The
    world's device must be the model's."""

    def __init__(self, model: torch.nn.Module, table=None,
                 device_plane: bool = False, lr: float = 0.01,
                 option: Optional[AddOption] = None,
                 groups: Optional[dict] = None):
        self._model = model
        self._params = list(model.parameters())
        self.device_params = None
        if device_plane:
            CHECK(table is None, "the device plane creates its own tables")
            if groups is None:
                arrays: Dict[str, List[str]] = {}
                for name, _ in model.named_parameters():
                    arrays.setdefault(name.split(".")[0], []).append(name)
                groups = {"arrays": arrays}
            self.lr, self.option = lr, option or AddOption()
            self.device_params = DeviceTableParams(model, **groups)
            self.device_params.zero_grad()
            return
        super().__init__(self._get_flat, self._set_flat, table=table)

    def sync_all_param(self, rows: Optional[Dict[str, Sequence[int]]] = None
                       ) -> None:
        """On the device plane ``rows`` names the matrix tables' rows to
        push (``DeviceTableParams.push``; every row when not given)."""
        if self.device_params is None:
            CHECK(rows is None, "rows are the device plane's")
            super().sync_all_param()
            return
        self.device_params.push(self.lr, self.option, rows=rows)
        self.device_params.zero_grad()

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


class DeviceTableParams:
    """A module's parameters held in parameter tables on the device plane.

    ``arrays``: table name -> parameter names, one ArrayTable each (the
    parameters flattened in that order). ``stacks``: table name -> one list
    of parameter names a row, a MatrixTable of one row a list (every list
    the same shapes: a layer's experts). ``row_params``: table name -> a
    2-D parameter whose rows are the MatrixTable's rows (an embedding).
    Every parameter of the module is in exactly one group. The tables are
    created under ``updater_type`` (None: the world's flag) and start from
    the module's current values (one on-card copy at creation); from then
    on each parameter is a view of its table's state and its ``.grad`` a
    view of one gradient buffer a table, which backward fills in place.
    The caller owns the tables while it uses them (the device-plane
    verbs bypass the engine)."""

    def __init__(self, model: torch.nn.Module,
                 arrays: Dict[str, List[str]],
                 stacks: Optional[Dict[str, List[List[str]]]] = None,
                 row_params: Optional[Dict[str, str]] = None,
                 updater_type: Optional[str] = None):
        params = dict(model.named_parameters())
        stacks, row_params = stacks or {}, row_params or {}
        seen = [n for names in arrays.values() for n in names]
        seen += [n for rows in stacks.values() for r in rows for n in r]
        seen += list(row_params.values())
        CHECK(sorted(seen) == sorted(params),
              "every parameter of the module belongs to exactly one group")
        self.params = params
        #: table name -> (server table, kind, layout); a layout is a list
        #: of (row or None, element offset, parameter name)
        self.tables: Dict[str, tuple] = {}
        self.grads: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name, names in arrays.items():
                size = sum(params[n].numel() for n in names)
                CHECK(size <= MAX_TABLE_ELEMENTS,
                      f"table {name}: {size} elements pass int32 offsets")
                srv = api.MV_CreateTable(ArrayTableOption(
                    size=size, updater_type=updater_type)).server()
                layout = self._layout([names], params)
                self._fill(srv.device_state()["data"][:size].view(1, size),
                           layout)
                self.tables[name] = (srv, "array", layout)
            for name, rows in stacks.items():
                width = sum(params[n].numel() for n in rows[0])
                CHECK(all(sum(params[n].numel() for n in r) == width
                          for r in rows), f"table {name}: rows differ")
                self._add_matrix(name, len(rows), width,
                                 self._layout(rows, params), updater_type)
            for name, pname in row_params.items():
                p = params[pname]
                CHECK(p.dim() == 2, f"{pname}: a row table takes a 2-D "
                      f"parameter")
                self._add_matrix(name, p.shape[0], p.shape[1],
                                 [(None, 0, pname)], updater_type)
        self.repoint()

    @staticmethod
    def _layout(rows, params) -> list:
        out = []
        for r, names in enumerate(rows):
            off = 0
            for n in names:
                out.append((r, off, n))
                off += params[n].numel()
        return out

    def _add_matrix(self, name, num_rows, num_cols, layout, updater_type):
        CHECK(num_rows * num_cols <= MAX_TABLE_ELEMENTS,
              f"table {name}: {num_rows} x {num_cols} elements pass int32 "
              f"offsets")
        srv = api.MV_CreateTable(MatrixTableOption(
            num_rows=num_rows, num_cols=num_cols,
            updater_type=updater_type)).server()
        self._fill(srv.device_rows(), layout)
        self.tables[name] = (srv, "matrix", layout)

    def _fill(self, rows: torch.Tensor, layout) -> None:
        for r, off, n in layout:
            p = self.params[n]
            if r is None:
                rows.copy_(p.detach())
            else:
                rows[r, off:off + p.numel()].copy_(p.detach().reshape(-1))

    def _views(self, base: torch.Tensor, layout):
        for r, off, n in layout:
            shape = self.params[n].shape
            if r is None:
                yield n, base.view(shape)
            else:
                yield n, base[r, off:off + shape.numel()].view(shape)

    def state_rows(self, name: str) -> torch.Tensor:
        """Table ``name``'s live state as rows: (1, size) for an array
        table, (num_rows, num_cols) for a matrix table."""
        srv, kind, _ = self.tables[name]
        if kind == "array":
            return srv.device_state()["data"][: srv.size].view(1, srv.size)
        return srv.device_rows()

    def repoint(self, names: Optional[Sequence[str]] = None) -> None:
        """Make every parameter (of tables ``names``; all when None) a
        view of its table's current state."""
        for name in self.tables if names is None else names:
            for n, view in self._views(self.state_rows(name),
                                       self.tables[name][2]):
                self.params[n].data = view

    def _gathered(self, name: str) -> torch.Tensor:
        """Table ``name``'s gradient buffer, holding every parameter's
        ``.grad``: one that backward did not fill in place (a caller's
        ``zero_grad(set_to_none=True)`` dropped the view) is copied in,
        a missing one is zero."""
        g = self.grads[name]
        for n, view in self._views(g, self.tables[name][2]):
            grad = self.params[n].grad
            if grad is None:
                view.zero_()
            elif grad.data_ptr() != view.data_ptr():
                view.copy_(grad)
        return g

    def zero_grad(self) -> None:
        """Zero the gradient buffers and make every ``.grad`` a view of
        its table's buffer (backward accumulates into it in place)."""
        for name, (_, _, layout) in self.tables.items():
            g = self.grads.get(name)
            if g is None:
                g = torch.zeros_like(self.state_rows(name))
                self.grads[name] = g
            else:
                g.zero_()
            for n, view in self._views(g, layout):
                self.params[n].grad = view

    def push(self, scale: float, option: Optional[AddOption] = None,
             rows: Optional[Dict[str, Sequence[int]]] = None) -> int:
        """Hand ``scale`` times each table's gradient to its updater: an
        array table whole (``device_update``), a matrix table's rows
        ``rows[name]`` (every row when not given; none when empty) by
        ``device_apply_rows``. The gradient buffers are scaled in place.
        Returns the matrix rows pushed."""
        option = option or AddOption()
        opt = option.as_tensors()
        rows = rows or {}
        pushed = 0
        for name, (srv, kind, _) in self.tables.items():
            g = self._gathered(name).mul_(scale)
            if kind == "array":
                new = srv.device_update(srv.device_state(),
                                        self._padded(srv, g), opt)
                srv.device_set_state(new)
                # the old state goes as soon as no parameter views it
                self.repoint([name])
                continue
            ids = rows.get(name)
            if ids is None:
                ids = np.arange(srv.num_rows, dtype=np.int32)
                delta = g
            else:
                ids = np.asarray(ids, np.int32).ravel()
                if ids.size == 0:
                    continue
                delta = g.index_select(0, torch.from_numpy(ids).to(
                    g.device).long())
            srv.device_apply_rows(ids, delta, option)
            pushed += int(ids.size)
        return pushed

    @staticmethod
    def _padded(srv, g: torch.Tensor) -> torch.Tensor:
        flat = g.view(-1)
        if srv.padded == srv.size:
            return flat
        return torch.nn.functional.pad(flat, (0, srv.padded - srv.size))


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
