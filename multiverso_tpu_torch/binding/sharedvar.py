"""Per-variable PS-backed shared values: the ``mv_shared`` surface.

Counterpart of ``multiverso_tpu/binding/sharedvar.py`` (reference
binding/python/multiverso/theano_ext/sharedvar.py:12-99): a wrapper that
pairs one mutable array (a "shared variable") with one ArrayTable and
syncs by the delta trick,

    add(current_value - last_synced_value); value = get()

so concurrent workers' updates merge additively on the server, with the
master-initializes convention (only worker 0's init value lands). Any box
with ``get_value()``/``set_value()`` works; ``SharedArray`` is one over a
numpy array.
"""

from __future__ import annotations

import numpy as np


class SharedArray:
    """Minimal get_value/set_value box over a numpy array (the stand-in for
    ``theano.shared``)."""

    def __init__(self, value):
        self._value = np.array(value, np.float32)

    def get_value(self, borrow: bool = False) -> np.ndarray:
        return self._value if borrow else self._value.copy()

    def set_value(self, value, borrow: bool = False) -> None:
        arr = np.asarray(value, np.float32)
        self._value = arr if borrow else arr.copy()


class MVSharedVariable:
    """Pairs a shared-variable box with an ArrayTable (reference
    sharedvar.py:12-49); every other attribute forwards to the box."""

    def __init__(self, svobj):
        from multiverso_tpu_torch import binding as mv
        from multiverso_tpu_torch.parallel import multihost
        self._svobj = svobj
        init = np.asarray(svobj.get_value(), np.float32)
        self._shape = init.shape
        self._mv_array = mv.ArrayTableHandler(init.size,
                                              init_value=init.reshape(-1))
        # every process's init add lands before the first get (reference
        # sharedvar.py:29); in one process the blocking add already has,
        # and the worker threads may not exist yet, so only the
        # cross-process leg runs
        multihost.host_barrier("mv_sharedvar_init")
        synced = self._mv_array.get().reshape(self._shape)
        self._svobj.set_value(synced, borrow=False)
        self._last_mv_data = synced.copy()

    def mv_sync(self) -> None:
        """Push (current - last synced) and pull the merged value
        (reference sharedvar.py:37-49)."""
        current = np.asarray(self._svobj.get_value(), np.float32)
        self._mv_array.add((current - self._last_mv_data).reshape(-1))
        merged = self._mv_array.get().reshape(self._shape)
        self._svobj.set_value(merged, borrow=False)
        self._last_mv_data = merged.copy()

    def __getattr__(self, name):
        try:
            svobj = self.__dict__["_svobj"]
        except KeyError:
            raise AttributeError(name) from None
        return getattr(svobj, name)


def mv_shared(value, name=None, borrow=False, **kwargs):
    """``theano.shared``-shaped factory (reference sharedvar.py:76-87):
    builds the box, wraps it and registers the wrapper for
    ``sync_all_mv_shared_vars``; returns the wrapper. ``borrow`` is taken
    for the signature; other keyword arguments are refused."""
    if kwargs:
        raise TypeError(f"mv_shared: unsupported keyword arguments "
                        f"{sorted(kwargs)} (theano-era options have no "
                        f"equivalent here)")
    box = SharedArray(value)
    box.name = name
    var = MVSharedVariable(box)
    mv_shared.shared_vars.append(var)
    return var


mv_shared.shared_vars = []  # registry, reference sharedvar.py:87


def sync_all_mv_shared_vars() -> None:
    """Sync every variable created through ``mv_shared`` (reference
    sharedvar.py:90-99)."""
    for var in mv_shared.shared_vars:
        var.mv_sync()
