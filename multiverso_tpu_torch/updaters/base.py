"""Server-side updaters as functions on tensors.

Counterpart of ``multiverso_tpu/updaters/base.py`` (reference
include/multiverso/updater/, src/updater/updater.cpp): every updater is an
elementwise transform ``update(data, aux, delta, opt) -> (data, aux)`` that
the table applies to the touched rows (or the whole table). ``update``
returns new tensors and leaves its inputs alone, like the JAX functions it
mirrors; the table writes the results back in place.

``opt`` is ``AddOption.as_tensors()``: the option scalars as 0-d float32
CPU tensors, so ``1 - momentum`` or ``delta / lr`` round in float32 exactly
as the JAX package's traced scalars do (0-d CPU tensors mix with CUDA
tensors as scalars).

Contract flags, as in the JAX package: ``fusable`` (a pure elementwise rule
of (data, delta), no aux, identity on a zero delta: the row path may use
the fused read-modify-write kernel) and ``combine_scale`` (the rule is
``data + combine_scale * delta`` with a class constant: a window's Adds may
merge). The fused kernel takes the sign ``int(combine_scale)``. Per-worker
aux leaves have shape ``(num_workers,) + data.shape``.

Kept deviations from the C++ reference, as the JAX package keeps them:
AdaGrad follows the evident intent (``hist += (delta/lr)^2``), and DC-ASGD
degrades to plain SGD at ``lr == 0`` instead of dividing by zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from multiverso_tpu_torch.utils.configure import MV_DEFINE_string

MV_DEFINE_string("updater_type", "default", "server updater rule")


@dataclass
class AddOption:
    """Per-Add parameters riding along with the delta
    (reference updater.h:10-70; defaults match AddOption())."""

    worker_id: int = 0
    momentum: float = 0.0
    learning_rate: float = 0.01
    rho: float = 0.1
    lambda_: float = 0.1

    def as_tensors(self) -> Dict[str, Any]:
        """The updater's ``opt``: float scalars as 0-d float32 tensors."""
        f32 = torch.float32
        return {
            "worker_id": int(self.worker_id),
            "momentum": torch.tensor(self.momentum, dtype=f32),
            "learning_rate": torch.tensor(self.learning_rate, dtype=f32),
            "rho": torch.tensor(self.rho, dtype=f32),
            "lambda_": torch.tensor(self.lambda_, dtype=f32),
        }


@dataclass
class GetOption:
    """Per-Get parameters (reference updater.h:72-110)."""

    worker_id: int = 0


class Updater:
    """Base = plain accumulation ``data += delta`` (updater.cpp:21-29)."""

    name = "default"
    fusable = False
    combine_scale = None

    def init_aux(self, shape, dtype, num_workers: int,
                 device=None) -> Dict[str, torch.Tensor]:
        """Aux state: leaves shaped like data are shared state; leaves
        shaped (num_workers,)+shape are per-worker state."""
        return {}

    def combine(self, rows: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        return rows + deltas

    def update(self, data, aux, delta, opt):
        return data + delta, aux

    def access(self, data, aux, opt):
        """Get path: identity for every reference updater."""
        return data


class AddUpdater(Updater):
    name = "default"
    fusable = True
    combine_scale = 1.0


class SGDUpdater(Updater):
    """``data -= delta``: the client sends lr-scaled gradients
    (reference sgd_updater.h:15-19)."""

    name = "sgd"
    fusable = True
    combine_scale = -1.0

    def combine(self, rows, deltas):
        return rows - deltas

    def update(self, data, aux, delta, opt):
        return data - delta, aux


class MomentumUpdater(Updater):
    """``smooth = m * smooth + (1-m) * delta; data -= smooth`` with one
    shared smooth buffer (reference momentum_updater.h:18-26)."""

    name = "momentum"

    def init_aux(self, shape, dtype, num_workers, device=None):
        return {"smooth": torch.zeros(shape, dtype=dtype, device=device)}

    def update(self, data, aux, delta, opt):
        m = opt["momentum"]
        smooth = m * aux["smooth"] + (1 - m) * delta
        return data - smooth, {"smooth": smooth}


class AdaGradUpdater(Updater):
    """Per-worker AdaGrad (reference adagrad_updater.h:15-58, intent):
    one historic-g^2 buffer per worker, selected by the Add's worker_id."""

    name = "adagrad"
    eps = 1e-6

    def init_aux(self, shape, dtype, num_workers, device=None):
        return {"hist": torch.zeros((num_workers,) + tuple(shape),
                                    dtype=dtype, device=device)}

    def update(self, data, aux, delta, opt):
        wid = opt["worker_id"]
        grad = delta / opt["learning_rate"]
        hist = aux["hist"].clone()
        h = hist[wid] + grad * grad
        data = data - opt["rho"] * grad / torch.sqrt(h + self.eps)
        hist[wid] = h
        return data, {"hist": hist}


class DCASGDUpdater(Updater):
    """Delay-compensated ASGD (Zheng et al.): one parameter backup per
    worker; an Add from worker m applies
    ``w -= delta + (lambda / lr) * delta^2 * (w - backup[m])`` and refreshes
    ``backup[m] = w``. ``lr <= 0`` degrades the compensation to plain SGD."""

    name = "dcasgd"

    def init_aux(self, shape, dtype, num_workers, device=None):
        return {"backup": torch.zeros((num_workers,) + tuple(shape),
                                      dtype=dtype, device=device)}

    def update(self, data, aux, delta, opt):
        wid = opt["worker_id"]
        lr, lam = opt["learning_rate"], opt["lambda_"]
        lam_over_lr = torch.where(lr > 0, lam / torch.clamp(lr, min=1e-30),
                                  torch.zeros((), dtype=lr.dtype))
        bak = aux["backup"][wid]
        new = data - (delta + lam_over_lr * delta * delta * (data - bak))
        backup = aux["backup"].clone()
        backup[wid] = new
        return new, {"backup": backup}


_REGISTRY = {
    "default": AddUpdater,
    "": AddUpdater,
    "sgd": SGDUpdater,
    "momentum": MomentumUpdater,
    "adagrad": AdaGradUpdater,
    "dcasgd": DCASGDUpdater,
}


def CreateUpdater(updater_type: str | None = None) -> Updater:
    """Factory keyed by the ``updater_type`` flag; an unknown type gets the
    default updater (reference updater.cpp:46-57)."""
    if updater_type is None:
        from multiverso_tpu_torch.utils.configure import GetFlag
        updater_type = GetFlag("updater_type")
    return _REGISTRY.get(updater_type, AddUpdater)()
