"""The port's five updaters against the JAX package's, on identical arrays.

Each case applies a sequence of Adds (different workers and option
scalars) to the same numpy start state through both packages' ``update``
and compares data and aux after every step, rtol 1e-6: both compute in
float32 with the option scalars as float32, so only the operation order
inside XLA's and PyTorch's elementwise kernels may differ.
"""

import jax.numpy as jnp
import numpy as np
import torch

from multiverso_tpu.updaters import base as jup
from multiverso_tpu_torch.updaters import base as tup

torch.set_num_threads(1)

SHAPE = (12, 7)
WORKERS = 3
STEPS = (  # (worker_id, momentum, learning_rate, rho, lambda_)
    (0, 0.9, 0.1, 0.5, 0.2),
    (2, 0.5, 0.05, 0.1, 0.1),
    (1, 0.0, 0.3, 0.2, 0.7),
    (0, 0.99, 0.01, 0.3, 0.05),
)


def _run_both(updater_type, steps):
    rng = np.random.default_rng(11)
    data = rng.standard_normal(SHAPE).astype(np.float32)
    jupd = jup.CreateUpdater(updater_type)
    tupd = tup.CreateUpdater(updater_type)
    assert type(jupd).__name__ == type(tupd).__name__
    assert (jupd.fusable, jupd.combine_scale) == (tupd.fusable,
                                                  tupd.combine_scale)
    jdata, jaux = jnp.asarray(data), jupd.init_aux(SHAPE, jnp.float32,
                                                   WORKERS)
    tdata, taux = torch.from_numpy(data.copy()), tupd.init_aux(
        SHAPE, torch.float32, WORKERS)
    assert {k: tuple(v.shape) for k, v in jaux.items()} == \
        {k: tuple(v.shape) for k, v in taux.items()}
    for wid, m, lr, rho, lam in steps:
        delta = rng.standard_normal(SHAPE).astype(np.float32) * 0.1
        jopt = jup.AddOption(wid, m, lr, rho, lam).as_jnp()
        topt = tup.AddOption(wid, m, lr, rho, lam).as_tensors()
        jdata, jaux = jupd.update(jdata, jaux, jnp.asarray(delta), jopt)
        tdata, taux = tupd.update(tdata, taux, torch.from_numpy(delta), topt)
        np.testing.assert_allclose(tdata.numpy(), np.asarray(jdata),
                                   rtol=1e-6, atol=1e-7)
        for k in jaux:
            np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                       rtol=1e-6, atol=1e-7)
    return tdata


def test_updaters_match_jax():
    for updater_type in ("default", "sgd", "momentum", "adagrad", "dcasgd"):
        try:
            _run_both(updater_type, STEPS)
        except AssertionError as exc:
            raise AssertionError(f"{updater_type}: {exc}") from exc


def test_dcasgd_degrades_to_sgd_at_zero_lr():
    steps = [(w, m, 0.0, rho, lam) for w, m, _, rho, lam in STEPS]
    dc = _run_both("dcasgd", steps)
    sgd = _run_both("sgd", steps)
    np.testing.assert_array_equal(dc.numpy(), sgd.numpy())


def test_factory_default_and_pure_update():
    """An unknown type gets the default updater (both packages), and
    ``update`` leaves its inputs alone."""
    assert type(tup.CreateUpdater("no-such-rule")) is tup.AddUpdater
    assert type(jup.CreateUpdater("no-such-rule")).__name__ == "AddUpdater"
    upd = tup.CreateUpdater("adagrad")
    data = torch.ones(SHAPE)
    aux = upd.init_aux(SHAPE, torch.float32, WORKERS)
    new, new_aux = upd.update(data, aux, torch.ones(SHAPE),
                              tup.AddOption(1).as_tensors())
    assert torch.equal(data, torch.ones(SHAPE))
    assert torch.count_nonzero(aux["hist"]) == 0
    assert torch.count_nonzero(new_aux["hist"][1]) == new.numel()
