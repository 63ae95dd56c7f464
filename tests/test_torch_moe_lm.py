"""The port's MoE language model (``multiverso_tpu_torch.models.moe_lm``)
against the plain float32 reference of the benchmark, on the CPU at a tiny
size on seeded weights (``tests/_moe_common.py``): logits, loss and every
pushed delta at step 1; the tables after 3 momentum steps; rows the
tokens do not reach keep their value and momentum state."""

from __future__ import annotations

import math

import numpy as np
import torch

from multiverso_tpu_torch.binding import param_manager as pm
from tests._moe_common import (PARAMS, REF, SEED, close, ref_weights,
                               tiny_cfg, trainer)


def test_logits_loss_and_every_pushed_delta_at_step_1(monkeypatch):
    cfg = tiny_cfg()
    toks = REF.tokens(cfg, PARAMS, SEED, 0)
    tr = trainer(cfg)
    deltas = {}
    real = pm.DeviceTableParams.push

    def push(self, scale, *a, **k):
        deltas.update({n: p.grad * scale for n, p in self.params.items()})
        return real(self, scale, *a, **k)
    try:
        with torch.no_grad():
            logits = tr.model.logits(torch.from_numpy(toks[:, :-1]))
        monkeypatch.setattr(pm.DeviceTableParams, "push", push)
        loss = float(tr.step(toks, record=True))
        delta_sq = tr.recorded["delta_sq"]
    finally:
        monkeypatch.undo()
        tr.close()
    W = ref_weights(cfg)
    for b in range(PARAMS["batch"]):
        with torch.no_grad():
            ref_logits = REF.sequence_logits(W, cfg,
                                             torch.from_numpy(toks[b, :-1]))
        close(logits[b], ref_logits, 1e-5)
    Wg = {n: w.clone().requires_grad_(not n.endswith(".bias"))
          for n, w in W.items()}
    ref_loss = 0.0
    N = PARAMS["batch"] * PARAMS["seq"]
    for b in range(PARAMS["batch"]):
        lb = REF.sequence_loss(Wg, cfg, torch.from_numpy(toks[b])) / N
        lb.backward()
        ref_loss += float(lb.detach())
    assert abs(loss - ref_loss) <= 1e-6 * ref_loss
    assert set(deltas) == {n for n in Wg if not n.endswith(".bias")}
    for n, d in deltas.items():
        ref_delta = cfg["lr"] * Wg[n].grad
        close(d, ref_delta, 2e-5)
        assert math.isclose(delta_sq[n], float(ref_delta.double().pow(2)
                                               .sum()), rel_tol=1e-4)


def test_tables_after_three_momentum_steps():
    cfg = tiny_cfg()
    tr = trainer(cfg)
    try:
        for k in range(3):
            tr.step(REF.tokens(cfg, PARAMS, SEED, k))
        got = {n: p.detach().clone() for n, p in tr.params.params.items()}
        tables = {n: tr.params.state_rows(n).clone()
                  for n in tr.params.tables}
        layouts = {n: t[2] for n, t in tr.params.tables.items()}
    finally:
        tr.close()
    ref = REF.follow(cfg, PARAMS, SEED, torch.device("cpu"), 3)
    W0 = ref_weights(cfg)
    for n, p in got.items():
        # the change to within 1e-4 of itself and a few float32 ulps of
        # the weights it is the difference of
        ulps = 4 * float(torch.finfo(torch.float32).eps) * float(
            W0[n].abs().max())
        close(p - W0[n], ref["change"][n], 1e-4, ulps)
    # the parameters are the tables' state, element for element
    for t, rows in tables.items():
        for r, off, n in layouts[t]:
            flat = rows.reshape(-1) if r is None else rows[r]
            assert torch.equal(flat[off:off + got[n].numel()],
                               got[n].reshape(-1))


def test_untouched_rows_keep_value_and_momentum():
    """Rows the step's tokens do not reach (embedding ids, held experts
    that took no token) are not pushed: the updater leaves their value
    and their momentum state."""
    cfg = tiny_cfg()
    toks = np.full((2, 33), 5, dtype=np.int64)
    toks[:, ::2] = 7
    tr = trainer(cfg)
    try:
        emb = tr.params.tables["embed"][0]
        before = tr.params.state_rows("embed").clone()
        tr.step(toks)
        after = tr.params.state_rows("embed")
        smooth = emb.state["aux"]["smooth"][: cfg["vocab_size"]]
        touched = torch.zeros(cfg["vocab_size"], dtype=torch.bool)
        touched[[5, 7]] = True
        assert torch.equal(after[~touched], before[~touched])
        assert not torch.equal(after[touched], before[touched])
        assert float(smooth[~touched].abs().max()) == 0.0
    finally:
        tr.close()
