"""The device-plane route on the CPU: a step of the MoE app and a sync of
``TorchParamManager(device_plane=True)`` call none of the table verbs'
numpy entry points and no host copy; the app's counters."""

from __future__ import annotations

import math

import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.binding import param_manager as pm
from tests._moe_common import PARAMS, REF, SEED, close, tiny_cfg, trainer


def _forbid_host_route(monkeypatch):
    """Every numpy entry point of the table verbs and the device context's
    host copies raise."""
    from multiverso_tpu_torch.parallel import mesh
    from multiverso_tpu_torch.tables import array_table, matrix_table

    def boom(*a, **k):
        raise AssertionError("the host route was taken")
    for cls, names in ((array_table.ArrayServer,
                        ("ProcessAdd", "ProcessGet", "ProcessGetAsync")),
                       (matrix_table.MatrixServerTable,
                        ("ProcessAdd", "ProcessGet", "ProcessGetAsync",
                         "ProcessAddRun")),
                       (array_table.ArrayWorker, ("Get", "Add")),
                       (matrix_table.MatrixWorkerTable,
                        ("Get", "GetRows", "Add", "AddRows")),
                       (mesh.DeviceContext, ("fetch",))):
        for n in names:
            monkeypatch.setattr(cls, n, boom)


def test_device_plane_step_leaves_the_host_route_untouched(monkeypatch):
    cfg = tiny_cfg()
    tr = trainer(cfg, dtype=torch.bfloat16)
    try:
        _forbid_host_route(monkeypatch)
        before = {n: p.detach().clone() for n, p in tr.params.params.items()}
        loss = tr.step(REF.tokens(cfg, PARAMS, SEED, 0))
        assert math.isfinite(float(loss))
        moved = [n for n, p in tr.params.params.items()
                 if not torch.equal(p.detach(), before[n])]
        assert len(moved) == len(before)
    finally:
        monkeypatch.undo()
        tr.close()


def test_torch_param_manager_device_plane(monkeypatch):
    """``TorchParamManager(device_plane=True)``: the module's parameters
    live in the tables; a sync hands lr x grad to the momentum updater
    with no host copy, and the module computes on the new state."""
    torch.manual_seed(6)
    m = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Tanh(),
                            torch.nn.Linear(4, 2))
    w0 = {n: p.detach().clone() for n, p in m.named_parameters()}
    mvt.MV_Init(["-mv_device=cpu", "-updater_type=momentum"])
    try:
        mgr = pm.TorchParamManager(m, device_plane=True, lr=0.5,
                                   option=pm.AddOption(momentum=0.9))
        assert sorted(mgr.device_params.tables) == ["0", "2"]
        _forbid_host_route(monkeypatch)
        x = torch.randn(7, 5)
        smooth = {n: torch.zeros_like(w) for n, w in w0.items()}
        want = dict(w0)
        for _ in range(3):
            m(x).pow(2).sum().backward()
            grads = {n: p.grad.clone() for n, p in m.named_parameters()}
            mgr.sync_all_param()
            for n in want:
                smooth[n] = 0.9 * smooth[n] + (1 - 0.9) * (0.5 * grads[n])
                want[n] = want[n] - smooth[n]
            for n, p in m.named_parameters():
                # the updater's float32 (1 - m) against 1 - 0.9 in double
                close(p.detach(), want[n], 1e-6, 1e-6)
                assert float(p.grad.abs().max()) == 0.0
        srv = mgr.device_params.tables["0"][0]
        assert srv.device_state()["data"].data_ptr() == \
            m[0].weight.data_ptr()
    finally:
        monkeypatch.undo()
        mvt.MV_ShutDown()


def test_app_counters():
    cfg = tiny_cfg()
    tr = trainer(cfg)
    try:
        c0 = tr.counters()
        toks = REF.tokens(cfg, PARAMS, SEED, 0)
        tr.step(toks, record=True)
        tr.flush()
        grown = {n: v - c0[n] for n, v in tr.counters().items()}
        masks = tr.recorded["held_masks"]
        assert grown["moe.tokens"] == PARAMS["batch"] * PARAMS["seq"]
        assert grown["moe.routed_pairs"] == sum(int(m.sum()) for m in masks)
        assert grown["moe.experts_pushed"] == sum(int(m.any(0).sum())
                                                  for m in masks)
        assert grown["moe.sync_s"] > 0 and tr.sync_s == grown["moe.sync_s"]
    finally:
        tr.close()


def test_bias_steps_go_through_the_bias_table(monkeypatch):
    """A step adds each MoE layer's balancing step to its correction bias
    in the bias table (the add updater), and the layers route on views of
    the table's state."""
    from multiverso_tpu_torch.models.moe_lm import model as mm
    cfg = tiny_cfg()
    tr = trainer(cfg)
    try:
        steps = []
        real = mm.MoE.balance

        def seen(self, choice):
            steps.append(real(self, choice))
            return steps[-1]
        monkeypatch.setattr(mm.MoE, "balance", seen)
        b = [m.bias.clone() for m in tr._moe]
        g = cfg["bias_update_speed"]
        for k in range(3):
            tr.step(REF.tokens(cfg, PARAMS, SEED, k))
            assert len(steps) == len(tr._moe)
            data = tr._bias.device_state()["data"]
            e = cfg["router_experts"]
            for i, (m, st) in enumerate(zip(tr._moe, steps)):
                assert set(st.abs().tolist()) <= {0.0, float(
                    torch.tensor(g))}
                b[i] = b[i] + st
                assert torch.equal(m.bias, b[i])
                assert m.bias.data_ptr() == data[i * e:].data_ptr()
            moved = any(bool(st.any()) for st in steps)
            steps.clear()
        assert moved
    finally:
        monkeypatch.undo()
        tr.close()
