"""CPU tests of the MoE cell (``moonlight_16b_a3b.s8k_x8``) at a tiny size.

    python -m pytest portbench/tests -q

The cell's whole run (set-up, window, comparison with the plain
reference) on the CPU; the per-layer metrics a traced run gives without a
device trace; the faults the comparison has to catch, planted in the
program under a run (a held expert's output dropped, the routing scale
dropped, half of each step's sequences left out of the loss, a window step
that leaves the tables as they were or writes a NaN); the bfloat16-tables
control; each new metric reader, None where its
record is missing; the FLOP count at the published widths.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import control_moe  # noqa: E402
from portbench.lib import core, roofline_moe  # noqa: E402

CELL = "moonlight_16b_a3b.s8k_x8"
TINY = {"hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 16,
        "intermediate_size": 96, "moe_intermediate_size": 32,
        "router_experts": 8, "held_experts": [0, 1], "n_routed_experts": 2,
        "num_experts_per_tok": 2, "vocab_size": 100, "num_hidden_layers": 3,
        # at ~150 token-expert pairs a step one routing flip moves
        # pairs_gap by ~1%: the CPU's runs compute in float32
        "matmul_dtype": "float32"}
TINY_PARAMS = {"batch": 2, "seq": 32}
BENCH = core.benchmark(ROOT)


def tiny_run(seed: int = 2 ** 31 + 7, seconds: float = 0.5,
             trace: bool = False) -> dict:
    return core.run_cell(CELL, seed, seconds, trace, device="cpu",
                         cfg_override=TINY, params_override=TINY_PARAMS)


def test_cell_runs_correct_on_cpu():
    out = tiny_run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in core.cell_metrics(BENCH, CELL, "end_to_end")}
    assert want == {"words_per_s", "setup_s"}
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == {
        "loss_gap", "grad_gap", "change_gap", "route_differ", "pairs_gap",
        "window_tokens_gap", "tables_nonfinite", "tables_unmoved"}


def test_trace_run_reports_the_program_counter_metric():
    """No device trace on the CPU: the device-trace metrics are left out,
    the program counter's share is there."""
    out = tiny_run(trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"moe.sync_share"}
    assert 0 < out["metrics"]["moe.sync_share"]["value"] < 100


def _drop_expert(monkeypatch):
    from multiverso_tpu_torch.models.moe_lm import model as mm
    real = mm.MoE.pairs

    def dropped(self, choice, w):
        return real(self, choice, w * (self.slot[choice] != 0))
    monkeypatch.setattr(mm.MoE, "pairs", dropped)


def _drop_scale(monkeypatch):
    from multiverso_tpu_torch.models.moe_lm import model as mm
    real = mm.route
    monkeypatch.setattr(mm, "route",
                        lambda h, r, b, k, scale: real(h, r, b, k, 1.0))


def _drop_half(monkeypatch):
    from multiverso_tpu_torch.models.moe_lm import model as mm
    real = mm.MoeLM.loss
    monkeypatch.setattr(mm.MoeLM, "loss",
                        lambda self, t: real(self, t[: t.shape[0] // 2]))


@pytest.mark.parametrize("fault", [_drop_expert, _drop_scale, _drop_half])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = tiny_run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "nan"])
def test_broken_window_is_not_correct(fault, monkeypatch):
    """Window steps that leave the tables as they were, or write a NaN
    into the embedding table, after the checked steps of set-up."""
    from multiverso_tpu_torch.binding import param_manager as pm
    real_load, real_push = core.load_cell, pm.DeviceTableParams.push

    def nan_push(self, *a, **k):
        out = real_push(self, *a, **k)
        self.state_rows("embed")[0, 0] = float("nan")
        return out
    broken = {"unchanged": lambda self, *a, **k: 0, "nan": nan_push}[fault]

    def load(cell, bench_dir=core.BENCH_DIR):
        wl, cfg, drv = real_load(cell, bench_dir)

        class Broken(drv.Cell):
            def window(self, seconds, phases):
                monkeypatch.setattr(pm.DeviceTableParams, "push", broken)
                return super().window(seconds, phases)
        drv.Cell = Broken
        return wl, cfg, drv
    monkeypatch.setattr(core, "load_cell", load)
    out = tiny_run()
    name = {"unchanged": "tables_unmoved", "nan": "tables_nonfinite"}[fault]
    assert out["checks"][name]["value"] > 0, out["checks"]
    assert not out["correct"], out["checks"]


def test_control_in_bfloat16_tables_fails_change_gap():
    wl, cfg, _ = core.load_cell(CELL)
    res = control_moe.control(dict(cfg, **TINY),
                              dict(wl["params"], **TINY_PARAMS), 11,
                              torch.device("cpu"))
    assert res["change_gap"]["value"] > res["change_gap"]["limit"], res
    assert not control_moe.correct(res)


def test_non_finite_reading_is_not_correct():
    drv = core.load_module(ROOT / "portbench" / "drivers"
                           / "moonlight_16b_a3b.py", "drv_moe_nan")
    assert drv.gap(float("nan"), 1.0, 1.0) == sys.float_info.max
    assert drv.gap(1.0, 0.0, 0.0) == sys.float_info.max
    assert drv.gap(0.0, 0.0, 0.0) == 0.0


def _metric(name):
    return core.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                            f"m_{name.replace('.', '_')}")


def test_metric_readers():
    run = {"window_s": 10.0, "trace": {"busy_s": 9.0},
           "moe": {"flops": 4.945e15, "peaks": {"bf16_flops": 989e12},
                   "sync_s": 0.25}}
    assert _metric("moe.mfu").read(run) == pytest.approx(50.0)
    assert _metric("moe.sync_share").read(run) == pytest.approx(2.5)
    assert _metric("moe.device_idle").read(run) == pytest.approx(10.0)
    for name in ("moe.mfu", "moe.sync_share", "moe.device_idle"):
        assert _metric(name).read({"window_s": 10.0}) is None
        assert _metric(name).read({"window_s": 10.0, "we": {}}) is None
    # a CPU trace run: no device trace, no peaks
    cpu = {"window_s": 10.0, "moe": {"flops": 1.0, "sync_s": 0.1}}
    assert _metric("moe.mfu").read(cpu) is None
    assert _metric("moe.device_idle").read(cpu) is None
    assert _metric("words_per_s").read(
        {"window_s": 2.0, "we": {"words": 131072}}) == 65536


def test_row_kernel_roofline_reader():
    """The pushed rows' least bytes over the gather and set kernels' time
    in the trace's costliest operations; None without a trace, without
    the bytes, or when either kernel is not among the operations."""
    read = _metric("moe.rows_group_kernel_roofline").read
    ops = [["void rows_group_kernel<0, float4>(float4*, int const*", 1.0],
           ["nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN", 5.0],
           ["void rows_group_kernel<3, float4>(float4*, int const*", 0.5],
           ["void rows_group_kernel<0, float>(float*, int const*", 0.5]]
    run = {"window_s": 10.0, "moe": {"row_bytes": 3.35e12},
           "trace": {"busy_s": 9.0, "breakdown": {"device_ops": ops}}}
    assert read(run) == pytest.approx(50.0)
    assert read({"window_s": 10.0, "moe": {"row_bytes": 1.0}}) is None
    assert read(dict(run, moe={})) is None
    assert read(dict(run, trace={"breakdown": {"device_ops": ops[:2]}})) \
        is None
    cfg = core.read_json(ROOT / "portbench" / "configs"
                         / "moonlight_16b_a3b.json")
    # an expert's row is 8,650,752 floats; a token's 2,048
    assert roofline_moe.row_bytes(cfg, 1, 0) == 16 * 8650752
    assert roofline_moe.row_bytes(cfg, 0, 1) == 16 * 2048


def test_step_flops_at_the_published_widths():
    """~375 million multiply-adds a token outside the routed experts;
    ~240 TFLOP a step at ~6,144 tokens a held expert; attention over the
    causal triangle only."""
    cfg = core.read_json(ROOT / "portbench" / "configs"
                         / "moonlight_16b_a3b.json")
    dense = roofline_moe.dense_params_per_token(cfg)
    assert 370e6 < dense < 380e6
    pairs = 8 * 8 * 6144
    total = roofline_moe.step_flops(cfg, 8, 8192, pairs)
    assert 230e12 < total < 260e12
    one = roofline_moe.step_flops(cfg, 1, 8192, 0)
    two = roofline_moe.step_flops(cfg, 1, 2 * 8192, 0)
    # doubling the sequence doubles the matmuls and ~quadruples attention
    assert 2 * one < two < 4 * one
