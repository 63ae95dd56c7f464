"""Shared pieces of the MoE app's CPU tests (``tests/test_torch_moe_*.py``):
the tiny configuration (hidden 64, 4 heads, kv rank 16, rope 8, 8 experts
of which 2 held, top-2), a trainer on the reference's seeded weights, the
plain float32 reference of the benchmark
(``portbench/reference/moonlight_16b_a3b.py``, which imports nothing of the
port) and a tolerance check."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import torch

from multiverso_tpu_torch.models.moe_lm import (MoeLMTrainer,
                                                config_from_published)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 11
CONFIG = ROOT / "portbench" / "configs" / "moonlight_16b_a3b.json"
PARAMS = {"batch": 2, "seq": 32}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(ROOT / "portbench" / "reference" / "moonlight_16b_a3b.py",
            "moe_reference_for_tests")


def published() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


def tiny_cfg(**kw) -> dict:
    cfg = published()
    cfg.update(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=16,
               intermediate_size=96, moe_intermediate_size=32,
               router_experts=8, held_experts=[0, 1], n_routed_experts=2,
               num_experts_per_tok=2, vocab_size=100, num_hidden_layers=3)
    cfg.update(kw)
    return cfg


def trainer(cfg, dtype=None) -> MoeLMTrainer:
    return MoeLMTrainer(config_from_published(cfg), lr=cfg["lr"],
                        momentum=cfg["momentum"], device="cpu",
                        matmul_dtype=dtype,
                        init=REF.start_values(cfg, PARAMS, SEED,
                                              torch.device("cpu")))


def ref_weights(cfg) -> dict:
    init = REF.start_values(cfg, PARAMS, SEED, torch.device("cpu"))
    return {n: init(n, s, torch.device("cpu"))
            for n, s in REF.param_specs(cfg)}


def close(a, b, tol, atol=0.0):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) <= tol * scale + atol, (
        float((a - b).abs().max()), scale)
