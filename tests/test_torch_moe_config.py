"""The MoE app's configuration: the tables' sizes at the published widths
(built on the meta device), the published keys it refuses, and the
correction bias's balancing rule."""

from __future__ import annotations

import pytest
import torch

from multiverso_tpu_torch.models.moe_lm import config_from_published
from multiverso_tpu_torch.models.moe_lm import model as mm
from multiverso_tpu_torch.models.moe_lm.trainer import table_groups
from tests._moe_common import published, tiny_cfg


def test_full_size_tables_fit_int32_offsets():
    """At the published widths (9 layers, 8 of 64 experts, 20,480 ids)
    every table is under 2^31 elements and the model has ~0.97 billion
    parameters; built on the meta device, no memory."""
    cfg = config_from_published(published())
    with torch.device("meta"):
        model = mm.MoeLM(cfg)
    params = dict(model.named_parameters())
    groups = table_groups(model)
    sizes = [sum(params[n].numel() for n in names)
             for names in groups["arrays"].values()]
    sizes += [sum(params[n].numel() for r in rows for n in r)
              for rows in groups["stacks"].values()]
    sizes.append(params["embed"].numel())
    assert max(sizes) < 2 ** 31
    assert sum(sizes) == sum(p.numel() for p in params.values())
    assert 0.96e9 < sum(sizes) < 0.98e9
    # one expert row: gate, up and down flattened
    row = sum(params[n].numel() for n in groups["stacks"]["experts.1"][0])
    assert row == 3 * 2048 * 1408 == 8650752


def test_published_keys_the_model_does_not_implement_are_refused():
    with pytest.raises(Exception):
        config_from_published(tiny_cfg(q_lora_rank=1536))
    with pytest.raises(Exception):
        config_from_published(tiny_cfg(scoring_func="softmax"))


def test_bias_moves_by_the_balancing_rule():
    """A training forward leaves each expert's step of the update speed
    toward the mean load of its choices in ``bias_step`` (the trainer
    pushes it through the bias table); a forward without gradients leaves
    none. The layer's bias is not changed in place."""
    base = config_from_published(tiny_cfg())
    torch.manual_seed(7)
    moe = mm.MoE(mm.MoeLMConfig(**dict(base.__dict__,
                                       bias_update_speed=0.01)))
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randn(p.shape) * 0.1)
    x = torch.randn(2, 16, base.hidden)
    b0 = moe.bias.clone()
    with torch.no_grad():
        moe(x)
    assert torch.equal(moe.bias, b0) and moe.bias_step is None
    choice, _ = mm.route(x.reshape(-1, base.hidden), moe.router, b0,
                         base.top_k, base.route_scale)
    load = torch.bincount(choice.reshape(-1), minlength=base.experts).float()
    moe(x)
    assert torch.equal(moe.bias, b0)
    assert torch.equal(moe.bias_step, 0.01 * torch.sign(load.mean() - load))
