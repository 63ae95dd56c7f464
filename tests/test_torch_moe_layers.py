"""The MoE model's layers on the CPU: MLA with RoPE against a direct
formula; the router's choice on score + bias and its normalised, scaled
weights; the share rule (the MoE layer's outputs of 4 shares of 2
experts, the shared experts counted once, sum to the uncut layer)."""

from __future__ import annotations

import math

import torch

from multiverso_tpu_torch.models.moe_lm import MoeLMConfig, config_from_published
from multiverso_tpu_torch.models.moe_lm import model as mm
from tests._moe_common import close, tiny_cfg


def _direct_mla(attn: mm.MLA, x: torch.Tensor) -> torch.Tensor:
    """MLA written out head by head: RoPE as a rotation of each pair
    (i, i + d/2) by pos / theta^(2i/d), an explicit causal softmax."""
    cfg = attn.cfg
    B, S, _ = x.shape
    H, nope, rp, vd = cfg.heads, cfg.qk_nope, cfg.qk_rope, cfg.v_dim
    q = (x @ attn.wq.T).view(B, S, H, nope + rp)
    kv = x @ attn.wkv_a.T
    c = kv[..., : cfg.kv_rank]
    c = c / torch.sqrt(c.pow(2).mean(-1, keepdim=True) + cfg.eps) \
        * attn.kv_norm
    kvb = (c @ attn.wkv_b.T).view(B, S, H, nope + vd)

    def rotate(v, pos):
        out = v.clone()
        half = rp // 2
        for i in range(half):
            ang = pos / cfg.rope_theta ** (2 * i / rp)
            a, b = v[..., i], v[..., i + half]
            out[..., i] = a * math.cos(ang) - b * math.sin(ang)
            out[..., i + half] = b * math.cos(ang) + a * math.sin(ang)
        return out
    out = torch.zeros(B, S, H * vd)
    for b in range(B):
        for h in range(H):
            for t in range(S):
                qt = torch.cat([q[b, t, h, :nope], rotate(q[b, t, h, nope:],
                                                          t)])
                scores = []
                for u in range(t + 1):
                    ku = torch.cat([kvb[b, u, h, :nope],
                                    rotate(kv[b, u, cfg.kv_rank:], u)])
                    scores.append(float(qt @ ku) / math.sqrt(nope + rp))
                p = torch.softmax(torch.tensor(scores), 0)
                out[b, t, h * vd:(h + 1) * vd] = sum(
                    p[u] * kvb[b, u, h, nope:] for u in range(t + 1))
    return out @ attn.wo.T


def test_mla_with_rope_matches_the_direct_formula():
    cfg = config_from_published(tiny_cfg())
    torch.manual_seed(3)
    attn = mm.MLA(cfg)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape) * 0.2)
        x = torch.randn(2, 9, cfg.hidden)
        cos, sin = mm.rope_tables(9, cfg.qk_rope, cfg.rope_theta, "cpu")
        got = attn(x, cos, sin)
        want = _direct_mla(attn, x)
    close(got, want, 1e-5)


def test_router_choice_and_weights():
    torch.manual_seed(4)
    E, k, scale = 8, 3, 2.446
    h = torch.randn(50, 16)
    router = torch.randn(E, 16) * 0.3
    bias = torch.randn(E) * 0.2
    choice, w = mm.route(h, router, bias, k, scale)
    s = torch.sigmoid(h @ router.T)
    for t in range(h.shape[0]):
        order = sorted(range(E), key=lambda e: -float(s[t, e] + bias[e]))
        assert set(choice[t].tolist()) == set(order[:k])
        raw = s[t, choice[t]]
        close(w[t], raw / raw.sum() * scale, 1e-6)
        assert abs(float(w[t].sum()) - scale) < 1e-5
    # the bias moves the choice; the weights stay the raw scores'
    unbiased, _ = mm.route(h, router, torch.zeros(E), k, scale)
    assert not torch.equal(choice, unbiased)


def test_shares_sum_to_the_uncut_layer():
    """Four chips of two experts each: their layer outputs, the shared
    experts counted once, add up to the layer that holds all eight."""
    base = config_from_published(tiny_cfg())
    torch.manual_seed(5)
    whole = mm.MoE(MoeLMConfig(**dict(base.__dict__, held=tuple(range(8)))))
    with torch.no_grad():
        for p in whole.parameters():
            p.copy_(torch.randn(p.shape) * 0.1)
        whole.bias.copy_(torch.randn(8) * 0.05)
    x = torch.randn(2, 16, base.hidden)
    with torch.no_grad():
        want = whole(x)
        shared = whole.shared(x)
        total = shared.clone()
        for chip in range(4):
            held = (2 * chip, 2 * chip + 1)
            part = mm.MoE(MoeLMConfig(**dict(base.__dict__, held=held)))
            part.router.copy_(whole.router)
            part.bias.copy_(whole.bias)
            part.shared.load_state_dict(whole.shared.state_dict())
            for j, e in enumerate(held):
                part.experts[j].load_state_dict(
                    whole.experts[e].state_dict())
            total += part(x) - shared
    close(total, want, 1e-5)
