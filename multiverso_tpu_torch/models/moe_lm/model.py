"""The DeepSeek-V3 block (arXiv:2405.04434, arXiv:2412.19437) as one chip's
share of an expert-parallel layer.

* MLA: ``q = W_q x`` split into a no-position part and a RoPE part; ``[c_kv,
  k_pe] = W_kva x``; ``c_kv`` RMS-normed; ``[k_nope, v] = W_kvb c_kv``; RoPE
  (rotate-half form) on ``q_pe`` and on the one ``k_pe`` every head shares;
  causal softmax at ``1/sqrt(qk_nope + qk_rope)``; ``o = W_o`` of the heads'
  ``v``. ``v`` is padded to the query width so that the fused (flash)
  attention kernel takes the three tensors; the pad columns are cut off.
* Router: ``s = sigmoid(W_r x)`` in float32 over every expert of the layer;
  the top ``k`` of ``s + b`` (``b`` the correction bias) are chosen; their
  weights are ``s`` normalised to sum 1, times ``route_scale``. A training
  forward leaves DeepSeek-V3's balancing step for ``b`` on the layer's load
  in ``bias_step`` (``bias_update_speed``); the trainer pushes it through
  the bias's table.
* MoE: ``y = shared(x) + sum over chosen AND held experts of w_e *
  down_e(silu(gate_e x) * up_e x)``. The layer is told which experts it
  holds, routes over all of them and computes only its own experts' part.
* Dense layers (the first ``first_dense``) take one MLP; the head is untied.

Parameters are float32. Under ``torch.autocast`` the matmuls run in the
autocast type (bfloat16 on the card); the router, the norms, RoPE's tables
and the loss stay in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multiverso_tpu_torch.telemetry import trace as ttrace


@dataclass
class MoeLMConfig:
    """A DeepSeek-V3 language model cut to one chip's share."""

    hidden: int = 2048
    layers: int = 9
    first_dense: int = 1
    dense_width: int = 11264
    expert_width: int = 1408
    shared_experts: int = 2
    heads: int = 16
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    kv_rank: int = 512
    rope_theta: float = 50000.0
    eps: float = 1e-5
    #: experts the router scores (the layer's whole expert count)
    experts: int = 64
    top_k: int = 6
    route_scale: float = 2.446
    #: DeepSeek-V3's bias update speed (gamma): each training forward
    #: steps each expert's correction bias by gamma toward the mean load
    #: (0: the bias stays as it is)
    bias_update_speed: float = 0.0
    #: the experts this chip holds, by their id in the router's output
    held: Sequence[int] = field(default_factory=lambda: tuple(range(8)))
    #: vocabulary ids this chip holds (the tokens, logits and loss are
    #: over the slice)
    vocab: int = 20480

    @property
    def qk_dim(self) -> int:
        return self.qk_nope + self.qk_rope


def matmul_dtype(device: torch.device) -> torch.dtype:
    """The type the matmuls run in: autocast's where it is on."""
    if torch.is_autocast_enabled(device.type):
        return torch.get_autocast_dtype(device.type)
    return torch.float32


class _RMSNorm(torch.autograd.Function):
    """RMSNorm computed in float32, its output in ``out_dtype``; saves only
    its input and the reciprocal RMS (not a float32 copy of its output)."""

    @staticmethod
    def forward(ctx, x, weight, eps, out_dtype):
        xf = x.float()
        rstd = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, weight, rstd)
        return (xf * rstd * weight).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        xhat = x.float() * rstd
        g = g.float()
        gw = (g * xhat).reshape(-1, xhat.shape[-1]).sum(0)
        gh = g * weight
        gx = rstd * (gh - xhat * (gh * xhat).mean(-1, keepdim=True))
        return gx.to(x.dtype), gw, None, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x / rms(x) * weight`` in float32, returned in ``out_dtype``."""
    return _RMSNorm.apply(x, weight, eps, out_dtype)


class _SwiGLU(torch.autograd.Function):
    """``silu(a) * b``; saves a and b only (silu is recomputed)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return F.silu(a) * b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        af, g = a.float(), g.float()
        sig = torch.sigmoid(af)
        silu = af * sig
        ga = g * b.float() * sig * (1 + af * (1 - sig))
        return ga.to(a.dtype), (g * silu).to(b.dtype)


def rope_tables(seq: int, dim: int, theta: float, device):
    """cos and sin, (seq, dim) float32, of the rotate-half form."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device,
                                       dtype=torch.float32) / dim)
    freqs = torch.outer(torch.arange(seq, device=device,
                                     dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], -1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """RoPE on ``x`` (..., seq, heads, dim) in float32, back in x's type."""
    half = x.shape[-1] // 2
    xf = x.float()
    rot = torch.cat([-xf[..., half:], xf[..., :half]], -1)
    c, s = cos[:, None, :], sin[:, None, :]
    return (xf * c + rot * s).to(x.dtype)


class MLP(nn.Module):
    """``down(silu(gate x) * up x)``."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.w_gate = nn.Parameter(torch.empty(width, hidden))
        self.w_up = nn.Parameter(torch.empty(width, hidden))
        self.w_down = nn.Parameter(torch.empty(hidden, width))

    def forward(self, x):
        return F.linear(_SwiGLU.apply(F.linear(x, self.w_gate),
                                      F.linear(x, self.w_up)), self.w_down)


class MLA(nn.Module):
    """Multi-head latent attention without a q projection rank."""

    def __init__(self, cfg: MoeLMConfig):
        super().__init__()
        self.cfg = cfg
        H, D = cfg.heads, cfg.hidden
        self.wq = nn.Parameter(torch.empty(H * cfg.qk_dim, D))
        self.wkv_a = nn.Parameter(torch.empty(cfg.kv_rank + cfg.qk_rope, D))
        self.kv_norm = nn.Parameter(torch.empty(cfg.kv_rank))
        self.wkv_b = nn.Parameter(torch.empty(
            H * (cfg.qk_nope + cfg.v_dim), cfg.kv_rank))
        self.wo = nn.Parameter(torch.empty(D, H * cfg.v_dim))

    def forward(self, x, cos, sin):
        cfg = self.cfg
        B, S, _ = x.shape
        H = cfg.heads
        q = F.linear(x, self.wq).view(B, S, H, cfg.qk_dim)
        q_nope, q_pe = q.split([cfg.qk_nope, cfg.qk_rope], -1)
        kv = F.linear(x, self.wkv_a)
        c_kv, k_pe = kv.split([cfg.kv_rank, cfg.qk_rope], -1)
        c_kv = rms_norm(c_kv, self.kv_norm, cfg.eps, kv.dtype)
        kvb = F.linear(c_kv, self.wkv_b).view(B, S, H, cfg.qk_nope + cfg.v_dim)
        k_nope, v = kvb.split([cfg.qk_nope, cfg.v_dim], -1)
        dt = kvb.dtype
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe.view(B, S, 1, cfg.qk_rope), cos, sin)
        q = torch.cat([q_nope, q_pe.to(dt)], -1)
        k = torch.cat([k_nope, k_pe.to(dt).expand(B, S, H, cfg.qk_rope)], -1)
        v = F.pad(v, (0, cfg.qk_dim - cfg.v_dim))
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=1.0 / math.sqrt(cfg.qk_dim))
        o = o.transpose(1, 2)[..., : cfg.v_dim].reshape(B, S, H * cfg.v_dim)
        return F.linear(o, self.wo)


def route(h: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float):
    """(chosen expert ids (N, k), their weights (N, k) float32) for the
    rows of ``h``: top-k of ``sigmoid(W_r h) + b``, weighted by the raw
    scores normalised to sum 1, times ``scale``. Float32 throughout."""
    with torch.autocast(h.device.type, enabled=False):
        s = torch.sigmoid(F.linear(h.float(), router.float()))
    choice = torch.topk(s + bias, top_k, dim=-1).indices
    w = s.gather(1, choice)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * scale
    return choice, w


class MoE(nn.Module):
    """The layer's shared experts and the experts this chip holds."""

    def __init__(self, cfg: MoeLMConfig):
        super().__init__()
        self.cfg = cfg
        self.router = nn.Parameter(torch.empty(cfg.experts, cfg.hidden))
        self.register_buffer("bias", torch.zeros(cfg.experts))
        slot = torch.full((cfg.experts,), len(cfg.held), dtype=torch.long)
        slot[torch.as_tensor(list(cfg.held), dtype=torch.long)] = torch.arange(
            len(cfg.held))
        #: an expert id's place among the held experts (len(held): absent)
        self.register_buffer("slot", slot, persistent=False)
        self.shared = MLP(cfg.hidden, cfg.shared_experts * cfg.expert_width)
        self.experts = nn.ModuleList(MLP(cfg.hidden, cfg.expert_width)
                                     for _ in cfg.held)
        #: token-expert pairs each held expert took in the last forward
        self.counts: List[int] = []
        #: the last training forward's balancing step for ``bias``, (experts,)
        #: (None without one); the layer does not apply it
        self.bias_step: Optional[torch.Tensor] = None
        #: with ``record`` set, the last forward's (tokens, held) choice mask
        self.record = False
        self.held_mask: Optional[torch.Tensor] = None

    def forward(self, x):
        """x: the normed (B, S, D) float32 input; the router reads it, the
        shared and held experts one cast of it to the matmuls' type. The
        experts keep only their inputs for backward and run again there:
        their activations in every layer would not fit beside the tables
        at 65,536 tokens a step. The routing, outside, runs once."""
        B, S, D = x.shape
        h = x.reshape(B * S, D)
        with ttrace.span("moe.route", cat="moe"):
            choice, w = route(h, self.router, self.bias, self.cfg.top_k,
                              self.cfg.route_scale)
            tok, wts = self.pairs(choice, w)
            if self.cfg.bias_update_speed and torch.is_grad_enabled():
                self.bias_step = self.balance(choice)
        with ttrace.span("moe.experts", cat="moe"):
            y = checkpoint(self._experts, h, tok, wts, use_reentrant=False)
        return y.view(B, S, D)

    @torch.no_grad()
    def balance(self, choice) -> torch.Tensor:
        """DeepSeek-V3's auxiliary-loss-free balancing on this forward's
        choices: each expert's step of the update speed toward the mean
        load (added to the bias after the step: the next forward reads
        it)."""
        load = torch.bincount(choice.reshape(-1),
                              minlength=self.cfg.experts).float()
        return self.cfg.bias_update_speed * torch.sign(load.mean() - load)

    def pairs(self, choice, w):
        """The chosen (token, expert) pairs on held experts, sorted by
        expert: each pair's token and weight. One host read of the
        per-expert counts (``counts``) sizes the experts' matmuls."""
        n_held, k = len(self.cfg.held), self.cfg.top_k
        slot = self.slot[choice].reshape(-1)
        if self.record:
            mask = torch.zeros(choice.shape[0], n_held + 1, dtype=torch.bool,
                               device=choice.device)
            self.held_mask = mask.scatter_(1, slot.view(-1, k), True)[
                :, :n_held]
        order = torch.argsort(slot, stable=True)
        self.counts = torch.bincount(slot, minlength=n_held + 1)[
            :n_held].tolist()
        pairs = order[: sum(self.counts)]
        return pairs // k, w.reshape(-1)[pairs]

    def _experts(self, h, tok, wts):
        hm = h.to(matmul_dtype(h.device))
        return self.shared(hm) + self.held_experts(hm, tok, wts)

    def held_experts(self, hm, tok, wts):
        """The held experts' part, (N, D) float32: each expert on its run
        of the sorted pairs, weighted, summed into the pairs' tokens."""
        xs = hm[tok]
        out = torch.zeros(hm.shape, dtype=torch.float32, device=hm.device)
        parts, start = [], 0
        for expert, n in zip(self.experts, self.counts):
            if n:
                parts.append(expert(xs[start:start + n]))
            start += n
        if parts:
            y = torch.cat(parts) if len(parts) > 1 else parts[0]
            out.index_add_(0, tok, y * wts[:, None])
        return out


class Block(nn.Module):
    def __init__(self, cfg: MoeLMConfig, dense: bool):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = nn.Parameter(torch.empty(cfg.hidden))
        self.attn = MLA(cfg)
        self.mlp_norm = nn.Parameter(torch.empty(cfg.hidden))
        if dense:
            self.mlp = MLP(cfg.hidden, cfg.dense_width)
        else:
            self.moe = MoE(cfg)

    def forward(self, x, cos, sin):
        dt = matmul_dtype(x.device)
        x = x + self.attn(rms_norm(x, self.attn_norm, self.cfg.eps, dt),
                          cos, sin)
        if hasattr(self, "mlp"):
            return x + self.mlp(rms_norm(x, self.mlp_norm, self.cfg.eps, dt))
        return x + self.moe(rms_norm(x, self.mlp_norm, self.cfg.eps))


class MoeLM(nn.Module):
    """Embedding slice, ``layers`` blocks (the first ``first_dense`` dense),
    the final norm and the untied head over the vocabulary slice."""

    def __init__(self, cfg: MoeLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.hidden))
        self.layers = nn.ModuleList(Block(cfg, l < cfg.first_dense)
                                    for l in range(cfg.layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.hidden))
        self.head = nn.Parameter(torch.empty(cfg.vocab, cfg.hidden))

    def moe_layers(self) -> List[MoE]:
        return [b.moe for b in self.layers if hasattr(b, "moe")]

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) ids of the slice -> the final normed (B, S, D) states, in
        the matmuls' type."""
        S = tokens.shape[1]
        cos, sin = rope_tables(S, self.cfg.qk_rope, self.cfg.rope_theta,
                               tokens.device)
        x = F.embedding(tokens, self.embed)
        for block in self.layers:
            x = block(x, cos, sin)
        return rms_norm(x, self.final_norm, self.cfg.eps,
                        matmul_dtype(x.device))

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) ids of the slice -> (B, S, vocab) logits."""
        return F.linear(self.hidden(tokens), self.head)

    def loss(self, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy (float32) of (B, S + 1) ids. The
        head and the loss run one sequence at a time and are recomputed in
        backward, so no (tokens, vocab) logits outlive their sequence."""
        h = self.hidden(tokens[:, :-1])
        targets = tokens[:, 1:]
        total = sum(checkpoint(_head_loss, h[b], self.head, targets[b],
                               use_reentrant=False)
                    for b in range(h.shape[0]))
        return total / targets.numel()


def _head_loss(h, head, targets):
    """The summed cross-entropy (float32) of one sequence's logits."""
    return F.cross_entropy(F.linear(h, head).float(), targets,
                           reduction="sum")
