"""Plain reference of Moonlight-16B-A3B (DeepSeek-V3: latent attention,
sigmoid-routed experts with a correction bias, shared experts) as one
chip's share of an expert-parallel layer, trained under the parameter
server's momentum updater.

Plain PyTorch in float32 (TF32 off); imports nothing of the program and
nothing of JAX. It is handed what the program is handed (the configuration,
the workload's parameters, the seed) and draws the same inputs: each
parameter's starting value (``draw``) and each step's tokens (``tokens``).
The share rule is the program's: the router scores every expert of the
layer, and only the held experts' part is computed; tokens, logits and loss
are over the vocabulary slice.

The layer (arXiv:2405.04434 §2.1, arXiv:2412.19437 §2.1):

* attention: q = W_q x = [q_nope, q_pe]; [c_kv, k_pe] = W_kva x; c_kv
  RMS-normed; [k_nope, v] = W_kvb c_kv; RoPE (rotate-half form) on q_pe and
  on k_pe, which every head shares; scores q.k / sqrt(qk_nope + qk_rope),
  causal, softmax, times v, then W_o. Computed as written, one sequence
  at a time, each layer recomputed in backward (``checkpoint``) so that a
  layer's 8,192 x 8,192 scores of every head are alive at most once;
* router: s = sigmoid(W_r x) over every expert; the top k of s + b; weights
  s on the chosen, normalised to sum 1 (+1e-20), times the scaling factor;
* MoE: shared(x) + the chosen held experts' w_e * down(silu(gate x) * up x);
* the first ``first_k_dense_replace`` layers take one MLP; the head is untied.

The PS semantics: each step's loss is the mean next-token cross-entropy of
its (batch, seq + 1) tokens; the pushed delta is lr x the gradient; the
momentum updater applies smooth = m * smooth + (1 - m) * delta, w -= smooth
to every dense parameter, to the rows of the held experts that took tokens,
and to the embedding rows of the step's distinct input ids. Other rows
keep their value and their smooth.

Departures from the published model, also listed in the configuration:

* the correction bias b starts at DeepSeek-V3's balancing rule's fixed
  point for the starting weights on step 1's first two sequences
  (``balanced_biases``), where a deployment's balancing keeps it, and
  moves by the rule (b_i += gamma sign(mean load - load_i), gamma the
  configuration's ``bias_update_speed``) after each step on the load of
  this chip's own tokens (the program's replicas each push such a step
  into the biases' table, which sums them; the paper takes the sign of
  the load summed over the chips);
* no sequence-wise auxiliary balance loss;
* packed sequences with no document masks;
* momentum is the parameter server's updater, not Moonlight's Muon;
* RoPE in the rotate-half form: the published checkpoint's interleaved
  pair order is a fixed permutation of the rope rows of W_q and W_kva,
  which seeded weights make immaterial.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

def param_specs(cfg: dict) -> List[tuple]:
    """(name, shape) of every parameter and of each layer's correction
    bias (``layers.<l>.moe.bias``), in drawing order."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    out = [("embed", (cfg["vocab_size"], D))]

    def mlp(prefix, width):
        return [(f"{prefix}.w_gate", (width, D)), (f"{prefix}.w_up", (width, D)),
                (f"{prefix}.w_down", (D, width))]
    for l in range(cfg["num_hidden_layers"]):
        p = f"layers.{l}"
        out += [(f"{p}.attn_norm", (D,)),
                (f"{p}.attn.wq", (H * qk, D)),
                (f"{p}.attn.wkv_a", (cfg["kv_lora_rank"]
                                     + cfg["qk_rope_head_dim"], D)),
                (f"{p}.attn.kv_norm", (cfg["kv_lora_rank"],)),
                (f"{p}.attn.wkv_b", (H * (cfg["qk_nope_head_dim"]
                                          + cfg["v_head_dim"]),
                                     cfg["kv_lora_rank"])),
                (f"{p}.attn.wo", (D, H * cfg["v_head_dim"])),
                (f"{p}.mlp_norm", (D,))]
        if l < cfg["first_k_dense_replace"]:
            out += mlp(f"{p}.mlp", cfg["intermediate_size"])
        else:
            out += [(f"{p}.moe.router", (cfg["router_experts"], D)),
                    (f"{p}.moe.bias", (cfg["router_experts"],))]
            out += mlp(f"{p}.moe.shared", cfg["n_shared_experts"]
                       * cfg["moe_intermediate_size"])
            for j in range(len(cfg["held_experts"])):
                out += mlp(f"{p}.moe.experts.{j}",
                           cfg["moe_intermediate_size"])
    return out + [("final_norm", (D,)), ("head", (cfg["vocab_size"], D))]


def draw(cfg: dict, seed: int, name: str, shape, device) -> torch.Tensor:
    """A parameter's starting value from the seed: norm weights 1, every
    matrix N(0, init_std), each from a generator of its own (seed, name),
    so the same value comes on one device whatever is drawn before it.
    (The correction biases come from ``balanced_biases``.)"""
    if len(shape) == 1:
        return torch.ones(shape, device=device)
    state = np.random.SeedSequence(
        [seed % 2 ** 63, *name.encode()]).generate_state(1, np.uint64)[0]
    g = torch.Generator(device).manual_seed(int(state) % 2 ** 63)
    return torch.randn(shape, generator=g, device=device) * cfg["init_std"]


def balance(s: torch.Tensor, k: int) -> torch.Tensor:
    """The correction bias b (one an expert) at which the top k of s + b
    spread the choices of the rows of ``s`` evenly over the experts:
    DeepSeek-V3's rule, b_i += gamma * sign(mean load - load_i), from b = 0
    with gamma 0.01 shrinking by 2% an iteration, 400 iterations."""
    E = s.shape[1]
    b = torch.zeros(E, device=s.device)
    target = s.shape[0] * k / E
    gamma = 0.01
    for _ in range(400):
        load = torch.bincount(torch.topk(s + b, k, dim=-1).indices.reshape(-1),
                              minlength=E)
        b += gamma * torch.sign(target - load.float())
        gamma *= 0.98
    return b


def balanced_biases(cfg: dict, params: dict, seed: int, device,
                    sequences: int = 2) -> Dict[str, torch.Tensor]:
    """Each MoE layer's correction bias as a deployment's balancing would
    have left it for these weights: ``balance`` of the layer's router
    scores over the first ``sequences`` sequences of step 1's tokens, the
    layers in order (a layer's bias sets its output, which the next layer
    routes). The start: each step then moves it by the rule (``follow``)."""
    specs = dict(param_specs(cfg))
    toks = torch.from_numpy(tokens(cfg, params, seed, 0)[:sequences, :-1])
    eps = cfg["rms_norm_eps"]
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        embed = draw(cfg, seed, "embed", specs["embed"], device)
        xs = [embed[t.to(device)] for t in toks]
        del embed
        for l in range(cfg["num_hidden_layers"]):
            p = f"layers.{l}"
            W = {n: draw(cfg, seed, n, s, device) for n, s in specs.items()
                 if n.startswith(p + ".") and not n.endswith(".bias")}
            xs = [x + attention(W, f"{p}.attn", rms(x, W[f"{p}.attn_norm"],
                                                    eps), cfg) for x in xs]
            hs = [rms(x, W[f"{p}.mlp_norm"], eps) for x in xs]
            if l < cfg["first_k_dense_replace"]:
                xs = [x + mlp(W, f"{p}.mlp", h) for x, h in zip(xs, hs)]
                continue
            s = torch.sigmoid(torch.cat(hs) @ W[f"{p}.moe.router"].T)
            W[f"{p}.moe.bias"] = out[f"{p}.moe.bias"] = balance(
                s, cfg["num_experts_per_tok"])
            xs = [x + moe(W, f"{p}.moe", h, cfg, None, "")
                  for x, h in zip(xs, hs)]
    return out


def start_values(cfg: dict, params: dict, seed: int, device):
    """``init(name, shape, device)``: each parameter's and each correction
    bias's starting value, as the program is handed them."""
    biases = balanced_biases(cfg, params, seed, device)

    def init(name, shape, dev):
        if name in biases:
            return biases[name].to(dev)
        return draw(cfg, seed, name, tuple(shape), dev)
    return init


def zipf_cdf(vocab: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    return np.cumsum(p / p.sum())


def tokens(cfg: dict, params: dict, seed: int, step: int) -> np.ndarray:
    """Step ``step``'s (batch, seq + 1) int64 ids of the slice: Zipf(s)
    over the slice's ids, id i the (i + 1)-th most frequent."""
    B, S = params["batch"], params["seq"]
    rng = np.random.default_rng([seed % 2 ** 63, step])
    ids = np.searchsorted(zipf_cdf(cfg["vocab_size"], cfg["zipf_s"]),
                          rng.random(B * (S + 1)), side="right")
    return np.minimum(ids, cfg["vocab_size"] - 1).reshape(B, S + 1).astype(
        np.int64)


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """Rotate-half RoPE of x (S, heads, d) at positions ``pos``."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = torch.cat([pos[:, None] * inv, pos[:, None] * inv], -1)[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * ang.cos() + rot * ang.sin()


def attention(W, p, x, cfg):
    S = x.shape[0]
    H, nope, rp = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                   cfg["qk_rope_head_dim"])
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    pos = torch.arange(S, device=x.device, dtype=torch.float32)
    q = (x @ W[f"{p}.wq"].T).view(S, H, nope + rp)
    kv = x @ W[f"{p}.wkv_a"].T
    c, k_pe = kv[:, :r], kv[:, r:]
    c = rms(c, W[f"{p}.kv_norm"], cfg["rms_norm_eps"])
    kvb = (c @ W[f"{p}.wkv_b"].T).view(S, H, nope + vd)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos,
                                       cfg["rope_theta"])], -1)
    k_pe = rope(k_pe.view(S, 1, rp), pos, cfg["rope_theta"])
    k = torch.cat([k_nope, k_pe.expand(S, H, rp)], -1)
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(nope + rp)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hst,thd->shd", scores.softmax(-1), v)
    return o.reshape(S, H * vd) @ W[f"{p}.wo"].T


def mlp(W, p, x):
    return (F.silu(x @ W[f"{p}.w_gate"].T) * (x @ W[f"{p}.w_up"].T)) \
        @ W[f"{p}.w_down"].T


def moe(W, p, x, cfg, record: Optional[dict], fault: str):
    """The shared experts plus the held experts' part; ``record`` (when
    given) takes the (tokens, held) choice mask and every expert's load
    (the tokens that chose it)."""
    held = cfg["held_experts"]
    s = torch.sigmoid(x @ W[f"{p}.router"].T)
    choice = torch.topk(s + W[f"{p}.bias"], cfg["num_experts_per_tok"],
                        dim=-1).indices
    w = s.gather(1, choice)
    scale = 1.0 if fault == "scale" else cfg["routed_scaling_factor"]
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * scale
    y = mlp(W, f"{p}.shared", x)
    mask = []
    for j, e in enumerate(held):
        hit = choice == e
        mask.append(hit.any(-1))
        rows = mask[-1].nonzero().squeeze(1)
        if fault == "expert" and j == 0:
            continue
        if len(rows):
            we = (w * hit).sum(-1)[rows]
            y = y.index_add(0, rows, we[:, None]
                            * mlp(W, f"{p}.experts.{j}", x[rows]))
    if record is not None:
        record[p] = (torch.stack(mask, 1), torch.bincount(
            choice.reshape(-1), minlength=cfg["router_experts"]))
    return y


def sequence_logits(W, cfg, ids: torch.Tensor, fault: str = "",
                    record: Optional[dict] = None) -> torch.Tensor:
    """The (seq, vocab) logits of one (seq,) row of ids."""
    eps = cfg["rms_norm_eps"]
    x = W["embed"][ids]
    for l in range(cfg["num_hidden_layers"]):
        p = f"layers.{l}"

        def layer(x, p=p, l=l):
            x = x + attention(W, f"{p}.attn", rms(x, W[f"{p}.attn_norm"],
                                                  eps), cfg)
            h = rms(x, W[f"{p}.mlp_norm"], eps)
            if l < cfg["first_k_dense_replace"]:
                return x + mlp(W, f"{p}.mlp", h)
            # the recompute in backward records nothing
            rec = record if record is not None and f"{p}.moe" not in record \
                else None
            return x + moe(W, f"{p}.moe", h, cfg, rec, fault)
        x = checkpoint(layer, x, use_reentrant=False)
    return rms(x, W["final_norm"], eps) @ W["head"].T


def sequence_loss(W, cfg, seq: torch.Tensor, fault: str = "",
                  record: Optional[dict] = None) -> torch.Tensor:
    """The sum of the next-token cross-entropies of one (seq + 1,) row."""
    return F.cross_entropy(sequence_logits(W, cfg, seq[:-1], fault, record),
                           seq[1:], reduction="sum")


def tables(cfg: dict) -> Dict[str, List[str]]:
    """The parameter tables the comparison reads, by their parameters: a
    layer's dense parameters, the final norm and head, a MoE layer's held
    experts, the embedding."""
    out: Dict[str, List[str]] = {}
    for name, _ in param_specs(cfg):
        if name.endswith(".bias"):
            continue
        parts = name.split(".")
        if parts[0] == "layers":
            key = (f"experts.{parts[1]}" if parts[2:4] == ["moe", "experts"]
                   else f"layer.{parts[1]}")
        else:
            key = {"embed": "embed"}.get(name, "head")
        out.setdefault(key, []).append(name)
    return out


def follow(cfg: dict, params: dict, seed: int, device, steps: int,
           dtype=torch.float32, fault: str = "", init=None) -> dict:
    """The first ``steps`` steps from the seed's weights and tokens.
    Returns each step's loss and token-expert pairs on held experts; at
    step 1 each parameter's pushed delta's squared norm and each MoE
    layer's (tokens, held) choice mask (sequences in order); after the last
    step each parameter's change from its start in ``dtype``. ``dtype``
    bfloat16 keeps the weights and the momentum state in bfloat16 (the
    control); ``fault`` "expert" drops
    held expert 0's output, "scale" the routing scale. ``init``: the
    starting values (``start_values``; computed when not given)."""
    lr, m = cfg["lr"], cfg["momentum"]
    init = init or start_values(cfg, params, seed, device)
    W0 = {n: init(n, s, device).to(dtype).float()
          for n, s in param_specs(cfg)}
    W = {n: w.clone().requires_grad_(not n.endswith(".bias"))
         for n, w in W0.items()}
    smooth = {n: torch.zeros_like(w) for n, w in W.items()
              if not n.endswith(".bias")}
    B, S = params["batch"], params["seq"]
    out = {"loss": [], "pairs": []}
    for step in range(steps):
        toks = torch.from_numpy(tokens(cfg, params, seed, step)).to(device)
        masks: Dict[str, list] = {}
        loads: Dict[str, torch.Tensor] = {}
        loss = 0.0
        for b in range(B):
            rec: dict = {}
            lb = sequence_loss(W, cfg, toks[b], fault, rec) / (B * S)
            lb.backward()
            loss += float(lb.detach())
            for k, (mask, load) in rec.items():
                masks.setdefault(k, []).append(mask)
                loads[k] = loads.get(k, 0) + load
        with torch.no_grad():
            # DeepSeek-V3's balancing: each expert's bias moves toward
            # the mean load by the update speed, after the step
            for k, load in loads.items():
                W[f"{k}.bias"] += cfg["bias_update_speed"] * torch.sign(
                    load.float().mean() - load.float())
        out["loss"].append(loss)
        held = {k: torch.cat(v) for k, v in masks.items()}
        out["pairs"].append(int(sum(int(v.sum()) for v in held.values())))
        if step == 0:
            out["held_masks"] = [held[k] for k in sorted(
                held, key=lambda k: int(k.split(".")[1]))]
        uniq = torch.unique(toks[:, :-1])
        with torch.no_grad():
            sq = {}
            for n, w in W.items():
                if w.grad is None:
                    continue
                delta = lr * w.grad
                sq[n] = float(delta.double().pow(2).sum())
                new_s = m * smooth[n] + (1 - m) * delta
                rows = None
                if n == "embed":
                    rows = uniq
                elif ".moe.experts." in n:
                    l, j = n.split(".")[1], int(n.split(".")[4])
                    if not bool(held[f"layers.{l}.moe"][:, j].any()):
                        rows = torch.empty(0, dtype=torch.long,
                                           device=device)
                if rows is None:
                    smooth[n] = new_s.to(dtype).float()
                    w -= smooth[n]
                elif len(rows):
                    smooth[n][rows] = new_s[rows].to(dtype).float()
                    w[rows] -= smooth[n][rows]
                w.copy_(w.to(dtype).float())
                w.grad = None
            if step == 0:
                out["delta_sq"] = sq
    with torch.no_grad():
        out["change"] = {n: (W[n] - W0[n]).detach() for n in smooth}
    return out
