"""The FLOPs a training step of the DeepSeek-V3 MoE share needs, counted
from the configuration's shapes, the tokens and the token-expert pairs on
held experts (never timed by the program): forward and backward of every
matmul at 3 x 2 FLOPs a multiply-add, the causal attention over the lower
triangle only (the scores and the weighted sum of v at the model's own
widths: v's pad to the query width is the program's, not the model's).
And the least bytes the momentum updater's row path moves for the rows a
step pushes."""


def dense_params_per_token(cfg: dict) -> int:
    """Multiply-adds a token takes outside the routed experts and the
    attention scores: the attention projections of every layer, the dense
    MLP of the leading layers, the router and the shared experts of the
    MoE layers, the head."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    attn = (H * (nope + rope) * D + (r + rope) * D + H * (nope + vd) * r
            + D * H * vd)
    L, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    moe = (cfg["router_experts"] * D
           + 3 * D * cfg["n_shared_experts"] * cfg["moe_intermediate_size"])
    return (L * attn + dense * 3 * D * cfg["intermediate_size"]
            + (L - dense) * moe + cfg["vocab_size"] * D)


def step_flops(cfg: dict, batch: int, seq: int, routed_pairs: float) -> float:
    """FLOPs of one training step of ``batch`` sequences of ``seq`` tokens
    with ``routed_pairs`` token-expert pairs on held experts."""
    tokens = batch * seq
    expert = 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
    H = cfg["num_attention_heads"]
    width = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
             + cfg["v_head_dim"])
    causal_pairs = seq * (seq + 1) // 2
    attn = H * causal_pairs * width * batch * cfg["num_hidden_layers"]
    return 6.0 * (tokens * dense_params_per_token(cfg)
                  + routed_pairs * expert + attn)


def row_bytes(cfg: dict, expert_rows: int, token_rows: int) -> int:
    """The least bytes of the pushed rows' path through the momentum
    updater: each pushed row of a table and its momentum row, float32,
    read once and written once; an expert's row holds its gate, up and
    down matrices, a token's row its embedding."""
    expert = 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
    return 16 * (expert_rows * expert + token_rows * cfg["hidden_size"])
