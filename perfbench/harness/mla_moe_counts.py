"""The yardstick's counts for the DeepSeek-V3 block (latent attention and a
dropless MoE with shared experts): the operations a prefill needs, and the
least time of the expert products, counted from the configuration's
published keys and the prompt's shape, whatever implements them.

- :func:`prefill_flops`: 2 x every weight product's parameters x tokens
  (the latent attention's q, kv_a, kv_b and o; the dense layers' SwiGLU;
  each MoE layer's router, its ``num_experts_per_tok`` routed experts and
  its shared experts), attention at ``2 (qk_nope + qk_rope + v)``
  operations per visible (query, key) pair and head in every layer, and
  the head on the last position only.
- :func:`experts_bound`: the MoE layers' expert products (routed and
  shared) at the bf16 tensor-core peak, against their bytes over HBM:
  each held expert's weights read once, the routed pairs' rows in and out
  once, the shared expert's tokens in and out once.  Every routed expert
  is counted as read: at the cell's sizes each gets pairs.
"""
from __future__ import annotations

from perfbench.harness.peaks import (H100_BF16_OPS_PER_S, causal_pairs,
                                     roofline_ms)

__all__ = ["attention_params", "prefill_flops", "experts_bound"]


def attention_params(cfg: dict) -> int:
    """Parameters of one latent attention that enter a product: W_q,
    W_kva, W_kvb and W_o (the latent norm's gain left out)."""
    d, H, r = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["kv_lora_rank"])
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    return d * H * (nope + rope) + d * (r + rope) + r * H * (nope + v) \
        + H * v * d


def _moe_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def _expert_params_per_token(cfg: dict) -> int:
    """Parameters of the expert products one token passes through in one
    MoE layer: its routed experts and the shared experts."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) * 3 * d * f


def prefill_flops(cfg: dict, B: int, S: int) -> float:
    """Operations one prefill of B prompts of S tokens needs (module
    docstring)."""
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    Ld, Lm = cfg["first_k_dense_replace"], _moe_layers(cfg)
    per_token = (L * attention_params(cfg)
                 + Ld * 3 * d * cfg["intermediate_size"]
                 + Lm * (d * cfg["n_routed_experts"]
                         + _expert_params_per_token(cfg)))
    qkv = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] \
        + cfg["v_head_dim"]
    attn = 2.0 * qkv * causal_pairs(S) * B * cfg["num_attention_heads"] * L
    return 2.0 * per_token * B * S + attn + 2.0 * d * V * B


def experts_bound(cfg: dict, B: int, S: int, size: int = 2):
    """Least time of every MoE layer's expert products for one prefill of B
    prompts of S tokens, with ``size``-byte elements: (ms, what bounds it
    -- "bytes" or "operations", operations, bytes)."""
    d, f, E = (cfg["hidden_size"], cfg["moe_intermediate_size"],
               cfg["n_routed_experts"])
    k, ns, Lm = (cfg["num_experts_per_tok"], cfg["n_shared_experts"],
                 _moe_layers(cfg))
    N = B * S
    ops = 2.0 * _expert_params_per_token(cfg) * N * Lm
    weights = (E + ns) * 3 * d * f
    rows = 2 * N * k * d + 2 * N * d         # routed pairs, shared tokens
    nbytes = float(size * (weights + rows) * Lm)
    ms, by = roofline_ms(nbytes, ops, H100_BF16_OPS_PER_S)
    return ms, by, ops, nbytes
