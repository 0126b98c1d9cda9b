"""The yardstick's peaks and least-time functions for one NVIDIA H100.

Frozen copies, taken from ``chip_smoke.py`` at commit 0916888 (the
constants at its lines 253-258, ``fe_bound_ms``, ``visible_pairs``,
``roofline_ms`` and ``fa_bound_ms``), with the dtype argument of
``fa_bound_ms`` given as a byte size so that this module needs no torch.
The peaks are the data sheet's (SXM part, dense, at the full 700 W power
limit); a card set below it reads lower shares.  ``prefill_flops`` is the
benchmark's own count of the work of one prefill.
"""
from __future__ import annotations

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12    # bf16 on the tensor cores, dense
H100_TF32_OPS_PER_S = 495e12    # TF32 on the tensor cores, dense
FE_OPS_PER_POSITION = 48        # f32 operations of one live (candidate, pos)


def fe_bound_ms(C: int, POP: int, P: int, live_positions: int, form):
    """Least time for one fusion_eval call in ``form`` (0 cost, 1 stats,
    2 raw): the strategies, the layer table, the per-condition scalars and
    hw rows read once, the CostOut and the form's group matrices (none, gid
    and M_g, or all seven) written once, over HBM; f32 operations over the
    f32 peak.  ``live_positions`` is the sum of the conditions' layer
    counts.  Returns (ms, what bounds it, bytes)."""
    mats = (0, 2, 7)[int(form)]
    bytes_ = (C * POP * P * 4                    # strategies
              + C * P * (5 * 4 + 4)              # A W F OE UC, SKIP
              + C * (4 * 4 + 10 * 4)             # n, batch, BPE, budget, hw
              + C * POP * (3 * 4 + 1 + 4)        # CostOut
              + mats * C * POP * P * 4)          # the form's matrices
    ops = POP * live_positions * FE_OPS_PER_POSITION
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), bytes_


def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention mask leaves visible."""
    total = 0
    for i in range(S):
        hi = min(T, i + 1) if causal else T
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def roofline_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def fa_bound_ms(B, S, T, Hq, Hkv, hd, causal, window, size):
    """Least time for one attention call of ``size``-byte elements: 4 * hd
    operations per visible (query, key) pair and head over the bf16 peak
    (2 bytes) or the f32 CUDA-core peak (4 bytes); q, k, v read once and
    the output written once over HBM."""
    ops = 4 * hd * visible_pairs(S, T, causal, window) * B * Hq
    nbytes = size * (2 * B * S * Hq * hd + 2 * B * T * Hkv * hd)
    peak = H100_BF16_OPS_PER_S if size == 2 else H100_F32_OPS_PER_S
    return roofline_ms(nbytes, ops, peak)


def block_params(cfg: dict) -> int:
    """Parameters of one dense decoder block that enter a product: q, k, v,
    o and the SwiGLU MLP (norm gains left out)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv, ff = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["intermediate_size"])
    return 2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * ff


def prefill_flops(cfg: dict, B: int, S: int) -> float:
    """Operations one prefill of B prompts of S tokens needs: 2 x the
    blocks' parameters x tokens, causal attention as ``fa_bound_ms`` counts
    it in every layer, and the head on the last position only."""
    L = cfg["num_hidden_layers"]
    gemm = 2.0 * L * block_params(cfg) * B * S
    attn = (4.0 * cfg["head_dim"] * causal_pairs(S) * B
            * cfg["num_attention_heads"] * L)
    head = 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * B
    return gemm + attn + head


def causal_pairs(S: int) -> int:
    """``visible_pairs(S, S, True, -1)`` in closed form."""
    return S * (S + 1) // 2
