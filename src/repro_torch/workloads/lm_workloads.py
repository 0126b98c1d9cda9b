"""Lower an LM arch config to a fusion-mapper ``Workload`` (a numpy-only
copy of ``repro.workloads.lm_workloads``).

Every LM architecture becomes a chain at transformer-block granularity,
the granularity at which inter-layer fusion stages activations across
blocks.  Per block: MACs = the block's matmul work per *sample* (one
sequence for train/prefill, one token for decode), staged activation =
the block-boundary hidden state, weights = the block's parameters (all
experts for MoE: residency is what fusion must budget).  The arithmetic is
the reference's, term for term, so every ``Layer`` field equals its.
"""
from __future__ import annotations

from ..configs import ArchConfig
from .layer import Layer, Workload

__all__ = ["lm_workload"]


def _block_stats(cfg: ArchConfig, seq: int, per_token: bool):
    """(macs, w_elems) per sample for one decoder block."""
    d, hd = cfg.d_model, cfg.hd
    toks = 1 if per_token else seq
    attn_w = d * (cfg.n_heads * hd) + 2 * d * (cfg.kv_heads * hd) \
        + (cfg.n_heads * hd) * d
    attn_macs = toks * attn_w
    # attention itself: each token attends to `seq` keys (the cache length)
    attn_macs += 2.0 * toks * seq * cfg.n_heads * hd
    if cfg.n_experts:
        w_ffn = cfg.n_experts * 3 * d * cfg.d_ff
        macs_ffn = toks * cfg.moe_top_k * 3 * d * cfg.d_ff
    elif cfg.family == "ssm":
        w_ffn = d * cfg.d_ff + cfg.d_ff * d + d * d     # channel mix + gate
        macs_ffn = toks * w_ffn
        attn_w = 4 * d * d                               # r,k,v,o time-mix
        attn_macs = toks * attn_w + toks * d * hd        # wkv update
    else:
        mult = 3 if cfg.mlp_kind == "swiglu" else 2
        w_ffn = mult * d * cfg.d_ff
        macs_ffn = toks * w_ffn
    if cfg.family == "hybrid":
        w_ffn += 2 * d * d + d * 2 * cfg.ssm_state
        macs_ffn += toks * (2 * d * d)
    return float(attn_macs + macs_ffn), float(attn_w + w_ffn)


def lm_workload(cfg: ArchConfig, *, seq_len: int, batch: int,
                mode: str = "train") -> Workload:
    """One ``Layer`` per transformer block (encoder and decoder for
    encdec), with the embedding first and the head last."""
    per_token = (mode == "decode")
    toks = 1 if per_token else seq_len
    d = cfg.d_model
    layers: list[Layer] = [Layer.op(
        "embed", macs=float(toks * d), out_elems=float(toks * d),
        w_elems=float(cfg.vocab_padded * d),
        shape6=(d, cfg.vocab_padded, toks, 1, 1, 1))]
    macs, w = _block_stats(cfg, seq_len, per_token)
    n_blocks = cfg.n_layers + (cfg.encoder_layers if cfg.family == "encdec"
                               else 0)
    for i in range(n_blocks):
        layers.append(Layer.op(
            f"block{i}", macs=macs, out_elems=float(toks * d), w_elems=w,
            shape6=(d, d, toks, 1, cfg.d_ff // max(d, 1) + 1, 1)))
    layers.append(Layer.op(
        "head", macs=float(toks * d * cfg.vocab_padded),
        out_elems=float(toks * cfg.vocab_padded),
        w_elems=float(d * cfg.vocab_padded),
        shape6=(cfg.vocab_padded, d, toks, 1, 1, 1)))
    return Workload(f"{cfg.name}_{mode}", layers, input_elems=float(toks),
                    input_shape6=(1, 1, toks, 1, 1, 1),
                    default_batch=batch)
