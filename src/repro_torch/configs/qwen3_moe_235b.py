"""qwen3-moe-235b-a22b [moe] (hf:Qwen/Qwen3-235B-A22B family).

94 layers, d_model=4096, 64 heads (GQA kv=4), head_dim=128, expert
d_ff=1536, vocab=151936, 128 experts top-8, qk-norm.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_moe_235b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, n_experts=128, moe_top_k=8, qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B scaled (hf)")
