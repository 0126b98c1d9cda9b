"""qwen3-8b [dense] (hf:Qwen/Qwen3-8B).

36 layers, d_model=4096, 32 heads (GQA kv=8), head_dim=128, d_ff=12288,
vocab=151936, qk-norm (RMS on per-head q/k).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B (hf)")
