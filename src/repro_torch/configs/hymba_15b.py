"""hymba-1.5b [hybrid] (arXiv:2411.13676).

32 layers, d_model=1600, 25 attn heads (GQA kv=5), d_ff=5504, vocab=32001,
parallel attention + Mamba-style SSM heads (state 16) fused per layer;
sliding-window attention on most layers (3 full-attention layers).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba_15b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, ssm_state=16,
    window_pattern=(1024,) * 15 + (-1,),
    source="arXiv:2411.13676 (hf)")
