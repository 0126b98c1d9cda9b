"""grok-1-314b [moe] (hf:xai-org/grok-1).

64 layers, d_model=6144, 48 heads (GQA kv=8), d_ff=32768, vocab=131072,
8 experts top-2.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok1_314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, kv_heads=8, d_ff=32768,
    vocab=131072, n_experts=8, moe_top_k=2,
    source="hf:xai-org/grok-1 (unverified)")
