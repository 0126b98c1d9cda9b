"""gemma3-1b [dense] (hf:google/gemma-3-1b-pt).

26 layers, d_model=1152, 4 heads (kv=1), head_dim=256, d_ff=6912,
vocab=262144, 5 local (1024-window) : 1 global interleave, 128k context.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144, tie_embeddings=True,
    window_pattern=(1024, 1024, 1024, 1024, 1024, -1),
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt (unverified)")
