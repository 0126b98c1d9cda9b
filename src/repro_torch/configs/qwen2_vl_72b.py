"""qwen2-vl-72b [vlm] backbone (arXiv:2409.12191).

80 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064,
M-RoPE (temporal/height/width sections).  Vision frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings + 3d position ids.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, kv_heads=8, d_ff=29568,
    vocab=152064, qkv_bias=True, mrope_sections=(16, 24, 24),
    embed_inputs=True, rope_theta=1_000_000.0,
    source="arXiv:2409.12191 (hf)")
