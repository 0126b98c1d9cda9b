"""qwen1.5-4b [dense] (hf:Qwen/Qwen1.5 family).

40 layers, d_model=2560, 20 heads (kv=20), d_ff=6912, vocab=151936,
QKV bias on (Qwen1.5 signature).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen15_4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, kv_heads=20, d_ff=6912,
    vocab=151936, qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B scaled (hf)")
