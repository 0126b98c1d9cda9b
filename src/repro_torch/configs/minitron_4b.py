"""minitron-4b [dense]: pruned Nemotron (arXiv:2407.14679).

32 layers, d_model=3072, 24 heads (GQA kv=8), d_ff=9216, vocab=256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron_4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, kv_heads=8, d_ff=9216,
    vocab=256000,
    source="arXiv:2407.14679 (hf)")
