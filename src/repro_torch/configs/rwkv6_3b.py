"""rwkv6-3b "Finch" [ssm, attention-free] (arXiv:2404.05892).

32 layers, d_model=2560, d_ff=8960, vocab=65536; data-dependent decay WKV6
recurrence, head_size 64 -> 40 heads; O(1) decode state.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, kv_heads=40, head_dim=64,
    d_ff=8960, vocab=65536, mlp_kind="gelu",
    source="arXiv:2404.05892 (hf)")
