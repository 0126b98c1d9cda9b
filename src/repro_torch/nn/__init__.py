"""Neural-network building blocks of the DT mapper and the LM substrate
(port of ``repro.nn``)."""
from .linear import Dense, Embedding
from .norms import LayerNorm, RMSNorm
from .rope import apply_rope, rope_freqs
from .attention import MHA, attend, init_kv_cache
from .transformer import MLP, Block, make_norm

__all__ = ["Dense", "Embedding", "LayerNorm", "RMSNorm", "apply_rope",
           "rope_freqs", "MHA", "attend", "init_kv_cache", "MLP", "Block",
           "make_norm"]
