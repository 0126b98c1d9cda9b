"""Neural-network building blocks of the DT mapper and the LM substrate
(port of ``repro.nn``), the RWKV6 block among them."""
from .linear import Dense, Embedding
from .norms import LayerNorm, RMSNorm
from .rope import apply_rope, rope_freqs
from .attention import MHA, attend, init_kv_cache
from .transformer import MLP, Block, make_norm
from .rwkv import RWKVBlock

__all__ = ["Dense", "Embedding", "LayerNorm", "RMSNorm", "apply_rope",
           "rope_freqs", "MHA", "attend", "init_kv_cache", "MLP", "Block",
           "make_norm", "RWKVBlock"]
