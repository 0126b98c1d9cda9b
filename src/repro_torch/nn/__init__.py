"""Neural-network building blocks of the DT mapper (port of ``repro.nn``)."""
from .linear import Dense, Embedding
from .norms import LayerNorm
from .attention import MHA, attend, init_kv_cache
from .transformer import MLP, Block

__all__ = ["Dense", "Embedding", "LayerNorm", "MHA", "attend",
           "init_kv_cache", "MLP", "Block"]
