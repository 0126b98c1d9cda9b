"""Neural-network building blocks of the DT mapper and the LM substrate
(port of ``repro.nn``): the RWKV6 block, the mixture of experts, the
selective SSM and the losses among them; and the port's own latent
attention (``mla``) and dropless MoE."""
from .linear import Dense, Embedding
from .norms import LayerNorm, RMSNorm
from .rope import apply_rope, mrope_freqs, rope_freqs
from .attention import MHA, attend, init_kv_cache
from .mla import MLA
from .transformer import MLP, Block, make_norm
from .rwkv import RWKVBlock
from .moe import MoE, moe_apply, moe_dropless, moe_route
from .ssm import SSM, ssm_init_state
from .losses import fused_linear_ce, vocab_parallel_ce

__all__ = ["Dense", "Embedding", "LayerNorm", "RMSNorm", "apply_rope",
           "mrope_freqs", "rope_freqs", "MHA", "attend", "init_kv_cache",
           "MLA", "MLP", "Block", "make_norm", "RWKVBlock", "MoE",
           "moe_apply", "moe_dropless", "moe_route", "SSM", "ssm_init_state",
           "fused_linear_ce", "vocab_parallel_ce"]
