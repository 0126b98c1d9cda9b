"""Pre-norm transformer block with a GELU MLP (port of the parts of
``repro.nn.transformer`` the DT mapper uses).

``jax.nn.gelu`` is the tanh approximation, so the MLP uses
``F.gelu(..., approximate="tanh")``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import MHA
from .linear import Dense
from .norms import LayerNorm

__all__ = ["MLP", "Block"]


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.up = Dense(d, d_ff, bias=True, **kw)
        self.down = Dense(d_ff, d, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class Block(nn.Module):
    """``x + attn(ln1(x))``, then ``+ mlp(ln2(x))``."""

    def __init__(self, d_model: int, *, n_heads: int, head_dim: int,
                 d_ff: int, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.attn = MHA(d_model, n_heads=n_heads, head_dim=head_dim, **kw)
        self.ln2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.mlp = MLP(d_model, d_ff, **kw)

    def forward(self, x: torch.Tensor, *, cache: dict | None = None):
        """Returns ``(x, cache)``."""
        h, cache = self.attn(self.ln1(x), cache=cache)
        x = x + h
        x = x + self.mlp(self.ln2(x))
        return x, cache
