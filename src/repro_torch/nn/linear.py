"""Dense and embedding primitives.

Port of ``repro.nn.linear``.  Weights keep the reference's layout,
``w`` [d_in, d_out] applied as ``x @ w`` (not ``nn.Linear``'s transposed
one), so reference checkpoints load without transposes.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["Dense", "Embedding"]


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` [d_in, d_out], drawn N(0, 1/d_in)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 generator: torch.Generator | None = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        w = torch.randn((d_in, d_out), generator=generator, device=device,
                        dtype=torch.float32) / math.sqrt(d_in)
        self.w = nn.Parameter(w.to(dtype))
        self.b = (nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        if self.b is not None:
            y = y + self.b
        return y


class Embedding(nn.Module):
    """Lookup table ``emb`` [vocab, d], drawn N(0, 0.02^2)."""

    def __init__(self, vocab: int, d: int, *,
                 generator: torch.Generator | None = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        e = torch.randn((vocab, d), generator=generator, device=device,
                        dtype=torch.float32) * 0.02
        self.emb = nn.Parameter(e.to(dtype))

    def forward(self, ids) -> torch.Tensor:
        return self.emb[ids]
