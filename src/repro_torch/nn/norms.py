"""LayerNorm and RMSNorm, computed in f32 and cast back (port of
``repro.nn.norms``)."""
from __future__ import annotations

import torch
from torch import nn

from ..runtime import obs

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * g + b`` over the last axis."""

    def __init__(self, d: int, *, eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, g=None, b=None) -> torch.Tensor:
        """``g``, ``b`` stand in for the gains (a tensor-parallel caller
        passes them through ``distributed.tp.copy_to_tp``)."""
        g = self.g if g is None else g
        b = self.b if b is None else b
        with obs.span("nn/norms"):
            xf = x.to(torch.float32)
            mu = xf.mean(-1, keepdim=True)
            var = torch.square(xf - mu).mean(-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + self.eps)
            return (y * g.to(torch.float32)
                    + b.to(torch.float32)).to(x.dtype)


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * g`` over the last axis."""

    def __init__(self, d: int, *, eps: float = 1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, g=None) -> torch.Tensor:
        """``g`` stands in for the gain, as in :class:`LayerNorm`."""
        g = self.g if g is None else g
        with obs.span("nn/norms"):
            xf = x.to(torch.float32)
            y = xf * torch.rsqrt(torch.square(xf).mean(-1, keepdim=True)
                                 + self.eps)
            return (y * g.to(torch.float32)).to(x.dtype)
