"""Rotary position embeddings (port of ``repro.nn.rope``).

The half-split rotation: the first and second halves of the head dim are
the two coordinates of each rotated pair (not interleaved), computed in
f32 and cast back.  Qwen2-VL's M-RoPE (``mrope_freqs``) waits for the VLM
slice.
"""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0):
    """cos/sin tables of shape [..., seq, head_dim/2] (f32)."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by tables [..., seq, hd/2]."""
    half = x.shape[-1] // 2
    c = cos[..., None, :].to(torch.float32)
    s = sin[..., None, :].to(torch.float32)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)
