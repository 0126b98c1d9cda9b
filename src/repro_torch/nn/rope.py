"""Rotary position embeddings (port of ``repro.nn.rope``).

The half-split rotation: the first and second halves of the head dim are
the two coordinates of each rotated pair (not interleaved), computed in
f32 and cast back.  Qwen2-VL's M-RoPE (arXiv:2409.12191, ``mrope_freqs``)
splits the half head dim into three sections rotated by the temporal,
height and width position ids; for text all three ids coincide, and the
tables equal ``rope_freqs``'.
"""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope", "mrope_freqs"]


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0):
    """cos/sin tables of shape [..., seq, head_dim/2] (f32)."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_freqs(pos_thw: torch.Tensor, head_dim: int,
                sections: tuple[int, int, int], theta: float = 10000.0):
    """M-RoPE cos/sin [..., seq, head_dim/2] (f32) from ``pos_thw`` [3,
    ..., seq] (temporal, height, width ids): frequency ``j`` of the half
    head dim takes the ids of the section it falls in (``sections`` sum to
    ``head_dim // 2``)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=pos_thw.device) / half))
    sec = torch.repeat_interleave(
        torch.arange(3, device=pos_thw.device),
        torch.as_tensor(sections, device=pos_thw.device), output_size=half)
    pos = pos_thw.to(torch.float32).movedim(0, -1)          # [..., seq, 3]
    ang = pos[..., sec] * inv                                # [..., seq, half]
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
