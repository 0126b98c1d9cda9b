"""Mamba-style selective SSM head of the hymba hybrid block (port of
``repro.nn.ssm``; arXiv:2411.13676).

Diagonal selective state space, per channel ``d`` and state index ``n``::

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t      h: [d, N]
    y_t = h_t @ C_t + D * x_t

with input-dependent ``dt``, ``B`` and ``C`` after a causal depthwise
convolution and a SiLU.  The recurrence runs step by step in f32, one
step a position, as the reference's ``lax.scan`` does (no closed form:
that would round otherwise).  Decode carries ``h`` [B, d, N] (f32) and the
convolution's last ``K - 1`` inputs ``cwin`` [B, K-1, d], so a token costs
O(1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .linear import Dense

__all__ = ["SSM", "ssm_init_state"]


def ssm_init_state(batch: int, d: int, state: int, conv: int, *,
                   dtype=torch.float32, device=None) -> dict:
    """Zero ``{"h": [batch, d, state] f32, "cwin": [batch, conv-1, d]}``."""
    return {"h": torch.zeros((batch, d, state), dtype=torch.float32,
                             device=device),
            "cwin": torch.zeros((batch, conv - 1, d), dtype=dtype,
                                device=device)}


class SSM(nn.Module):
    """``conv`` [K, d], ``wbc`` d -> 2N, ``wdt1`` d -> d/16, ``wdt2``
    d/16 -> d (with bias), ``A_log`` [d, N] and ``D`` [d] (both f32)."""

    def __init__(self, d: int, *, state: int = 16, conv: int = 4,
                 dt_rank: int | None = None, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        dt_rank = dt_rank or max(1, d // 16)
        kw = dict(generator=generator, device=device, dtype=dtype)
        c = torch.randn((conv, d), generator=generator, device=device,
                        dtype=torch.float32) / math.sqrt(conv)
        self.conv = nn.Parameter(c.to(dtype))
        self.wbc = Dense(d, 2 * state, bias=False, **kw)
        self.wdt1 = Dense(d, dt_rank, bias=False, **kw)
        self.wdt2 = Dense(dt_rank, d, bias=True, **kw)
        a = torch.log(torch.arange(1, state + 1, dtype=torch.float32,
                                   device=device))
        self.A_log = nn.Parameter(a[None, :].repeat(d, 1))
        self.D = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                         device=device))

    def _conv(self, x, cwin):
        """Depthwise causal conv of x [B, T, d]; returns (y, last K-1
        inputs)."""
        K = self.conv.shape[0]
        pad = (torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device) if cwin is None else cwin)
        xp = torch.cat([pad, x], dim=1)
        T = x.shape[1]
        y = 0
        for i in range(K):
            y = y + xp[:, i:i + T] * self.conv[i]
        return y, (xp[:, -(K - 1):] if K > 1 else pad)

    def forward(self, x: torch.Tensor, *, state: dict | None = None):
        """x [B, T, d] -> (y [B, T, d], new state or None)."""
        N = self.A_log.shape[1]
        xc, cwin = self._conv(x, None if state is None else state["cwin"])
        xc = F.silu(xc)
        bc = self.wbc(xc).float()
        Bt, Ct = bc[..., :N], bc[..., N:]
        dt = F.softplus(self.wdt2(self.wdt1(xc)).float())        # [B,T,d]
        A = -torch.exp(self.A_log)                                # [d,N]
        decay = torch.exp(dt[..., None] * A)                      # [B,T,d,N]
        inp = (dt * xc.float())[..., None] * Bt[..., None, :]
        h = (torch.zeros(decay.shape[:1] + decay.shape[2:],
                         dtype=torch.float32, device=x.device)
             if state is None else state["h"])
        ys = []
        for t in range(x.shape[1]):
            h = decay[:, t] * h + inp[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, Ct[:, t]))
        y = torch.stack(ys, dim=1).to(x.dtype) + xc * self.D.to(x.dtype)
        return y, (None if state is None else {"h": h, "cwin": cwin})
