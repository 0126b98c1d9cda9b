"""Multi-head attention with a KV cache: the dense path of the reference.

Port of the parts of ``repro.nn.attention`` the DT mapper uses: the dense
``attend`` with ``q_offset``/``kv_len`` masking and a KV cache with one
write index ``idx`` shared by every row.  The cache is updated in place
and its index is a Python int, so a decode step makes no host sync.  The
chunked path, GQA with ``kv_heads < n_heads``, RoPE and qk-norm belong to
the LM substrate and are not ported here.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .linear import Dense

__all__ = ["MHA", "attend", "init_kv_cache"]

NEG_INF = -1e30


def init_kv_cache(batch: int, max_len: int, kv_heads: int, head_dim: int, *,
                  dtype=torch.float32, device=None) -> dict:
    """``{"k", "v"}`` [batch, max_len, kv_heads, head_dim] zeros and the
    shared write index ``idx`` (a Python int)."""
    shape = (batch, max_len, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": 0}


def attend(q, k, v, *, q_offset: int = 0,
           kv_len: int | None = None) -> torch.Tensor:
    """Dense causal attention: q [B,S,H,hd], k/v [B,T,H,hd] -> [B,S,H*hd].

    Query ``i`` (global ``i + q_offset``) sees key ``j`` iff ``j <= i +
    q_offset`` and ``j < kv_len`` (when given)."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    i = torch.arange(S, device=q.device)[:, None] + q_offset
    j = torch.arange(T, device=q.device)[None, :]
    ok = j <= i
    if kv_len is not None:
        ok = ok & (j < kv_len)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        / math.sqrt(hd)
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.reshape(B, S, H * hd).to(q.dtype)


class MHA(nn.Module):
    """Causal self-attention with ``n_heads`` heads (no biases), optionally
    over a KV cache."""

    def __init__(self, d_model: int, *, n_heads: int, head_dim: int,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        kw = dict(bias=False, generator=generator, device=device, dtype=dtype)
        self.q = Dense(d_model, n_heads * head_dim, **kw)
        self.k = Dense(d_model, n_heads * head_dim, **kw)
        self.v = Dense(d_model, n_heads * head_dim, **kw)
        self.o = Dense(n_heads * head_dim, d_model, **kw)

    def forward(self, x: torch.Tensor, *, cache: dict | None = None):
        """Returns ``(out, cache)``; with ``cache``, ``x`` holds the new
        tokens, which are written at ``cache["idx"]``."""
        B, S, _ = x.shape
        H, hd = self.n_heads, self.head_dim
        q = self.q(x).reshape(B, S, H, hd)
        k = self.k(x).reshape(B, S, H, hd)
        v = self.v(x).reshape(B, S, H, hd)
        q_offset, kv_len = 0, None
        if cache is not None:
            idx = cache["idx"]
            cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
            cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
            cache["idx"] = idx + S
            k, v = cache["k"], cache["v"]
            q_offset, kv_len = idx, idx + S
        out = attend(q, k, v, q_offset=q_offset, kv_len=kv_len)
        return self.o(out), cache
