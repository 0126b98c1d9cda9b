"""Multi-head attention with GQA, qk-norm, sliding windows and a KV cache.

Port of ``repro.nn.attention``:

- GQA through ``kv_heads < n_heads``: q-head ``h`` reads kv-head
  ``h // G`` with ``G = n_heads // kv_heads`` (a grouped einsum, no
  repeated K/V);
- a per-layer sliding window, a Python int (``window <= 0`` is full
  attention);
- optional qk-norm (qwen3: RMSNorm of each head's q and k, before RoPE)
  and QKV bias (qwen1.5);
- a KV cache written in place at one write index ``idx`` shared by every
  row.  ``idx`` is a Python int, so a decode step makes no host sync;
- cross-attention (whisper): with ``xkv`` (the encoder memory) K and V
  come from it on every call, with no rope, no cache append and no causal
  mask, as in the reference.

``impl`` selects the math, as the reference's ``impl`` does:

- ``"dense"`` (the reference's ``"xla"``): masked softmax attention in
  f32 (``kernels.dense_attention``), chunked over query blocks of
  ``q_chunk`` rows for ``S > q_chunk``.
  The DT mapper always runs it, as the reference runs the DT at
  ``impl="xla"``.
- ``"kernel"`` (the reference's ``"pallas"``): an uncached full sequence
  goes to ``kernels.flash_attention``; a single causal token over a cache
  with the full window (``-1``) goes to ``kernels.flash_decode`` with
  ``min(kv_len, q_offset + 1)`` visible keys; anything else (a multi-token
  cache append, such as a prefill, or a windowed single-token decode)
  takes the dense or chunked math.  Uncached cross-attention is a full
  sequence, so it goes to ``flash_attention`` with ``causal=False``, a
  decode step's single query included.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels import flash_attention as _fa, flash_decode as _fd
from ..kernels.dense_attention import attend_chunked, attend_dense
from .linear import Dense
from .norms import RMSNorm
from .rope import apply_rope

__all__ = ["MHA", "attend", "init_kv_cache", "Q_CHUNK", "IMPLS"]

Q_CHUNK = 512
IMPLS = ("dense", "kernel")


def init_kv_cache(batch: int, max_len: int, kv_heads: int, head_dim: int, *,
                  dtype=torch.float32, device=None) -> dict:
    """``{"k", "v"}`` [batch, max_len, kv_heads, head_dim] zeros and the
    shared write index ``idx`` (a Python int)."""
    shape = (batch, max_len, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": 0}


def attend(q, k, v, *, causal: bool = True, window: int = -1,
           q_offset: int = 0, kv_len: int | None = None,
           impl: str = "dense", q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Attention of q [B,S,Hq,hd] over k/v [B,T,Hkv,hd] -> [B,S,Hq*hd].

    Query ``i`` (global ``i + q_offset``) sees key ``j`` iff ``j <= i +
    q_offset`` (causal), ``i + q_offset - j < window`` (window > 0) and
    ``j < kv_len`` (when given).  ``impl`` is described in the module
    docstring."""
    if impl not in IMPLS:
        raise ValueError(f"attend: impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        if kv_len is None and q_offset == 0:
            return _fa.flash_attention(q, k, v, causal=causal, window=window)
        if (q.shape[1] == 1 and causal and kv_len is not None
                and window == -1):
            return _fd.flash_decode(q, k, v, min(kv_len, q_offset + 1))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    if q.shape[1] > q_chunk:
        return attend_chunked(q, k, v, q_chunk=q_chunk, **kw)
    return attend_dense(q, k, v, **kw)


class MHA(nn.Module):
    """Self-attention with ``n_heads`` query heads over ``kv_heads`` K/V
    heads, optionally over a KV cache."""

    def __init__(self, d_model: int, *, n_heads: int, head_dim: int,
                 kv_heads: int | None = None, qkv_bias: bool = False,
                 qk_norm: bool = False, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kv_heads = kv_heads or n_heads
        if n_heads % kv_heads:
            raise ValueError(f"n_heads {n_heads} is not a multiple of "
                             f"kv_heads {kv_heads}")
        self.n_heads, self.kv_heads, self.head_dim = n_heads, kv_heads, \
            head_dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.q = Dense(d_model, n_heads * head_dim, bias=qkv_bias, **kw)
        self.k = Dense(d_model, kv_heads * head_dim, bias=qkv_bias, **kw)
        self.v = Dense(d_model, kv_heads * head_dim, bias=qkv_bias, **kw)
        self.o = Dense(n_heads * head_dim, d_model, bias=False, **kw)
        if qk_norm:
            self.qn = RMSNorm(head_dim, device=device, dtype=dtype)
            self.kn = RMSNorm(head_dim, device=device, dtype=dtype)
        else:
            self.qn = self.kn = None

    def forward(self, x: torch.Tensor, *, cos=None, sin=None,
                causal: bool = True, window: int = -1,
                xkv: torch.Tensor | None = None,
                cache: dict | None = None, impl: str = "dense"):
        """Returns ``(out, cache)``; with ``cache``, ``x`` holds the new
        tokens, which are written at ``cache["idx"]``.  With ``xkv`` [B,
        T, d] the layer cross-attends to it (no rope, no cache, not
        causal)."""
        B, S, _ = x.shape
        Hq, Hkv, hd = self.n_heads, self.kv_heads, self.head_dim
        src = x if xkv is None else xkv
        T = src.shape[1]
        q = self.q(x).reshape(B, S, Hq, hd)
        k = self.k(src).reshape(B, T, Hkv, hd)
        v = self.v(src).reshape(B, T, Hkv, hd)
        if self.qn is not None:
            q, k = self.qn(q), self.kn(k)
        if xkv is not None:
            out = attend(q, k, v, causal=False, window=window, impl=impl)
            return self.o(out), cache
        if cos is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        q_offset, kv_len = 0, None
        if cache is not None:
            idx = cache["idx"]
            if idx + S > cache["k"].shape[1]:
                raise ValueError(f"KV cache of length {cache['k'].shape[1]} "
                                 f"cannot take {S} tokens at {idx}")
            cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
            cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
            cache["idx"] = idx + S
            k, v = cache["k"], cache["v"]
            q_offset, kv_len = idx, idx + S
        out = attend(q, k, v, causal=causal, window=window, q_offset=q_offset,
                     kv_len=kv_len, impl=impl)
        return self.o(out), cache
