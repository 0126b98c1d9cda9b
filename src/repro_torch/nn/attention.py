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
  decode step's single query included.  A call whose q/k and v head dims
  differ goes to ``flash_attention`` where it is uncached and the kernel
  for q's type takes the pair (latent attention's prompt: q/k 192, v 128
  in bf16, ``kernels.flash_attention.HEAD_DIMS``); any other such
  ``"kernel"`` call raises instead of taking the dense math.

Each call counts its route (``runtime.obs``): ``attend.flash_attention``,
``attend.flash_decode``, ``attend.chunked`` or ``attend.dense``, and a
``"kernel"`` call that takes a dense route also ``attend.kernel_fallback``.
``MHA.forward`` runs in an ``nn/attention`` span.

Under tensor parallelism (an ambient ``distributed.tp.Parallel`` with a
'model' axis above 1) a rank holds the plan's shard of q, k, v and o:

- q/o sharded (``n_heads % tp == 0``): the rank's contiguous q-heads; q
  is column-parallel (its input through ``tp.copy_to_tp``), o
  row-parallel (its output through ``tp.reduce_from_tp``), and qk-norm's
  gains through ``copy_to_tp``, since each rank uses them on its own
  heads only;
- k/v sharded too (``kv_heads % tp == 0``): the rank's kv-heads, which
  its q-heads read with the global grouping; else (the plan's veto) K/V
  are whole on every rank and the rank takes the kv-heads its q-heads
  read (``h // G`` on global indices; ``tp.tp_select``, whose backward
  all-reduces), one per q-head where they do not group evenly;
- q/o replicated (``n_heads % tp != 0``): the whole attention on every
  rank, no collective.

A decode cache under a sharded step (``Parallel.seq``) holds every
kv-head of a contiguous share of the positions: rank ``r`` of the
sequence axis holds ``[r * T_l, (r + 1) * T_l)``.  A prefill (write index
0) attends its heads over the prompt's own keys (the dense route, as on
one device) and writes the positions the rank holds, the kv-heads
gathered over 'model'; a later step gathers q over 'model', writes the
new keys on the rank that holds their positions, attends all q-heads over
the rank's keys with their log-sum-exps (``flash_decode(stats=True)`` on
the kernel route, ``attend_stats`` on the dense one and for windowed
layers), merges the ranks' parts (``tp.sp_merge``) and keeps its own
heads for the row-parallel o.
"""
from __future__ import annotations

import torch
from torch import nn

from ..distributed import tp
from ..runtime import obs
from ..kernels import flash_attention as _fa, flash_decode as _fd
from ..kernels.dense_attention import (attend_chunked, attend_dense,
                                       attend_stats)
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
    """Attention of q [B,S,Hq,hd] over k [B,T,Hkv,hd] and v [B,T,Hkv,hv]
    -> [B,S,Hq*hv], scaled by 1/sqrt(hd).

    Query ``i`` (global ``i + q_offset``) sees key ``j`` iff ``j <= i +
    q_offset`` (causal), ``i + q_offset - j < window`` (window > 0) and
    ``j < kv_len`` (when given).  ``impl`` is described in the module
    docstring."""
    if impl not in IMPLS:
        raise ValueError(f"attend: impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        hd, hk, hv = q.shape[-1], k.shape[-1], v.shape[-1]
        pair = (hd == hk and (hd, hv) in _fa.HEAD_DIMS.get(q.dtype, ())
                and kv_len is None and q_offset == 0)
        if not (hd == hk == hv or pair):
            raise ValueError(f"attend: no kernel takes q/k/v head dims "
                             f"{hd}/{hk}/{hv} in {q.dtype} on this call "
                             f"(unequal ones only uncached, at "
                             f"flash_attention.HEAD_DIMS); ask for "
                             f"impl='dense'")
        if kv_len is None and q_offset == 0:
            obs.count("attend.flash_attention")
            return _fa.flash_attention(q, k, v, causal=causal, window=window)
        if (q.shape[1] == 1 and causal and kv_len is not None
                and window == -1):
            obs.count("attend.flash_decode")
            return _fd.flash_decode(q, k, v, min(kv_len, q_offset + 1))
        obs.count("attend.kernel_fallback")
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    if q.shape[1] > q_chunk:
        obs.count("attend.chunked")
        return attend_chunked(q, k, v, q_chunk=q_chunk, **kw)
    obs.count("attend.dense")
    return attend_dense(q, k, v, **kw)


class MHA(nn.Module):
    """Self-attention with ``n_heads`` query heads over ``kv_heads`` K/V
    heads, optionally over a KV cache."""

    def __init__(self, d_model: int, *, n_heads: int, head_dim: int,
                 kv_heads: int | None = None, qkv_bias: bool = False,
                 qk_norm: bool = False, norm_eps: float | None = None,
                 generator=None, device=None, dtype=torch.float32):
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
            nk = dict(device=device, dtype=dtype)
            if norm_eps is not None:
                nk["eps"] = norm_eps
            self.qn = RMSNorm(head_dim, **nk)
            self.kn = RMSNorm(head_dim, **nk)
        else:
            self.qn = self.kn = None

    def forward(self, x: torch.Tensor, *, cos=None, sin=None,
                causal: bool = True, window: int = -1,
                xkv: torch.Tensor | None = None,
                cache: dict | None = None, impl: str = "dense"):
        """Returns ``(out, cache)``; with ``cache``, ``x`` holds the new
        tokens, which are written at ``cache["idx"]``.  With ``xkv`` [B,
        T, d] the layer cross-attends to it (no rope, no cache, not
        causal).  Sharded as the module docstring says."""
        with obs.span("nn/attention"):
            B, S, _ = x.shape
            hd = self.head_dim
            ax = tp.tp_axis()
            Hq, Hkv = self.q.w.shape[1] // hd, self.k.w.shape[1] // hd
            q_sh = ax is not None and Hq != self.n_heads
            kv_sh = ax is not None and Hkv != self.kv_heads
            src = x if xkv is None else xkv
            T = src.shape[1]
            xi = tp.copy_to_tp(x, ax) if q_sh else x
            q = self.q(xi).reshape(B, S, Hq, hd)
            si = (xi if xkv is None else tp.copy_to_tp(src, ax)) if kv_sh \
                else src
            k = self.k(si).reshape(B, T, Hkv, hd)
            v = self.v(si).reshape(B, T, Hkv, hd)
            if self.qn is not None:
                q = self.qn(q, tp.copy_to_tp(self.qn.g, ax) if q_sh else None)
                k = self.kn(k, tp.copy_to_tp(self.kn.g, ax) if kv_sh else None)
            if cos is not None and xkv is None:
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            sel = self._kv_select(ax) if q_sh and not kv_sh else None
            pick = (lambda t: t) if sel is None else \
                (lambda t: tp.tp_select(t, ax, 2, sel))
            seq = getattr(tp.current(), "seq", None)
            if xkv is not None:
                out = attend(q, pick(k), pick(v), causal=False, window=window,
                             impl=impl)
            elif cache is not None and (ax is not None or seq is not None):
                out = self._sharded_cache(q, k, v, pick, cache, ax, seq, q_sh,
                                          kv_sh, causal=causal, window=window,
                                          impl=impl)
            else:
                q_offset, kv_len = 0, None
                if cache is not None:
                    idx = cache["idx"]
                    if idx + S > cache["k"].shape[1]:
                        raise ValueError(f"KV cache of length "
                                         f"{cache['k'].shape[1]} cannot take "
                                         f"{S} tokens at {idx}")
                    cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
                    cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
                    cache["idx"] = idx + S
                    k, v = cache["k"], cache["v"]
                    q_offset, kv_len = idx, idx + S
                out = attend(q, pick(k), pick(v), causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len, impl=impl)
            out = self.o(out)
            return (tp.reduce_from_tp(out, ax) if q_sh else out), cache

    def _kv_select(self, ax) -> list:
        """The kv-heads this rank's q-heads read when K/V are whole, each
        once; the kernels' GQA mapping then holds on local indices, which
        needs the rank's q-heads to group evenly over them (every config
        at a power-of-two 'model' axis does)."""
        hq = self.n_heads // ax.size
        G = self.n_heads // self.kv_heads
        idx = [h // G for h in range(ax.rank * hq, (ax.rank + 1) * hq)]
        uniq = sorted(set(idx))
        if hq % len(uniq) or any(idx.count(u) != hq // len(uniq)
                                 for u in uniq):
            raise ValueError(f"{hq} q-heads a rank do not group evenly "
                             f"over kv-heads {uniq}")
        return uniq

    def _sharded_cache(self, q, k, v, pick, cache, ax, seq, q_sh, kv_sh, *,
                       causal, window, impl):
        """Attention with a cache under a sharded step (module docstring):
        ``q`` [B,S,Hq_l,hd] on this rank's heads, ``k``/``v`` [B,S,Hkv_l,
        hd] (all kv-heads when the plan keeps them whole); returns [B, S,
        Hq_l * hd]."""
        B, S, Hq, hd = q.shape
        idx, Tl = cache["idx"], cache["k"].shape[1]
        off = (seq.rank if seq is not None else 0) * Tl
        span = Tl * (seq.size if seq is not None else 1)
        if idx + S > span:
            raise ValueError(f"KV cache of length {span} cannot take {S} "
                             f"tokens at {idx}")
        kall = tp.gather_from_tp(k, ax, 2, "sp") if kv_sh else k
        vall = tp.gather_from_tp(v, ax, 2, "sp") if kv_sh else v
        lo, hi = max(idx, off), min(idx + S, off + Tl)
        if lo < hi:
            dt = cache["k"].dtype
            cache["k"][:, lo - off:hi - off] = kall[:, lo - idx:hi - idx].to(dt)
            cache["v"][:, lo - off:hi - off] = vall[:, lo - idx:hi - idx].to(dt)
        cache["idx"] = idx + S
        if idx == 0:                   # a prefill: the prompt's own keys
            dt = cache["k"].dtype
            return attend(q, pick(k).to(dt), pick(v).to(dt), causal=causal,
                          window=window, q_offset=0, kv_len=S, impl=impl)
        qall = tp.gather_from_tp(q, ax, 2, "sp") if q_sh else q
        seen = min(max(idx + S - off, 0), Tl)
        ck, cv = cache["k"], cache["v"]
        if impl == "kernel" and S == 1 and causal and window == -1:
            obs.count("attend.flash_decode")
            o, lse = _fd.flash_decode(qall, ck, cv, seen, stats=True)
            o, lse = o.reshape(B, 1, -1, hd), lse[:, None]
        else:
            if impl == "kernel":
                obs.count("attend.kernel_fallback")
            obs.count("attend.dense")
            o, lse = attend_stats(qall, ck, cv, causal=causal, window=window,
                                  q_offset=idx - off, kv_len=seen)
        merged = tp.sp_merge(o, lse, seq)
        if q_sh:
            merged = merged[:, :, ax.rank * Hq:(ax.rank + 1) * Hq]
        return merged.reshape(B, S, Hq * hd).to(q.dtype)
