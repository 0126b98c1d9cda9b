"""Masked softmax attention in plain PyTorch, in f32: the masking rule that
the attention kernels' plain twins and ``nn.attention``'s dense route
share (port of the reference's ``impl="xla"`` math).

Query ``i`` (global ``i + q_offset``) sees key ``j`` iff ``j <= i +
q_offset`` (causal), ``i + q_offset - j < window`` (window > 0) and ``j <
kv_len`` (when given).  GQA is a grouped einsum: q-head ``h`` reads
kv-head ``h // G`` with ``G = Hq // Hkv``, and K/V are never repeated.

:func:`attend_stats` is the same attention over one shard of the keys
(``q_offset`` may then be negative: the keys are global positions from the
shard's first), with each row's log-sum-exp beside its output, for the
sequence-parallel merge (``distributed.tp.merge_partials``); a row that
sees no key of the shard gives 0 and -inf.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attend_dense", "attend_chunked", "attend_stats",
           "visible_mask", "NEG_INF"]

NEG_INF = -1e30


def visible_mask(rows, T: int, *, causal: bool, window: int,
                 kv_len: int | None) -> torch.Tensor:
    """[len(rows), T] bool: global query position ``i`` (in ``rows``) sees
    key ``j`` iff ``j <= i`` (causal), ``i - j < window`` (window > 0) and
    ``j < kv_len`` (when given)."""
    i = rows[:, None]
    j = torch.arange(T, device=rows.device)[None, :]
    ok = torch.ones((rows.shape[0], T), dtype=torch.bool, device=rows.device)
    if causal:
        ok = ok & (j <= i)
    if window > 0:
        ok = ok & ((i - j) < window)
    if kv_len is not None:
        ok = ok & (j < kv_len)
    return ok


def _grouped_scores(q, k):
    """q [B,S,Hq,hd], k [B,T,Hkv,hd] -> scores [B,Hkv,G,S,T] (f32)."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, hd)
    return torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) \
        / math.sqrt(hd)


def _grouped_out(probs, v):
    """probs [B,Hkv,G,S,T], v [B,T,Hkv,hd] -> [B,S,Hq*hd] (f32)."""
    B, Hkv, G, S, T = probs.shape
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, Hkv * G * v.shape[-1])


def attend_dense(q, k, v, *, causal: bool = True, window: int = -1,
                 q_offset: int = 0, kv_len: int | None = None):
    """q [B,S,Hq,hd] over k/v [B,T,Hkv,hd] -> [B,S,Hq*hd] in q's type, all
    query rows at once (the score matrix is held whole)."""
    S, T = q.shape[1], k.shape[1]
    rows = torch.arange(S, device=q.device) + q_offset
    ok = visible_mask(rows, T, causal=causal, window=window, kv_len=kv_len)
    scores = torch.where(ok, _grouped_scores(q, k), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, v).to(q.dtype)


def attend_chunked(q, k, v, *, causal: bool = True, window: int = -1,
                   q_offset: int = 0, kv_len: int | None = None,
                   q_chunk: int):
    """:func:`attend_dense` over query blocks of ``q_chunk`` rows, so the
    S x T score matrix is never held whole (peak ~ q_chunk x T per
    (kv-head, group))."""
    S, T = q.shape[1], k.shape[1]
    outs = []
    for c0 in range(0, S, q_chunk):
        qi = q[:, c0:c0 + q_chunk]
        rows = torch.arange(c0, c0 + qi.shape[1], device=q.device) + q_offset
        ok = visible_mask(rows, T, causal=causal, window=window,
                          kv_len=kv_len)
        s = torch.where(ok, _grouped_scores(qi, k), NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        outs.append(_grouped_out(p / torch.clamp_min(l, 1e-30), v))
    return torch.cat(outs, dim=1).to(q.dtype)


def attend_stats(q, k, v, *, causal: bool = True, window: int = -1,
                 q_offset: int = 0, kv_len: int | None = None,
                 q_chunk: int = 512):
    """``(out [B,S,Hq,hd] f32, lse [B,S,Hq] f32)``: q [B,S,Hq,hd] over
    k/v [B,T,Hkv,hd] under :func:`visible_mask`'s rule, over query blocks
    of ``q_chunk`` rows; a row that sees no key gives 0 and -inf."""
    B, S, Hq, hd = q.shape
    T = k.shape[1]
    outs, lses = [], []
    for c0 in range(0, S, q_chunk):
        qi = q[:, c0:c0 + q_chunk]
        rows = torch.arange(c0, c0 + qi.shape[1], device=q.device) + q_offset
        ok = visible_mask(rows, T, causal=causal, window=window,
                          kv_len=kv_len)
        s = torch.where(ok, _grouped_scores(qi, k), float("-inf"))
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = _grouped_out(p / torch.clamp_min(l, 1e-30), v)
        outs.append(o.reshape(B, -1, Hq, hd))
        lse = (m + torch.log(l))[..., 0]              # [B,Hkv,G,s]
        lses.append(lse.permute(0, 3, 1, 2).reshape(B, -1, Hq))
    return torch.cat(outs, 1), torch.cat(lses, 1)
