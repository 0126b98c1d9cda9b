"""Next-token cross-entropy (port of ``repro.nn.losses``).

``vocab_parallel_ce`` is the log-sum-exp form of the reference: the
row maximum (held out of the gradient), ``log(sum(exp(l - m))) + m`` in
f32, minus the label's logit.  A label outside ``[0, V)`` (the pad label
-1) picks no logit, as the reference's one-hot picks none; this form does
not mask it, as the reference's does not.

``fused_linear_ce`` projects the final hidden states through the head in
chunks of ``chunk`` positions, so ``[B, S, V]`` logits are never held
whole.  Past one chunk the sequence is padded with zero rows labelled -1,
each chunk sums its masked CE (labels -1 add nothing) and runs under
``torch.utils.checkpoint``, so a backward pass recomputes a chunk's logits
instead of keeping them; the total is divided by ``B * S`` (the unpadded
length), as the reference divides.

Vocab-parallel (``distributed.tp``): given the global ``vocab`` and a
head (or logits) holding a rank's contiguous share of it, the row maximum
is all-reduced with MAX, and the exp-sum and the label's logit (read by
the rank that holds the label, 0 elsewhere) are all-reduced with SUM in
one collective; the hidden states enter the product through
``tp.copy_to_tp``.  The padded rows of ``vocab_padded`` are logits like
any other, as on one device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed import tp

__all__ = ["vocab_parallel_ce", "fused_linear_ce", "CHUNK"]

CHUNK = 512


def _shard(V: int, vocab: int | None):
    """``(axis, first row)`` of a rank's vocab share of ``V`` columns, or
    ``(None, 0)`` when they are the whole vocabulary."""
    ax = tp.vocab_axis(V, V if vocab is None else vocab)
    return ax, 0 if ax is None else ax.rank * V


def _lse_and_label(logits: torch.Tensor, labels: torch.Tensor,
                   vocab: int | None = None):
    """(log-sum-exp, label logit) over the last axis of f32 ``logits`` (a
    rank's vocab share when ``vocab`` is above it); a label outside the
    vocabulary picks 0."""
    V = logits.shape[-1]
    ax, lo = _shard(V, vocab)
    m = logits.amax(-1, keepdim=True).detach()
    if ax is not None:
        m = tp.all_reduce(m, ax, op="max")
    se = torch.exp(logits - m).sum(-1)
    local = labels - lo
    hit = (local >= 0) & (local < V)
    ll = logits.gather(-1, local.clamp(0, V - 1)[..., None].long())[..., 0]
    ll = torch.where(hit, ll, torch.zeros_like(ll))
    if ax is not None:
        se, ll = tp.reduce_from_tp(torch.stack([se, ll]), ax).unbind(0)
    return torch.log(se) + m[..., 0], ll


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, *,
                      vocab: int | None = None) -> torch.Tensor:
    """Mean next-token CE of logits [B, S, V] (a rank's share of
    ``vocab`` under tensor parallelism) against labels [B, S]."""
    lse, ll = _lse_and_label(logits.float(), labels, vocab)
    return (lse - ll).mean()


def _piece(xi: torch.Tensor, w: torch.Tensor, li: torch.Tensor,
           vocab: int | None = None):
    lse, ll = _lse_and_label((xi @ w).float(), li, vocab)
    return ((lse - ll) * (li >= 0).float()).sum()


def fused_linear_ce(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    *, chunk: int = CHUNK,
                    vocab: int | None = None) -> torch.Tensor:
    """Mean CE of ``x @ w`` (x [B, S, d] final hidden states, w [d, V]
    head weights: ``emb.T`` when tied) against labels [B, S], chunked over
    the sequence when ``S > chunk``; ``vocab`` the global vocabulary, of
    which ``w`` may hold a rank's share."""
    B, S, d = x.shape
    ax, _ = _shard(w.shape[-1], vocab)
    x = tp.copy_to_tp(x, ax)
    if S <= chunk:
        return vocab_parallel_ce((x @ w).float(), labels, vocab=vocab)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + checkpoint(_piece, x[:, sl], w, labels[:, sl], vocab,
                               use_reentrant=False)
    return tot / (B * S)
