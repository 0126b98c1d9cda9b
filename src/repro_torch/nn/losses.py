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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["vocab_parallel_ce", "fused_linear_ce", "CHUNK"]

CHUNK = 512


def _lse_and_label(logits: torch.Tensor, labels: torch.Tensor):
    """(log-sum-exp, label logit) over the last axis of f32 ``logits``; a
    label outside the vocabulary picks 0."""
    V = logits.shape[-1]
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    hit = (labels >= 0) & (labels < V)
    ll = logits.gather(-1, labels.clamp(0, V - 1)[..., None].long())[..., 0]
    return lse, torch.where(hit, ll, torch.zeros_like(ll))


def vocab_parallel_ce(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE of logits [B, S, V] against labels [B, S]."""
    lse, ll = _lse_and_label(logits.float(), labels)
    return (lse - ll).mean()


def _piece(xi: torch.Tensor, w: torch.Tensor, li: torch.Tensor):
    lse, ll = _lse_and_label((xi @ w).float(), li)
    return ((lse - ll) * (li >= 0).float()).sum()


def fused_linear_ce(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    *, chunk: int = CHUNK) -> torch.Tensor:
    """Mean CE of ``x @ w`` (x [B, S, d] final hidden states, w [d, V]
    head weights: ``emb.T`` when tied) against labels [B, S], chunked over
    the sequence when ``S > chunk``."""
    B, S, d = x.shape
    if S <= chunk:
        return vocab_parallel_ce((x @ w).float(), labels)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + checkpoint(_piece, x[:, sl], w, labels[:, sl],
                               use_reentrant=False)
    return tot / (B * S)
