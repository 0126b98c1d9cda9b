"""Top-k token-choice mixture of experts with capacity (port of
``repro.nn.moe``; GShard/Switch semantics).

The router runs in f32: softmax over the experts, the top k, their weights
renormalised to sum to one, and the Switch load-balancing loss ``E *
sum_e (share of routed slots to e) * (mean router probability of e)``,
the shares taken over the global batch under a data-parallel train step
(:func:`_data_parallel_sum`).

Dispatch is grouped per sequence, as in the reference: within a row of the
batch the ``S * k`` (token, choice) pairs are sorted by expert id with a
**stable** sort (so, within an expert, in token order), each pair's
position in its expert's segment is its slot, and pairs at positions past
the capacity ``C = max(1, int(S * k / E * capacity_factor))`` are
dropped.  :func:`moe_route` returns these integer results (``idx``,
``keep``, ``C``) so that they can be held equal to the reference's.

Both data movements are gathers (``linear.take_rows``, whose backward
is the same bits on every run), so the layer is deterministic, its
gradients included:

- dispatch: slot ``c`` of expert ``e`` reads the pair at sorted position
  ``start_e + c`` when ``c`` is below the expert's count, else holds
  zeros; only kept pairs are placed, each slot once;
- combine: each token gathers its ``k`` expert outputs through the
  inverse of the sort, weighted by its routing weight (0 when dropped),
  and sums them one at a time in expert-id order, the order in which the
  reference's scatter-add meets them.

The experts are SwiGLU, run as batched products over ``[B, E, C, d]``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .linear import Dense, take_rows

__all__ = ["MoE", "Route", "moe_route", "moe_apply", "capacity"]


class MoE(nn.Module):
    """Router ``router.w`` [d, E] (always f32) and stacked expert weights
    ``gate``, ``up`` [E, d, d_ff] and ``down`` [E, d_ff, d]."""

    def __init__(self, d: int, d_ff: int, n_experts: int, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.router = Dense(d, n_experts, bias=False, generator=generator,
                            device=device, dtype=torch.float32)

        def draw(*shape, fan_in):
            w = torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) / math.sqrt(fan_in)
            return nn.Parameter(w.to(dtype))

        self.gate = draw(n_experts, d, d_ff, fan_in=d)
        self.up = draw(n_experts, d, d_ff, fan_in=d)
        self.down = draw(n_experts, d_ff, d, fan_in=d_ff)

    @property
    def n_experts(self) -> int:
        return self.gate.shape[0]


class Route(NamedTuple):
    """A grouped routing: ``w``, ``idx`` [B, S, k] (weights in f32, expert
    ids), ``aux`` (f32 scalar), ``C`` (capacity per expert and row),
    ``order`` [B, S*k] (the stable sort of the flattened ids), ``start``,
    ``count`` [B, E] (each expert's segment in the sorted order) and
    ``keep`` [B, S*k] (sorted pair within capacity)."""

    w: torch.Tensor
    idx: torch.Tensor
    aux: torch.Tensor
    C: int
    order: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    keep: torch.Tensor


def capacity(S: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and row, computed as the reference computes it."""
    return max(1, int(S * top_k / n_experts * capacity_factor))


def _data_parallel_sum(counts: torch.Tensor):
    """``(counts summed over the data ranks, their number)``: the ranks
    of the ambient mesh's 'data' axis (``launch.steps`` runs the train
    step's loss under ``mesh_ctx``), else ``(counts, 1)``.

    Each rank then takes ``E * sum(me_r * ce)``: its own mean router
    probability ``me_r`` (which carries the gradient) against the global
    share ``ce``.  The ranks' mean of that is the aux loss over the
    global batch, and so is the mean of their gradients, since ``ce``
    carries none: one integer all-reduce, no differentiable collective.
    """
    from ..distributed.sharding import ambient_mesh
    from ..launch.mesh import axis_sizes
    mesh = ambient_mesh()
    if mesh is None or not hasattr(mesh, "get_group") \
            or axis_sizes(mesh).get("data", 1) == 1:
        return counts, 1
    import torch.distributed as dist
    dp = mesh["data"]
    dist.all_reduce(counts, group=dp.get_group())
    return counts, dp.size()


def moe_route(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25) -> Route:
    """Route x [B, S, d] to ``top_k`` of ``p``'s experts."""
    B, S, _ = x.shape
    E = p.n_experts
    probs = torch.softmax(x.float() @ p.router.w.float(), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    me = probs.mean((0, 1))
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    counts, ranks = _data_parallel_sum(counts)
    ce = counts.float() / (B * S * top_k * ranks)
    aux = E * torch.sum(me * ce)
    SK = S * top_k
    C = capacity(S, top_k, E, capacity_factor)
    flat_e = idx.reshape(B, SK)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    start = torch.searchsorted(se, experts)
    count = torch.searchsorted(se, experts, right=True) - start
    pos = torch.arange(SK, device=x.device) - start.gather(1, se)
    return Route(w, idx, aux, C, order, start, count, pos < C)


def moe_apply(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25):
    """x [B, S, d] -> (out [B, S, d] in x's type, aux loss f32 scalar)."""
    B, S, d = x.shape
    E, SK = p.n_experts, S * top_k
    r = moe_route(p, x, top_k=top_k, capacity_factor=capacity_factor)
    C = r.C
    # dispatch: slot c of expert e <- sorted pair start_e + c, if any
    c = torch.arange(C, device=x.device)
    at = r.start[:, :, None] + c                              # [B, E, C]
    filled = c < r.count[:, :, None]
    src = torch.div(r.order, top_k, rounding_mode="floor")    # pair -> token
    tok = src.gather(1, at.reshape(B, E * C).clamp(max=SK - 1))
    rows = torch.arange(B, device=x.device)[:, None]
    xe = take_rows(x.reshape(B * S, d), rows * S + tok).reshape(
        B, E, C, d) * filled[..., None].to(x.dtype)
    h = F.silu(torch.einsum("becd,edf->becf", xe, p.gate)) \
        * torch.einsum("becd,edf->becf", xe, p.up)
    ye = torch.einsum("becf,efd->becd", h, p.down).reshape(B, E * C, d)
    # combine: token s's choices, in expert-id order (the sorted order)
    inv = torch.argsort(r.order, dim=-1)                      # pair -> sorted
    jj = torch.sort(inv.reshape(B, S, top_k), dim=-1).values  # [B, S, k]
    flat = jj.reshape(B, SK)
    se = r.idx.reshape(B, SK).gather(1, r.order).gather(1, flat)
    pos = flat - r.start.gather(1, se)
    slot = se * C + torch.clamp_max(pos, C - 1)
    wt = r.w.reshape(B, SK).to(x.dtype).gather(1, r.order).gather(1, flat)
    wt = wt * r.keep.gather(1, flat).to(x.dtype)
    contrib = take_rows(ye.reshape(B * E * C, d), rows * (E * C) + slot) \
        * wt[..., None]
    contrib = contrib.reshape(B, S, top_k, d)
    out = contrib[:, :, 0]
    for i in range(1, top_k):
        out = out + contrib[:, :, i]
    return out, r.aux
