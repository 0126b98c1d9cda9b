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

Under tensor parallelism (``distributed.tp``) the routing runs whole on
every rank (the batch is not split over 'model', so the kept and dropped
pairs and the aux loss's shares are one device's, and no second sum is
needed).  Then:

- expert parallelism (the plan's rule when ``n_experts % tp == 0``): a
  rank holds ``E / tp`` experts and serves ``ceil(B / tp)`` rows of the
  batch (zero rows past B); it dispatches its rows' slots of every expert
  (``tp.tp_select`` of the rows, whose backward all-reduces), an
  all-to-all over 'model' sends each expert's slots to the rank that
  holds it and a second brings the outputs back, the rank combines its
  rows in expert-id order, and the rows are all-gathered;
- expert-TP (``moe_tp``, when ``E % tp != 0``, grok1 at tp 16): a rank
  holds each expert's ``d_ff / tp`` columns of gate and up and rows of
  down, column- and row-parallel as the dense MLP.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp
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
        self.d_ff = d_ff

    @property
    def n_experts(self) -> int:
        """The global expert count (the router's width; a rank holds
        ``gate.shape[0]`` of them under expert parallelism)."""
        return self.router.w.shape[1]


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
    of the ambient ``distributed.tp.Parallel``'s data axes (``launch.
    steps`` runs every step under one), else ``(counts, 1)``.

    Each rank then takes ``E * sum(me_r * ce)``: its own mean router
    probability ``me_r`` (which carries the gradient) against the global
    share ``ce``.  The ranks' mean of that is the aux loss over the
    global batch, and so is the mean of their gradients, since ``ce``
    carries none: one integer all-reduce, no differentiable collective.
    """
    par = tp.current()
    if par is None or par.dp.size == 1:
        return counts, 1
    import torch.distributed as dist
    dist.all_reduce(counts, group=par.dp.group)
    return counts, par.dp.size


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
    """x [B, S, d] -> (out [B, S, d] in x's type, aux loss f32 scalar);
    sharded over 'model' as the module docstring says."""
    B, S, d = x.shape
    E, SK = p.n_experts, S * top_k
    ax = tp.tp_axis()
    ep = ax is not None and p.gate.shape[0] != E
    r = moe_route(p, x, top_k=top_k, capacity_factor=capacity_factor)
    C = r.C
    # dispatch: slot c of expert e <- sorted pair start_e + c, if any
    c = torch.arange(C, device=x.device)
    at = r.start[:, :, None] + c                              # [B, E, C]
    filled = c < r.count[:, :, None]
    src = torch.div(r.order, top_k, rounding_mode="floor")    # pair -> token
    tok = src.gather(1, at.reshape(B, E * C).clamp(max=SK - 1))
    # combine: token s's choices, in expert-id order (the sorted order)
    inv = torch.argsort(r.order, dim=-1)                      # pair -> sorted
    jj = torch.sort(inv.reshape(B, S, top_k), dim=-1).values  # [B, S, k]
    flat = jj.reshape(B, SK)
    se = r.idx.reshape(B, SK).gather(1, r.order).gather(1, flat)
    pos = flat - r.start.gather(1, se)
    slot = se * C + torch.clamp_max(pos, C - 1)
    wt = r.w.reshape(B, SK).to(x.dtype).gather(1, r.order).gather(1, flat)
    wt = wt * r.keep.gather(1, flat).to(x.dtype)
    if ep:
        return _apply_ep(p, x, ax, tok, filled, slot, wt, C, top_k), r.aux
    rows = torch.arange(B, device=x.device)[:, None]
    xe = take_rows(x.reshape(B * S, d), rows * S + tok).reshape(
        B, E, C, d) * filled[..., None].to(x.dtype)
    ye = _experts(p, xe, ax if ax is not None
                  and p.gate.shape[2] != p.d_ff else None).reshape(
        B, E * C, d)
    return _combine(ye, rows, slot, wt, E * C, S, top_k), r.aux


def _experts(p: MoE, xe: torch.Tensor, ax) -> torch.Tensor:
    """SwiGLU of each expert's slots xe [..., E, C, d]; with ``ax`` (the
    expert-TP layout) column- then row-parallel over 'model'."""
    xe = tp.copy_to_tp(xe, ax)
    h = F.silu(torch.einsum("...ecd,edf->...ecf", xe, p.gate)) \
        * torch.einsum("...ecd,edf->...ecf", xe, p.up)
    return tp.reduce_from_tp(torch.einsum("...ecf,efd->...ecd", h, p.down),
                             ax)


def _combine(ye, rows, slot, wt, EC: int, S: int, top_k: int):
    """Each token's ``top_k`` expert outputs out of ye [b, E*C, d],
    weighted, summed one at a time in expert-id order -> [b, S, d]."""
    b, d = ye.shape[0], ye.shape[-1]
    contrib = take_rows(ye.reshape(b * EC, d), rows * EC + slot) \
        * wt[..., None]
    contrib = contrib.reshape(b, S, top_k, d)
    out = contrib[:, :, 0]
    for i in range(1, top_k):
        out = out + contrib[:, :, i]
    return out


def _apply_ep(p: MoE, x, ax, tok, filled, slot, wt, C: int, top_k: int):
    """The expert-parallel layer: this rank's ``ceil(B / tp)`` rows
    dispatched to every expert, two all-to-alls over 'model' around the
    rank's ``E / tp`` experts, its rows combined, the rows all-gathered."""
    B, S, d = x.shape
    E, El, t = p.n_experts, p.gate.shape[0], ax.size
    Bl = -(-B // t)
    pad = Bl * t - B
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        tok, slot = F.pad(tok, (0, 0, 0, pad)), F.pad(slot, (0, 0, 0, pad))
        filled = F.pad(filled, (0, 0, 0, 0, 0, pad))
        wt = F.pad(wt, (0, 0, 0, pad))
    mine = list(range(ax.rank * Bl, (ax.rank + 1) * Bl))
    lo = ax.rank * Bl
    xr = tp.tp_select(x, ax, 0, mine, "ep")
    rows = torch.arange(Bl, device=x.device)[:, None]
    xe = take_rows(xr.reshape(Bl * S, d), rows * S + tok[lo:lo + Bl]) \
        .reshape(Bl, E, C, d) * filled[lo:lo + Bl, ..., None].to(x.dtype)
    send = xe.reshape(Bl, t, El, C, d).transpose(0, 1)     # [t, Bl, El..]
    got = tp.all_to_all_tp(send, ax)                        # [src, Bl, El..]
    back = tp.all_to_all_tp(_experts(p, got, None), ax)     # [owner, Bl..]
    ye = back.transpose(0, 1).reshape(Bl, E * C, d)
    out = _combine(ye, rows, slot[lo:lo + Bl], tp.tp_select(
        wt, ax, 0, mine, "ep"), E * C, S, top_k)
    return tp.gather_from_tp(out, ax, 0, "ep")[:B]
