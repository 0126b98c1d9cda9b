"""Top-k token-choice mixture of experts with capacity (port of
``repro.nn.moe``; GShard/Switch semantics), and a dropless one with a
sigmoid router and shared experts (DeepSeek-V3, a port-only path).

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

**The dropless path** (a ``router="sigmoid"`` MoE, :func:`moe_dropless`;
DeepSeek-V3's ``noaux_tc`` router with ``n_group = topk_group = 1``):

- router in f32: ``s = sigmoid(x W_r)`` over the experts; the top k of
  ``s + b`` (``b`` the selection bias ``MoE.bias``, which picks but does
  not weigh); weights ``s_i / sum_topk s_j * routed_scale`` from the
  unbiased ``s``;
- the ``B * S * k`` (token, choice) pairs are stably sorted by expert, so
  each expert's pairs form one contiguous segment; the routed SwiGLUs run
  as three grouped products over those segments (``torch._grouped_mm``
  with the segments' ends as ``offs``; no capacity, no padding, no loop
  over experts), and no pair is dropped;
- combine: the outputs are put back in (token, choice) order through the
  sort's permutation, and each token sums its ``k`` weighted, in f32 (one
  batched product); the shared
  expert (one SwiGLU of ``n_shared * d_ff`` over every token) is added in
  the activation type, as DeepSeek-V3's reference adds it.

It has no aux loss (0) and no tensor-parallel plan: under a 'model' axis
above 1 it raises.  Spans: ``nn/moe`` around either path (routing, sort,
dispatch, combine), ``nn/moe.experts`` around the expert products (the
shared expert's included); counters ``moe.pairs`` (pairs computed) and
``moe.dropped`` (0 on the dropless path; the capacity path counts its
dropped pairs while tracing is on, which reads them on the host).

:func:`recording` is the dropless path's routing record: inside its
block each :func:`moe_dropless` call appends ``(x, idx)`` to the list it
yields, in call order: its input x [B, S, d] and its chosen expert ids idx
[B, S, k] (the top k of ``s + b``), both on the device, so that a check
can hold the choices a forward made, and the router that made them, to a
reference without reaching into the router.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp
from ..runtime import obs
from .linear import Dense, take_rows

__all__ = ["MoE", "Route", "moe_route", "moe_apply", "moe_dropless",
           "capacity", "recording"]

ROUTERS = ("softmax", "sigmoid")
_RECORD: list | None = None        # the open :func:`recording`'s list


@contextlib.contextmanager
def recording():
    """Yields a list to which each :func:`moe_dropless` call inside the
    block appends its input and its expert ids ``(x [B, S, d], idx [B, S,
    k])`` (module docstring).  Blocks do not nest."""
    global _RECORD
    if _RECORD is not None:
        raise RuntimeError("moe.recording: a recording is already open")
    _RECORD = seen = []
    try:
        yield seen
    finally:
        _RECORD = None


class MoE(nn.Module):
    """Router ``router.w`` [d, E] (always f32) and stacked expert weights
    ``gate``, ``up`` [E, d, d_ff] and ``down`` [E, d_ff, d].  ``scoring``
    is the router: ``"softmax"`` routes through the capacity path,
    ``"sigmoid"`` through the dropless one with the selection bias ``bias``
    [E] (f32, zeros); and
    with ``n_shared`` one shared SwiGLU ``shared_gate``, ``shared_up`` [d,
    n_shared * d_ff] and ``shared_down`` [n_shared * d_ff, d], drawn after
    the routed experts."""

    def __init__(self, d: int, d_ff: int, n_experts: int, *,
                 router: str = "softmax", n_shared: int = 0, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if router not in ROUTERS:
            raise ValueError(f"router {router!r}: one of {ROUTERS}")
        self.scoring = router
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
        self.bias = (nn.Parameter(torch.zeros(n_experts, device=device,
                                              dtype=torch.float32))
                     if router == "sigmoid" else None)
        self.shared_gate = self.shared_up = self.shared_down = None
        if n_shared:
            fs = n_shared * d_ff
            self.shared_gate = draw(d, fs, fan_in=d)
            self.shared_up = draw(d, fs, fan_in=d)
            self.shared_down = draw(fs, d, fan_in=fs)

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
    if p.scoring != "softmax":
        raise ValueError("the capacity path takes the softmax router")
    B, S, _ = x.shape
    E = p.n_experts
    probs = torch.softmax(x.float() @ p.router.w.float(), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    me = probs.mean((0, 1))
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(  # repro_torch: noqa[TDET003] -- int64 counts: exact in any order
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
              capacity_factor: float = 1.25, routed_scale: float = 1.0):
    """x [B, S, d] -> (out [B, S, d] in x's type, aux loss f32 scalar);
    sharded over 'model' as the module docstring says.  A sigmoid router
    runs :func:`moe_dropless` (``routed_scale`` is its, an aux loss of 0);
    a softmax router the capacity path (``capacity_factor`` is its)."""
    if p.scoring == "sigmoid":
        return (moe_dropless(p, x, top_k=top_k, routed_scale=routed_scale),
                torch.zeros((), dtype=torch.float32, device=x.device))
    with obs.span("nn/moe"):
        return _apply_capacity(p, x, top_k=top_k,
                               capacity_factor=capacity_factor)


def _apply_capacity(p: MoE, x: torch.Tensor, *, top_k: int,
                    capacity_factor: float):
    B, S, d = x.shape
    E, SK = p.n_experts, S * top_k
    ax = tp.tp_axis()
    ep = ax is not None and p.gate.shape[0] != E
    r = moe_route(p, x, top_k=top_k, capacity_factor=capacity_factor)
    obs.count("moe.pairs", B * SK)
    if obs.tracing():
        obs.count("moe.dropped", int((~r.keep).sum()))
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
    with obs.span("nn/moe.experts"):
        xe = tp.copy_to_tp(xe, ax)
        h = F.silu(torch.einsum("...ecd,edf->...ecf", xe, p.gate)) \
            * torch.einsum("...ecd,edf->...ecf", xe, p.up)
        return tp.reduce_from_tp(torch.einsum("...ecf,efd->...ecd", h,
                                              p.down), ax)


def _choose(p: MoE, x: torch.Tensor, top_k: int, routed_scale: float):
    """The sigmoid router over x [N, d]: (weights [N, k] f32, expert ids
    [N, k]), as the module docstring says."""
    s = torch.sigmoid(x.float() @ p.router.w.float())
    idx = torch.topk(s + p.bias.float(), top_k, dim=-1).indices
    w = s.gather(-1, idx)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * routed_scale, idx


def moe_dropless(p: MoE, x: torch.Tensor, *, top_k: int,
                 routed_scale: float = 1.0) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d] in x's type: every (token, choice) pair
    through its expert, plus the shared expert (module docstring)."""
    if p.scoring != "sigmoid":
        raise ValueError("the dropless path takes the sigmoid router")
    if tp.tp_axis() is not None:
        raise NotImplementedError("the dropless MoE (sigmoid router, "
                                  "shared experts) has no tensor-parallel "
                                  "plan")
    with obs.span("nn/moe"):
        B, S, d = x.shape
        N, E = B * S, p.n_experts
        xf = x.reshape(N, d)
        w, idx = _choose(p, xf, top_k, routed_scale)
        if _RECORD is not None:
            _RECORD.append((x, idx.reshape(B, S, top_k)))
        ids, order = torch.sort(idx.reshape(-1), stable=True)
        # each expert's segment ends where the sorted ids pass it: no count
        # read back to the host
        offs = torch.searchsorted(ids, torch.arange(E, device=x.device),
                                  right=True).to(torch.int32)
        xs = take_rows(xf, torch.div(order, top_k, rounding_mode="floor"))
        ys, shared = _grouped_experts(p, xs, offs, xf)
        back = torch.empty_like(ys)
        back[order] = ys                   # sorted pair j back to its place
        out = torch.bmm(w[:, None, :], back.reshape(N, top_k, d).float())[
            :, 0].to(x.dtype)
        if shared is not None:
            out = out + shared
        obs.count("moe.pairs", N * top_k)
        obs.count("moe.dropped", 0)
        return out.reshape(B, S, d)


def _grouped_experts(p: MoE, xs: torch.Tensor, offs: torch.Tensor,
                     x: torch.Tensor):
    """The routed SwiGLUs over the sorted pairs xs [N*k, d], expert ``e``
    on rows ``offs[e-1]:offs[e]``, as grouped products; and the shared
    expert over the tokens x [N, d] (None without one)."""
    with obs.span("nn/moe.experts"):
        h = F.silu(torch._grouped_mm(xs, p.gate, offs=offs)) \
            * torch._grouped_mm(xs, p.up, offs=offs)
        ys = torch._grouped_mm(h, p.down, offs=offs)
        if p.shared_gate is None:
            return ys, None
        hs = F.silu(x @ p.shared_gate) * (x @ p.shared_up)
        return ys, hs @ p.shared_down


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
