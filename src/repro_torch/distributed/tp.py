"""Tensor, expert and sequence parallelism over a mesh's 'model' axis.

A rank of a ``(data, model)`` or ``(pod, data, model)`` mesh holds, as
plain tensors, its 'model' shard of every leaf that the plan
(``distributed.sharding.param_specs``) shards there: the contiguous
``1/tp`` of the leaf's 'model' dim that :func:`shard_leaf` cuts.  The
modules (``nn.attention``, ``nn.transformer``, ``nn.moe``, ``nn.rwkv``,
``nn.linear``, ``nn.losses`` and the models) read the ambient
:class:`Parallel` (:func:`current`, entered by ``launch.steps``) and
compare a leaf's shape with its global width to see whether it is
sharded; with no ambient :class:`Parallel`, or a 'model' axis of 1, they
run as on one device.

Megatron's conjugate operators (arXiv:1909.08053, section 3) keep the
gradients of replicated leaves whole and equal on every rank:

- :func:`copy_to_tp`: identity forward, all-reduce of the gradient
  backward; the input of a column-parallel product, or a replicated leaf
  that a rank uses for its own heads only (RWKV's group-norm gains);
- :func:`reduce_from_tp`: all-reduce forward, identity backward; the
  output of a row-parallel product, the vocab-parallel lookup, the
  cross-entropy's statistics;
- :func:`gather_from_tp`: all-gather forward, this rank's slice of the
  gradient backward (the logits, RWKV's receptance gate ``cr``);
- :func:`tp_select`: some entries of a replicated tensor forward, the
  gradient zero-padded and all-reduced backward (the kv-heads that a
  rank's q-heads read when the plan keeps K/V whole, RWKV's decay and
  bonus on the rank's heads, the MoE rows a rank serves).

Every collective of this module counts the bytes of its buffer on this
rank in ``Parallel.moved``, keyed by ``(part, kind)``: ``part`` is
``"tp"``, ``"ep"`` or ``"sp"``; an all-reduce counts its tensor, an
all-gather its output, an all-to-all its input.  ``launch.cost_analysis``
reckons the same payloads from the plan.

:func:`merge_partials` is the sequence-parallel decode's online-softmax
combine of partial outputs and their log-sum-exps, a pure function;
:func:`sp_merge` gathers the ranks' partials and calls it, so the
merge can be run over shards held on one device as well.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field

import torch

__all__ = ["Axis", "Parallel", "current", "parallel", "tp_axis",
           "all_reduce", "all_gather", "all_to_all", "all_to_all_tp",
           "copy_to_tp",
           "reduce_from_tp", "gather_from_tp", "tp_select", "vocab_lookup",
           "merge_partials", "sp_merge", "shard_leaf", "model_dim",
           "Keep", "keep_all", "shard_module", "local_heads", "cache_len",
           "vocab_axis", "logits"]


@dataclass
class Axis:
    """One process group of a mesh: this rank's index in it and its
    size."""
    group: object
    rank: int
    size: int


@dataclass
class Parallel:
    """The ambient parallel context of a sharded step: ``tp`` the 'model'
    axis, ``dp`` the data axes flattened, ``seq`` the axis a decode
    cache's sequence is cut over (None: the cache is whole)."""
    tp: Axis
    dp: Axis
    seq: Axis | None = None
    moved: Counter = field(default_factory=Counter)


_CUR: list = []


def current() -> Parallel | None:
    """The innermost :func:`parallel`'s context, or None."""
    return _CUR[-1] if _CUR else None


@contextlib.contextmanager
def parallel(par: Parallel):
    _CUR.append(par)
    try:
        yield par
    finally:
        _CUR.pop()


def tp_axis() -> Axis | None:
    """The ambient 'model' axis when it is above 1, else None."""
    par = current()
    return par.tp if par is not None and par.tp.size > 1 else None


def local_heads(n: int) -> int:
    """Heads of ``n`` this rank holds: ``n / tp`` when the 'model' axis
    divides them (the plan's head rule), else all."""
    ax = tp_axis()
    return n // ax.size if ax is not None and n % ax.size == 0 else n


def cache_len(max_len: int) -> int:
    """Positions of a ``max_len`` decode cache this rank holds: its share
    of the sequence axis (``Parallel.seq``), else all."""
    par = current()
    seq = par.seq if par is not None else None
    return max_len // seq.size if seq is not None else max_len


def vocab_axis(cols: int, vocab: int) -> Axis | None:
    """The 'model' axis when a head of ``cols`` columns is a rank's share
    of a ``vocab``-wide one, else None."""
    ax = tp_axis()
    return ax if ax is not None and cols != vocab else None


def logits(x: torch.Tensor, w: torch.Tensor, vocab: int) -> torch.Tensor:
    """``x @ w`` for a head ``w`` [d, V] that may hold a rank's share of
    the vocabulary: then column-parallel and all-gathered, so every rank
    holds the whole row (an argmax over it is ``torch.argmax`` over the
    one-device row, ties included)."""
    ax = vocab_axis(w.shape[-1], vocab)
    return gather_from_tp(copy_to_tp(x, ax) @ w, ax, -1)


def _count(part: str, kind: str, t: torch.Tensor) -> None:
    par = current()
    if par is not None:
        par.moved[(part, kind)] += t.numel() * t.element_size()


def all_reduce(x: torch.Tensor, ax: Axis, *, op: str = "sum",
               part: str = "tp") -> torch.Tensor:
    """A new tensor: ``x`` summed (or maxed) over ``ax``'s ranks."""
    import torch.distributed as dist
    y = x.contiguous().clone()
    _count(part, "all-reduce", y)
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=ax.group)
    return y


def all_gather(x: torch.Tensor, ax: Axis, dim: int, *,
               part: str = "tp") -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated on ``dim`` in rank
    order."""
    import torch.distributed as dist
    x = x.contiguous()
    out = x.new_empty((ax.size * x.shape[0],) + tuple(x.shape[1:]))
    _count(part, "all-gather", out)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor            # its name before 2.12
    gather(out, x, group=ax.group)
    if dim == 0:
        return out
    return torch.cat(out.view((ax.size,) + tuple(x.shape)).unbind(0),
                     dim=dim)


def all_to_all(x: torch.Tensor, ax: Axis, *,
               part: str = "ep") -> torch.Tensor:
    """Block ``j`` of ``x``'s leading dim (``size`` equal blocks) to rank
    ``j``; the result's block ``j`` came from rank ``j``."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    _count(part, "all-to-all", x)
    dist.all_to_all_single(out, x, group=ax.group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, part):
        ctx.ax, ctx.part = ax, part
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax, part=ctx.part), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, part):
        return all_reduce(x, ax, part=part)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, part):
        ctx.ax, ctx.dim, ctx.m = ax, dim, x.shape[dim]
        return all_gather(x, ax, dim, part=part)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.rank * ctx.m, ctx.m), None, None, \
            None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, part):
        ctx.ax, ctx.part = ax, part
        return all_to_all(x, ax, part=part)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.ax, part=ctx.part), None, None


class _Select(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, index, part):
        ctx.ax, ctx.dim, ctx.index, ctx.part = ax, dim, index, part
        ctx.shape = x.shape
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape).index_add_(ctx.dim, ctx.index, g)
        return all_reduce(full, ctx.ax, part=ctx.part), None, None, None, \
            None


def copy_to_tp(x, ax: Axis | None, part: str = "tp"):
    """Identity forward, the gradient all-reduced over ``ax`` backward
    (``x`` as it is when ``ax`` is None or no gradient is recorded)."""
    if ax is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Copy.apply(x, ax, part)


def reduce_from_tp(x, ax: Axis | None, part: str = "tp"):
    """``x`` summed over ``ax``'s ranks; the gradient passes as it is."""
    if ax is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reduce.apply(x, ax, part)
    return all_reduce(x, ax, part=part)


def gather_from_tp(x, ax: Axis | None, dim: int, part: str = "tp"):
    """The ranks' ``x`` concatenated on ``dim``; backward, this rank's
    slice of the gradient."""
    if ax is None:
        return x
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, ax, dim, part)
    return all_gather(x, ax, dim, part=part)


def all_to_all_tp(x, ax: Axis, part: str = "ep"):
    """:func:`all_to_all` with its own adjoint (the same exchange of the
    gradient's blocks) as backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, ax, part)
    return all_to_all(x, ax, part=part)


def tp_select(x, ax: Axis | None, dim: int, index, part: str = "tp"):
    """``x``'s entries ``index`` (a list of ints) on ``dim``: a narrow
    when they are a run, else an ``index_select``; backward, the gradient
    scattered into zeros of ``x``'s shape and all-reduced over ``ax``, so
    a replicated ``x`` gets its whole gradient on every rank."""
    dim = dim % x.dim()
    index = list(index)
    if ax is not None and torch.is_grad_enabled() and x.requires_grad:
        idx = torch.tensor(index, device=x.device)
        return _Select.apply(x, ax, dim, idx, part)
    if index == list(range(index[0], index[0] + len(index))):
        return x.narrow(dim, index[0], len(index))
    return x.index_select(dim, torch.tensor(index, device=x.device))


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, rows: int,
                 ax: Axis | None) -> torch.Tensor:
    """Rows ``ids`` of a table of ``rows`` rows whose 'model' shard
    ``table`` is (the whole table when ``ax`` is None): each rank reads
    the ids it holds through ``take_rows`` (zeros elsewhere) and the
    lookup is summed over the ranks, to which exactly one contributes a
    nonzero row, so the sum is exact."""
    from ..nn.linear import take_rows
    if ax is None or table.shape[0] == rows:
        return take_rows(table, ids)
    n = table.shape[0]
    local = ids - ax.rank * n
    hit = (local >= 0) & (local < n)
    got = take_rows(table, local.clamp(0, n - 1))
    got = torch.where(hit[..., None], got, torch.zeros((), dtype=got.dtype,
                                                       device=got.device))
    return reduce_from_tp(got, ax)


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The online-softmax combine of ``R`` partial attentions over
    disjoint key sets: ``outs`` [R, ..., H, hd] (each normalised over its
    keys), ``lses`` [R, ..., H] their log-sum-exps (-inf where a part saw
    no key) -> [..., H, hd] in f32, the parts summed in order.  A part
    with -inf weighs exactly 0; a row that no part saw is 0."""
    lf = lses.float()
    m = lf.amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lf - m)                       # [R, ..., H]
    num = (outs.float() * w[..., None]).sum(0)
    den = w.sum(0)
    return num / torch.clamp_min(den, 1e-30)[..., None]


def sp_merge(out: torch.Tensor, lse: torch.Tensor,
             ax: Axis | None) -> torch.Tensor:
    """This rank's partial ``out`` [..., H, hd] over its key shard, with
    ``lse`` [..., H], merged with the other ranks' of ``ax`` (one
    all-gather of both, packed) -> [..., H, hd] f32."""
    if ax is None or ax.size == 1:
        return merge_partials(out[None], lse[None])
    pack = torch.cat([out.float(), lse.float()[..., None]], dim=-1)
    got = all_gather(pack[None], ax, 0, part="sp")
    return merge_partials(got[..., :-1], got[..., -1])


def model_dim(spec: tuple) -> int | None:
    """The dim a spec shards over 'model', or None."""
    for d, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return d
    return None


def shard_leaf(t: torch.Tensor, spec: tuple, rank: int,
               size: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous ``1/size`` of ``t`` on its 'model' dim
    (``t`` itself when the spec has none)."""
    d = model_dim(spec)
    if d is None or size == 1:
        return t
    m = t.shape[d] // size
    return t.narrow(d, rank * m, m)


class Keep:
    """Cuts a model to one rank's 'model' shard as it is built: called on
    each module the model's constructor makes (a block, the embedding,
    the head) with its ``param_tree`` prefix, it swaps each parameter for
    the rank's slice, so a rank holds one module whole at most beside its
    shards, and every leaf is drawn as on one device.  ``specs`` is
    ``param_specs`` of the global model (:meth:`of`)."""

    def __init__(self, specs: dict, rank: int, size: int):
        self.specs, self.rank, self.size = specs, rank, size

    @classmethod
    def of(cls, cfg, rank: int, size: int) -> "Keep":
        """Rank ``rank`` of a 'model' axis of ``size`` for ``cfg``'s
        model: the plan ruled on a ``meta`` model."""
        from ..launch.mesh import MeshSpec
        from ..models import registry
        from .sharding import param_specs
        meta = registry.get_model(cfg).MODEL(cfg, device="meta")
        specs = param_specs(meta, MeshSpec((1, size), ("data", "model")),
                            cfg)
        return cls(specs, rank, size)

    def __call__(self, prefix: str, module):
        return shard_module(module, self.specs, self.rank, self.size,
                            prefix=prefix)


def keep_all(prefix: str, module):
    """The one-device :class:`Keep`: every leaf whole."""
    return module


@torch.no_grad()
def shard_module(module, specs: dict, rank: int, size: int, *,
                 prefix: str = ""):
    """Swap each parameter of ``module`` (keyed ``prefix/name`` in
    ``specs``) for rank ``rank``'s slice, in place; returns ``module``."""
    from torch import nn
    for name, p in list(module.named_parameters()):
        key = "/".join(filter(None, [prefix] + name.split(".")))
        if key.startswith("type_"):
            key = "type" + key[5:]
        cut = shard_leaf(p.data, specs[key], rank, size)
        if cut.shape == p.shape:
            continue
        owner = module.get_submodule(name.rpartition(".")[0]) \
            if "." in name else module
        setattr(owner, name.rpartition(".")[2],
                nn.Parameter(cut.clone(), requires_grad=p.requires_grad))
    return module
