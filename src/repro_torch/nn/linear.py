"""Dense and embedding primitives.

Port of ``repro.nn.linear``.  Weights keep the reference's layout,
``w`` [d_in, d_out] applied as ``x @ w`` (not ``nn.Linear``'s transposed
one), so reference checkpoints load without transposes.

:func:`take_rows` is the row gather of the LM path (the embedding lookup,
the MoE dispatch and combine): the plain gather, with a backward
(:func:`segment_sum`) that gives the same bits on every run and is
linear in the ids.

Under tensor parallelism (``distributed.tp``) a rank's :class:`Embedding`
holds its contiguous share of the rows (the plan's vocab shard) and looks
up through ``tp.vocab_lookup``; a :class:`Dense` holds its column or row
shard as a plain weight, and the module that owns it places the
collectives (``nn.transformer.MLP``, ``nn.attention.MHA``, ...).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..distributed import tp

__all__ = ["Dense", "Embedding", "take_rows", "segment_sum"]


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: rows of ``table`` [N, d] at ``ids`` (any shape) ->
    [*ids.shape, d], with a backward that gives the same bits on every run.

    A plain gather's backward adds a repeated row's gradients with atomic
    adds on the CPU (past 32768 elements on several threads), so two runs
    of one seed part in the last bits.  Here the forward is the plain
    gather and the backward is :func:`segment_sum`, whose order of
    addition is fixed by the ids; both are linear in the ids."""
    flat = ids.reshape(-1)
    return _TakeRows.apply(table, flat).reshape(*ids.shape, table.shape[-1])


def segment_sum(g: torch.Tensor, ids: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """``zeros(n_rows, d).index_add_(0, ids, g)`` for ``g`` [n, d], summed
    in an order fixed by ``ids`` on every device and thread count.

    The ids are stable-sorted so that each row's gradients form a run; a
    segmented inclusive scan by doubling (ceil(log2 n) passes, each adding
    the value ``span`` places back where it lies in the same run) leaves
    each run's sum at its last place; the run ends are written with an
    accumulating ``index_put_`` in which every other place adds an exact
    zero, so its order cannot change a bit.  Memory is a few [n, d]
    buffers, and no value leaves the device (no host sync)."""
    s, order = torch.sort(ids, stable=True)
    acc = g[order]
    n = s.numel()
    span = 1
    while span < n:
        same = (s[span:] == s[:-span])[:, None]
        acc = torch.cat([acc[:span], torch.where(
            same, acc[span:] + acc[:-span], acc[span:])])
        span *= 2
    end = torch.ones_like(s, dtype=torch.bool)
    end[:-1] = s[1:] != s[:-1]
    out = g.new_zeros((n_rows, g.shape[-1]))
    return out.index_put_((s,), torch.where(end[:, None], acc, 0),  # repro_torch: noqa[TDET003] -- segment_sum, the sanctioned route: one nonzero add a row
                          accumulate=True)


class _TakeRows(torch.autograd.Function):
    """``table[flat]`` with :func:`segment_sum` as its backward."""

    @staticmethod
    def forward(ctx, table, flat):
        ctx.save_for_backward(flat)
        ctx.n_rows = table.shape[0]
        return table[flat]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        flat, = ctx.saved_tensors
        return segment_sum(g, flat, ctx.n_rows), None


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` [d_in, d_out], drawn N(0, 1/d_in)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = True,
                 generator: torch.Generator | None = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        w = torch.randn((d_in, d_out), generator=generator, device=device,
                        dtype=torch.float32) / math.sqrt(d_in)
        self.w = nn.Parameter(w.to(dtype))
        self.b = (nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        if self.b is not None:
            y = y + self.b
        return y


class Embedding(nn.Module):
    """Lookup table ``emb`` [vocab, d], drawn N(0, 0.02^2); ``rows`` is
    the table's global row count, above ``emb``'s on a rank that holds a
    vocab shard."""

    def __init__(self, vocab: int, d: int, *,
                 generator: torch.Generator | None = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        e = torch.randn((vocab, d), generator=generator, device=device,
                        dtype=torch.float32) * 0.02
        self.emb = nn.Parameter(e.to(dtype))
        self.rows = vocab

    def forward(self, ids) -> torch.Tensor:
        return tp.vocab_lookup(self.emb, ids, self.rows, tp.tp_axis())
