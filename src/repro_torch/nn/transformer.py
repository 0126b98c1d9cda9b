"""Pre-norm transformer block (port of ``repro.nn.transformer``).

The MLP is SwiGLU (``down(silu(gate(x)) * up(x))``, no biases) or GELU
(``down(gelu(up(x)))`` with biases).  ``jax.nn.gelu`` is the tanh
approximation, so the GELU MLP uses ``F.gelu(..., approximate="tanh")``.
The norm is RMSNorm or LayerNorm.  A block built with ``cross_attn``
(whisper's decoder) adds ``lnx`` and ``xattn``, attending to the encoder
memory after the self-attention.  The reference's scanned stack becomes a
Python loop over per-layer blocks in the models that use them, each
block called through :func:`remat_call`.

Under tensor parallelism (``distributed.tp``) the MLP's gate and up are
column-parallel and down row-parallel over the hidden dim (a rank holds
``d_ff / tp`` of it; down's bias is added once, after the sum); the
block's norms stay whole on every rank.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp
from ..runtime import obs
from .attention import MHA
from .linear import Dense
from .norms import LayerNorm, RMSNorm

__all__ = ["MLP", "Block", "make_norm", "remat_call"]


_SAVED_BY_DOTS = ("mm", "addmm")


def _dots_policy(ctx, op, *args, **kwargs):
    """The reference's ``checkpoint_dots_with_no_batch_dims`` as a
    selective-checkpoint policy: keep the products with no batch
    dimension (``aten.mm``/``aten.addmm``: every ``Dense`` and ``x @ W``
    over flattened rows, the projections and MLPs), recompute the rest
    (``aten.bmm`` included: attention scores, stacked experts and the SSM
    readout, batched dot_generals in the reference, which it does not
    keep either)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if getattr(op, "_opname", None) in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(blk, *args, remat: str = "none", **kw):
    """``blk(*args, **kw)`` under the reference's ``remat`` of a scanned
    stack (``stack_apply``): ``"none"`` keeps the block's activations for
    the backward; ``"full"`` keeps its inputs and recomputes it there
    (non-reentrant ``torch.utils.checkpoint``; the blocks draw no random
    numbers, so no RNG state is kept); ``"dots"`` keeps its inputs and
    the outputs of its unbatched products and recomputes the rest
    (selective checkpointing, :func:`_dots_policy`).  Under ``no_grad``
    all three run the block as it is."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {remat!r}: 'none', 'full' or 'dots'")
    if remat == "none" or not torch.is_grad_enabled():
        return blk(*args, **kw)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(blk, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def make_norm(kind: str, d: int, *, eps: float | None = None, device=None,
              dtype=torch.float32):
    """``RMSNorm`` for ``"rms"``, ``LayerNorm`` for ``"layer"``; ``eps``
    None keeps the norm's own default."""
    kw = dict(device=device, dtype=dtype)
    if eps is not None:
        kw["eps"] = eps
    if kind == "rms":
        return RMSNorm(d, **kw)
    if kind == "layer":
        return LayerNorm(d, **kw)
    raise ValueError(f"unknown norm {kind!r}")


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, *, kind: str = "swiglu",
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.kind, self.d_ff = kind, d_ff
        if kind == "swiglu":
            self.gate = Dense(d, d_ff, bias=False, **kw)
            self.up = Dense(d, d_ff, bias=False, **kw)
            self.down = Dense(d_ff, d, bias=False, **kw)
        elif kind == "gelu":
            self.up = Dense(d, d_ff, bias=True, **kw)
            self.down = Dense(d_ff, d, bias=True, **kw)
        else:
            raise ValueError(f"unknown mlp kind {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with obs.span("nn/mlp"):
            ax = tp.tp_axis()
            if ax is None or self.up.w.shape[1] == self.d_ff:
                if self.kind == "swiglu":
                    return self.down(F.silu(self.gate(x)) * self.up(x))
                return self.down(F.gelu(self.up(x), approximate="tanh"))
            x = tp.copy_to_tp(x, ax)
            if self.kind == "swiglu":
                h = F.silu(self.gate(x)) * self.up(x)
            else:
                h = F.gelu(self.up(x), approximate="tanh")
            y = tp.reduce_from_tp(h @ self.down.w, ax)
            return y if self.down.b is None else y + self.down.b


class Block(nn.Module):
    """``x + attn(norm1(x))``, with ``cross_attn`` then ``+
    xattn(normx(x), memory)``, then ``+ mlp(norm2(x))``; ``norm_eps`` (None:
    the norms' defaults) reaches every norm of the block, qk-norm's too."""

    def __init__(self, d_model: int, *, n_heads: int, head_dim: int,
                 d_ff: int, kv_heads: int | None = None,
                 mlp_kind: str = "swiglu", norm: str = "rms",
                 qkv_bias: bool = False, qk_norm: bool = False,
                 cross_attn: bool = False, norm_eps: float | None = None,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        nk = dict(eps=norm_eps, device=device, dtype=dtype)
        self.ln1 = make_norm(norm, d_model, **nk)
        self.attn = MHA(d_model, n_heads=n_heads, head_dim=head_dim,
                        kv_heads=kv_heads, qkv_bias=qkv_bias,
                        qk_norm=qk_norm, norm_eps=norm_eps, **kw)
        self.ln2 = make_norm(norm, d_model, **nk)
        self.mlp = MLP(d_model, d_ff, kind=mlp_kind, **kw)
        if cross_attn:
            self.lnx = make_norm(norm, d_model, **nk)
            self.xattn = MHA(d_model, n_heads=n_heads, head_dim=head_dim,
                             kv_heads=kv_heads, **kw)

    def forward(self, x: torch.Tensor, *, cos=None, sin=None,
                causal: bool = True, window: int = -1,
                memory: torch.Tensor | None = None,
                cache: dict | None = None, impl: str = "dense"):
        """Returns ``(x, cache)``; ``memory`` [B, T, d] feeds the
        cross-attention."""
        h, cache = self.attn(self.ln1(x), cos=cos, sin=sin, causal=causal,
                             window=window, cache=cache, impl=impl)
        x = x + h
        if memory is not None:
            h, _ = self.xattn(self.lnx(x), xkv=memory, impl=impl)
            x = x + h
        x = x + self.mlp(self.ln2(x))
        return x, cache
