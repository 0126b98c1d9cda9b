"""RWKV6 language model, attention-free (port of ``repro.models.rwkv_lm``;
arXiv:2404.05892).

Embedding (no scale), one :class:`~repro_torch.nn.RWKVBlock` per layer run
by a Python loop (the reference scans over stacked parameters), a final
LayerNorm ``ln_f`` and an untied ``head``.  Parameter names follow the
reference's pytree paths with the layer index spelled out
(``blocks.3.mu.r`` for row 3 of ``blocks/mu/r``).

Entry points, with the signatures of ``models.lm``: :func:`init`,
:func:`forward` (teacher-forced logits), :func:`loss_fn` (next-token CE
through the chunked ``fused_linear_ce``; differentiable),
:func:`init_decode_state`, :func:`prefill` and :func:`decode_step`.
``impl="kernel"`` (the default of every entry point but :func:`loss_fn`)
sends each layer's time mix to the ``wkv6`` kernel, a decode step's
single token included; ``impl="dense"`` is the reference's ``impl="xla"``
(the chunked form, and the sequential step for a single token) and
:func:`loss_fn`'s default: ``wkv6`` has no backward.
The decode state is ``{"s": [L,B,H,n,n] f32, "x_tm", "xc_tm": [L,B,d]}``
in the cache type, O(1) in ``max_len``, and written in place.

Tensor parallelism as in ``models.lm``: a rank's blocks run their heads
(``nn.rwkv``), its state ``S`` holds them, and the logits are
all-gathered over the vocab.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..configs import ArchConfig
from ..distributed import tp
from ..nn import Dense, Embedding, LayerNorm, RWKVBlock, fused_linear_ce
from ..nn.rwkv import rwkv_init_state
from ..nn.transformer import remat_call

__all__ = ["RWKVLM", "MODEL", "init", "forward", "loss_fn",
           "init_decode_state", "prefill", "decode_step"]


class RWKVLM(nn.Module):
    """The RWKV6 LM; ``cfg`` fixes its shapes."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None,
                 dtype=torch.bfloat16, keep=tp.keep_all):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = keep("embed", Embedding(cfg.vocab_padded, cfg.d_model,
                                             **kw))
        self.blocks = nn.ModuleList(
            keep(f"blocks/{i}", RWKVBlock(cfg.d_model, n_heads=cfg.n_heads,
                                          head_dim=cfg.hd, d_ff=cfg.d_ff,
                                          **kw))
            for i in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, device=device, dtype=dtype)
        self.head = keep("head", Dense(cfg.d_model, cfg.vocab_padded,
                                       bias=False, **kw))


MODEL = RWKVLM                    # the class a reference checkpoint fills


def init(cfg: ArchConfig, *, seed: int = 0, dtype=torch.bfloat16,
         device=None, shard: tp.Keep | None = None) -> RWKVLM:
    """A model with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``cuda`` unless given); with ``shard``, one
    rank's 'model' shard of the same draw (``models.lm.init``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return RWKVLM(cfg, generator=gen, device=dev, dtype=dtype,
                   keep=shard or tp.keep_all).eval()


def _run(model: RWKVLM, x, *, states=None, impl: str, remat: str = "none"):
    """The block stack over x [B,T,d]; ``states`` the decode state,
    written in place."""
    for i, blk in enumerate(model.blocks):
        st = None
        if states is not None:
            st = {key: states[key][i] for key in ("s", "x_tm", "xc_tm")}
        x, new = remat_call(blk, x, state=st, impl=impl, remat=remat)
        if states is not None:
            for key, val in new.items():
                states[key][i].copy_(val)
    return x


def _logits(model: RWKVLM, x: torch.Tensor) -> torch.Tensor:
    return tp.logits(model.ln_f(x), model.head.w, model.cfg.vocab_padded)


@torch.no_grad()
def forward(model: RWKVLM, batch: dict, *,
            impl: str = "kernel") -> torch.Tensor:
    """Teacher-forced logits [B, S, vocab_padded] for ``batch["tokens"]``
    [B, S]."""
    return _logits(model, _run(model, model.embed(batch["tokens"]),
                               impl=impl))


def loss_fn(model: RWKVLM, batch: dict, *, impl: str = "dense",
            remat: str = "none", aux_weight: float = 0.0) -> torch.Tensor:
    """Mean next-token CE against ``batch["labels"]``, with gradients
    (``aux_weight`` unused, as in the reference; ``remat`` as
    ``nn.transformer.remat_call``'s)."""
    x = _run(model, model.embed(batch["tokens"]), impl=impl, remat=remat)
    return fused_linear_ce(model.ln_f(x), model.head.w, batch["labels"],
                           vocab=model.cfg.vocab_padded)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Zero recurrent state for every layer (``max_len`` unused: the state
    is O(1) in it)."""
    st = rwkv_init_state(batch, tp.local_heads(cfg.n_heads), cfg.hd,
                         cfg.d_model,
                         dtype=dtype, device=resolve_device(device))
    return {key: a.expand(cfg.n_layers, *a.shape).clone()
            for key, a in st.items()}


@torch.no_grad()
def prefill(model: RWKVLM, batch: dict, max_len: int, *,
            impl: str = "kernel", cache_dtype=torch.bfloat16):
    """Process the prompt ``batch["tokens"]`` [B, S]: ``(logits of the last
    token [B, 1, vocab_padded], filled decode state)``."""
    ids = batch["tokens"]
    state = init_decode_state(model.cfg, ids.shape[0], max_len,
                              dtype=cache_dtype, device=ids.device)
    x = _run(model, model.embed(ids), states=state, impl=impl)
    return _logits(model, x[:, -1:]), state


@torch.no_grad()
def decode_step(model: RWKVLM, state: dict, batch: dict, *,
                impl: str = "kernel"):
    """One decode step for ``batch["tokens"]`` [B, 1]: ``(logits [B, 1,
    vocab_padded], state)``; the state is updated in place."""
    x = _run(model, model.embed(batch["tokens"]), states=state, impl=impl)
    return _logits(model, x), state
