"""Hymba hybrid-head LM (port of ``repro.models.hymba``;
arXiv:2411.13676).

Each layer runs GQA attention (sliding-window on most layers, full on a
few: the window is ``cfg.windows()[i]``) and a selective-SSM head
(``nn.ssm``) in parallel on the same RMS-normed input; each path's output
is RMS-normed on its own (``na``, ``ns``), the two are averaged and added
to the residual, and a SwiGLU MLP follows.  Token embeddings are not
scaled; the head is untied.  Parameter names follow the reference's pytree
paths with the layer index spelled out (``blocks.3.ssm.A_log``).

Entry points, with the signatures of ``models.lm``: :func:`init`,
:func:`forward`, :func:`loss_fn`, :func:`init_decode_state`,
:func:`prefill` and :func:`decode_step`.  With ``impl="kernel"`` an
uncached sequence takes ``flash_attention`` on every layer (the window
passed to the kernel), and a decode step takes ``flash_decode`` on the
full-attention layers only; the windowed layers' single-token steps and a
prefill's cache append take the dense masked math, as in the reference.
The decode state is ``{"kv": {"k", "v": [L, B, T, Hkv, hd], "idx": int},
"ssm": {"h": [L, B, d, N] f32, "cwin": [L, B, K-1, d]}}``, written in
place.  The SSM's recurrence is a Python loop over positions: on the card
about four launches a position and layer.

Tensor parallelism as in ``models.lm``: attention and MLP run their
shards; the SSM and the norms are whole on every rank (the plan
replicates them), so their inputs and outputs are too.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..configs import ArchConfig
from ..distributed import tp
from ..nn import (MHA, MLP, SSM, Dense, Embedding, RMSNorm, fused_linear_ce,
                  rope_freqs, ssm_init_state)
from ..nn.transformer import remat_call

__all__ = ["Hymba", "HymbaBlock", "MODEL", "init", "forward", "loss_fn",
           "init_decode_state", "prefill", "decode_step"]


class HymbaBlock(nn.Module):
    """Attention and SSM in parallel, per-path norms, mean, residual, MLP."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        d = cfg.d_model
        self.ln1 = RMSNorm(d, device=device, dtype=dtype)
        self.attn = MHA(d, n_heads=cfg.n_heads, head_dim=cfg.hd,
                        kv_heads=cfg.kv_heads, **kw)
        self.ssm = SSM(d, state=cfg.ssm_state, conv=cfg.ssm_conv, **kw)
        self.na = RMSNorm(d, device=device, dtype=dtype)
        self.ns = RMSNorm(d, device=device, dtype=dtype)
        self.ln2 = RMSNorm(d, device=device, dtype=dtype)
        self.mlp = MLP(d, cfg.d_ff, kind="swiglu", **kw)

    def forward(self, x, *, cos, sin, window: int, kv=None, ssm=None,
                impl: str = "dense"):
        """Returns ``(x, new SSM state or None)``; ``kv`` is written in
        place."""
        xn = self.ln1(x)
        ha, _ = self.attn(xn, cos=cos, sin=sin, window=window, cache=kv,
                          impl=impl)
        hs, ssm = self.ssm(xn, state=ssm)
        x = x + 0.5 * (self.na(ha) + self.ns(hs))
        return x + self.mlp(self.ln2(x)), ssm


class Hymba(nn.Module):
    """The hybrid LM; ``cfg`` fixes its shapes."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None,
                 dtype=torch.bfloat16, keep=tp.keep_all):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = keep("embed", Embedding(cfg.vocab_padded, cfg.d_model,
                                             **kw))
        self.blocks = nn.ModuleList(keep(f"blocks/{i}", HymbaBlock(cfg, **kw))
                                    for i in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.head = keep("head", Dense(cfg.d_model, cfg.vocab_padded,
                                       bias=False, **kw))


MODEL = Hymba                     # the class a reference checkpoint fills


def init(cfg: ArchConfig, *, seed: int = 0, dtype=torch.bfloat16,
         device=None, shard: tp.Keep | None = None) -> Hymba:
    """A model with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``cuda`` unless given); with ``shard``, one
    rank's 'model' shard of the same draw (``models.lm.init``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return Hymba(cfg, generator=gen, device=dev, dtype=dtype,
                   keep=shard or tp.keep_all).eval()


def _run(model: Hymba, ids, pos0: int = 0, *, state=None, impl: str,
         remat: str = "none"):
    """Embed ``ids`` [B, S] at positions ``pos0 ..`` and run the stack;
    ``state`` (the decode state) is written in place."""
    cfg = model.cfg
    x = model.embed(ids)
    pos = torch.arange(ids.shape[1], device=ids.device) + pos0
    cos, sin = rope_freqs(pos, cfg.hd, cfg.rope_theta)
    for i, (blk, window) in enumerate(zip(model.blocks, cfg.windows())):
        kv = ssm = None
        if state is not None:
            kv = {"k": state["kv"]["k"][i], "v": state["kv"]["v"][i],
                  "idx": state["kv"]["idx"]}
            ssm = {key: state["ssm"][key][i] for key in ("h", "cwin")}
        x, new = remat_call(blk, x, cos=cos, sin=sin, window=window, kv=kv,
                            ssm=ssm, impl=impl, remat=remat)
        if state is not None:
            for key, val in new.items():
                state["ssm"][key][i].copy_(val)
    if state is not None:
        state["kv"]["idx"] += ids.shape[1]
    return model.ln_f(x)


@torch.no_grad()
def forward(model: Hymba, batch: dict, *,
            impl: str = "kernel") -> torch.Tensor:
    """Teacher-forced logits [B, S, vocab_padded] for ``batch["tokens"]``
    [B, S]."""
    return _logits(model, _run(model, batch["tokens"], impl=impl))


def _logits(model: Hymba, x: torch.Tensor) -> torch.Tensor:
    return tp.logits(x, model.head.w, model.cfg.vocab_padded)


def loss_fn(model: Hymba, batch: dict, *, impl: str = "dense",
            remat: str = "none", aux_weight: float = 0.0) -> torch.Tensor:
    """Mean next-token CE against ``batch["labels"]``, with gradients (no
    aux loss: ``aux_weight`` is accepted and unused, as in the
    reference; ``remat`` as ``nn.transformer.remat_call``'s)."""
    x = _run(model, batch["tokens"], impl=impl, remat=remat)
    return fused_linear_ce(x, model.head.w, batch["labels"],
                           vocab=model.cfg.vocab_padded)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Zero KV caches (as ``lm``'s) and zero SSM states for every layer."""
    dev = resolve_device(device)
    L = cfg.n_layers
    shape = (L, batch, tp.cache_len(max_len), cfg.kv_heads, cfg.hd)
    kv = {"k": torch.zeros(shape, dtype=dtype, device=dev),
          "v": torch.zeros(shape, dtype=dtype, device=dev), "idx": 0}
    ssm = ssm_init_state(batch, cfg.d_model, cfg.ssm_state, cfg.ssm_conv,
                         dtype=dtype, device=dev)
    ssm = {key: a.expand(L, *a.shape).clone() for key, a in ssm.items()}
    return {"kv": kv, "ssm": ssm}


@torch.no_grad()
def prefill(model: Hymba, batch: dict, max_len: int, *,
            impl: str = "kernel", cache_dtype=torch.bfloat16):
    """Process the prompt ``batch["tokens"]`` [B, S]: ``(logits of the last
    token [B, 1, vocab_padded], filled decode state)``."""
    ids = batch["tokens"]
    state = init_decode_state(model.cfg, ids.shape[0], max_len,
                              dtype=cache_dtype, device=ids.device)
    x = _run(model, ids, state=state, impl=impl)
    return _logits(model, x[:, -1:]), state


@torch.no_grad()
def decode_step(model: Hymba, state: dict, batch: dict, *,
                impl: str = "kernel"):
    """One decode step for ``batch["tokens"]`` [B, 1]: ``(logits [B, 1,
    vocab_padded], state)``; the state is updated in place."""
    x = _run(model, batch["tokens"], state["kv"]["idx"], state=state,
             impl=impl)
    return _logits(model, x), state
