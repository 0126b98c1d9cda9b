"""Decoder-only LM for the dense family (port of ``repro.models.lm``).

One pre-norm block per layer, run by a Python loop (the reference scans
over stacked parameters): GQA (+ qk-norm, QKV bias), per-layer sliding
windows, a SwiGLU MLP, standard RoPE, tied or untied embeddings.  The
model is an ``nn.Module`` whose parameter names follow the reference's
pytree paths with the layer index spelled out (``blocks.3.attn.q.w`` for
row 3 of ``blocks/attn/q/w``).

Entry points: :func:`init`, :func:`forward` (teacher-forced logits),
:func:`init_decode_state`, :func:`prefill` (fill the KV caches from a
prompt) and :func:`decode_step` (one token).  ``impl="kernel"`` (the
default) sends each layer's uncached attention to ``flash_attention`` and
each single-token decode to ``flash_decode``; ``impl="dense"`` is the
reference's ``impl="xla"`` (see ``nn.attention``).  The kernels take q,
k and v of one type, so on the card ``impl="kernel"`` decodes need the
cache in the parameters' type (the defaults, bf16 and bf16, agree).  The
decode state is
``{"k", "v": [L, B, T, Hkv, hd], "idx": int}``, written in place; its
write index is a Python int, so a decode step makes no host sync.

MoE layers, M-RoPE and precomputed input embeddings raise
``NotImplementedError``; ``loss_fn`` waits for the training slice.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..configs import ArchConfig
from ..nn import Block, Dense, Embedding, make_norm, rope_freqs

__all__ = ["LM", "MODEL", "init", "forward", "init_decode_state", "prefill",
           "decode_step"]


def _check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE layers come with the "
                                  "MoE slice of the port")
    if cfg.mrope_sections is not None or cfg.embed_inputs:
        raise NotImplementedError(f"{cfg.name}: M-RoPE and precomputed "
                                  "input embeddings come with the VLM "
                                  "slice of the port")


class LM(nn.Module):
    """The dense LM; ``cfg`` fixes its shapes."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(
            Block(cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.hd,
                  d_ff=cfg.d_ff, kv_heads=cfg.kv_heads,
                  mlp_kind=cfg.mlp_kind, norm=cfg.norm,
                  qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, **kw)
            for _ in range(cfg.n_layers))
        self.ln_f = make_norm(cfg.norm, cfg.d_model, device=device,
                              dtype=dtype)
        self.head = (None if cfg.tie_embeddings else
                     Dense(cfg.d_model, cfg.vocab_padded, bias=False, **kw))

    def head_w(self) -> torch.Tensor:
        """[d_model, vocab_padded]: ``head.w``, or ``embed.emb.T`` when
        tied."""
        return self.embed.emb.T if self.head is None else self.head.w


MODEL = LM                        # the class a reference checkpoint fills


def init(cfg: ArchConfig, *, seed: int = 0, dtype=torch.bfloat16,
         device=None) -> LM:
    """A model with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return LM(cfg, generator=gen, device=dev, dtype=dtype).eval()


def _embed(model: LM, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows times sqrt(d_model), rounded to f32 and then to the
    activation type as the reference rounds it; a 0-d CPU tensor is a
    kernel argument, not a copy to the device."""
    x = model.embed(ids)
    scale = torch.tensor(math.sqrt(model.cfg.d_model), dtype=torch.float32)
    return x * scale.to(x.dtype)


def _run(model: LM, x, positions, *, caches=None, impl: str):
    """The block stack over x [B,S,d]; ``positions`` [S] are the tokens'
    global positions; ``caches`` the decode state, written in place."""
    cfg = model.cfg
    cos, sin = rope_freqs(positions, cfg.hd, cfg.rope_theta)
    for i, (blk, window) in enumerate(zip(model.blocks, cfg.windows())):
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i],
                     "idx": caches["idx"]}
        x, _ = blk(x, cos=cos, sin=sin, window=window, cache=cache,
                   impl=impl)
    if caches is not None:
        caches["idx"] += x.shape[1]
    return x


def _logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    return model.ln_f(x) @ model.head_w()


@torch.no_grad()
def forward(model: LM, batch: dict, *, impl: str = "kernel") -> torch.Tensor:
    """Teacher-forced logits [B, S, vocab_padded] for ``batch["tokens"]``
    [B, S]."""
    ids = batch["tokens"]
    x = _embed(model, ids)
    positions = torch.arange(ids.shape[1], device=ids.device)
    return _logits(model, _run(model, x, positions, impl=impl))


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Per-layer KV caches ``{"k", "v": [L, B, T, Hkv, hd] zeros, "idx":
    0}``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "idx": 0}


@torch.no_grad()
def prefill(model: LM, batch: dict, max_len: int, *, impl: str = "kernel",
            cache_dtype=torch.bfloat16):
    """Process the prompt ``batch["tokens"]`` [B, S]: ``(logits of the last
    token [B, 1, vocab_padded], filled decode state)``."""
    ids = batch["tokens"]
    B, S = ids.shape
    state = init_decode_state(model.cfg, B, max_len, dtype=cache_dtype,
                              device=ids.device)
    x = _run(model, _embed(model, ids), torch.arange(S, device=ids.device),
             caches=state, impl=impl)
    return _logits(model, x[:, -1:]), state


@torch.no_grad()
def decode_step(model: LM, state: dict, batch: dict, *,
                impl: str = "kernel"):
    """One decode step for ``batch["tokens"]`` [B, 1] at position
    ``state["idx"]``: ``(logits [B, 1, vocab_padded], state)``; the state is
    updated in place."""
    ids = batch["tokens"]
    pos = torch.arange(ids.shape[1], device=ids.device) + state["idx"]
    x = _run(model, _embed(model, ids), pos, caches=state, impl=impl)
    return _logits(model, x), state
