"""Whisper-style encoder-decoder backbone (port of
``repro.models.encdec``; arXiv:2212.04356).

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``batch["embeds"]`` [B, S, d] plus sinusoidal
positions, runs non-causal pre-norm blocks and a final LayerNorm into the
memory.  The decoder embeds ``batch["tokens"]`` with a token table ``tok``
and a learned position table ``pos`` (4104 rows), runs causal
self-attention, cross-attention to the memory and the MLP in each block,
a final LayerNorm, and ties its head to ``tok``.  The decoder's text is
``S // DEC_FRAC`` tokens long for an encoder input of S frames.

Entry points, with the signatures of ``models.lm``: :func:`init`,
:func:`forward`, :func:`loss_fn`, :func:`init_decode_state`,
:func:`prefill` (encode, then consume the decoder prompt) and
:func:`decode_step`.  With ``impl="kernel"`` the encoder's attention and
every cross-attention take ``flash_attention`` (non-causal; a decode
step's single query included, since cross-attention reads the memory
whole on every call, with no cache), and a decode step's self-attention
takes ``flash_decode``; a prefill's cache append takes the dense math.
The decode state is ``{"k", "v": [L, B, T, Hkv, hd], "idx": int,
"memory": [B, S_enc, d]}``; ``init_decode_state`` sizes the memory at
``max_len * DEC_FRAC`` frames, as the reference does, and ``prefill``
stores the encoder's output there.

Tensor parallelism as in ``models.lm``: both stacks run their shards, the
token and position tables are vocab-parallel, and the memory is whole on
every rank of 'model' (the plan shards it on the batch only).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..configs import ArchConfig
from ..distributed import tp
from ..nn import Block, Embedding, LayerNorm, fused_linear_ce
from ..nn.transformer import remat_call

__all__ = ["EncDec", "MODEL", "DEC_FRAC", "POS_ROWS", "init", "forward",
           "loss_fn", "init_decode_state", "prefill", "decode_step"]

DEC_FRAC = 8            # decoder_len = encoder seq_len // DEC_FRAC
POS_ROWS = 4096 + 8     # the decoder's learned positions


def _sinusoid(S: int, d: int, dtype, device) -> torch.Tensor:
    """[S, d]: sin then cos of pos / 10000^(2i/d), in f64 and cast."""
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, device=device).to(dtype)


class EncDec(nn.Module):
    """The encoder-decoder; ``cfg`` fixes its shapes."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None,
                 dtype=torch.bfloat16, keep=tp.keep_all):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)

        def block(cross):
            return Block(cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.hd,
                         d_ff=cfg.d_ff, kv_heads=cfg.kv_heads,
                         mlp_kind=cfg.mlp_kind, norm=cfg.norm,
                         cross_attn=cross, **kw)

        self.enc_blocks = nn.ModuleList(keep(f"enc_blocks/{i}", block(False))
                                        for i in range(cfg.encoder_layers))
        self.enc_ln = LayerNorm(cfg.d_model, device=device, dtype=dtype)
        self.tok = keep("tok", Embedding(cfg.vocab_padded, cfg.d_model, **kw))
        self.pos = keep("pos", Embedding(POS_ROWS, cfg.d_model, **kw))
        self.dec_blocks = nn.ModuleList(keep(f"dec_blocks/{i}", block(True))
                                        for i in range(cfg.n_layers))
        self.dec_ln = LayerNorm(cfg.d_model, device=device, dtype=dtype)


MODEL = EncDec                    # the class a reference checkpoint fills


def init(cfg: ArchConfig, *, seed: int = 0, dtype=torch.bfloat16,
         device=None, shard: tp.Keep | None = None) -> EncDec:
    """A model with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``cuda`` unless given); with ``shard``, one
    rank's 'model' shard of the same draw (``models.lm.init``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return EncDec(cfg, generator=gen, device=dev, dtype=dtype,
                   keep=shard or tp.keep_all).eval()


def _enc(model: EncDec, embeds: torch.Tensor, impl: str,
         remat: str = "none") -> torch.Tensor:
    """The encoder memory [B, S, d] of frame embeddings [B, S, d]."""
    x = embeds + _sinusoid(embeds.shape[1], model.cfg.d_model, embeds.dtype,
                           embeds.device)
    for blk in model.enc_blocks:
        x, _ = remat_call(blk, x, causal=False, impl=impl, remat=remat)
    return model.enc_ln(x)


def _dec(model: EncDec, tokens, memory, *, state=None, impl: str,
         remat: str = "none"):
    """The decoder's final hidden states [B, S, d] for ``tokens`` [B, S]
    at positions ``state["idx"] ..`` (0 without a state); the state's
    caches are written in place."""
    pos0 = 0 if state is None else state["idx"]
    S = tokens.shape[1]
    x = model.tok(tokens) + model.pos(torch.arange(pos0, pos0 + S,
                                                   device=tokens.device))
    for i, blk in enumerate(model.dec_blocks):
        cache = None
        if state is not None:
            cache = {"k": state["k"][i], "v": state["v"][i], "idx": pos0}
        x, _ = remat_call(blk, x, causal=True, memory=memory, cache=cache,
                          impl=impl, remat=remat)
    if state is not None:
        state["idx"] += S
    return model.dec_ln(x)


def _logits(model: EncDec, x: torch.Tensor) -> torch.Tensor:
    return tp.logits(x, model.tok.emb.T, model.cfg.vocab_padded)


@torch.no_grad()
def forward(model: EncDec, batch: dict, *,
            impl: str = "kernel") -> torch.Tensor:
    """Teacher-forced decoder logits [B, S_dec, vocab_padded] for
    ``batch["embeds"]`` [B, S, d] and ``batch["tokens"]`` [B, S_dec]."""
    memory = _enc(model, batch["embeds"], impl)
    return _logits(model, _dec(model, batch["tokens"], memory, impl=impl))


def loss_fn(model: EncDec, batch: dict, *, impl: str = "dense",
            remat: str = "none", aux_weight: float = 0.0) -> torch.Tensor:
    """Mean next-token CE of the decoder against ``batch["labels"]`` [B,
    S_dec], with gradients (``aux_weight`` unused, as in the reference;
    ``remat`` as ``nn.transformer.remat_call``'s)."""
    memory = _enc(model, batch["embeds"], impl, remat)
    x = _dec(model, batch["tokens"], memory, impl=impl, remat=remat)
    return fused_linear_ce(x, model.tok.emb.T, batch["labels"],
                           vocab=model.cfg.vocab_padded)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Zero self-attention KV caches [L, B, max_len, Hkv, hd] and a zero
    memory [B, max_len * DEC_FRAC, d]."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, tp.cache_len(max_len), cfg.kv_heads,
             cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "idx": 0,
            "memory": torch.zeros((batch, max_len * DEC_FRAC, cfg.d_model),
                                  dtype=dtype, device=dev)}


@torch.no_grad()
def prefill(model: EncDec, batch: dict, max_len: int, *,
            impl: str = "kernel", cache_dtype=torch.bfloat16):
    """Encode ``batch["embeds"]`` and consume the decoder prompt
    ``batch["tokens"]`` [B, S_dec]: ``(logits of its last position [B, 1,
    vocab_padded], decode state with the memory)``."""
    memory = _enc(model, batch["embeds"], impl)
    B = batch["tokens"].shape[0]
    shape = (model.cfg.n_layers, B, tp.cache_len(max_len),
             model.cfg.kv_heads, model.cfg.hd)
    state = {"k": torch.zeros(shape, dtype=cache_dtype, device=memory.device),
             "v": torch.zeros(shape, dtype=cache_dtype, device=memory.device),
             "idx": 0}
    x = _dec(model, batch["tokens"], memory, state=state, impl=impl)
    state["memory"] = memory.to(cache_dtype)
    return _logits(model, x[:, -1:]), state


@torch.no_grad()
def decode_step(model: EncDec, state: dict, batch: dict, *,
                impl: str = "kernel"):
    """One decoder step for ``batch["tokens"]`` [B, 1] against the state's
    memory: ``(logits [B, 1, vocab_padded], state)``, updated in place."""
    x = _dec(model, batch["tokens"], state["memory"], state=state, impl=impl)
    return _logits(model, x), state
