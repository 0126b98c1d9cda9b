"""Generic decoder-only LM for the dense, MoE and VLM-backbone families
(port of ``repro.models.lm``).

One pre-norm block per layer, run by a Python loop (the reference scans
over stacked parameters): GQA (+ qk-norm, QKV bias), per-layer sliding
windows, a SwiGLU MLP or a top-k mixture of experts (``nn.moe``: qwen3_moe,
grok1), standard RoPE or Qwen2-VL's M-RoPE, tied or untied embeddings, and
the stubbed modality frontend of ``embed_inputs`` configs: the batch
carries precomputed embeddings ``batch["embeds"]`` [B, S, d], taken as
they are (no ``sqrt(d)`` scale, which only token embeddings get), and
optionally the M-RoPE position grid ``batch["pos_thw"]`` [3, B, S]
(temporal, height, width ids; text-only batches leave it out and all three
ids are the token positions).  The model is an ``nn.Module`` whose
parameter names follow the reference's pytree paths with the layer index
spelled out (``blocks.3.attn.q.w`` for row 3 of ``blocks/attn/q/w``,
``blocks.3.moe.gate`` for ``blocks/moe/gate``).

Entry points: :func:`init`, :func:`forward` (teacher-forced logits),
:func:`forward_aux` (the logits and the MoE layers' summed Switch aux loss,
the reference ``forward``'s two outputs), :func:`loss_fn` (next-token CE
through the chunked ``fused_linear_ce``, plus ``aux_weight * aux /
n_layers``; differentiable), :func:`init_decode_state`, :func:`prefill`
(fill the KV caches from a prompt) and :func:`decode_step` (one token, or
one embedding), each one root span of ``runtime.obs`` (``lm.prefill``,
``lm.decode_step``, with B and S).  ``impl="kernel"`` (the default of every entry point
but :func:`loss_fn`) sends each layer's uncached attention to
``flash_attention`` and each single-token decode to ``flash_decode``;
``impl="dense"`` is the reference's ``impl="xla"`` (see ``nn.attention``)
and :func:`loss_fn`'s default, as ``"xla"`` is the reference's: the
kernels have no backward and refuse inputs that require grad.  The kernels take q, k and v of one type, so on the
card ``impl="kernel"`` decodes need the cache in the parameters' type (the
defaults, bf16 and bf16, agree).  The decode state is ``{"k", "v": [L, B,
T, Hkv, hd], "idx": int}``, written in place; its write index is a Python
int, so a decode step makes no host sync.

The port-only DeepSeek-V3 stack (``moonlight_16b_a3b``, a config with
``kv_lora_rank``) runs the same entry points: every block's attention is
latent (``nn.mla.MLA``), the first ``first_dense`` blocks carry a dense
SwiGLU of ``dense_d_ff`` and the rest the dropless MoE with the sigmoid
router and shared experts (``nn.moe.moe_dropless``), every norm takes
``cfg.norm_eps``, and the decode state is the latent cache ``{"ckv": [L,
B, T, kv_lora_rank], "kpe": [L, B, T, qk_rope_head_dim], "idx": int}``.
Latent attention runs ``attend``'s dense math under either ``impl``: no
kernel of the port takes its unequal q/k and v head dims.  Neither latent attention nor the sigmoid router has a tensor-parallel
plan: :func:`init` refuses a shard, and their layers raise under a
'model' axis.

Tensor parallelism (``distributed.tp``): a model built with a
``tp.Keep`` (``init(shard=...)``) holds one rank's 'model' shard of each
leaf, cut block by block as it is built from the one-device draw; under
an ambient ``tp.Parallel`` (``launch.steps``) the layers run their
shards, the logits are all-gathered over the vocab (``tp.logits``), the
loss is the vocab-parallel CE, and a decode cache holds the rank's share
of the positions (``tp.cache_len``) with every kv-head.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..configs import ArchConfig
from ..distributed import tp
from ..nn import (MHA, MLA, MLP, Block, Dense, Embedding, MoE,
                  fused_linear_ce, make_norm, moe_apply, mrope_freqs,
                  rope_freqs)
from ..nn.transformer import remat_call
from ..runtime import obs

__all__ = ["LM", "MoEBlock", "MODEL", "init", "forward", "forward_aux",
           "loss_fn", "init_decode_state", "prefill", "decode_step"]


class MoEBlock(nn.Module):
    """``x + attn(norm1(x))``, then ``+ moe(norm2(x))``; returns the
    layer's aux loss beside ``(x, cache)``.  The attention is latent
    (``MLA``) for a config with ``kv_lora_rank``; a ``dense`` block (one of
    the stack's first ``first_dense``) has ``mlp``, a SwiGLU of
    ``dense_d_ff``, in the MoE's place and an aux loss of 0."""

    def __init__(self, cfg: ArchConfig, *, dense: bool = False,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        nk = dict(eps=cfg.norm_eps, device=device, dtype=dtype)
        self.top_k, self.capacity_factor = cfg.moe_top_k, cfg.capacity_factor
        self.routed_scale = cfg.routed_scale
        self.ln1 = make_norm(cfg.norm, cfg.d_model, **nk)
        if cfg.mla:
            self.attn = MLA(cfg.d_model, n_heads=cfg.n_heads,
                            kv_lora_rank=cfg.kv_lora_rank,
                            qk_nope_head_dim=cfg.qk_nope_head_dim,
                            qk_rope_head_dim=cfg.qk_rope_head_dim,
                            v_head_dim=cfg.v_head_dim, **kw)
        else:
            self.attn = MHA(cfg.d_model, n_heads=cfg.n_heads,
                            head_dim=cfg.hd, kv_heads=cfg.kv_heads,
                            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                            norm_eps=cfg.norm_eps, **kw)
        self.ln2 = make_norm(cfg.norm, cfg.d_model, **nk)
        self.mlp = self.moe = None
        if dense:
            self.mlp = MLP(cfg.d_model, cfg.dense_d_ff, **kw)
        else:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts,
                           router=cfg.router, n_shared=cfg.n_shared_experts,
                           **kw)

    def forward(self, x, *, cos=None, sin=None, window: int = -1,
                cache=None, impl: str = "dense"):
        h, cache = self.attn(self.ln1(x), cos=cos, sin=sin, window=window,
                             cache=cache, impl=impl)
        x = x + h
        if self.mlp is not None:
            return (x + self.mlp(self.ln2(x)), cache,
                    torch.zeros((), dtype=torch.float32, device=x.device))
        h, aux = moe_apply(self.moe, self.ln2(x), top_k=self.top_k,
                           capacity_factor=self.capacity_factor,
                           routed_scale=self.routed_scale)
        return x + h, cache, aux


class LM(nn.Module):
    """The decoder-only LM; ``cfg`` fixes its shapes."""

    def __init__(self, cfg: ArchConfig, *, generator=None, device=None,
                 dtype=torch.bfloat16, keep=tp.keep_all):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = keep("embed", Embedding(cfg.vocab_padded, cfg.d_model,
                                             **kw))

        def block(i):
            if cfg.n_experts:
                return MoEBlock(cfg, dense=i < cfg.first_dense, **kw)
            return Block(cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.hd,
                         d_ff=cfg.d_ff, kv_heads=cfg.kv_heads,
                         mlp_kind=cfg.mlp_kind, norm=cfg.norm,
                         qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                         norm_eps=cfg.norm_eps, **kw)
        self.blocks = nn.ModuleList(keep(f"blocks/{i}", block(i))
                                    for i in range(cfg.n_layers))
        self.ln_f = make_norm(cfg.norm, cfg.d_model, eps=cfg.norm_eps,
                              device=device, dtype=dtype)
        self.head = (None if cfg.tie_embeddings else keep("head", Dense(
            cfg.d_model, cfg.vocab_padded, bias=False, **kw)))

    def head_w(self) -> torch.Tensor:
        """[d_model, vocab_padded]: ``head.w``, or ``embed.emb.T`` when
        tied."""
        return self.embed.emb.T if self.head is None else self.head.w


MODEL = LM                        # the class a reference checkpoint fills


def init(cfg: ArchConfig, *, seed: int = 0, dtype=torch.bfloat16,
         device=None, shard: tp.Keep | None = None) -> LM:
    """A model with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``cuda`` unless given); with ``shard``, one
    rank's 'model' shard of the same draw."""
    if shard is not None and (cfg.mla or cfg.router != "softmax"):
        raise NotImplementedError(f"{cfg.name}: latent attention and the "
                                  "sigmoid router have no tensor-parallel "
                                  "plan")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return LM(cfg, generator=gen, device=dev, dtype=dtype,
                  keep=shard or tp.keep_all).eval()


def _inputs(model: LM, batch: dict) -> torch.Tensor:
    """The first layer's input [B, S, d]: the batch's embeddings for an
    ``embed_inputs`` config, else the token embeddings times sqrt(d_model),
    rounded to f32 and then to the activation type as the reference rounds
    it (a 0-d CPU tensor is a kernel argument, not a copy to the device)."""
    if model.cfg.embed_inputs:
        return batch["embeds"]
    x = model.embed(batch["tokens"])
    scale = torch.tensor(math.sqrt(model.cfg.d_model), dtype=torch.float32)
    return x * scale.to(x.dtype)


def _rope_tables(cfg: ArchConfig, batch: dict, positions: torch.Tensor):
    """cos/sin [S, hd/2] (or [B, S, hd/2] from a ``pos_thw`` grid) for the
    global ``positions`` [S]; M-RoPE when the config has sections."""
    if cfg.mrope_sections is None:
        return rope_freqs(positions, cfg.rope_dim, cfg.rope_theta)
    pos_thw = batch.get("pos_thw")
    if pos_thw is None:                   # text only: the three ids agree
        pos_thw = positions.expand(3, positions.shape[0])
    return mrope_freqs(pos_thw, cfg.hd, cfg.mrope_sections, cfg.rope_theta)


def _run(model: LM, x, cos, sin, *, caches=None, impl: str,
         remat: str = "none"):
    """The block stack over x [B,S,d] -> (x, summed MoE aux loss, f32);
    ``caches`` the decode state, written in place."""
    cfg = model.cfg
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (blk, window) in enumerate(zip(model.blocks, cfg.windows())):
        cache = None
        if caches is not None:
            cache = {k: (v if k == "idx" else v[i])
                     for k, v in caches.items()}
        if cfg.n_experts:
            x, _, aux_l = remat_call(blk, x, cos=cos, sin=sin,
                                     window=window, cache=cache, impl=impl,
                                     remat=remat)
            aux = aux + aux_l
        else:
            x, _ = remat_call(blk, x, cos=cos, sin=sin, window=window,
                              cache=cache, impl=impl, remat=remat)
    if caches is not None:
        caches["idx"] += x.shape[1]
    return x, aux


def _hidden(model: LM, batch: dict, impl: str, remat: str = "none"):
    """Final hidden states before ``ln_f`` [B,S,d] and the aux loss."""
    x = _inputs(model, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = _rope_tables(model.cfg, batch, positions)
    return _run(model, x, cos, sin, impl=impl, remat=remat)


def _logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    return tp.logits(model.ln_f(x), model.head_w(), model.cfg.vocab_padded)


@torch.no_grad()
def forward_aux(model: LM, batch: dict, *, impl: str = "kernel"):
    """``(logits [B, S, vocab_padded], aux)``: the reference ``forward``'s
    outputs, ``aux`` the MoE layers' summed load-balancing loss (0 for a
    dense config)."""
    x, aux = _hidden(model, batch, impl)
    return _logits(model, x), aux


def forward(model: LM, batch: dict, *, impl: str = "kernel") -> torch.Tensor:
    """Teacher-forced logits [B, S, vocab_padded] for ``batch["tokens"]``
    [B, S] (or ``batch["embeds"]`` [B, S, d])."""
    return forward_aux(model, batch, impl=impl)[0]


def loss_fn(model: LM, batch: dict, *, impl: str = "dense",
            remat: str = "none", aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token CE against ``batch["labels"]`` [B, S] plus
    ``aux_weight * aux / n_layers``, with gradients; ``remat`` as
    ``nn.transformer.remat_call``'s."""
    x, aux = _hidden(model, batch, impl, remat)
    ce = fused_linear_ce(model.ln_f(x), model.head_w(), batch["labels"],
                         vocab=model.cfg.vocab_padded)
    return ce + aux_weight * aux / max(model.cfg.n_layers, 1)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Per-layer KV caches ``{"k", "v": [L, B, T, Hkv, hd] zeros, "idx":
    0}``, T this rank's share of ``max_len`` (``tp.cache_len``); for a
    latent-attention config the latent caches ``{"ckv": [L, B, T,
    kv_lora_rank], "kpe": [L, B, T, qk_rope_head_dim], "idx": 0}``."""
    dev = resolve_device(device)
    if cfg.mla:
        lead = (cfg.n_layers, batch, max_len)
        return {"ckv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype,
                                   device=dev),
                "kpe": torch.zeros(lead + (cfg.qk_rope_head_dim,),
                                   dtype=dtype, device=dev),
                "idx": 0}
    shape = (cfg.n_layers, batch, tp.cache_len(max_len), cfg.kv_heads,
             cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "idx": 0}


@torch.no_grad()
def prefill(model: LM, batch: dict, max_len: int, *, impl: str = "kernel",
            cache_dtype=torch.bfloat16):
    """Process the prompt (``batch["tokens"]`` [B, S] or ``"embeds"``):
    ``(logits of the last position [B, 1, vocab_padded], filled decode
    state)``."""
    B, S = _batch_shape(model, batch)
    with obs.span("lm.prefill", B=B, S=S):
        x = _inputs(model, batch)
        state = init_decode_state(model.cfg, B, max_len, dtype=cache_dtype,
                                  device=x.device)
        cos, sin = _rope_tables(model.cfg, batch,
                                torch.arange(S, device=x.device))
        x, _ = _run(model, x, cos, sin, caches=state, impl=impl)
        return _logits(model, x[:, -1:]), state


@torch.no_grad()
def decode_step(model: LM, state: dict, batch: dict, *,
                impl: str = "kernel"):
    """One decode step for ``batch["tokens"]`` [B, 1] (or ``"embeds"`` [B,
    1, d]) at position ``state["idx"]``: ``(logits [B, 1, vocab_padded],
    state)``; the state is updated in place."""
    B, S = _batch_shape(model, batch)
    with obs.span("lm.decode_step", B=B, S=S):
        x = _inputs(model, batch)
        pos = torch.arange(x.shape[1], device=x.device) + state["idx"]
        cos, sin = _rope_tables(model.cfg, batch, pos)
        x, _ = _run(model, x, cos, sin, caches=state, impl=impl)
        return _logits(model, x), state


def _batch_shape(model: LM, batch: dict) -> tuple[int, int]:
    """(B, S) of the batch's tokens [B, S] (embeddings [B, S, d] for an
    ``embed_inputs`` config)."""
    x = batch["embeds"] if model.cfg.embed_inputs else batch["tokens"]
    return int(x.shape[0]), int(x.shape[1])
