"""Multi-head latent attention (DeepSeek-V2 MLA, arXiv:2405.04434 §2.1),
without q-LoRA, as DeepSeek-V3 and Moonlight-16B-A3B publish it.

For the layer's normed input ``h`` [B, S, d] and ``H`` heads:

- ``q = h W_q`` [B, S, H, nope + rope], split into ``q_nope`` and ``q_pe``;
- ``[c_kv | k_pe] = h W_kva`` (``kv_lora_rank + rope`` wide), then
  ``c_kv = RMSNorm_kv(c_kv)`` (eps 1e-6, the published modeling code's
  ``kv_a_layernorm``, which takes the norm's default and not the config's
  ``rms_norm_eps``);
- RoPE turns ``q_pe`` and the one ``k_pe`` that every head shares (the
  port's half-split ``apply_rope``);
- ``[k_nope | v] = c_kv W_kvb`` [B, S, H, nope + v]; head ``h``'s key is
  ``[k_nope | k_pe]``, its query ``[q_nope | q_pe]``, scores scaled by
  ``1 / sqrt(nope + rope)`` under a causal softmax, and ``o = W_o
  concat_h(p v)``.

The decode cache holds only the latent: ``{"ckv": [B, T, kv_lora_rank],
"kpe": [B, T, rope], "idx"}`` (the normed ``c_kv`` and the roped ``k_pe``,
``kv_lora_rank + rope`` values a token), never a per-head K or V; each
write adds its bytes to the counter ``mla.latent_bytes``.

- A prefill (write index 0, or no cache) up-projects its own prompt's
  latent to per-head keys and values and attends them through
  ``nn.attention.attend`` (q/k head dim 192, v 128 at Moonlight's widths).
- A later step (``idx > 0``: decode, or an append) attends the latent
  cache in the **absorbed** form of DeepSeek-V2 §2.1.2: ``W_kvb``'s key
  half is folded into the query (``q_lat = q_nope W_kb^T``, ``r`` wide per
  head), every head attends the one shared key ``[c_kv | k_pe]`` and value
  ``c_kv`` (multi-query attention through ``attend``, the query in f32
  and scaled so that ``attend``'s ``1/sqrt(r + rope)`` gives the layer's
  ``1/sqrt(nope + rope)``), and the value half of ``W_kvb`` maps each
  head's latent output to its ``v`` dims.  The cache is never expanded.

The route is chosen here, by the input's shape and type, never by a
fallback inside ``attend``:

- the prompt passes the caller's ``impl`` on where the attention kernel
  for q's type takes its (q/k, v) head dims
  (``kernels.flash_attention.HEAD_DIMS``): at Moonlight's widths in bf16,
  ``impl="kernel"`` runs ``flash_attention``'s (192, 128) instance, q, k
  and v in bf16, both products summed in f32, the softmax in f32 and P
  rounded once to bf16 before P V, as the published modeling code casts
  the softmax weights to the query's type; where no kernel takes them
  (the tests' small widths, or f32 at Moonlight's) it asks for the dense
  math (``impl="dense"``: masked softmax in f32, chunked over query
  blocks);
- the absorbed form always asks for the dense math: no kernel takes its
  576 and 512 (``attend(impl="kernel")`` refuses such a call).

``MLA.forward`` runs in an ``nn/mla`` span.  There is no tensor-parallel
plan: under a 'model' or sequence axis above 1 the layer raises.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..distributed import tp
from ..kernels import flash_attention as _fa
from ..runtime import obs
from .attention import IMPLS, attend
from .linear import Dense
from .norms import RMSNorm
from .rope import apply_rope

__all__ = ["MLA"]


class MLA(nn.Module):
    """Latent attention with weights ``q.w`` [d, H (nope + rope)],
    ``kva.w`` [d, r + rope], ``kvn.g`` [r], ``kvb.w`` [r, H (nope + v)] and
    ``o.w`` [H v, d] (``r`` = ``kv_lora_rank``)."""

    def __init__(self, d_model: int, *, n_heads: int, kv_lora_rank: int,
                 qk_nope_head_dim: int, qk_rope_head_dim: int,
                 v_head_dim: int, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        H, r = n_heads, kv_lora_rank
        self.n_heads, self.r = H, r
        self.nope, self.rope, self.vd = (qk_nope_head_dim, qk_rope_head_dim,
                                         v_head_dim)
        kw = dict(bias=False, generator=generator, device=device,
                  dtype=dtype)
        self.q = Dense(d_model, H * (self.nope + self.rope), **kw)
        self.kva = Dense(d_model, r + self.rope, **kw)
        self.kvn = RMSNorm(r, device=device, dtype=dtype)
        self.kvb = Dense(r, H * (self.nope + self.vd), **kw)
        self.o = Dense(H * self.vd, d_model, **kw)

    def forward(self, x: torch.Tensor, *, cos=None, sin=None,
                causal: bool = True, window: int = -1,
                cache: dict | None = None, impl: str = "dense"):
        """Returns ``(out [B, S, d], cache)``; with ``cache``, ``x`` holds
        the new tokens, whose latent is written at ``cache["idx"]``.
        ``impl`` reaches the prompt's attention where a kernel takes it
        (module docstring)."""
        if impl not in IMPLS:
            raise ValueError(f"MLA: impl must be one of {IMPLS}, got "
                             f"{impl!r}")
        par = tp.current()
        if tp.tp_axis() is not None or getattr(par, "seq", None) is not None:
            raise NotImplementedError("latent attention (MLA) has no "
                                      "tensor- or sequence-parallel plan")
        if not causal or window != -1:
            raise ValueError("latent attention is causal over the whole "
                             f"sequence (causal {causal}, window {window})")
        with obs.span("nn/mla"):
            B, S, _ = x.shape
            H, r = self.n_heads, self.r
            q = self.q(x).reshape(B, S, H, self.nope + self.rope)
            kva = self.kva(x)
            c_kv = self.kvn(kva[..., :r])
            # one rotation for every head's q_pe and the shared k_pe
            pe = apply_rope(torch.cat([q[..., self.nope:], kva[..., None, r:]],
                                      dim=2), cos, sin)
            q_nope, q_pe, k_pe = q[..., :self.nope], pe[:, :, :H], \
                pe[:, :, H:]                               # k_pe [B,S,1,rope]
            idx = 0
            if cache is not None:
                idx = cache["idx"]
                T = cache["ckv"].shape[1]
                if idx + S > T:
                    raise ValueError(f"latent cache of length {T} cannot "
                                     f"take {S} tokens at {idx}")
                cache["ckv"][:, idx:idx + S] = c_kv.to(cache["ckv"].dtype)
                cache["kpe"][:, idx:idx + S] = k_pe[:, :, 0].to(
                    cache["kpe"].dtype)
                cache["idx"] = idx + S
                obs.count("mla.latent_bytes", B * S * (
                    r * cache["ckv"].element_size()
                    + self.rope * cache["kpe"].element_size()))
            if idx == 0:
                out = self._prompt(q_nope, q_pe, c_kv, k_pe, impl)
            else:
                out = self._absorbed(q_nope, q_pe, cache, idx + S)
            return self.o(out.to(x.dtype)), cache

    def _prompt(self, q_nope, q_pe, c_kv, k_pe, impl):
        """The prompt's own keys and values, up-projected -> [B, S, H v];
        ``impl`` kept where the kernel for q's type takes the head dims,
        else the dense math."""
        B, S, H, _ = q_nope.shape
        kv = self.kvb(c_kv).reshape(B, S, H, self.nope + self.vd)
        k_nope, v = kv.split([self.nope, self.vd], dim=-1)   # v: a view
        k = torch.cat([k_nope, k_pe.expand(B, S, H, self.rope)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        if (self.nope + self.rope, self.vd) not in _fa.HEAD_DIMS.get(
                q.dtype, ()):
            impl = "dense"
        return attend(q, k, v, causal=True, impl=impl)

    def _absorbed(self, q_nope, q_pe, cache, T):
        """The absorbed form over the first ``T`` cached positions (the new
        tokens the last of them) -> [B, S, H v]."""
        B, S, H, _ = q_nope.shape
        w = self.kvb.w.reshape(self.r, H, self.nope + self.vd)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w[..., :self.nope])
        scale = math.sqrt((self.r + self.rope) / (self.nope + self.rope))
        qa = torch.cat([q_lat.float(), q_pe.float()], dim=-1) * scale
        ckv = cache["ckv"][:, :T]
        ka = torch.cat([ckv, cache["kpe"][:, :T]], dim=-1)[:, :, None]
        o_lat = attend(qa, ka, ckv[:, :, None], causal=True,
                       q_offset=T - S, kv_len=T, impl="dense")
        o = torch.einsum("bshr,rhv->bshv",
                         o_lat.reshape(B, S, H, self.r).to(w.dtype),
                         w[..., self.nope:])
        return o.reshape(B, S, H * self.vd)
