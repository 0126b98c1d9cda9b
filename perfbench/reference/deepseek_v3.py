"""The plain reference of the DeepSeek-V3 block (Moonlight-16B-A3B): the
forward in float32, with TF32 off, over the benchmark's own weights, giving
the logits of each prompt's last position.

It follows the published block (hf:moonshotai/Moonlight-16B-A3B,
``model_type`` deepseek_v3, and its modeling code), layer by layer:
``u = h + MLA(RMSNorm(h))``, then ``u + FFN(RMSNorm(u))``:

- latent attention with no q-LoRA: ``q = x W_q`` split into ``q_nope``
  (``qk_nope_head_dim``) and ``q_pe`` (``qk_rope_head_dim``); ``[c_kv |
  k_pe] = x W_kva``, ``c_kv`` through the latent RMSNorm (eps 1e-6, the
  modeling code's ``kv_a_layernorm``); ``[k_nope | v] = c_kv W_kvb`` per
  head; RoPE on ``q_pe`` and the one shared ``k_pe``; each head's key
  ``[k_nope | k_pe]``, scores over ``sqrt(qk_nope + qk_rope)``, causal
  softmax, ``o = concat_h(p v) W_o``;
- the first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``; the rest an MoE: ``s = sigmoid(x W_r)`` in f32,
  the top ``num_experts_per_tok`` of ``s + b`` (``b`` the selection bias;
  ``n_group`` = ``topk_group`` = 1, so no group limit), weights ``s_i /
  (sum of the chosen s + 1e-20) * routed_scaling_factor`` from the
  unbiased ``s``, ``y = sum_i w_i E_i(x) + S(x)``, each routed expert a
  SwiGLU of ``moe_intermediate_size`` run on the tokens that chose it (a
  mask per expert), ``S`` one SwiGLU of ``n_shared_experts *
  moe_intermediate_size``; no token dropped;
- a final RMSNorm and the untied head; block norms take ``rms_norm_eps``.

Where the configuration's ``port_departures`` says so it follows the
port's conventions: token embeddings times sqrt(hidden_size), and RoPE
over the two halves of the rope dims (not interleaved pairs, a fixed
permutation of the rope columns of W_q and W_kva).  The vocabulary is the
published one.  It imports nothing of the program.

Memory: attention runs over blocks of ``q_block`` query rows, the FFN over
blocks of ``row_block`` positions, and each layer's weights are converted
to f32 one layer at a time; the last layer computes its attention and FFN
for the last position only.

``prec`` says how the operands of every weight product (``x @ w``, ``w``
the bf16 weight) are taken: :data:`F32`, the reference's, converts ``w``
to f32; :data:`FP8`, the control's, rounds ``w`` to float8 e4m3 with a
scale per output column and ``x`` with a scale per row, then multiplies
in f32.

Weights ``W`` (``drivers/lm_prefill_mla.make_weights``' layout): ``embed``
[V', d], ``head`` [d, V'], ``ln_f`` [d]; over all layers ``ln1``, ``ln2``
[L, d], ``q`` [L, d, H (nope + rope)], ``kva`` [L, d, r + rope], ``kvn``
[L, r], ``kvb`` [L, r, H (nope + v)], ``o`` [L, H v, d]; over the dense
layers ``dense_gate``, ``dense_up`` [Ld, d, F], ``dense_down`` [Ld, F, d];
over the MoE layers ``router`` [Lm, d, E], ``bias`` [Lm, E], ``gate``,
``up`` [Lm, E, d, f], ``down`` [Lm, E, f, d], ``shared_gate``,
``shared_up`` [Lm, d, n_shared f], ``shared_down`` [Lm, n_shared f, d].
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["last_logits", "mla", "moe", "router_gap", "Precision", "F32",
           "FP8", "no_tf32", "LATENT_EPS"]

FP8_MAX = 448.0                 # the largest finite float8 e4m3 number
LATENT_EPS = 1e-6               # kv_a_layernorm: the RMSNorm's default


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision(NamedTuple):
    weight: Callable     # bf16 weight [..., d_in, d_out] -> f32 operand
    act: Callable        # f32 activation [..., d_in] -> f32 operand


F32 = Precision(lambda w: w.float(), lambda x: x)
FP8 = Precision(lambda w: _fp8(w.float(), -2), lambda x: _fp8(x, -1))


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.square(x).mean(-1, keepdim=True) + eps) \
        * g.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, R, heads, n] turned by cos/sin [R, n/2], halves paired."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attend(q, k, v, rows, q_block: int):
    """Causal attention of q [B, R, H, dq] at global positions ``rows`` [R]
    over k [B, T, H, dq] and v [B, T, H, dv] -> [B, R, H * dv]."""
    B, R, H, dq = q.shape
    out = []
    for r0 in range(0, R, q_block):
        qi = q[:, r0:r0 + q_block]
        pos = rows[r0:r0 + q_block]
        end = int(pos[-1]) + 1
        s = torch.einsum("bshd,bthd->bhst", qi, k[:, :end]) / math.sqrt(dq)
        seen = torch.arange(end, device=q.device)[None, :] <= pos[:, None]
        p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
        out.append(torch.einsum("bhst,bthd->bshd", p, v[:, :end])
                   .reshape(B, qi.shape[1], -1))
        del s, p
    return torch.cat(out, dim=1)


def _swiglu(x, gate, up, down, gemm):
    return gemm(F.silu(gemm(x, gate)) * gemm(x, up), down)


@torch.no_grad()
def router_gap(x, router, bias, idx) -> float:
    """How far below the k-th selection score ``s + b`` that the router
    gives in f32 (TF32 off) on x [N, d], ``router`` [d, E] and ``bias``
    [E] taken in f32, the chosen experts idx [N, k] lie at most, in score
    units: 0 where they are its top k."""
    with no_tf32():
        pick = torch.sigmoid(x.float() @ router.float()) + bias.float()
        kth = torch.topk(pick, idx.shape[-1], dim=-1).values[:, -1:]
        return float((kth - pick.gather(-1, idx)).max().clamp_min(0))


def moe(x, w, cfg, gemm, follow=None, stats: dict | None = None):
    """The MoE over x [N, d] with one layer's weights ``w`` (operands as
    ``gemm`` takes them: ``router``, ``gate``, ``up``, ``down``,
    ``shared_*``; ``bias``; ``router_f32``, the router in f32) -> [N, d].
    It routes each token to the top k of its selection scores ``s + b``,
    or, with ``follow`` [N, k], to those experts; ``stats`` (see
    :func:`last_logits`) gathers how far they lie from its own, and,
    routing by its own scores, how far its choices lie from those of the
    f32 router on the same x (:func:`router_gap`)."""
    k = cfg["num_experts_per_tok"]
    s = torch.sigmoid(gemm(x, w["router"]))
    pick = s + w["bias"].float()
    own = torch.topk(pick, k, dim=-1)
    idx = own.indices if follow is None else follow
    if stats is not None:
        gap = own.values[:, -1:] - pick.gather(-1, idx)
        stats["route_gap"] = max(stats.get("route_gap", 0.0),
                                 float(gap.max().clamp_min(0)))
        off = (idx[:, :, None] != own.indices[:, None, :]).all(-1)
        stats["flips"] = stats.get("flips", 0) + int(off.sum())
        stats["choices"] = stats.get("choices", 0) + idx.numel()
        if follow is None:
            stats["router_gap"] = max(stats.get("router_gap", 0.0),
                                      router_gap(x, w["router_f32"],
                                                 w["bias"], idx))
    top = s.gather(-1, idx)
    wt = top / (top.sum(-1, keepdim=True) + 1e-20) \
        * float(cfg["routed_scaling_factor"])
    y = _swiglu(x, w["shared_gate"], w["shared_up"], w["shared_down"], gemm)
    for e in range(cfg["n_routed_experts"]):
        mask = idx == e                                  # [N, k]
        rows = mask.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        we = (wt * mask).sum(-1)[rows]
        y[rows] += we[:, None] * _swiglu(x[rows], w["gate"][e], w["up"][e],
                                         w["down"][e], gemm)
    return y, idx


def mla(h, w, kvn, cfg, cos, sin, rows, gemm, q_block: int = 256):
    """Latent attention of one layer: h [B, S, d] the normed input, ``w``
    its f32 operands (``q``, ``kva``, ``kvb``, ``o``), ``kvn`` the latent
    norm's gain, cos/sin [S, rope/2]; the output [B, len(rows), d] of the
    queries at positions ``rows`` over every position's keys."""
    B, S, _ = h.shape
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    kva = gemm(h, w["kva"])
    c = _rms(kva[..., :r], kvn, LATENT_EPS)
    kpe = _rope(kva[..., None, r:], cos, sin)               # [B, S, 1, rope]
    kv = gemm(c, w["kvb"]).reshape(B, S, H, nope + vd)
    k = torch.cat([kv[..., :nope], kpe.expand(B, S, H, rope)], dim=-1)
    v = kv[..., nope:]
    del kva, c, kpe, kv
    q = gemm(h[:, rows], w["q"]).reshape(B, -1, H, nope + rope)
    q = torch.cat([q[..., :nope],
                   _rope(q[..., nope:], cos[rows], sin[rows])], dim=-1)
    return gemm(_attend(q, k, v, rows, q_block), w["o"])


@torch.no_grad()
def last_logits(W: dict, tokens: torch.Tensor, cfg: dict, *,
                prec: Precision = F32, q_block: int = 256,
                row_block: int = 8192, follow: list | None = None,
                stats: dict | None = None):
    """Logits [B, vocab_size] (f32) of the last position of ``tokens``
    [B, S], from the weights ``W`` (module docstring).

    ``follow``, a list of each MoE layer's chosen experts [B, S, k] (the
    program's), routes every token to those experts (the weights still the
    reference's own unbiased scores there): a routing choice at a near-tie
    that the program's rounding decides the other way, upstream of the
    last position, would otherwise send the two forwards apart.  ``stats``,
    a dict, gathers ``route_gap``: the largest amount by which a followed
    choice's selection score ``s + b`` lies below the reference's own k-th
    (0 where it routes alike); ``flips`` and ``choices``: the followed
    choices outside the reference's own top k, and all of them;
    ``chosen``: each MoE layer's choices [B, S', k] (S' = 1 in the last
    layer, which computes the last position only); and, without
    ``follow``, ``router_gap``: :func:`router_gap` of its own choices on
    its own MoE inputs (0 in f32; the control's router rounded to
    ``prec``)."""
    with no_tf32():
        return _forward(W, tokens, cfg, prec, q_block, row_block, follow,
                        stats)


def _forward(W, tokens, cfg, prec, q_block, row_block, follow,
             stats):
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    V, eps, Ld = (cfg["vocab_size"], cfg["rms_norm_eps"],
                  cfg["first_k_dense_replace"])
    if cfg["q_lora_rank"] is not None or cfg["n_group"] != 1 \
            or cfg["topk_group"] != 1 or cfg["scoring_func"] != "sigmoid":
        raise ValueError("the reference runs no q-LoRA, no expert groups "
                         "and the sigmoid router")
    B, S = tokens.shape
    dev = tokens.device
    scale = math.sqrt(d) if "embed_scale" in cfg.get("port_departures",
                                                      {}) else 1.0
    x = W["embed"][tokens].float() * scale
    half = cfg["qk_rope_head_dim"] // 2
    inv = 1.0 / (float(cfg["rope_theta"]) ** (
        torch.arange(half, dtype=torch.float32, device=dev) / half))
    ang = torch.arange(S, dtype=torch.float32, device=dev)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    rows = torch.arange(S, device=dev)

    def gemm(a, w):
        return prec.act(a) @ w

    for i in range(L):
        w = {n: prec.weight(W[n][i]) for n in ("q", "kva", "kvb", "o")}
        if i == L - 1:                      # only the last position goes on
            rows = rows[-1:]
        a = mla(_rms(x, W["ln1"][i], eps), w, W["kvn"][i], cfg, cos, sin,
                rows, gemm, q_block)
        x = x[:, rows] + a
        del a, w
        if i < Ld:
            w = {n: prec.weight(W["dense_" + n][i])
                 for n in ("gate", "up", "down")}
        else:
            j = i - Ld
            w = {n: prec.weight(W[n][j]) for n in (
                "router", "gate", "up", "down", "shared_gate", "shared_up",
                "shared_down")}
            w["bias"], w["router_f32"] = W["bias"][j], W["router"][j].float()
        chosen = []
        for r0 in range(0, x.shape[1], row_block):
            xb = x[:, r0:r0 + row_block]
            hb = _rms(xb, W["ln2"][i], eps).reshape(-1, d)
            if i < Ld:
                y = _swiglu(hb, w["gate"], w["up"], w["down"], gemm)
            else:
                given = None if follow is None else follow[i - Ld]
                if given is not None and given.shape[1] != x.shape[1]:
                    given = given[:, rows]          # the last layer's row
                if given is not None:
                    given = given[:, r0:r0 + row_block]
                y, idx = moe(hb, w, cfg, gemm,
                             None if given is None else
                             given.reshape(hb.shape[0], -1), stats)
                chosen.append(idx.reshape(B, xb.shape[1], -1))
            x[:, r0:r0 + row_block] = xb + y.reshape(xb.shape)
            del hb, y
        if stats is not None and chosen:
            stats.setdefault("chosen", []).append(torch.cat(chosen, 1))
        del w
    x = _rms(x[:, -1], W["ln_f"], eps)
    return gemm(x, prec.weight(W["head"][:, :V]))
