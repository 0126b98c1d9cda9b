"""The plain reference of the LM cells: a Qwen3 dense decoder's forward in
float32, with TF32 off, over the benchmark's own weights, giving the logits
of each prompt's last position.

It follows the published Qwen3 block (hf:Qwen/Qwen3-8B: pre-norm RMSNorm,
GQA with RMSNorm of each head's q and k before a half-split RoPE, causal
softmax attention scaled by 1/sqrt(head_dim), a SwiGLU MLP, no biases, a
final RMSNorm and an untied head) and, where the configuration's
``port_departures`` says so, the port's convention (token embeddings
times sqrt(hidden_size)); the vocabulary is the published one.  The
arithmetic follows the port's plain twins as of commit 0916888
(``nn/norms.py``, ``nn/rope.py``, ``kernels/dense_attention.py``), written
out here in f32 throughout: it imports nothing of the program.

Memory: attention runs over blocks of ``q_block`` query rows against the
keys they see, the MLP over blocks of ``row_block`` rows, and each layer's
weights are converted to f32 one layer at a time; the last layer computes
its attention and MLP for the last position only.

``prec`` says how the operands of every weight product (``x @ w``, ``w``
the bf16 weight) are taken: :data:`F32`, the reference's, converts ``w``
to f32; :data:`FP8`, the control's, rounds ``w`` to float8 e4m3 with a
scale per output column and ``x`` with a scale per row, then multiplies
in f32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple

import torch

__all__ = ["last_logits", "Precision", "F32", "FP8", "no_tf32"]

FP8_MAX = 448.0                 # the largest finite float8 e4m3 number


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
    weight: Callable     # bf16 weight [d_in, d_out] -> f32 operand
    act: Callable        # f32 activation [..., d_in] -> f32 operand


F32 = Precision(lambda w: w.float(), lambda x: x)
FP8 = Precision(lambda w: _fp8(w.float(), 0), lambda x: _fp8(x, -1))


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.square(x).mean(-1, keepdim=True) + eps) \
        * g.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attend(q, k, v, rows, q_block: int):
    """Causal attention of q [B, R, Hq, hd] at global positions ``rows``
    [R] over k, v [B, T, Hkv, hd] -> [B, R, Hq * hd]."""
    B, R, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    out = []
    for r0 in range(0, R, q_block):
        qi = q[:, r0:r0 + q_block].reshape(B, -1, Hkv, G, hd)
        pos = rows[r0:r0 + q_block]
        end = int(pos[-1]) + 1
        kk, vv = k[:, :end], v[:, :end]
        s = torch.einsum("bskgh,btkh->bkgst", qi, kk) / math.sqrt(hd)
        seen = torch.arange(end, device=q.device)[None, :] <= pos[:, None]
        s = s.masked_fill(~seen, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgst,btkh->bskgh", p, vv)
        out.append(o.reshape(B, -1, Hq * hd))
        del s, p
    return torch.cat(out, dim=1)


@torch.no_grad()
def last_logits(W: dict, tokens: torch.Tensor, cfg: dict, *,
                prec: Precision = F32, q_block: int = 512,
                row_block: int = 4096) -> torch.Tensor:
    """Logits [B, vocab_size] (f32) of the last position of ``tokens``
    [B, S], from the weights ``W`` (``drivers/lm_prefill.make_weights``'
    layout: per-layer tensors stacked on a leading layer axis)."""
    with no_tf32():
        return _forward(W, tokens, cfg, prec, q_block, row_block)


def _forward(W, tokens, cfg, prec, q_block, row_block):
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    Hq, Hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    V, eps = cfg["vocab_size"], cfg["rms_norm_eps"]
    B, S = tokens.shape
    dev = tokens.device
    scale = math.sqrt(d) if "embed_scale" in cfg.get("port_departures",
                                                      {}) else 1.0
    x = W["embed"][tokens].float() * scale
    half = hd // 2
    inv = 1.0 / (float(cfg["rope_theta"]) ** (
        torch.arange(half, dtype=torch.float32, device=dev) / half))
    ang = torch.arange(S, dtype=torch.float32, device=dev)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    rows = torch.arange(S, device=dev)

    def gemm(a, w):
        return prec.act(a) @ w

    for i in range(L):
        w = {n: prec.weight(W[n][i]) for n in ("q", "k", "v", "o", "gate",
                                                "up", "down")}
        h = _rms(x, W["ln1"][i], eps)
        k = gemm(h, w["k"]).reshape(B, S, Hkv, hd)
        v = gemm(h, w["v"]).reshape(B, S, Hkv, hd)
        k = _rope(_rms(k, W["kn"][i], eps), cos, sin)
        if i == L - 1:                      # only the last position goes on
            x, h, rows = x[:, -1:], h[:, -1:], rows[-1:]
        q = gemm(h, w["q"]).reshape(B, -1, Hq, hd)
        q = _rope(_rms(q, W["qn"][i], eps), cos[rows], sin[rows])
        a = _attend(q, k, v, rows, q_block)
        del q, k, v, h
        x = x + gemm(a, w["o"])
        del a
        for r0 in range(0, x.shape[1], row_block):
            xb = x[:, r0:r0 + row_block]
            hb = _rms(xb, W["ln2"][i], eps)
            u = torch.nn.functional.silu(gemm(hb, w["gate"])) \
                * gemm(hb, w["up"])
            x[:, r0:r0 + row_block] = xb + gemm(u, w["down"])
            del hb, u
        del w
    x = _rms(x[:, -1], W["ln_f"], eps)
    return gemm(x, prec.weight(W["head"][:, :V]))
