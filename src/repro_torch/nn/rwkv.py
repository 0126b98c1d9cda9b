"""RWKV6 "Finch" block (arXiv:2404.05892): data-dependent decay WKV.

Port of ``repro.nn.rwkv``.  Time-mix recurrence per head (head dim n):
    y_t = r_t @ (diag(u) k_t^T v_t + S_t)
    S_{t+1} = diag(w_t) S_t + k_t^T v_t
with per-channel decay w_t = exp(-exp(w0 + tanh(x_t W1) W2)) computed in
f32, token-shift interpolation on every projection input, a per-head
LayerNorm (``gn``) and SiLU(g) output gating.  The channel mix is the
squared-ReLU RWKV FFN.  ``w0`` and ``u`` stay f32 whatever the
parameters' type.

``impl`` selects the recurrence: ``"kernel"`` (the reference's
``"pallas"``) sends every time mix, the single-token decode step
included, to ``kernels.rwkv6_scan.wkv6`` (the card's kernel; its plain
twin on CPU tensors); ``"dense"`` (the reference's ``"xla"``) sends a
multi-token one to :func:`wkv_chunked` and a single token to the
sequential step :func:`wkv_scan`, as the reference's ``"xla"`` path does.
Decode carries O(1) state: S [B,H,n,n] and the last normed token of each
shift.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6_scan import wkv6, wkv6_plain as wkv_scan
from .attention import IMPLS
from .linear import Dense
from .norms import LayerNorm

__all__ = ["RWKVBlock", "rwkv_init_state", "wkv_scan", "wkv_chunked"]

_MIX = ("r", "k", "v", "w", "g")


def wkv_chunked(r, k, v, w, u, s0, *, chunk: int = 32):
    """Chunk-parallel WKV6 in f32 (GLA-style, arXiv:2312.06635 §4): within
    a chunk, with cumulative decays cum_t = prod_{i<=t} w_i,
        y_t = (r_t cum_{t-1}) @ S_0 + sum_{s<t} (r~_t . k~_s) v_s
              + (r_t . u . k_t) v_t,   k~_s = k_s / cum_s
        S_C = cum_C S_0 + sum_s (cum_C / cum_s) k_s^T v_s.
    T is padded to whole chunks, with w padded by 1.  Returns (y, sT)."""
    B, T, H, n = r.shape
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def prep(x, val=0.0):
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad), value=val)
        return x.reshape(B, nc, chunk, H, n)

    rp, kp, vp, wp = prep(r), prep(k), prep(v), prep(w, 1.0)
    s = s0.float()
    causal = torch.tril(torch.ones((chunk, chunk), device=r.device), -1)
    uf = u.float()
    ys = []
    for c in range(nc):
        rc, kc, vc, wc = rp[:, c], kp[:, c], vp[:, c], wp[:, c]
        cum = torch.exp(torch.cumsum(torch.log(torch.clamp_min(wc, 1e-30)),
                                     dim=1))                  # [B,C,H,n]
        cum_prev = cum / wc
        rt = rc * cum_prev
        kt = kc / torch.clamp_min(cum, 1e-30)
        inter = torch.einsum("bchn,bhnm->bchm", rt, s)
        scores = torch.einsum("bchn,bdhn->bhcd", rt, kt) * causal
        diag = torch.einsum("bchn,hn,bchn->bch", rc, uf, kc)
        intra = torch.einsum("bhcd,bdhm->bchm", scores, vc) \
            + diag[..., None] * vc
        cend = cum[:, -1]                                     # [B,H,n]
        s = cend[..., None] * s + torch.einsum(
            "bchn,bchm->bhnm",
            (cend[:, None] / torch.clamp_min(cum, 1e-30)) * kc, vc)
        ys.append(inter + intra)
    return torch.cat(ys, 1)[:, :T], s


def rwkv_init_state(batch: int, n_heads: int, head_dim: int, d: int, *,
                    dtype=torch.float32, device=None) -> dict:
    """``{"s": [B,H,n,n] f32, "x_tm", "xc_tm": [B,d]}`` zeros."""
    return {"s": torch.zeros((batch, n_heads, head_dim, head_dim),
                             dtype=torch.float32, device=device),
            "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "xc_tm": torch.zeros((batch, d), dtype=dtype, device=device)}


def _shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1}, with zeros or the carried ``last`` at t=0.
    ``last`` is cast to x's type (the reference promotes instead; the two
    agree when the cache has the parameters' type, as in every caller)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else \
        last[:, None].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


class RWKVBlock(nn.Module):
    """Time mix then channel mix, each a residual branch after a LayerNorm.
    Parameter names follow the reference's (``mu.r``, ``w0``, ``gn.g``,
    ``mu_c.k``, ``ck.w``, ...)."""

    def __init__(self, d: int, *, n_heads: int, head_dim: int, d_ff: int,
                 lora_rank: int = 32, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if n_heads * head_dim != d:
            raise ValueError(f"n_heads {n_heads} x head_dim {head_dim} != "
                             f"d {d}")
        self.n_heads, self.head_dim = n_heads, head_dim
        kw = dict(generator=generator, device=device, dtype=dtype)

        def full(n, val, dt=dtype):
            return nn.Parameter(torch.full((n,), val, device=device,
                                           dtype=dt))

        self.ln1 = LayerNorm(d, device=device, dtype=dtype)
        self.ln2 = LayerNorm(d, device=device, dtype=dtype)
        self.mu = nn.ParameterDict({m: full(d, 0.5) for m in _MIX})
        for m in ("r", "k", "v", "g", "o"):
            setattr(self, m, Dense(d, d, bias=False, **kw))
        # decays near 1 (RWKV init): w0 = -6 gives w ~ 0.9975
        self.w0 = full(d, -6.0, torch.float32)
        self.w1 = Dense(d, lora_rank, bias=False, **kw)
        self.w2 = Dense(lora_rank, d, bias=False, **kw)
        self.u = nn.Parameter(torch.zeros((n_heads, head_dim), device=device,
                                          dtype=torch.float32))
        self.gn = LayerNorm(head_dim, device=device, dtype=dtype)
        self.mu_c = nn.ParameterDict({m: full(d, 0.5) for m in ("k", "r")})
        self.ck = Dense(d, d_ff, bias=False, **kw)
        self.cv = Dense(d_ff, d, bias=False, **kw)
        self.cr = Dense(d, d, bias=False, **kw)

    def _time_mix(self, xn, xs, s0, impl: str):
        B, T, d = xn.shape
        H, n = self.n_heads, self.head_dim
        proj = {m: _mix(xn, xs, self.mu[m]) for m in _MIX}
        r = self.r(proj["r"]).reshape(B, T, H, n)
        k = self.k(proj["k"]).reshape(B, T, H, n)
        v = self.v(proj["v"]).reshape(B, T, H, n)
        g = self.g(proj["g"])
        lora = self.w2(torch.tanh(self.w1(proj["w"])))
        w = torch.exp(-torch.exp(self.w0 + lora.float())).reshape(B, T, H, n)
        if impl == "kernel":
            y, sT = wkv6(r, k, v, w, self.u, s0)
        elif T > 1:
            y, sT = wkv_chunked(r, k, v, w, self.u, s0)
        else:
            y, sT = wkv_scan(r, k, v, w, self.u, s0)
        yn = self.gn(y.to(xn.dtype))                          # [B,T,H,n]
        return self.o(yn.reshape(B, T, d) * F.silu(g)), sT

    def forward(self, x: torch.Tensor, *, state: dict | None = None,
                impl: str = "dense"):
        """x [B,T,d] -> ``(x, new_state)``.  With ``state`` (``"s"``,
        ``"x_tm"``, ``"xc_tm"`` of one layer) the shifts start from the
        carried tokens and the recurrence from ``state["s"]``; the new
        state carries the normed last tokens.  Without it, ``new_state``
        is None."""
        if impl not in IMPLS:
            raise ValueError(f"rwkv: impl must be one of {IMPLS}, got "
                             f"{impl!r}")
        B, T, _ = x.shape
        H, n = self.n_heads, self.head_dim
        s0 = state["s"] if state is not None else \
            torch.zeros((B, H, n, n), dtype=torch.float32, device=x.device)
        xn = self.ln1(x)
        xs = _shift(xn, state["x_tm"] if state is not None else None)
        att, sT = self._time_mix(xn, xs, s0, impl)
        x = x + att
        xc = self.ln2(x)
        xcs = _shift(xc, state["xc_tm"] if state is not None else None)
        kx = _mix(xc, xcs, self.mu_c["k"])
        rx = _mix(xc, xcs, self.mu_c["r"])
        kk = torch.square(torch.relu(self.ck(kx)))
        x = x + torch.sigmoid(self.cr(rx)) * self.cv(kk)
        new_state = None
        if state is not None:
            new_state = {"s": sT, "x_tm": xn[:, -1], "xc_tm": xc[:, -1]}
        return x, new_state
