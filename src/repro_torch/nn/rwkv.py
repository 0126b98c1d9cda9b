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

Under tensor parallelism (``distributed.tp``; the plan shards r, k, v, g,
o by heads when ``n_heads % tp == 0`` and ck, cv, cr by width) a rank runs
its ``H / tp`` heads: r, k, v and g are column-parallel (their token-shift
mixes through ``tp.copy_to_tp``), o row-parallel; the decay, computed
whole from the replicated LoRA, and the bonus ``u`` are cut to the rank's
heads by ``tp.tp_select``; the per-head norm's gains, shared by all heads,
pass through ``copy_to_tp``.  ``wkv6`` runs at the rank's heads and the
state ``S`` holds them.  In the channel mix ck is column- and cv
row-parallel over ``d_ff``, and cr column-parallel, its gate all-gathered
over 'model' before the product with cv's sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp
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
        self.n_heads, self.head_dim, self.d_ff = n_heads, head_dim, d_ff
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
        n = self.head_dim
        H = self.r.w.shape[1] // n                      # the rank's heads
        ax = tp.tp_axis()
        ax = ax if ax is not None and H != self.n_heads else None
        cp = lambda t: tp.copy_to_tp(t, ax)
        proj = {m: _mix(xn, xs, self.mu[m]) for m in _MIX}
        r = self.r(cp(proj["r"])).reshape(B, T, H, n)
        k = self.k(cp(proj["k"])).reshape(B, T, H, n)
        v = self.v(cp(proj["v"])).reshape(B, T, H, n)
        g = self.g(cp(proj["g"]))
        lora = self.w2(torch.tanh(self.w1(proj["w"])))
        w = torch.exp(-torch.exp(self.w0 + lora.float()))
        u = self.u
        if ax is not None:
            w = tp.tp_select(w, ax, -1, range(ax.rank * H * n,
                                              (ax.rank + 1) * H * n))
            u = tp.tp_select(u, ax, 0, range(ax.rank * H, (ax.rank + 1) * H))
        w = w.reshape(B, T, H, n)
        if impl == "kernel":
            y, sT = wkv6(r, k, v, w, u, s0)
        elif T > 1:
            y, sT = wkv_chunked(r, k, v, w, u, s0)
        else:
            y, sT = wkv_scan(r, k, v, w, u, s0)
        gains = (cp(self.gn.g), cp(self.gn.b)) if ax is not None else ()
        yn = self.gn(y.to(xn.dtype), *gains)                  # [B,T,H,n]
        out = self.o(yn.reshape(B, T, H * n) * F.silu(g))
        return tp.reduce_from_tp(out, ax), sT

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
        n = self.head_dim
        H = self.r.w.shape[1] // n
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
        ax = tp.tp_axis()
        fx = ax if ax is not None and self.ck.w.shape[1] != self.d_ff \
            else None
        rax = ax if ax is not None and self.cr.w.shape[1] != x.shape[-1] \
            else None
        kk = torch.square(torch.relu(self.ck(tp.copy_to_tp(kx, fx))))
        vv = tp.reduce_from_tp(self.cv(kk), fx)
        gate = torch.sigmoid(self.cr(tp.copy_to_tp(rx, rax)))
        x = x + tp.gather_from_tp(gate, rax, -1) * vv
        new_state = None
        if state is not None:
            new_state = {"s": sT, "x_tm": xn[:, -1], "xc_tm": xc[:, -1]}
        return x, new_state
