"""DNNFuser: the decision-transformer mapper (paper §4.3, §5.1).

Port of ``repro.core.model``: 3 blocks, 2 heads, d=128 by default.  A
trajectory (r_0, s_0, a_0, ...) is embedded into interleaved reward /
state / action tokens; a causal transformer predicts the action of step t
from the state token of step t.  With ``cfg.hw_dim > 0`` a projection of
the normalized accelerator features is added to every reward token.

The model is an ``nn.Module`` whose parameter names mirror the
reference's pytree paths (``blocks.0.attn.q.w`` for ``blocks/0/attn/q/w``),
except ``type`` -> ``type_``, which would shadow ``nn.Module.type``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..nn import Block, Dense, Embedding, LayerNorm, init_kv_cache
from .env import STATE_DIM

__all__ = ["DTConfig", "DT", "dt_init", "dt_apply", "dt_loss",
           "dt_cache_init", "dt_prefill", "dt_decode_step", "DTBackend",
           "param_tree", "load_param_tree"]


@dataclass(frozen=True)
class DTConfig:
    n_blocks: int = 3          # paper §5.1
    n_heads: int = 2           # paper §5.1
    d_model: int = 128         # paper §5.1
    max_steps: int = 64        # trajectory positions (N+1 <= max_steps)
    d_ff: int = 512
    dtype: torch.dtype = torch.float32
    hw_dim: int = 0            # hw-condition feature dim (0 = unconditioned)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class DT(nn.Module):
    """The decision transformer; ``cfg`` fixes its shapes."""

    def __init__(self, cfg: DTConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(generator=generator, device=device, dtype=cfg.dtype)
        # drawn in the reference's key order (emb_r, emb_s, emb_a, time,
        # type, head, emb_h, blocks); torch streams differ from JAX's anyway
        self.emb_r = Dense(1, d, **kw)
        self.emb_s = Dense(STATE_DIM, d, **kw)
        self.emb_a = Dense(1, d, **kw)
        self.time = Embedding(cfg.max_steps, d, **kw)
        self.type_ = Embedding(3, d, **kw)
        self.ln_f = LayerNorm(d, device=device, dtype=cfg.dtype)
        self.head = Dense(d, 1, **kw)
        self.emb_h = Dense(cfg.hw_dim, d, **kw) if cfg.hw_dim else None
        self.blocks = nn.ModuleList(
            Block(d, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                  d_ff=cfg.d_ff, mlp_kind="gelu", norm="layer", **kw)
            for _ in range(cfg.n_blocks))

    def hw_emb(self, hw: torch.Tensor | None, batch: int):
        """[B, d] additive hw-condition embedding, or None when the model is
        unconditioned; a missing ``hw`` on an hw-aware model is zeros."""
        if self.emb_h is None:
            return None
        if hw is None:
            hw = torch.zeros((batch, self.cfg.hw_dim), dtype=self.cfg.dtype,
                             device=self.head.w.device)
        return self.emb_h(hw)

    def time_at(self, t: int) -> torch.Tensor:
        """Time embedding row of host step ``t`` (NaN past ``max_steps``)."""
        if t < self.cfg.max_steps:
            return self.time.emb[t]
        return torch.full_like(self.time.emb[0], float("nan"))

    def time_emb(self, idx: torch.Tensor) -> torch.Tensor:
        """Time embedding at ``idx``; indices past ``max_steps`` are
        poisoned to NaN instead of raising or aliasing a row.

        The lookup is a one-hot product, which selects each row exactly
        (TF32 is off) and whose backward is a matmul: on the card the
        gradient of ``time`` is then the same in every run.  Both gather
        forms are not: ``F.embedding``'s backward sums a row's gradient in
        another order from run to run once it sees more than 3072 indices
        (measured on the H100, torch 2.11), with no warning under
        ``torch.use_deterministic_algorithms``."""
        ms = self.cfg.max_steps
        onehot = F.one_hot(idx.clamp(0, ms - 1).long(), ms)
        t = onehot.to(self.time.emb.dtype) @ self.time.emb
        return torch.where((idx < ms)[..., None], t, float("nan"))


def dt_init(cfg: DTConfig, *, seed: int = 0, device=None) -> DT:
    """A DT with weights drawn on the CPU from a ``torch.Generator``
    seeded with ``seed``, then moved to ``device`` (default ``cuda``), so
    one seed gives the same weights on every device."""
    dev = resolve_device(device)
    model = DT(cfg, generator=torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def dt_apply(model: DT, rtg, states, actions, t0=None, hw=None):
    """rtg [B,T], states [B,T,8], actions [B,T] -> predicted actions [B,T].

    ``t0`` [B] (optional) offsets the time embedding; positions past
    ``max_steps`` are NaN.  ``hw`` [B, hw_dim] are normalized accelerator
    features, added to every reward token when ``cfg.hw_dim > 0``."""
    cfg = model.cfg
    B, T = rtg.shape
    d = cfg.d_model
    tok_r = model.emb_r(rtg[..., None])
    hemb = model.hw_emb(hw, B)
    if hemb is not None:
        tok_r = tok_r + hemb[:, None, :]
    tok_s = model.emb_s(states)
    tok_a = model.emb_a(actions[..., None])
    steps = torch.arange(T, device=rtg.device)
    if t0 is None:
        time = model.time_emb(steps)[None]
    else:
        time = model.time_emb(t0.long()[:, None] + steps[None, :])
    typ = model.type_.emb
    toks = torch.stack([tok_r + typ[0], tok_s + typ[1], tok_a + typ[2]],
                       dim=2) + time[:, :, None, :]
    x = toks.reshape(B, 3 * T, d)
    for blk in model.blocks:
        x, _ = blk(x)
    x = model.ln_f(x)
    s_tok = x.reshape(B, T, 3, d)[:, :, 1]
    return model.head(s_tok)[..., 0]


def dt_loss(model: DT, batch: dict) -> torch.Tensor:
    """Masked MSE (paper §4.3.1) of tensors ``batch`` (``rtg``, ``states``,
    ``actions``, ``mask`` and optionally ``t0`` window offsets and ``hw``
    condition rows)."""
    pred = dt_apply(model, batch["rtg"], batch["states"], batch["actions"],
                    batch.get("t0"), batch.get("hw"))
    err = torch.square(pred - batch["actions"]) * batch["mask"]
    return err.sum() / torch.clamp_min(batch["mask"].sum(), 1.0)


def _ref_name(name: str) -> str:
    """Port parameter name -> the reference's pytree path."""
    parts = name.split(".")
    if parts[0] == "type_":
        parts[0] = "type"
    return "/".join(parts)


def param_tree(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters keyed by the reference's pytree paths
    (``blocks/0/attn/q/w``, ``type/emb``), in ``named_parameters`` order:
    the ``params`` tree of a training checkpoint."""
    return {_ref_name(k): p for k, p in model.named_parameters()}


@torch.no_grad()
def load_param_tree(model: nn.Module, tree: dict) -> nn.Module:
    """Copy ``tree`` (reference paths -> arrays or tensors) into the
    model's parameters in place; raises on a missing, extra or misshapen
    leaf."""
    params = param_tree(model)
    if set(tree) != set(params):
        raise KeyError(f"parameter trees differ: "
                       f"{sorted(set(tree) ^ set(params))}")
    for k, p in params.items():
        v = torch.as_tensor(tree[k])
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)}, the model has "
                             f"{tuple(p.shape)}")
        p.copy_(v)
    return model


def dt_cache_init(cfg: DTConfig, batch: int = 1, device=None) -> list:
    """Per-block KV caches over the flat (r, s, a) token stream."""
    return [init_kv_cache(batch, 3 * cfg.max_steps, cfg.n_heads,
                          cfg.head_dim, dtype=cfg.dtype, device=device)
            for _ in range(cfg.n_blocks)]


def _blocks_cached(model: DT, x: torch.Tensor, caches: list):
    for blk, cch in zip(model.blocks, caches):
        x, _ = blk(x, cache=cch)
    x = model.ln_f(x)
    return model.head(x)[..., 0], caches


def dt_prefill(model: DT, cache: list, r0, s0, hw=None):
    """Start an episode: feed (r_0, s_0), predict a_0.
    r0 [B], s0 [B, 8] -> (pred_a0 [B], cache)."""
    typ = model.type_.emb
    time0 = model.time_at(0)
    tok_r = model.emb_r(r0[..., None]) + typ[0] + time0
    hemb = model.hw_emb(hw, r0.shape[0])
    if hemb is not None:
        tok_r = tok_r + hemb
    tok_s = model.emb_s(s0) + typ[1] + time0
    preds, cache = _blocks_cached(model, torch.stack([tok_r, tok_s], dim=1),
                                  cache)
    return preds[:, 1], cache


def dt_decode_step(model: DT, cache: list, r_t, s_t, a_prev, hw=None):
    """One decode step t >= 1: append (a_{t-1}, r_t, s_t), predict a_t.

    ``a_prev`` is the encoded action of step t-1; the step index comes from
    the cache's write index (``idx == 3t - 1``).  Returns (pred_a_t [B],
    cache)."""
    t = (cache[0]["idx"] + 1) // 3
    typ = model.type_.emb
    time_prev, time_t = model.time_at(t - 1), model.time_at(t)
    tok_a = model.emb_a(a_prev[..., None]) + typ[2] + time_prev
    tok_r = model.emb_r(r_t[..., None]) + typ[0] + time_t
    hemb = model.hw_emb(hw, r_t.shape[0])
    if hemb is not None:
        tok_r = tok_r + hemb
    tok_s = model.emb_s(s_t) + typ[1] + time_t
    preds, cache = _blocks_cached(
        model, torch.stack([tok_a, tok_r, tok_s], dim=1), cache)
    return preds[:, 2], cache


class DTBackend:
    """The decision transformer as a mapper backend: the rollout in
    ``infer`` drives (``forward``, ``state_init``, ``prefill``, ``step``)
    with the per-block KV caches as its decode state."""

    kind = "dt"

    @staticmethod
    def forward(model, rtg, states, actions, hw=None):
        return dt_apply(model, rtg, states, actions, hw=hw)

    @staticmethod
    def state_init(model, batch: int = 1):
        return dt_cache_init(model.cfg, batch, device=model.head.w.device)

    @staticmethod
    def prefill(model, state, r0, s0, hw=None):
        return dt_prefill(model, state, r0, s0, hw)

    @staticmethod
    def step(model, state, r_t, s_t, a_prev, hw=None):
        return dt_decode_step(model, state, r_t, s_t, a_prev, hw)
