"""RNN Seq2Seq baseline sequence model (paper §5.1).

Port of ``repro.core.seq2seq``.  "The Seq2Seq is made of a LSTM with 2
layers of fully connected layers and 128 hidden dimension in each encoder
and decoder."  The encoder LSTM reads the (reward, state) sequence; the
decoder LSTM, started from the encoder's final state, reads [state_t,
rtg_t, a_{t-1}] and regresses a_t.  Trained with the DT's masked-MSE
imitation objective.  With ``cfg.hw_dim > 0`` a projection of the
normalized accelerator features is added to every encoder and decoder
input (a zero ``emb_h`` is the unconditioned model).

The LSTM cell is the reference's, not ``torch.nn.LSTM``: one [4H] product
of the input and one of the state, gates ``i, f, g, o`` in that order, and
a forget gate of ``sigmoid(f + 1)``.  cuDNN's cell orders its gates
otherwise, has two biases and no +1, so it would not take the reference's
weights.  The module's parameter names are the reference's pytree paths
(``enc_lstm.wx.w`` for ``enc_lstm/wx/w``), so ``model.param_tree`` and
``load_param_tree`` carry weights across packages unchanged.

Incremental decode.  The LSTM's analogue of a KV cache is its (h, c)
state.  ``s2s_encode`` runs the encoder over a known sequence and
``s2s_decode_step`` then replays the teacher-forced decoder cell by cell,
bit for bit as ``s2s_apply`` (which runs its decoder so).
``s2s_stream_step`` serves rollouts, where the future states do not exist
yet: the encoder advances beside the decoder and seeds it at t = 0.  The stream state's step count ``t`` is a host
integer (the reference's is a device scalar): the rollout's prefill is
always the step with ``t == 0`` and its steps never are, so nothing reads a
device value to decide it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import resolve_device
from ..nn import Dense
from .env import STATE_DIM

__all__ = ["S2SConfig", "S2S", "s2s_init", "s2s_apply", "s2s_loss",
           "s2s_encode", "s2s_decode_start", "s2s_decode_step",
           "s2s_stream_init", "s2s_stream_step", "S2SBackend"]


@dataclass(frozen=True)
class S2SConfig:
    hidden: int = 128          # paper §5.1
    max_steps: int = 64
    dtype: torch.dtype = torch.float32
    hw_dim: int = 0            # hw-condition feature dim (0 = unconditioned)


class LSTMCell(nn.Module):
    """One LSTM step, the reference's cell: x [B, d_in], (h, c) [B, d_h]."""

    def __init__(self, d_in: int, d_h: int, **kw):
        super().__init__()
        self.wx = Dense(d_in, 4 * d_h, **kw)
        self.wh = Dense(d_h, 4 * d_h, bias=False, **kw)

    def forward(self, x, h, c):
        i, f, g, o = torch.chunk(self.wx(x) + self.wh(h), 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class S2S(nn.Module):
    """The seq2seq baseline; ``cfg`` fixes its shapes."""

    def __init__(self, cfg: S2SConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden
        kw = dict(generator=generator, device=device, dtype=cfg.dtype)
        # drawn in the reference's key order; torch streams differ anyway
        self.enc_in = Dense(STATE_DIM + 1, H, **kw)
        self.enc_fc = Dense(H, H, **kw)
        self.enc_lstm = LSTMCell(H, H, **kw)
        self.dec_in = Dense(STATE_DIM + 2, H, **kw)
        self.dec_fc = Dense(H, H, **kw)
        self.dec_lstm = LSTMCell(H, H, **kw)
        self.head1 = Dense(H, H, **kw)
        self.head2 = Dense(H, 1, **kw)
        self.emb_h = Dense(cfg.hw_dim, H, **kw) if cfg.hw_dim else None

    @property
    def device(self) -> torch.device:
        return self.head2.w.device

    def hw_emb(self, hw, batch: int):
        """[B, H] additive hw embedding, or None when unconditioned; a
        missing ``hw`` on an hw-aware model is zeros."""
        if self.emb_h is None:
            return None
        if hw is None:
            hw = torch.zeros((batch, self.cfg.hw_dim), dtype=self.cfg.dtype,
                             device=self.device)
        return self.emb_h(hw)

    def enc_x(self, r, s):
        x = torch.cat([s, r[..., None]], -1)
        return torch.relu(self.enc_fc(torch.relu(self.enc_in(x))))

    def dec_x(self, r, s, a_prev):
        x = torch.cat([s, r[..., None], a_prev[..., None]], -1)
        return torch.relu(self.dec_fc(torch.relu(self.dec_in(x))))

    def head(self, h):
        return self.head2(torch.relu(self.head1(h)))[..., 0]


def s2s_init(cfg: S2SConfig, *, seed: int = 0, device=None) -> S2S:
    """An S2S with weights drawn on the CPU from a ``torch.Generator``
    seeded with ``seed``, then moved to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    model = S2S(cfg, generator=torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def s2s_encode(model: S2S, rtg, states, hw=None):
    """The full-sequence encoder, the one inside ``s2s_apply``: rtg [B, T],
    states [B, T, 8] -> final (h, c) [B, H]."""
    B = rtg.shape[0]
    h = model.enc_x(rtg, states)
    hemb = model.hw_emb(hw, B)
    if hemb is not None:
        h = h + hemb[:, None, :]
    he = ce = torch.zeros((B, model.cfg.hidden), dtype=rtg.dtype,
                          device=rtg.device)
    for t in range(h.shape[1]):
        he, ce = model.enc_lstm(h[:, t], he, ce)
    return he, ce


def s2s_apply(model: S2S, rtg, states, actions, hw=None):
    """Teacher-forced predictions [B, T] (a_{t-1} fed, a_{-1} = 0).

    The decoder runs as ``s2s_decode_step`` cell by cell, so its products
    have the shapes of a decode step's and the incremental decode replays
    this function bit for bit (a [B*T]-row product may sum in another order
    than a [B]-row one)."""
    cache = s2s_decode_start(s2s_encode(model, rtg, states, hw))
    prev = torch.zeros_like(actions[:, 0])
    preds = []
    for t in range(rtg.shape[1]):
        pred, cache = s2s_decode_step(model, cache, rtg[:, t], states[:, t],
                                      prev, hw)
        preds.append(pred)
        prev = actions[:, t]
    return torch.stack(preds, dim=1)


def s2s_loss(model: S2S, batch: dict) -> torch.Tensor:
    """Masked MSE of tensors ``batch`` (``rtg``, ``states``, ``actions``,
    ``mask``, optionally ``hw``), the DT's objective."""
    pred = s2s_apply(model, batch["rtg"], batch["states"], batch["actions"],
                     batch.get("hw"))
    err = torch.square(pred - batch["actions"]) * batch["mask"]
    return err.sum() / torch.clamp_min(batch["mask"].sum(), 1.0)


def s2s_decode_start(enc_state) -> dict:
    he, ce = enc_state
    return {"h": he, "c": ce}


def s2s_decode_step(model: S2S, cache: dict, r_t, s_t, a_prev, hw=None):
    """One decoder cell step; an exact replay of ``s2s_apply`` when seeded
    from ``s2s_encode``.  Returns (pred [B], cache)."""
    g = model.dec_x(r_t, s_t, a_prev)
    hemb = model.hw_emb(hw, r_t.shape[0])
    if hemb is not None:
        g = g + hemb
    h, c = model.dec_lstm(g, cache["h"], cache["c"])
    return model.head(h), {"h": h, "c": c}


def s2s_stream_init(cfg: S2SConfig, batch: int = 1, dtype=torch.float32,
                    device=None) -> dict:
    """A fresh streaming state on ``device`` (``cuda`` unless ``"cpu"``):
    zero encoder and decoder (h, c), and the host step count ``t``."""
    z = torch.zeros((batch, cfg.hidden), dtype=dtype,
                    device=resolve_device(device))
    return {"eh": z, "ec": z, "h": z, "c": z, "t": 0}


def s2s_stream_step(model: S2S, cache: dict, r_t, s_t, a_prev, hw=None):
    """Streaming decode: advance the encoder on (s_t, r_t), seed the
    decoder from it at t = 0, step the decoder.  Returns (pred [B],
    cache)."""
    ex = model.enc_x(r_t, s_t)
    hemb = model.hw_emb(hw, r_t.shape[0])
    if hemb is not None:
        ex = ex + hemb
    eh, ec = model.enc_lstm(ex, cache["eh"], cache["ec"])
    first = cache["t"] == 0
    h, c = (eh, ec) if first else (cache["h"], cache["c"])
    pred, dc = s2s_decode_step(model, {"h": h, "c": c}, r_t, s_t, a_prev, hw)
    return pred, {"eh": eh, "ec": ec, "h": dc["h"], "c": dc["c"],
                  "t": cache["t"] + 1}


class S2SBackend:
    """The seq2seq baseline as a mapper backend: the rollouts in ``infer``
    drive (``forward``, ``state_init``, ``prefill``, ``step``) with the
    streaming (encoder, decoder) LSTM state as the decode state.  The
    prefill feeds (r_0, s_0) with a zero previous action and seeds the
    decoder from the advancing encoder."""

    kind = "s2s"

    @staticmethod
    def forward(model, rtg, states, actions, hw=None):
        """Full-sequence teacher-forced scores (the host rollout's path)."""
        return s2s_apply(model, rtg, states, actions, hw)

    @staticmethod
    def state_init(model, batch: int = 1):
        return s2s_stream_init(model.cfg, batch, device=model.device)

    @staticmethod
    def prefill(model, state, r0, s0, hw=None):
        return s2s_stream_step(model, state, r0, s0, torch.zeros_like(r0),
                               hw)

    @staticmethod
    def step(model, state, r_t, s_t, a_prev, hw=None):
        return s2s_stream_step(model, state, r_t, s_t, a_prev, hw)
