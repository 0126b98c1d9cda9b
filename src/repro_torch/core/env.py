"""Layer-fusion RL environment (paper §4.2).

Port of ``repro.core.env``.  One episode is one pass over the n+1
positions of a workload chain; at step ``t`` the agent picks the
micro-batch of position ``t`` (``SYNC`` = flush).  The cost model is the
environment.  Two forms:

- the batched tensor env (``env_make`` ... ``env_final``): the state is a
  ``cost_model.PrefixCarry``, the transition an O(1) ``prefix_step`` and
  the observation an O(1) ``prefix_out``, all batched over a leading row
  axis so a stack of serving conditions moves in lockstep;
- :class:`FusionEnv`, the host episode API of one condition (``reset`` /
  ``step`` / ``decorate``), the readable reference path: each state is a
  full ``cost_model.evaluate`` of the truncated strategy, so on the card
  each step is one ``fusion_eval`` launch.

State (paper Eq. 2): the log-normalized 6-loop shape of the current
layer, the normalized budget, and the running speedup over the no-fusion
baseline.  Conditioning reward (§4.3.3): the fraction of the requested
buffer still free.

``encode_action``, ``decode_action`` and ``returns_to_go`` take tensors
(and compute on their device) or host numbers / numpy arrays (and stay in
numpy, as the reference's host functions do).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import cost_model as cm
from .accel import AccelConfig, accel_features

__all__ = ["STATE_DIM", "encode_action", "decode_action", "returns_to_go",
           "EnvConsts", "env_make", "env_reset", "env_observe", "env_step",
           "env_final", "FusionEnv"]

STATE_DIM = 8
_LOG_CAP = float(np.log1p(2 ** 24))
_BUDGET_CAP = float(np.log1p(1024.0))


def encode_action(a, batch):
    """Map {SYNC} u [1..B] -> [-1, 1] for the regression head (``batch``
    is per row for tensors)."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, dtype=np.float32)
        return np.where(a < 0, -0.5, a / float(batch)).astype(np.float32)  # repro_torch: noqa[TSYNC003] -- the numpy branch: host arrays only
    a = a.to(torch.float32)
    return torch.where(a < 0.0, -0.5, a / batch)


def decode_action(y, batch):
    """Inverse of :func:`encode_action`, thresholded at 0.  Rounds half to
    even (``torch.round``, ``np.rint``), as the reference does."""
    if not isinstance(y, torch.Tensor):
        y = np.asarray(y, dtype=np.float32)
        mb = np.clip(np.rint(y * batch), 1, batch)
        return np.where(y < 0.0, cm.SYNC, mb).astype(np.int32)
    y = y.to(torch.float32)
    batch = torch.as_tensor(batch, dtype=torch.float32, device=y.device)
    mb = torch.minimum(torch.clamp_min(torch.round(y * batch), 1.0), batch)
    return torch.where(y < 0.0, float(cm.SYNC), mb).to(torch.int32)


def returns_to_go(peak_mem, budget_bytes):
    """The §4.3.3 conditioning rule: fraction of the requested budget still
    free after the prefix commits."""
    if isinstance(peak_mem, torch.Tensor):
        return torch.clamp_min((budget_bytes - peak_mem) / budget_bytes, 0.0)
    b = np.float32(budget_bytes)
    return np.maximum(
        np.float32(0.0),
        (b - np.asarray(peak_mem, np.float32)) / b).astype(np.float32)


def _shape_feats(shape6: torch.Tensor) -> torch.Tensor:
    """Log-normalized 6-loop shape features (state dims 0..5)."""
    return torch.log1p(shape6.to(torch.float32)) / _LOG_CAP


def _budget_feat(budget_bytes: torch.Tensor) -> torch.Tensor:
    """Log-normalized requested budget (state dim 6)."""
    return torch.log1p(budget_bytes.to(torch.float32) / 2 ** 20) / _BUDGET_CAP


class EnvConsts(NamedTuple):
    pc: cm.PrefixConsts          # also carries B / budget / n
    base_lat: torch.Tensor       # [R] no-fusion baseline latency
    shape_feats: torch.Tensor    # [R, P, 6]
    budget_feat: torch.Tensor    # [R]


def env_make(wl: dict, batch, budget_bytes, hw) -> EnvConsts:
    """Per-row constants for rows ``wl`` [R, P], ``batch``/``budget_bytes``
    [R] and hw rows [R, 10]."""
    A = wl["A"]
    B = torch.as_tensor(batch, dtype=torch.float32, device=A.device)
    budget = torch.as_tensor(budget_bytes, dtype=torch.float32,
                             device=A.device)
    pc = cm.prefix_consts(wl, B, budget, hw)
    base = cm.baseline_grid(wl, B, hw).latency
    return EnvConsts(pc=pc, base_lat=base,
                     shape_feats=_shape_feats(wl["SHAPE6"]),
                     budget_feat=_budget_feat(budget))


def env_reset(consts: EnvConsts) -> cm.PrefixCarry:
    return cm.prefix_init(consts.pc)


def env_observe(consts: EnvConsts, state: cm.PrefixCarry, hw):
    """(conditioning reward r_t [R], state vector s_t [R, 8])."""
    out = cm.prefix_out(consts.pc, state, hw)
    mem_avail = returns_to_go(out.peak_mem, consts.pc.budget)
    perf = consts.base_lat / torch.clamp_min(out.latency, 1e-12)
    t = torch.minimum(state.t, consts.pc.n)
    feats = consts.shape_feats.gather(
        1, t[:, None, None].expand(-1, 1, 6))[:, 0]
    svec = torch.cat([feats, consts.budget_feat[:, None],
                      torch.log1p(perf)[:, None]], dim=-1)
    return mem_avail, svec


def env_step(consts: EnvConsts, state: cm.PrefixCarry, action,
             hw) -> cm.PrefixCarry:
    """Commit ``action`` [R] for positions ``state.t``."""
    return cm.prefix_step(consts.pc, state, action, hw)


def env_final(consts: EnvConsts, state: cm.PrefixCarry, hw) -> cm.CostOut:
    """Full-strategy CostOut once all n+1 actions are committed."""
    return cm.prefix_out(consts.pc, state, hw)


@dataclass
class FusionEnv:
    """One (workload, accelerator, batch, budget) condition, packed on
    ``device`` (``cuda`` unless ``"cpu"``): the holder that
    ``infer.dnnfuser_infer_fused`` and ``infer.dnnfuser_infer_batch``
    accept, and the host episode API (``reset``, ``step``, ``decorate``)
    that the host G-Sampler, the host corpus and the host mapper drive."""

    workload: object                 # workloads.Workload
    hw: AccelConfig
    batch: int
    budget_bytes: float
    nmax: int = 64
    device: object = None

    def __post_init__(self):
        self.wl = cm.pack_workload(self.workload, self.hw, self.nmax,
                                   device=self.device)
        self.device = self.wl["A"].device
        self.wl_np = {k: v.cpu().numpy() for k, v in self.wl.items()}
        self.n = int(self.workload.n)
        self.shape_feats = _shape_feats(self.wl["SHAPE6"]).cpu().numpy()
        self.baseline_latency = float(cm.baseline_no_fusion(
            self.wl, float(self.batch), self.hw).latency)
        self._budget_feat = np.float32(_budget_feat(
            torch.tensor(float(self.budget_bytes))))
        # normalized hw condition vector for hw-aware mappers
        self.hw_features = accel_features(self.hw).numpy()
        self.reset()

    # -- episode API ---------------------------------------------------------
    def reset(self) -> np.ndarray:
        self.t = 0
        self.actions = np.full(self.nmax, cm.SYNC, dtype=np.int32)
        self._last = None  # CostOut of the current prefix
        return self._state()

    def _prefix_eval(self) -> cm.CostOut:
        pos = np.arange(self.nmax)
        return self.evaluate_strategy(
            np.where(pos < self.t, self.actions, cm.SYNC))

    def _state(self) -> np.ndarray:
        out = self._prefix_eval()
        self._last = out
        peak = float(out.peak_mem)
        lat = float(out.latency)
        perf = self.baseline_latency / max(lat, 1e-12)
        st = np.empty(STATE_DIM, dtype=np.float32)
        st[:6] = self.shape_feats[min(self.t, self.n)]
        st[6] = self._budget_feat
        st[7] = np.float32(np.log1p(perf))
        # conditioning reward r_hat
        self._mem_avail = returns_to_go(peak, self.budget_bytes)
        return st

    @property
    def reward_to_go(self) -> float:
        """Conditioning reward r_hat_t: remaining fraction of the budget."""
        return float(self._mem_avail)

    def step(self, action: int) -> tuple[np.ndarray, float, bool]:
        """Apply ``action`` for position ``t``.  Terminal reward: the
        speedup if the full strategy is valid, else a constraint-violation
        penalty."""
        if self.t > self.n:
            raise RuntimeError("episode finished; call reset()")
        a = int(action)
        if self.t == 0 and a < 1:
            a = 1  # the input micro-batch cannot sync
        self.actions[self.t] = a
        self.t += 1
        done = self.t > self.n
        state = self._state()
        reward = 0.0
        if done:
            lat = float(self._last.latency)
            peak = float(self._last.peak_mem)
            if peak <= self.budget_bytes:
                reward = self.baseline_latency / max(lat, 1e-12)
            else:
                reward = -1.0 * (peak / self.budget_bytes - 1.0)
        return state, reward, done

    # -- whole-strategy helpers ----------------------------------------------
    def evaluate_strategy(self, strategy) -> cm.CostOut:
        """CostOut (0-dim fields) of ``strategy`` [nmax]: one ``fusion_eval``
        launch on the card."""
        return cm.evaluate(self.wl, strategy, float(self.batch),
                           float(self.budget_bytes), self.hw)

    def speedup(self, strategy) -> tuple[float, float, bool]:
        out = self.evaluate_strategy(strategy)
        return (self.baseline_latency / max(float(out.latency), 1e-12),
                float(out.peak_mem), bool(out.valid))

    def decorate(self, strategy: np.ndarray) -> dict[str, np.ndarray]:
        """A final strategy as a (reward, state, action) trajectory for
        imitation learning (paper §4.5.1 step 2), from one
        :func:`cost_model.prefix_trace` call."""
        tr = cm.prefix_trace(self.wl, strategy, float(self.batch),
                             float(self.budget_bytes), self.hw)
        T = self.n + 1
        lat = tr.latency.cpu().numpy()[:T]
        peak = tr.peak_mem.cpu().numpy()[:T]
        states = np.zeros((T, STATE_DIM), dtype=np.float32)
        states[:, :6] = self.shape_feats[:T]
        states[:, 6] = self._budget_feat
        states[:, 7] = np.log1p(self.baseline_latency / np.maximum(lat, 1e-12))
        rtg = returns_to_go(peak, self.budget_bytes)
        strategy = np.asarray(strategy)
        return dict(states=states, rtg=rtg,
                    actions=encode_action(strategy[:T], self.batch),
                    raw_actions=np.asarray(strategy[:T], dtype=np.int32),
                    length=np.int32(T))
