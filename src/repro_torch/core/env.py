"""Layer-fusion RL environment (paper §4.2).

Port of ``repro.core.env``.  One episode is one pass over the n+1
positions of a workload chain; at step ``t`` the agent picks the
micro-batch of position ``t`` (``SYNC`` = flush).  The cost model is the
environment: the state is a ``cost_model.PrefixCarry``, the transition an
O(1) ``prefix_step`` and the observation an O(1) ``prefix_out``, all
batched over a leading row axis so a stack of serving conditions moves in
lockstep.

State (paper Eq. 2): the log-normalized 6-loop shape of the current
layer, the normalized budget, and the running speedup over the no-fusion
baseline.  Conditioning reward (§4.3.3): the fraction of the requested
buffer still free.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import cost_model as cm
from .accel import AccelConfig

__all__ = ["STATE_DIM", "encode_action", "decode_action", "returns_to_go",
           "EnvConsts", "env_make", "env_reset", "env_observe", "env_step",
           "env_final", "FusionEnv"]

STATE_DIM = 8
_LOG_CAP = float(np.log1p(2 ** 24))
_BUDGET_CAP = float(np.log1p(1024.0))


def encode_action(a: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """Map {SYNC} u [1..B] -> [-1, 1] for the regression head (``batch``
    is per row)."""
    a = a.to(torch.float32)
    return torch.where(a < 0.0, -0.5, a / batch)


def decode_action(y: torch.Tensor, batch) -> torch.Tensor:
    """Inverse of :func:`encode_action`, thresholded at 0.  Rounds half to
    even (``torch.round``), as the reference does."""
    y = y.to(torch.float32)
    batch = torch.as_tensor(batch, dtype=torch.float32, device=y.device)
    mb = torch.minimum(torch.clamp_min(torch.round(y * batch), 1.0), batch)
    return torch.where(y < 0.0, float(cm.SYNC), mb).to(torch.int32)


def returns_to_go(peak_mem: torch.Tensor, budget_bytes: torch.Tensor):
    """The §4.3.3 conditioning rule: fraction of the requested budget still
    free after the prefix commits."""
    return torch.clamp_min((budget_bytes - peak_mem) / budget_bytes, 0.0)


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
    ``device``: the holder that ``infer.dnnfuser_infer_fused`` and
    ``infer.dnnfuser_infer_batch`` accept."""

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
        self.n = int(self.workload.n)
