"""Gradient polish of integer fusion strategies.

Port of ``repro.core.polish``.  A proposed strategy is REFINED by descent
instead of re-searched: relax the integer micro-batches to a continuous
tile space (the sync structure -- which positions flush -- stays FIXED),
descend a smooth twin of the cost under a ramped budget penalty, then
re-round snapshots of the trajectory and keep the best exactly-scored
valid candidate.

Relaxation contract:

 - ``mb_i = 1 + (B - 1) * sigmoid(z_i)`` maps unconstrained ``z`` into the
   legal tile range ``[1, B]``;
 - the smooth evaluator (:func:`_relaxed_cost`) is the cost model EXCEPT
   that micro-batch waves are continuous (``B / mbe`` instead of
   ``ceil(B / mbe)``), a lower bound of the integer cost that is tight at
   divisors of ``B``;
 - the descent loss is ``latency / latency_0 + lam_t * relu(peak/budget
   - 1)^2`` with ``lam_t`` ramped geometrically from ``lam0`` to ``lam1``
   over the steps; snapshots along the ramp are re-rounded.

The descent runs batched over ``[C, P]`` with torch autograd (a Python
loop over the steps).  Its group sums are one-hot products reduced by
``cost_model.fixed_sum``, and so is the latency over the groups (the peak
is a max, exact in any order): every operation is elementwise or reduces
in an order fixed by the axis length, so a lane's trajectory is
bit-identical run to run and whatever its neighbours are (no
``index_add_``/``scatter_add_``, whose CUDA atomics add in no fixed order,
and no ``torch.sum``, whose order may follow the tensor's shape).

Rounding contract (the never-worsens guarantee): every snapshot is
re-rounded three ways (round, floor, ceil), each candidate is doubled
with a tail-flush variant (SYNC at position ``n``), the ORIGINAL is
prepended, and all candidates are exactly re-scored in one
``cost_model.evaluate_grid`` call (one ``fusion_eval`` launch on the
card): the best valid candidate by exact latency wins, ties keep the
original.  If NO candidate is valid, a deterministic constraint repair
(shrink the worst group's largest stage, else split it) runs on the
lowest-peak candidate through ``evaluate_grid_stats``; if even that fails
the original comes back untouched.  No RNG anywhere.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from . import cost_model as cm
from .accel import BW_OFF, BW_ON, FREQ, LANES, NPE, STREAM, T_PASS, \
    T_SYNC, stack_hw

__all__ = ["PolishConfig", "PolishResult", "polish_strategy", "polish_grid"]


@dataclass(frozen=True)
class PolishConfig:
    """Descent/rounding knobs (the reference's defaults)."""
    steps: int = 48          # Adam steps along the penalty ramp
    snapshots: int = 6       # re-rounded trajectory points (3 cands each)
    lr: float = 0.16         # Adam step size in z (logit-tile) space
    lam0: float = 0.1        # penalty weight at step 0
    lam1: float = 300.0      # penalty weight at the last step
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    zclip: float = 12.0      # |z| bound (sigmoid saturation guard)
    repair_tries: int = 8    # deterministic-repair rounds for invalid cells


@dataclass
class PolishResult:
    """One polished condition: the accepted strategy with its exact cost
    and the pre-polish numbers it is guaranteed not to be worse than."""
    strategy: np.ndarray
    latency: float
    peak_mem: float
    valid: bool
    improved: bool
    pre_latency: float
    pre_peak: float
    pre_valid: bool
    wall_s: float


# ---------------------------------------------------------------------------
# The smooth relaxed evaluator.
# ---------------------------------------------------------------------------


def _clip(x, lo, hi):
    """``jnp.clip``: max then min, whose gradient splits at ties."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _shift(x: torch.Tensor, first) -> torch.Tensor:
    """``x`` moved one position right along the last axis, ``first`` at 0."""
    head = torch.full_like(x[:, :1], first)
    return torch.cat([head, x[:, :-1]], dim=1)


def _relaxed_cost(wl: dict, sync, mb, B, budget, hw):
    """(latency [C], peak [C]) of the smooth twin over rows ``wl`` [C, P]
    with a FIXED sync structure ``sync`` [C, P] (bool) and continuous
    tiles ``mb`` [C, P]; ``B``/``budget`` [C], ``hw`` [C, 10].  The cost
    model's math except ``waves = B / mbe`` (no ceil)."""
    A, W = cm._scaled_AW(wl, hw)
    F, OE, UC = wl["F"], wl["OE"], wl["UC"]
    mask, skip, n = wl["mask"], wl["SKIP"].long(), wl["n"].long()
    C, P = A.shape
    pos = torch.arange(P, device=A.device)
    Bc = B[:, None]

    sync = sync & mask
    mb = _clip(mb, torch.ones_like(mb), Bc)
    prev_mb = _shift(mb, 1.0)
    prev_sync = _shift(sync, False)
    mbe = torch.where(sync, torch.where(prev_sync, 1.0, prev_mb), mb)
    stage_mb = torch.where(sync, 1.0, mb)
    fmask = mask.to(torch.float32)

    si = sync.to(torch.int64)
    gid = torch.cumsum(si, dim=1) - si
    head = mask & (prev_sync | (pos == 1))
    tail = mask & (sync | (pos == n[:, None]))
    onehot = (gid[:, :, None] == pos).to(torch.float32)        # [C, i, g]

    def seg(x):                  # per-group sums in a fixed order, [C, g]
        return cm.fixed_sum(x[:, :, None] * onehot, dim=1)

    glen = seg(fmask)
    fused = (glen.gather(1, gid) > 1.0) & mask
    mbe = torch.where(fused, mbe, Bc)

    A_prev = _shift(A, 0.0)
    has_skip = (skip >= 0) & mask
    src = skip.clamp(0, P - 1)
    same_group = has_skip & (gid.gather(1, src) == gid)
    A_src = A.gather(1, src)
    skip_hold = torch.where(same_group, mbe * A_src, 0.0)
    skip_traffic = torch.where(has_skip & ~same_group, 2.0 * Bc * A_src, 0.0)

    m_fused = (stage_mb * A + head.to(torch.float32) * mbe * A_prev
               + skip_hold)
    mem_i = torch.where(fused, m_fused,
                        torch.minimum(m_fused, hw[:, STREAM:STREAM + 1]))
    M_g = seg(mem_i * fmask)

    waves = Bc / mbe                      # continuous: the relaxation
    t_i = (head.to(torch.float32) * Bc * A_prev
           + tail.to(torch.float32) * Bc * A + W * waves + skip_traffic)
    T_g = seg(t_i * fmask)

    lanes = hw[:, NPE:NPE + 1] * hw[:, LANES:LANES + 1]
    peak_macs = lanes * hw[:, FREQ:FREQ + 1]
    util = _clip(mbe * OE / lanes, torch.full_like(UC, cm._UTIL_MIN), UC)
    comp = Bc * F / peak_macs / util
    C_g = seg(comp * fmask)
    o_i = Bc * (A_prev + A) + W * waves
    O_g = seg(o_i * fmask)
    wave_g = seg(waves * fmask)

    nonempty = glen > 0.0
    peak = torch.amax(torch.where(nonempty, M_g, 0.0), dim=-1)   # exact
    fill_g = (wave_g * hw[:, T_PASS:T_PASS + 1]
              + nonempty.to(torch.float32) * hw[:, T_SYNC:T_SYNC + 1])
    L_g = torch.maximum(torch.maximum(C_g, T_g / hw[:, BW_OFF:BW_OFF + 1]),
                        O_g / hw[:, BW_ON:BW_ON + 1]) + fill_g
    return cm.fixed_sum(L_g), peak


def _mb_of(z: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return 1.0 + (B - 1.0) * torch.sigmoid(z)


def _z_of(strategy: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Logit-space init: ``mb_of(z_of(s)) ~= clip(s, 1, B)``.  SYNC
    positions land at the low saturation (their tile is unused)."""
    s = strategy.to(torch.float32)
    mb0 = _clip(s, torch.ones_like(s), B)
    frac = torch.clamp((mb0 - 1.0) / torch.clamp_min(B - 1.0, 1e-6),
                       1e-4, 1.0 - 1e-4)
    return torch.log(frac) - torch.log1p(-frac)


def _snap_indices(cfg: PolishConfig) -> tuple[int, ...]:
    """Snapshot steps: ``snapshots`` points spread over the ramp, always
    including the final step (skipping step ~0: the original is prepended
    as its own candidate)."""
    k = max(1, min(cfg.snapshots, cfg.steps))
    return tuple(sorted({int(i) for i in
                         np.linspace(0, cfg.steps - 1, k + 1)[1:]}))


def _descent(wl, strategies, B, budget, hw, cfg: PolishConfig):
    """Adam descent of every lane at once: strategies [C, P] -> tile
    snapshots [C, K, P].  Deterministic and lane-independent: the loss is
    a sum of per-lane losses (its gradient is each lane's own) and every
    operation is elementwise or a fixed-order reduction."""
    dev = strategies.device
    lams = torch.exp(torch.linspace(math.log(cfg.lam0), math.log(cfg.lam1),
                                    cfg.steps, device=dev))
    snap = set(_snap_indices(cfg))
    Bc = B[:, None]
    sync = (strategies < 0) & wl["mask"]
    z = _z_of(strategies, Bc)
    with torch.no_grad():
        lat0, _ = _relaxed_cost(wl, sync, _mb_of(z, Bc), B, budget, hw)
        lat0 = torch.clamp_min(lat0, 1e-30)
    mu, nu = torch.zeros_like(z), torch.zeros_like(z)
    t = torch.zeros((), device=dev)
    b1 = torch.tensor(cfg.beta1, device=dev)
    b2 = torch.tensor(cfg.beta2, device=dev)
    zero = torch.zeros_like(budget)
    snaps = []
    for k in range(cfg.steps):
        zg = z.detach().requires_grad_(True)
        lat, peak = _relaxed_cost(wl, sync, _mb_of(zg, Bc), B, budget, hw)
        over = torch.maximum(peak / budget - 1.0, zero)
        loss = lat / lat0 + lams[k] * over * over
        g, = torch.autograd.grad(loss.sum(), zg)
        with torch.no_grad():
            t = t + 1.0
            mu = cfg.beta1 * mu + (1.0 - cfg.beta1) * g
            nu = cfg.beta2 * nu + (1.0 - cfg.beta2) * g * g
            mh = mu / (1.0 - b1 ** t)
            nh = nu / (1.0 - b2 ** t)
            z = torch.clamp(z - cfg.lr * mh / (torch.sqrt(nh) + cfg.eps),
                            -cfg.zclip, cfg.zclip)
            if k in snap:
                snaps.append(_mb_of(z, Bc))
    return torch.stack(snaps, dim=1)


# ---------------------------------------------------------------------------
# Re-rounding, exact scoring, deterministic repair.
# ---------------------------------------------------------------------------


def _repair_det(wls, s, batches, budgets, hw, tries: int):
    """Deterministic twin of the G-Sampler's repair: while a strategy is
    over budget, SHRINK the worst group's largest staged micro-batch, or
    SPLIT the group when no stage can shrink -- no coin flip, so the
    result is a pure function of the input (lane-order invariant).  One
    ``evaluate_grid_stats`` call a round; stops after the first round that
    finds every candidate valid (which changes nothing)."""
    C, K, P = s.shape
    pos = torch.arange(P, device=s.device)
    mask = wls["mask"]
    for _ in range(tries):
        out, gid, M_g = cm.evaluate_grid_stats(wls, s, batches, budgets, hw)
        invalid = ~out.valid                                  # [C, K]
        if not bool(invalid.any()):
            break
        worst = torch.argmax(M_g, dim=-1)
        members = (gid == worst[..., None]) & mask[:, None, :]
        mi = members.to(torch.int32)
        start = torch.argmax(mi, dim=-1)
        end = P - 1 - torch.argmax(mi.flip(-1), dim=-1)
        mid = (start + end) // 2
        multi = end > start
        seg_mb = torch.where(members & (s > 1), s, 0)
        jmax = torch.argmax(seg_mb, dim=-1)
        has_mb = torch.amax(seg_mb, dim=-1) > 1
        onehot_mid = pos == mid[..., None]
        onehot_j = pos == jmax[..., None]
        shrink_s = torch.where(onehot_j, torch.clamp_min(s // 2, 1), s)
        split_s = torch.where(multi[..., None] & onehot_mid, cm.SYNC, s)
        new = torch.where(has_mb[..., None], shrink_s, split_s)
        apply = invalid & members.any(-1)
        s = torch.where(apply[..., None], new, s).to(torch.int32)
    return s.contiguous()


def _round_candidates(strategies: np.ndarray, mbs: np.ndarray,
                      batches: np.ndarray, ns: np.ndarray,
                      mask: np.ndarray) -> np.ndarray:
    """[original | round | floor | ceil](snapshots)] x [as-is |
    tail-flush] -> [C, 2(1+3K), P] (host numpy, the reference's).

    Sync positions and padding keep SYNC; tiles clip to [1, B].  All
    three integer neighbours matter: the smooth ``B/mbe`` twin undercuts
    the real ``ceil(B/mbe)`` just below wave boundaries, so the continuous
    optimum often sits at e.g. 63.4 where 64 (ceil) is the true winner,
    63 (round/floor) pays a whole extra wave, and floor can restore
    validity that rounding up broke."""
    C, K, P = mbs.shape
    pos = np.arange(P)
    validp = pos[None, :] <= ns[:, None]
    sync = (strategies < 0) & mask
    B = batches.astype(np.float64)[:, None, None]  # repro_torch: noqa[TDET002] -- host re-round candidates; integer tiles exact, re-scored in f32
    tiles = np.concatenate([np.rint(mbs), np.floor(mbs), np.ceil(mbs)],
                           axis=1)
    tiles = np.clip(tiles, 1.0, B).astype(np.int32)
    cand = np.where(sync[:, None, :], cm.SYNC, tiles)
    cand = np.where(validp[:, None, :], cand, cm.SYNC)
    cand = np.concatenate([strategies[:, None, :], cand],
                          axis=1).astype(np.int32)
    # tail-flush variants: SYNC at position n shrinks the final group's
    # working set; position 0 can never sync (rows with n == 0 duplicate,
    # and duplicates re-score harmlessly)
    tail = (pos[None, :] == ns[:, None]) & (ns > 0)[:, None]
    flush = np.where(tail[:, None, :], cm.SYNC, cand)
    return np.concatenate([cand, flush], axis=1)


def _host_cost(out: cm.CostOut) -> tuple[np.ndarray, ...]:
    """(latency, peak_mem, valid) of a CostOut as host arrays, one copy."""
    both = torch.stack([out.latency, out.peak_mem,
                        out.valid.to(torch.float32)]).cpu().numpy()
    return both[0], both[1], both[2].astype(bool)


def polish_grid(wls: dict, strategies, batches, budgets_bytes, hw, *,
                cfg: PolishConfig = PolishConfig(), device=None) -> dict:
    """Polish [C] proposed strategies on ``device`` (``cuda`` unless
    ``"cpu"``).

    ``wls`` is a ``stack_workloads`` dict [C, ...] on ``device``;
    ``strategies`` [C, P] int32 (SYNC = -1, host numpy); ``hw``
    anything ``accel.stack_hw`` accepts.  Returns a dict of numpy arrays:
    the accepted ``strategy`` [C, P] plus its exact ``latency`` /
    ``peak_mem`` / ``valid`` and the pre-polish ``pre_latency`` /
    ``pre_peak`` / ``pre_valid``; ``improved`` [C] marks cells where
    polish strictly beat the proposal (lower exact latency, or validity
    restored).  Per cell the result is NEVER worse than the input."""
    dev = resolve_device(device)
    if wls["A"].device != dev:
        raise ValueError(f"workloads are on {wls['A'].device}, polish runs "
                         f"on {dev}")
    strategies = np.asarray(strategies, np.int32)
    C, P = strategies.shape
    batches = np.asarray(batches, np.float32).reshape(C)
    budgets = np.asarray(budgets_bytes, np.float32).reshape(C)
    hwv = stack_hw(hw, C, dev)
    B = torch.as_tensor(batches, device=dev)
    budget = torch.as_tensor(budgets, device=dev)
    mask = wls["mask"].cpu().numpy().astype(bool)
    ns = wls["n"].cpu().numpy().astype(np.int64)

    mbs = _descent(wls, torch.as_tensor(strategies, device=dev), B, budget,
                   hwv, cfg).cpu().numpy()                    # [C, K, P]
    cands = _round_candidates(strategies, mbs, batches, ns, mask)
    lat, peak, val = _host_cost(cm.evaluate_grid(
        wls, torch.as_tensor(cands, device=dev), B, budget, hwv))

    rows = np.arange(C)
    score = np.where(val, lat, np.inf)
    pick = np.argmin(score, axis=1)        # ties -> lowest index: original
    has_valid = val.any(axis=1)

    final = cands[rows, pick]
    f_lat, f_peak, f_val = lat[rows, pick], peak[rows, pick], val[rows, pick]

    if not has_valid.all():
        # no rounding was valid anywhere in these cells: deterministic
        # repair of the lowest-peak candidate, then exact re-score
        alt = np.argmin(peak, axis=1)
        seed = cands[rows, np.where(has_valid, pick, alt)][:, None, :]
        rep = _repair_det(wls, torch.as_tensor(seed, device=dev), B, budget,
                          hwv, cfg.repair_tries)
        r_lat, r_peak, r_val = (x[:, 0] for x in _host_cost(
            cm.evaluate_grid(wls, rep, B, budget, hwv)))
        rep = rep[:, 0].cpu().numpy()
        use = ~has_valid & r_val
        final = np.where(use[:, None], rep, final)
        f_lat = np.where(use, r_lat, f_lat)
        f_peak = np.where(use, r_peak, f_peak)
        f_val = np.where(use, r_val, f_val)
        # still invalid: hand the original back untouched
        keep = ~has_valid & ~r_val
        final = np.where(keep[:, None], strategies, final)
        f_lat = np.where(keep, lat[:, 0], f_lat)
        f_peak = np.where(keep, peak[:, 0], f_peak)
        f_val = np.where(keep, val[:, 0], f_val)

    o_lat, o_peak, o_val = lat[:, 0], peak[:, 0], val[:, 0]
    improved = (f_val & ~o_val) | (f_val & o_val & (f_lat < o_lat))
    return dict(strategy=final.astype(np.int32), latency=f_lat,
                peak_mem=f_peak, valid=f_val, improved=improved,
                pre_latency=o_lat, pre_peak=o_peak, pre_valid=o_val)


def polish_strategy(env, strategy, *,
                    cfg: PolishConfig = PolishConfig()) -> PolishResult:
    """Polish one strategy against a ``FusionEnv`` condition, on the env's
    device (:func:`polish_grid` is the batched form the engine uses)."""
    t0 = time.perf_counter()
    wls = cm.stack_workloads([env.wl])
    res = polish_grid(wls, np.asarray(strategy, np.int32)[None, :],
                      [float(env.batch)], [float(env.budget_bytes)],
                      [env.hw], cfg=cfg, device=env.device)
    return PolishResult(
        strategy=res["strategy"][0], latency=float(res["latency"][0]),
        peak_mem=float(res["peak_mem"][0]), valid=bool(res["valid"][0]),
        improved=bool(res["improved"][0]),
        pre_latency=float(res["pre_latency"][0]),
        pre_peak=float(res["pre_peak"][0]),
        pre_valid=bool(res["pre_valid"][0]),
        wall_s=time.perf_counter() - t0)
