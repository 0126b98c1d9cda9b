"""Analytical layer-fusion cost model (paper §5.1 "Cost Model").

Port of ``repro.core.cost_model``.  Maps (workload, batch, hw, fusion
strategy) to (latency, peak on-chip memory, off-chip traffic); the
semantics are the reference's (DESIGN §3).

Every population and grid evaluator goes through the ``fusion_eval``
kernel wrapper (``kernels/fusion_eval.py``): the hand-written CUDA kernel
for tensors on the card, its plain PyTorch twin for tensors on the CPU.
The reference's ``evaluator="xla"|"pallas"`` switch is not carried over.

Array convention (``Workload.arrays``): position 0 is the network-input
pseudo tensor, positions ``1..n`` are layers, padded to ``nmax``.  The
hardware is a ``[..., HW_FEATURE_DIM]`` f32 tensor (``accel.stack_hw``).
Packed workloads carry their pack-time bytes/elem (``BPE``); evaluation
rescales A/W to the serving hw's bytes/elem, an identity when they match.

The prefix-carry functions (``prefix_*``) are batched over a leading row
axis: consts fields are ``[R, P]`` or ``[R]``, carry fields ``[R]``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from .accel import (BPE, BW_OFF, BW_ON, FREQ, LANES, NPE, STREAM, T_PASS,
                    T_SYNC, AccelConfig, stack_hw)

__all__ = ["SYNC", "CostOut", "pack_workload", "stack_workloads",
           "finalize_groups", "evaluate", "evaluate_population",
           "evaluate_population_stats", "evaluate_grid",
           "evaluate_grid_stats", "baseline_no_fusion", "baseline_grid",
           "PrefixConsts", "PrefixCarry", "prefix_consts", "prefix_init",
           "prefix_step", "prefix_out", "prefix_probe_peak", "prefix_trace",
           "prefix_scan", "random_strategy", "fixed_sum"]

SYNC = -1  # strategy sentinel: flush activation off-chip after this layer
_UTIL_MIN = 1.0 / 4096.0
_F32_KEYS = ("A", "W", "F", "OE", "UC", "SHAPE6")


class CostOut(NamedTuple):
    latency: torch.Tensor     # seconds, end-to-end
    peak_mem: torch.Tensor    # bytes, max over fused groups
    traffic: torch.Tensor     # bytes, total off-chip
    valid: torch.Tensor       # peak_mem <= budget
    n_groups: torch.Tensor    # number of fused groups (int32)


def pack_workload(workload, hw: AccelConfig, nmax: int = 64,
                  device=None) -> dict[str, torch.Tensor]:
    """Device-ready workload tensors, bytes scaled by ``hw.bytes_per_elem``;
    ``BPE`` records that pack-time bytes/elem."""
    dev = resolve_device(device)
    arrs = workload.arrays(nmax, bytes_per_elem=hw.bytes_per_elem)
    out = {k: torch.as_tensor(np.asarray(arrs[k]).astype(np.float32),
                              device=dev) for k in _F32_KEYS}
    out["SKIP"] = torch.as_tensor(np.asarray(arrs["SKIP"], np.int32),
                                  device=dev)
    out["mask"] = torch.as_tensor(np.asarray(arrs["mask"], bool), device=dev)
    out["n"] = torch.tensor(int(arrs["n"]), dtype=torch.int32, device=dev)
    out["BPE"] = torch.tensor(float(hw.bytes_per_elem), dtype=torch.float32,
                              device=dev)
    return out


def stack_workloads(wls: list[dict]) -> dict[str, torch.Tensor]:
    """Stack packed workloads (same ``nmax``) along a leading condition
    axis; rows ride their own ``n``, padding stays masked."""
    sizes = sorted({int(w["A"].shape[-1]) for w in wls})
    if len(sizes) > 1:
        raise ValueError(f"cannot stack workloads packed to different nmax "
                         f"{sizes}; repack to a shared bucket")
    return {k: torch.stack([w[k] for w in wls]) for k in wls[0]}


def _col(hw: torch.Tensor, k: int) -> torch.Tensor:
    """Field ``k`` of hw rows ``[..., 10]`` with a trailing unit axis."""
    return hw[..., k:k + 1]


def _scaled_AW(wl: dict, hw: torch.Tensor):
    """A/W of rows ``[R, P]`` rescaled to hw rows ``[R, 10]``'s bytes/elem."""
    s = _col(hw, BPE) / wl["BPE"][..., None]
    return wl["A"] * s, wl["W"] * s


def finalize_groups(C_g, T_g, O_g, M_g, wave_g, glen, budget_bytes,
                    hw) -> CostOut:
    """Per-group decomposition -> CostOut, reducing the trailing group axis
    in group order.

    The reference's ``finalize_groups`` with its sums and max taken column
    by column from 0 over the closed groups (``glen > 0``), the order in
    which the ``fusion_eval`` kernel reduces in its launch, so the two
    agree bit for bit; an empty column adds exactly 0 in the reference.
    ``hw`` is a ``[..., 10]`` tensor whose leading axes broadcast against
    the group arrays' (``[C, 1, 10]`` for ``[C, POP, P]`` grids), and
    ``budget_bytes`` broadcasts against the result (``[C, 1]``)."""
    nonempty = glen > 0.0
    fill_g = wave_g * _col(hw, T_PASS) + nonempty.float() * _col(hw, T_SYNC)
    L_g = torch.maximum(torch.maximum(C_g, T_g / _col(hw, BW_OFF)),
                        O_g / _col(hw, BW_ON)) + fill_g
    L_g = torch.where(nonempty, L_g, 0.0)
    T_g = torch.where(nonempty, T_g, 0.0)
    M_g = torch.where(nonempty, M_g, 0.0)
    latency = traffic = peak_mem = torch.zeros(L_g.shape[:-1],
                                               device=L_g.device)
    for g in range(L_g.shape[-1]):
        latency = latency + L_g[..., g]
        traffic = traffic + T_g[..., g]
        peak_mem = torch.maximum(peak_mem, M_g[..., g])
    n_groups = torch.sum(nonempty, dim=-1).to(torch.int32)
    valid = peak_mem <= budget_bytes
    return CostOut(latency, peak_mem, traffic, valid, n_groups)


def fixed_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in one fixed order: zero-pad the axis to a power of
    two, then add its upper half onto its lower half until one entry is
    left.  Every step is elementwise, so a row's sum depends only on that
    row -- not on how many rows the tensor has, nor on the device -- where
    ``torch.sum`` may pick its reduction order by the tensor's shape."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    m = 1 << max(n - 1, 0).bit_length()
    if m != n:
        x = torch.nn.functional.pad(x, (0, m - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _as_strategies(strategies, like: torch.Tensor) -> torch.Tensor:
    if isinstance(strategies, torch.Tensor) and \
            strategies.dtype is torch.int32 and strategies.is_contiguous() \
            and strategies.get_device() == like.get_device():
        return strategies
    return torch.as_tensor(strategies, device=like.device).to(
        torch.int32).contiguous()


def _as_f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def evaluate_grid_stats(wls: dict, strategies, batches, budgets, hw):
    """``(CostOut [C, POP], gid [C, POP, P], M_g [C, POP, P])`` of
    per-condition populations ``strategies`` [C, POP, P] over stacked
    workloads, per-condition ``batches``/``budgets`` [C] and hardware
    (anything ``accel.stack_hw`` accepts): one ``fusion_eval`` launch on
    the card."""
    from ..kernels.fusion_eval import fusion_eval_grid_stats
    return fusion_eval_grid_stats(wls, _as_strategies(strategies, wls["A"]),
                                  batches, budgets, hw)


def evaluate_grid(wls: dict, strategies, batches, budgets, hw) -> CostOut:
    """CostOut [C, POP]; see :func:`evaluate_grid_stats` (the launch writes
    no group matrix)."""
    from ..kernels.fusion_eval import fusion_eval_grid
    return fusion_eval_grid(wls, _as_strategies(strategies, wls["A"]),
                            batches, budgets, hw)


def _lift(wl: dict) -> dict:
    return {k: v.unsqueeze(0) for k, v in wl.items()}


def _one(wl: dict, strategies, batch, budget_bytes, hw) -> tuple:
    """One packed workload's population as a one-condition grid."""
    s = _as_strategies(strategies, wl["A"])
    return (_lift(wl), s[None], _as_f32(batch, s).reshape(1),
            _as_f32(budget_bytes, s).reshape(1), stack_hw(hw, 1, s.device))


def evaluate_population_stats(wl: dict, strategies, batch, budget_bytes, hw):
    """Single-condition form: ``(CostOut [pop], gid [pop, P], M_g [pop, P])``."""
    out, gid, M_g = evaluate_grid_stats(*_one(wl, strategies, batch,
                                              budget_bytes, hw))
    return CostOut(*(x[0] for x in out)), gid[0], M_g[0]


def evaluate_population(wl: dict, strategies, batch, budget_bytes,
                        hw) -> CostOut:
    """CostOut [pop] of strategies [pop, P] against one packed workload."""
    out = evaluate_grid(*_one(wl, strategies, batch, budget_bytes, hw))
    return CostOut(*(x[0] for x in out))


def evaluate(wl: dict, strategy, batch, budget_bytes, hw) -> CostOut:
    """Cost of one strategy [P] (0-dim CostOut fields)."""
    s = _as_strategies(strategy, wl["A"])
    out = evaluate_population(wl, s[None], batch, budget_bytes, hw)
    return CostOut(*(x[0] for x in out))


def _baseline_rows(wl: dict, B: torch.Tensor, hw: torch.Tensor) -> CostOut:
    """No-fusion baseline of rows ``[R, P]``: B [R], hw [R, 10].  The sums
    are :func:`fixed_sum`'s, so a row's baseline (the numerator of every
    speedup) is the same in a batch of any size."""
    A, W = _scaled_AW(wl, hw)
    F, OE, UC, mask = wl["F"], wl["OE"], wl["UC"], wl["mask"]
    B = B[:, None]
    fmask = mask.float()
    A_prev = torch.nn.functional.pad(A[:, :-1], (1, 0))
    lanes = _col(hw, NPE) * _col(hw, LANES)
    util = torch.minimum(torch.clamp_min(B * OE / lanes, _UTIL_MIN), UC)
    comp = B * F / (lanes * _col(hw, FREQ)) / util
    t_i = B * (A_prev + A) + W
    L_i = torch.maximum(torch.maximum(comp, t_i / _col(hw, BW_OFF)),
                        t_i / _col(hw, BW_ON)) + _col(hw, T_SYNC)
    R = A.shape[0]
    return CostOut(fixed_sum(L_i * fmask), hw[:, STREAM].clone(),
                   fixed_sum(t_i * fmask),
                   torch.ones(R, dtype=torch.bool, device=A.device),
                   torch.sum(mask, dim=-1).to(torch.int32))


def baseline_grid(wls: dict, batches, hw) -> CostOut:
    """Per-condition no-fusion baselines, CostOut [C]."""
    B = _as_f32(batches, wls["A"])
    return _baseline_rows(wls, B, stack_hw(hw, B.shape[0], B.device))


def baseline_no_fusion(wl: dict, batch, hw) -> CostOut:
    """The paper's baseline: layer by layer, full batch per layer, minimal
    buffer, every activation round-trips off-chip (0-dim fields)."""
    out = baseline_grid(_lift(wl), _as_f32(batch, wl["A"]).reshape(1), hw)
    return CostOut(*(x[0] for x in out))


# ---------------------------------------------------------------------------
# Incremental prefix evaluation (the reference's scan-carry form).
#
# The carry holds the cost of the strategy with positions ``< t`` applied
# and the rest forced to SYNC, as O(1)-per-step running state: forced-SYNC
# positions are singleton groups whose cost does not depend on the prefix,
# so their suffix sums / max are precomputed once (``PrefixConsts``).
# ---------------------------------------------------------------------------


class PrefixConsts(NamedTuple):
    A: torch.Tensor          # [R, P] act bytes/sample (rescaled to hw)
    A_prev: torch.Tensor     # [R, P] producer act bytes
    W: torch.Tensor          # [R, P] weight bytes
    F: torch.Tensor          # [R, P] MACs/sample
    OE: torch.Tensor         # [R, P]
    UC: torch.Tensor         # [R, P]
    skip: torch.Tensor       # [R, P] residual source position or -1 (long)
    has_skip: torch.Tensor   # [R, P] bool
    mask: torch.Tensor       # [R, P]
    n: torch.Tensor          # [R] num layers (long)
    B: torch.Tensor          # [R] batch (f32)
    budget: torch.Tensor     # [R] bytes (f32)
    sm: torch.Tensor         # [R, P] singleton group peak mem
    st: torch.Tensor         # [R, P] singleton group traffic
    slat: torch.Tensor       # [R, P] singleton group latency
    hold0: torch.Tensor      # [R, P] same-group skip hold of a singleton
    SLAT: torch.Tensor       # [R, P+2] suffix sum of slat
    SPEAK: torch.Tensor      # [R, P+2] suffix max of sm
    STRAF: torch.Tensor      # [R, P+2] suffix sum of st
    SGRP: torch.Tensor       # [R, P+2] suffix count of layers (long)


class PrefixCarry(NamedTuple):
    t: torch.Tensor          # [R] next position to act on (long)
    g_start: torch.Tensor    # [R] first position of the open group (long)
    open_len: torch.Tensor   # [R] committed members of the open group
    last_mb: torch.Tensor    # [R] micro-batch of the last member (f32)
    c_sum: torch.Tensor      # open-group compute seconds
    t_sum: torch.Tensor      # open-group off-chip bytes
    o_sum: torch.Tensor      # open-group on-chip bytes
    m_sum: torch.Tensor      # open-group staged-act bytes
    w_sum: torch.Tensor      # open-group micro-batch waves
    lat: torch.Tensor        # closed groups: total latency
    peak: torch.Tensor       # closed groups: max group memory
    traf: torch.Tensor       # closed groups: total traffic
    groups: torch.Tensor     # closed groups: count (long)


def _suffix(x: torch.Tensor, op) -> torch.Tensor:
    s = op(x.flip(-1)).flip(-1)
    return torch.nn.functional.pad(s, (0, 2))


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[r, clip(i[r])]`` for rows ``x`` [R, L] and indices ``i`` [R]."""
    j = i.clamp(0, x.shape[-1] - 1).long()
    return x.gather(-1, j[:, None])[:, 0]


def _hw_terms(hw: torch.Tensor):
    """(lanes, peak_macs) of hw rows [R, 10], each [R]."""
    lanes = hw[:, NPE] * hw[:, LANES]
    return lanes, lanes * hw[:, FREQ]


def _util(mb, oe, uc, lanes):
    return torch.minimum(torch.clamp_min(mb * oe / lanes, _UTIL_MIN), uc)


def prefix_consts(wl: dict, batch, budget_bytes, hw) -> PrefixConsts:
    """Per-position constants of the forced-SYNC suffix for rows ``wl``
    [R, P], ``batch``/``budget_bytes`` [R] and hw rows [R, 10]."""
    A, W = _scaled_AW(wl, hw)
    F, OE, UC, mask = wl["F"], wl["OE"], wl["UC"], wl["mask"]
    skip = wl["SKIP"].long()
    R, P = A.shape
    pos = torch.arange(P, device=A.device)
    B = _as_f32(batch, A)
    Bc = B[:, None]
    fmask = mask.float()
    A_prev = torch.nn.functional.pad(A[:, :-1], (1, 0))
    has = (skip >= 0) & mask
    Asrc = A.gather(1, skip.clamp(0, P - 1))
    same0 = has & (skip == 0) & (pos == 1)
    hold0 = torch.where(same0, Bc * Asrc, 0.0)
    cross = torch.where(has & ~same0, 2.0 * Bc * Asrc, 0.0)
    lanes = _col(hw, NPE) * _col(hw, LANES)
    util_B = torch.minimum(torch.clamp_min(Bc * OE / lanes, _UTIL_MIN), UC)
    comp_B = Bc * F / (lanes * _col(hw, FREQ)) / util_B
    sm = torch.minimum(A + Bc * A_prev + hold0, _col(hw, STREAM)) * fmask
    st = (Bc * A_prev + Bc * A + W + cross) * fmask
    so = Bc * (A_prev + A) + W
    slat = (torch.maximum(torch.maximum(comp_B, st / _col(hw, BW_OFF)),
                          so / _col(hw, BW_ON))
            + _col(hw, T_PASS) + _col(hw, T_SYNC)) * fmask
    cumsum = lambda x: torch.cumsum(x, dim=-1)
    cummax = lambda x: torch.cummax(x, dim=-1).values
    return PrefixConsts(
        A=A, A_prev=A_prev, W=W, F=F, OE=OE, UC=UC, skip=skip, has_skip=has,
        mask=mask, n=wl["n"].long(), B=B,
        budget=_as_f32(budget_bytes, A),
        sm=sm, st=st, slat=slat, hold0=hold0,
        SLAT=_suffix(slat, cumsum), SPEAK=_suffix(sm, cummax),
        STRAF=_suffix(st, cumsum), SGRP=_suffix(mask.long(), cumsum))


def prefix_init(consts: PrefixConsts) -> PrefixCarry:
    R = consts.B.shape[0]
    dev = consts.B.device
    i0 = torch.zeros(R, dtype=torch.long, device=dev)
    f0 = torch.zeros(R, dtype=torch.float32, device=dev)
    return PrefixCarry(t=i0, g_start=i0 + 1, open_len=i0, last_mb=f0 + 1.0,
                       c_sum=f0, t_sum=f0, o_sum=f0, m_sum=f0, w_sum=f0,
                       lat=f0, peak=f0, traf=f0, groups=i0)


def _select(pred: torch.Tensor, a: NamedTuple, b: NamedTuple):
    return type(a)(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def _terms(c: PrefixConsts, i: torch.Tensor):
    """Per-position terms at (clipped) positions ``i`` [R]."""
    return (_at(c.A, i), _at(c.A_prev, i), _at(c.W, i), _at(c.F, i),
            _at(c.OE, i), _at(c.UC, i), _at(c.skip, i), _at(c.has_skip, i))


def _same_group(src, has, g_start):
    """gid[src] == gid[i] for ``i`` in the open group starting at g_start
    (position 0 carries gid 0, the id of the first group)."""
    return has & ((src >= g_start) | ((src == 0) & (g_start == 1)))


def _close_terms(c: PrefixConsts, carry: PrefixCarry, i, hw):
    """Component sums of the open group closed by a SYNC at position ``i``
    (riding the last member's micro-batch with a 1-sample staged FIFO)."""
    lanes, peak_macs = _hw_terms(hw)
    B = c.B
    Ai, Api, Wi, Fi, OEi, UCi, srci, hasi = _terms(c, i)
    Asrc = _at(c.A, srci)
    same = _same_group(srci, hasi, carry.g_start)
    mbe = carry.last_mb
    waves = torch.ceil(B / mbe)
    comp = B * Fi / peak_macs / _util(mbe, OEi, UCi, lanes)
    mem = Ai + torch.where(same, mbe * Asrc, 0.0)
    tr = (B * Ai + Wi * waves
          + torch.where(hasi & ~same, 2.0 * B * Asrc, 0.0))
    o = B * (Api + Ai) + Wi * waves
    Mg = carry.m_sum + mem
    Cg = carry.c_sum + comp
    Tg = carry.t_sum + tr
    Og = carry.o_sum + o
    Wg = carry.w_sum + waves
    Lg = (torch.maximum(torch.maximum(Cg, Tg / hw[:, BW_OFF]),
                        Og / hw[:, BW_ON])
          + Wg * hw[:, T_PASS] + hw[:, T_SYNC])
    return Lg, Mg, Tg


def prefix_step(consts: PrefixConsts, carry: PrefixCarry, action,
                hw) -> PrefixCarry:
    """Commit ``action`` [R] for positions ``carry.t`` (O(1) work): a
    non-SYNC action extends the open group, a SYNC closes it.  Position 0
    is the network-input pseudo tensor and contributes nothing."""
    c = consts
    i = carry.t
    B = c.B
    lanes, peak_macs = _hw_terms(hw)
    a = torch.as_tensor(action, device=B.device).to(torch.float32)
    Ai, Api, Wi, Fi, OEi, UCi, srci, hasi = _terms(c, i)
    Asrc = _at(c.A, srci)
    same = _same_group(srci, hasi, carry.g_start)
    is_tail_n = i == c.n

    mb = torch.minimum(torch.clamp_min(a, 1.0), B)
    head = carry.open_len == 0
    waves = torch.ceil(B / mb)
    comp = B * Fi / peak_macs / _util(mb, OEi, UCi, lanes)
    mem = (mb * Ai + torch.where(head, mb * Api, 0.0)
           + torch.where(same, mb * Asrc, 0.0))
    tr = (torch.where(head, B * Api, 0.0)
          + torch.where(is_tail_n, B * Ai, 0.0)
          + Wi * waves + torch.where(hasi & ~same, 2.0 * B * Asrc, 0.0))
    o = B * (Api + Ai) + Wi * waves
    carry_ns = carry._replace(
        t=i + 1, open_len=carry.open_len + 1, last_mb=mb,
        c_sum=carry.c_sum + comp, t_sum=carry.t_sum + tr,
        o_sum=carry.o_sum + o, m_sum=carry.m_sum + mem,
        w_sum=carry.w_sum + waves)

    Lg, Mg, Tg = _close_terms(c, carry, i, hw)
    single = carry.open_len == 0
    Lc = torch.where(single, _at(c.slat, i), Lg)
    Mc = torch.where(single, _at(c.sm, i), Mg)
    Tc = torch.where(single, _at(c.st, i), Tg)
    f0 = torch.zeros_like(B)
    carry_sy = PrefixCarry(
        t=i + 1, g_start=i + 1, open_len=torch.zeros_like(i),
        last_mb=f0 + 1.0, c_sum=f0, t_sum=f0, o_sum=f0, m_sum=f0, w_sum=f0,
        lat=carry.lat + Lc, peak=torch.maximum(carry.peak, Mc),
        traf=carry.traf + Tc, groups=carry.groups + 1)

    out = _select(a < 0.0, carry_sy, carry_ns)
    return _select(i == 0, carry._replace(t=torch.ones_like(i)), out)


def prefix_out(consts: PrefixConsts, carry: PrefixCarry, hw) -> CostOut:
    """CostOut [R] of the carried prefix: actions ``< t`` applied, the rest
    SYNC (the full-strategy cost once ``t == n + 1``)."""
    c = consts
    t = carry.t
    B = c.B
    tc = t.clamp(0, c.SLAT.shape[-1] - 2)

    # case A -- no open group: closed + all-SYNC suffix from t
    latA = carry.lat + _at(c.SLAT, tc)
    peakA = torch.maximum(carry.peak, _at(c.SPEAK, tc))
    trafA = carry.traf + _at(c.STRAF, tc)
    grpA = carry.groups + _at(c.SGRP, tc)

    # case B -- open group force-closed by the SYNC at t, suffix from t+1
    Lg, Mg, Tg = _close_terms(c, carry, t, hw)
    latB = carry.lat + Lg + _at(c.SLAT, tc + 1)
    peakB = torch.maximum(torch.maximum(carry.peak, Mg), _at(c.SPEAK, tc + 1))
    trafB = carry.traf + Tg + _at(c.STRAF, tc + 1)
    grpB = carry.groups + 1 + _at(c.SGRP, tc + 1)

    # case C -- t == n+1: close the open group as it is (a 1-member group
    # is unfused and re-derived from the singleton constants)
    jn = c.n
    memC1 = torch.minimum(
        carry.last_mb * _at(c.A, jn) + B * _at(c.A_prev, jn)
        + _at(c.hold0, jn), hw[:, STREAM])
    latC1 = carry.lat + _at(c.slat, jn)
    peakC1 = torch.maximum(carry.peak, memC1)
    trafC1 = carry.traf + _at(c.st, jn)
    LgC = (torch.maximum(torch.maximum(carry.c_sum,
                                       carry.t_sum / hw[:, BW_OFF]),
                         carry.o_sum / hw[:, BW_ON])
           + carry.w_sum * hw[:, T_PASS] + hw[:, T_SYNC])
    latC2 = carry.lat + LgC
    peakC2 = torch.maximum(carry.peak, carry.m_sum)
    trafC2 = carry.traf + carry.t_sum

    open0 = carry.open_len == 0
    open1 = carry.open_len == 1
    pick = lambda x0, x1, x2: torch.where(open0, x0, torch.where(open1, x1,
                                                                 x2))
    latC = pick(carry.lat, latC1, latC2)
    peakC = pick(carry.peak, peakC1, peakC2)
    trafC = pick(carry.traf, trafC1, trafC2)
    grpC = carry.groups + torch.where(open0, 0, 1)

    done = t >= c.n + 1
    fin = lambda xc, xa, xb: torch.where(done, xc, torch.where(open0, xa, xb))
    lat = fin(latC, latA, latB)
    peak = fin(peakC, peakA, peakB)
    traf = fin(trafC, trafA, trafB)
    grp = fin(grpC, grpA, grpB)
    return CostOut(lat, peak, traf, peak <= c.budget, grp.to(torch.int32))


def prefix_probe_peak(consts: PrefixConsts, carry: PrefixCarry, action,
                      hw) -> torch.Tensor:
    """Peak memory [R] of the probe strategy (``action`` at position ``t``,
    everything after forced SYNC) -- what the inference-time budget guard
    tests.  Equals ``prefix_out(prefix_step(carry, action)).peak_mem`` for
    a non-SYNC ``action``."""
    c = consts
    i = carry.t
    B = c.B
    a = torch.as_tensor(action, device=B.device).to(torch.float32)
    mb = torch.minimum(torch.clamp_min(a, 1.0), B)
    Ai, Api, _, _, _, _, srci, hasi = _terms(c, i)
    Asrc = _at(c.A, srci)
    same = _same_group(srci, hasi, carry.g_start)
    head = carry.open_len == 0
    mem_t = (mb * Ai + torch.where(head, mb * Api, 0.0)
             + torch.where(same, mb * Asrc, 0.0))
    P = c.A.shape[-1]
    tc = (i + 1).clamp(0, P - 1)
    A1, src1, has1 = _at(c.A, tc), _at(c.skip, tc), _at(c.has_skip, tc)
    same1 = _same_group(src1, has1, carry.g_start)
    mem_s = A1 + torch.where(same1, mb * _at(c.A, src1), 0.0)
    # t < n: fused group [g_start..t+1] + all-SYNC suffix from t+2
    peak_mid = torch.maximum(carry.m_sum + mem_t + mem_s,
                             _at(c.SPEAK, (i + 2).clamp(0, P + 1)))
    # t == n: the strategy is complete after this action
    jn = c.n
    mem_single = torch.minimum(
        mb * _at(c.A, jn) + B * _at(c.A_prev, jn) + _at(c.hold0, jn),
        hw[:, STREAM])
    peak_end = torch.where(head, mem_single, carry.m_sum + mem_t)
    grp = torch.where(i >= c.n, peak_end, peak_mid)
    grp = torch.where(i > c.n, 0.0, grp)          # inactive lane
    grp = torch.where(i == 0, c.SPEAK[:, 1], grp)  # input pseudo tensor
    return torch.maximum(carry.peak, grp)


def prefix_trace(wl: dict, strategy, batch, budget_bytes, hw) -> CostOut:
    """Partial-strategy trace for RL state decoration (paper Eq. 2).

    Entry ``t`` evaluates ``strategy`` [P] with only positions ``< t``
    applied (the rest forced to SYNC): the environment state before action
    ``t``.  The P truncations go through :func:`evaluate_population` as
    one [P, P] population, so on the card this is one ``fusion_eval``
    launch.  Returns a CostOut with a leading axis of length P."""
    s = _as_strategies(strategy, wl["A"])
    P = s.shape[-1]
    pos = torch.arange(P, device=s.device)
    trunc = torch.where(pos[None, :] < pos[:, None], s[None, :], SYNC)
    return evaluate_population(wl, trunc.to(torch.int32).contiguous(), batch,
                               budget_bytes, hw)


def prefix_scan(wls: dict, strategies, batches, budgets_bytes, hw):
    """Carry form of :func:`prefix_trace` for rows ``wls`` [R, P] and
    ``strategies`` [R, P], with per-row ``batches``/``budgets_bytes`` [R]
    and hardware (anything ``accel.stack_hw`` accepts).

    Folds ``prefix_out`` then ``prefix_step`` over the P positions, the
    carry frozen once it passes a row's ``n``.  Returns ``(trace, final)``:
    ``trace`` a CostOut of [R, P] fields whose entry ``t`` is
    ``prefix_trace`` entry ``t``, ``final`` the full-strategy CostOut [R].
    No ``fusion_eval`` launch: O(P) small elementwise steps."""
    s = _as_strategies(strategies, wls["A"])
    R, P = s.shape
    hwv = stack_hw(hw, R, s.device)
    consts = prefix_consts(wls, _as_f32(batches, s).reshape(R),
                           _as_f32(budgets_bytes, s).reshape(R), hwv)
    carry = prefix_init(consts)
    trace = []
    for t in range(P):
        trace.append(prefix_out(consts, carry, hwv))
        new = prefix_step(consts, carry, s[:, t], hwv)
        carry = _select(carry.t <= consts.n, new, carry)
    trace = CostOut(*(torch.stack(x, dim=-1) for x in zip(*trace)))
    return trace, prefix_out(consts, carry, hwv)


def random_strategy(rng: np.random.Generator, n: int, nmax: int, batch: int,
                    p_sync: float = 0.3) -> np.ndarray:
    """A random valid-format strategy (numpy; for tests and search seeds)."""
    s = np.full(nmax, SYNC, dtype=np.int32)
    vals = rng.integers(1, batch + 1, size=n + 1)
    syncs = rng.random(n + 1) < p_sync
    syncs[0] = False
    s[: n + 1] = np.where(syncs, SYNC, vals)
    return s
