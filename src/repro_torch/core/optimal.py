"""Exact optimal fusion mapper: the port's ground truth.

Port of ``repro.core.optimal``.  Every other mapper -- the G-Sampler, the
DT one-shot mapper, the Table-1 baselines -- is a heuristic over the chain
fusion map-space.  This module solves that space exactly: a left-to-right
cut-point DP over fusion-group boundaries, with a Pareto-front DP over the
members' micro-batch tilings inside each candidate segment, and
dominated-state pruning that loses no optimum.

The DP is host numpy in float64 and mirrors ``ref_model.evaluate_ref``'s
arithmetic expression by expression and in the same order of sums, so its
optimum is bit-exact against brute-force enumeration of every strategy
(``brute_force_optimal``).  Certification against the production f32
evaluator comes on top: every candidate final cut is scored in one
``evaluate_population`` call (``optimal_grid``: one ``evaluate_grid``
call for a whole condition grid) -- one ``fusion_eval`` launch on the
card -- and the DP's winner must also win under f32, within rounding.

Entry points
------------
``optimal_mapping(env)``            exact optimum for one FusionEnv, on
                                    the env's device
``optimal_search(wl_np, ...)``      same, from packed host arrays
``optimal_grid(...)``               per-condition optima + one
                                    ``evaluate_grid`` certification call
``brute_force_optimal(...)``        exhaustive oracle for small chains
``enumerate_strategies(...)``       the full strategy space as an array
``scaled_wl_np(wl_np, hw)``         pack-time -> serve-time BPE rescale,
                                    bit-matching ``cost_model._scaled_AW``
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from itertools import product
from typing import Optional

import numpy as np
import torch

from . import cost_model as cm
from . import ref_model
from .accel import AccelConfig

__all__ = ["OptimalResult", "optimal_search", "optimal_mapping",
           "optimal_grid", "brute_force_optimal", "enumerate_strategies",
           "scaled_wl_np"]

SYNC = cm.SYNC
_UTIL_MIN = ref_model._UTIL_MIN
_INF = float("inf")


@dataclass(frozen=True)
class OptimalResult:
    """Certified exact optimum of one (workload, batch, budget, hw) cell.

    ``latency``/``peak_mem``/``traffic`` are the float64 reference-model
    numbers of the argmin strategy (``ref_model.evaluate_ref`` semantics —
    the same arithmetic the DP minimized).  ``valid`` is False only when NO
    strategy fits the budget, in which case ``strategy`` is the all-sync
    fallback (the same contract the search stack uses).  ``certified`` is
    the production f32 ``CostOut`` of the same strategy (numpy scalars,
    read back from the evaluator) when certification ran, else None."""
    strategy: np.ndarray          # [nmax] int32, padded with SYNC
    latency: float
    peak_mem: float
    traffic: float
    valid: bool
    n_groups: int
    n_states: int                 # peak Pareto-front size (DP effort proxy)
    n_evals: int                  # state expansions + closes, effort proxy
    wall_s: float
    certified: Optional[cm.CostOut] = field(default=None, compare=False)


def scaled_wl_np(wl_np: dict, hw: AccelConfig) -> dict:
    """Host copy of a packed workload with A/W rescaled from the pack-time
    bytes/elem to ``hw``'s — the float32 multiply done exactly like
    ``cost_model._scaled_AW`` so oracle and production evaluators see
    bit-identical byte counts (identity when the BPEs match)."""
    out = {k: np.asarray(v) for k, v in wl_np.items()}
    bpe = out.get("BPE")
    if bpe is not None:
        s = np.float32(hw.bytes_per_elem) / np.asarray(bpe, np.float32)
        out["A"] = np.asarray(out["A"], np.float32) * s
        out["W"] = np.asarray(out["W"], np.float32) * s
        out["BPE"] = np.float32(hw.bytes_per_elem)
    return out


# ---------------------------------------------------------------------------
# member-term arithmetic (float64, expression-for-expression = evaluate_ref)
# ---------------------------------------------------------------------------

class _Chain:
    """Float64 views + hw scalars for one (workload, hw, batch) cell."""

    def __init__(self, wl_np: dict, batch: float, hw: AccelConfig):
        wl = scaled_wl_np(wl_np, hw)
        self.A, self.W, self.F, self.OE, self.UC = (
            np.asarray(wl[k], dtype=np.float64)  # repro_torch: noqa[TDET002] -- the f64 optimal oracle
            for k in ("A", "W", "F", "OE", "UC"))
        self.skip = np.asarray(wl["SKIP"], dtype=np.int64)
        self.n = int(wl["n"])
        self.B = float(batch)
        self.hw = hw
        self.lanes = float(hw.npe * hw.pe_lanes)
        self.peak_macs = float(hw.peak_macs)

    def _same_group(self, i: int, l: int) -> bool:
        # evaluate_ref tests ``crossing iff any sync in [max(src,1), i)``;
        # inside a group positions l..i-1 are non-sync and l-1 is a sync
        # whenever l > 1, so the scan reduces to this closed form.
        src = int(self.skip[i])
        return src >= 0 and (src >= l or l == 1)

    def free_member(self, i: int, l: int, is_r: bool, c: np.ndarray):
        """(comp, t, o, m, w) of a free-micro-batch member ``i`` (interior,
        or the final member of a non-sync-terminated last group when
        ``is_r``) for every candidate micro-batch in ``c`` — same
        expressions, same add order as evaluate_ref's fused-member branch."""
        A, W, F, OE, UC, B = self.A, self.W, self.F, self.OE, self.UC, self.B
        w = np.ceil(B / c)
        m = c * A[i]
        if i == l:
            m = m + c * A[i - 1]
        t = W[i] * w
        if i == l:
            t = t + B * A[i - 1]
        if is_r:
            t = t + B * A[i]
        src = int(self.skip[i])
        if src >= 0:
            if self._same_group(i, l):
                m = m + c * A[src]
            else:
                t = t + 2.0 * B * A[src]
        util = np.minimum(np.maximum(c * OE[i] / self.lanes, _UTIL_MIN),
                          UC[i])
        comp = B * F[i] / self.peak_macs / util
        o = np.full_like(c, B * (A[i - 1] + A[i])) + W[i] * w
        return comp, t, o, m, w

    def sync_tail(self, r: int, l: int, p: np.ndarray):
        """Terms of the SYNC member closing fused group [l..r], riding its
        producer's micro-batch ``p`` (stage = 1)."""
        A, W, F, OE, UC, B = self.A, self.W, self.F, self.OE, self.UC, self.B
        w = np.ceil(B / p)
        m = np.full_like(p, 1.0 * A[r])          # stage * A[r], stage = 1
        t = W[r] * w
        t = t + B * A[r]                         # tail flush (i == r)
        src = int(self.skip[r])
        if src >= 0:
            if self._same_group(r, l):
                m = m + p * A[src]
            else:
                t = t + 2.0 * B * A[src]
        util = np.minimum(np.maximum(p * OE[r] / self.lanes, _UTIL_MIN),
                          UC[r])
        comp = B * F[r] / self.peak_macs / util
        o = np.full_like(p, B * (A[r - 1] + A[r])) + W[r] * w
        return comp, t, o, m, w

    def singleton(self, i: int) -> tuple[float, float]:
        """(latency, mem) of the isolated group {i} with stage = 1 (the
        SYNC variant — its non-sync twin, which only exists at i == n, has
        identical latency and >= mem, so it can never beat it)."""
        A, W, F, OE, UC, B = self.A, self.W, self.F, self.OE, self.UC, self.B
        hw = self.hw
        m = 1.0 * A[i]
        m = m + B * A[i - 1]                     # head term, mbe = B
        t = W[i] * 1
        t = t + B * A[i - 1]
        t = t + B * A[i]
        src = int(self.skip[i])
        if src >= 0:
            if self._same_group(i, i):           # l == i for a singleton
                m = m + B * A[src]
            else:
                t = t + 2.0 * B * A[src]
        m = min(m, float(hw.stream_buf_bytes))
        util = min(max(B * OE[i] / self.lanes, _UTIL_MIN), float(UC[i]))
        comp = B * F[i] / self.peak_macs / util
        o = B * (A[i - 1] + A[i]) + W[i] * 1
        lat = max(comp, t / hw.bw_offchip, o / hw.bw_onchip) \
            + 1 * hw.t_pass + hw.t_sync
        return float(lat), float(m)

    def group_latency(self, vec: np.ndarray) -> np.ndarray:
        """L_g from accumulated (comp, traffic, onchip, mem, waves) rows."""
        hw = self.hw
        lat = np.maximum(np.maximum(vec[:, 0], vec[:, 1] / hw.bw_offchip),
                         vec[:, 2] / hw.bw_onchip)
        return lat + vec[:, 4] * hw.t_pass + hw.t_sync


def _pareto_keep(aug: np.ndarray, cap: int) -> np.ndarray:
    """Indices of the Pareto-minimal rows of ``aug`` (componentwise <=).

    Lossless: a row is dropped only when a kept row is <= in EVERY
    component and differs somewhere — any completion of the dominating row
    is then <= the dominated one's, so the optimum survives.  Exact
    duplicates collapse to one representative.  ``cap`` is a safety valve:
    an over-``cap`` front RAISES rather than silently approximating.

    After deduplication, ``a dominates b`` implies ``sum(a) < sum(b)``
    (<= everywhere + < somewhere), so rows are processed in component-sum
    order and each chunk is only checked against the already-kept front
    plus itself — O(K * front) instead of O(K^2)."""
    uniq, first = np.unique(aug, axis=0, return_index=True)
    order = np.argsort(uniq.sum(axis=1), kind="stable")
    rows = uniq[order]
    kept_rows = np.empty((0, rows.shape[1]))
    kept_idx: list[np.ndarray] = []
    CH = 2048
    for s in range(0, len(rows), CH):
        blk = rows[s:s + CH]
        sel = order[s:s + CH]
        if len(kept_rows):
            dom = np.zeros(len(blk), dtype=bool)
            for fs in range(0, len(kept_rows), 4096):
                fr = kept_rows[fs:fs + 4096]
                dom |= (fr[None, :, :] <= blk[:, None, :]).all(-1).any(1)
            blk, sel = blk[~dom], sel[~dom]
        if not len(blk):
            continue
        le = (blk[None, :, :] <= blk[:, None, :]).all(-1)
        np.fill_diagonal(le, False)
        inner = le.any(1)
        kept_rows = np.concatenate([kept_rows, blk[~inner]])
        kept_idx.append(sel[~inner])
        if len(kept_rows) > cap:
            raise RuntimeError(
                f"optimal-DP Pareto front exploded (> cap={cap}); raise "
                "front_cap= for this workload instead of approximating")
    idx = first[np.concatenate(kept_idx)] if kept_idx else first[:0]
    return np.sort(idx)


# ---------------------------------------------------------------------------
# branch-and-bound machinery (lossless: prune only on strict LB > UB)
# ---------------------------------------------------------------------------

_LB_SLACK = 1.0 - 1e-12      # guards against LB summation-order rounding


def _bounds_for_l(ch: _Chain, l: int, budget: float) -> dict:
    """Per-``l`` B&B tables: componentwise LOWER bounds on what future
    members/tails must still add to a partial group, and incumbent UPPER
    bounds from uniform tilings evaluated with the exact DP arithmetic
    (so every UB is a true achievable segment cost, never below the
    optimum — the strict-inequality prune is therefore lossless)."""
    n, B = ch.n, ch.B
    cand = np.arange(1.0, B + 1.0, dtype=np.float64)  # repro_torch: noqa[TDET002] -- the f64 optimal oracle
    # cum[m] = sum of per-member componentwise minima over l+1..m
    cum = np.zeros((n + 1, 5))
    acc = np.zeros(5)
    for j in range(l + 1, n):
        acc = acc + np.array([t.min() for t in
                              ch.free_member(j, l, False, cand)])
        cum[j] = acc
    tailmin = np.zeros((n + 1, 5))
    for r in range(l + 1, n + 1):
        tailmin[r] = [t.min() for t in ch.sync_tail(r, l, cand)]
    finmin = (np.array([t.min() for t in ch.free_member(n, l, True, cand)])
              if n > l else None)

    # incumbents: exact cost of uniform tilings (all members at mb = u)
    U = np.array(sorted({float(u) for u in (1, 2, 4, 8, 16, 32, 64, B)
                         if 1 <= u <= B}))
    UB = np.full(n + 1, _INF)
    UBfin = _INF
    acc = np.zeros((len(U), 5))
    for i in range(l, n):
        acc = acc + np.stack(ch.free_member(i, l, False, U), axis=1)
        r = i + 1
        closed = acc + np.stack(ch.sync_tail(r, l, U), axis=1)
        ok = closed[:, 3] <= budget
        if ok.any():
            UB[r] = ch.group_latency(closed[ok]).min()
        if r == n:
            fin = acc + np.stack(ch.free_member(n, l, True, U), axis=1)
            ok = fin[:, 3] <= budget
            if ok.any():
                UBfin = ch.group_latency(fin[ok]).min()
    return dict(cum=cum, tailmin=tailmin, finmin=finmin, UB=UB, UBfin=UBfin)


def _bnb_keep(ch: _Chain, bounds: dict, m: int, vec: np.ndarray,
              budget: float) -> np.ndarray:
    """True for states (interior through member ``m``) that can still beat
    SOME remaining close's incumbent: exists r > m with
    LB(state -> close at r) <= UB[r] and the minimal future memory fits."""
    n = ch.n
    hw = ch.hw
    adds, ubs = [], []
    for r in range(m + 1, n + 1):
        adds.append(bounds["cum"][r - 1] - bounds["cum"][m]
                    + bounds["tailmin"][r])
        ubs.append(bounds["UB"][r])
    if bounds["finmin"] is not None and m < n:
        adds.append(bounds["cum"][n - 1] - bounds["cum"][m]
                    + bounds["finmin"])
        ubs.append(bounds["UBfin"])
    if not adds:
        return np.ones(len(vec), dtype=bool)
    adds = np.stack(adds)                       # [R, 5]
    ubs = np.asarray(ubs)                       # [R]
    keep = np.zeros(len(vec), dtype=bool)
    for s in range(0, len(vec), 65536):
        v = vec[s:s + 65536]
        C = v[:, 0, None] + adds[None, :, 0]
        T = v[:, 1, None] + adds[None, :, 1]
        O = v[:, 2, None] + adds[None, :, 2]
        M = v[:, 3, None] + adds[None, :, 3]
        Wv = v[:, 4, None] + adds[None, :, 4]
        lb = np.maximum(np.maximum(C, T / hw.bw_offchip),
                        O / hw.bw_onchip) + Wv * hw.t_pass + hw.t_sync
        ok = (lb * _LB_SLACK <= ubs[None, :]) & \
             (M <= budget * (1.0 + 1e-12))
        keep[s:s + 65536] = ok.any(1)
    return keep


# ---------------------------------------------------------------------------
# the exact DP
# ---------------------------------------------------------------------------

def _solve(ch: _Chain, budget: float, front_cap: int) -> dict:
    """All-pairs optimal segments + prefix cut-point DP.

    Returns the internals (dp table, backpointers, per-segment optimal
    latency and tiling, effort counters) so wrappers can reconstruct the
    argmin strategy for any final cut."""
    n, B = ch.n, ch.B
    cand_all = np.arange(1.0, B + 1.0, dtype=np.float64)  # repro_torch: noqa[TDET002] -- the f64 optimal oracle
    segL = np.full((n + 2, n + 2), _INF)
    seg_tiling: dict[tuple[int, int], np.ndarray] = {}
    max_front, n_evals = 0, 0

    for l in range(1, n + 1):
        lat_s, mem_s = ch.singleton(l)
        if mem_s <= budget:
            segL[l, l] = lat_s
            seg_tiling[(l, l)] = np.array([SYNC], dtype=np.int64)
        bounds = _bounds_for_l(ch, l, budget) if l < n else None

        # Pareto states over the interior members l..m-1 of a growing
        # fused group: ``vec`` columns = accumulated (comp, traffic,
        # onchip, mem, waves); ``mbs`` = the LAST member's micro-batch
        # (the sync tail rides it); ``hist`` records (parent, mb) per
        # extension for path reconstruction.
        vec = np.zeros((1, 5))
        mbs = np.zeros(1)
        hist: list[tuple[np.ndarray, np.ndarray]] = []

        for m in range(l, n + 1):
            if m > l and len(vec):
                # close [l..m] with a SYNC tail riding each state's last mb
                tc, tt, to, tm, tw = ch.sync_tail(m, l, mbs)
                closed = vec + np.stack([tc, tt, to, tm, tw], axis=1)
                n_evals += len(vec)
                ok = closed[:, 3] <= budget
                if ok.any():
                    lat = ch.group_latency(closed[ok])
                    j = int(np.argmin(lat))
                    if lat[j] < segL[l, m]:
                        segL[l, m] = lat[j]
                        win = int(np.flatnonzero(ok)[j])
                        seg_tiling[(l, m)] = _backtrack(hist, win, True)
                if m == n:
                    # non-SYNC-terminated final group [l..n]: member n is
                    # a free-mb member that also flushes its output
                    fc = _prune_cand(ch.free_member(n, l, True, cand_all),
                                     cand_all, None, front_cap)
                    (c_, t_, o_, m_, w_), cmb = fc
                    ext = vec[:, None, :] + np.stack(
                        [c_, t_, o_, m_, w_], axis=1)[None, :, :]
                    ext = ext.reshape(-1, 5)
                    n_evals += len(ext)
                    ok = ext[:, 3] <= budget
                    if ok.any():
                        lat = ch.group_latency(ext[ok])
                        j = int(np.argmin(lat))
                        if lat[j] < segL[l, n]:
                            flat = int(np.flatnonzero(ok)[j])
                            st, ci = divmod(flat, len(cmb))
                            tl = _backtrack(hist, st, False)
                            seg_tiling[(l, n)] = np.concatenate(
                                [tl, [np.int64(cmb[ci])]])
                            segL[l, n] = lat[j]
            if m == n:
                break

            # extend the interior with member m; candidate micro-batches
            # pre-pruned under the same augmented dominance as states
            fc = _prune_cand(ch.free_member(m, l, False, cand_all),
                             cand_all, ch.sync_tail(m + 1, l, cand_all),
                             front_cap)
            (c_, t_, o_, m_, w_), cmb = fc
            new = vec[:, None, :] + np.stack(
                [c_, t_, o_, m_, w_], axis=1)[None, :, :]
            new = new.reshape(-1, 5)
            par = np.repeat(np.arange(len(vec)), len(cmb))
            chosen = np.tile(cmb, len(vec))
            n_evals += len(new)
            feas = new[:, 3] <= budget
            new, par, chosen = new[feas], par[feas], chosen[feas]
            if len(new):
                bk = _bnb_keep(ch, bounds, m, new, budget)
                new, par, chosen = new[bk], par[bk], chosen[bk]
            if len(new):
                # augmented dominance: base accumulators + what the NEXT
                # sync tail (position m+1, the only close that still reads
                # this member's mb) would add as a function of it --
                # lossless: no other close reads this member's mb.
                tc, _, _, tm, tw = ch.sync_tail(m + 1, l, chosen)
                aug = np.concatenate(
                    [new, np.stack([tw, tc, tm], axis=1)], axis=1)
                idx = _pareto_keep(aug, front_cap)
                vec, mbs = new[idx], chosen[idx]
                hist.append((par[idx], mbs.copy()))
                max_front = max(max_front, len(idx))
            else:
                vec = np.zeros((0, 5))
                mbs = np.zeros(0)
                hist.append((np.zeros(0, dtype=np.int64), np.zeros(0)))

    # prefix DP over segment ends: dp[r] = min_l dp[l-1] + segL[l, r]
    dp = np.full(n + 1, _INF)
    back = np.zeros(n + 1, dtype=np.int64)
    dp[0] = 0.0
    for r in range(1, n + 1):
        for l in range(1, r + 1):
            if dp[l - 1] < _INF and segL[l, r] < _INF:
                lat = dp[l - 1] + segL[l, r]
                if lat < dp[r]:
                    dp[r] = lat
                    back[r] = l
    return dict(dp=dp, back=back, segL=segL, seg_tiling=seg_tiling,
                max_front=max_front, n_evals=n_evals)


def _prune_cand(terms, cand: np.ndarray, tail, cap: int):
    """Pareto-prune per-member micro-batch candidates.  ``tail`` carries
    the would-be sync-tail terms at the next position as a function of the
    candidate (None for the final member, whose mb has no future)."""
    c_, t_, o_, m_, w_ = terms
    base = np.stack([c_, t_, o_, m_, w_], axis=1)
    if tail is None:
        aug = base
    else:
        tc, _, _, tm, tw = tail
        aug = np.concatenate([base, np.stack([tw, tc, tm], axis=1)], axis=1)
    idx = _pareto_keep(aug, cap)
    return tuple(x[idx] for x in (c_, t_, o_, m_, w_)), cand[idx]


def _backtrack(hist, last_idx: int, tail_sync: bool) -> np.ndarray:
    """Interior member micro-batches ending at state ``last_idx`` of the
    latest front, walking the (parent, mb) records backwards."""
    out = []
    idx = int(last_idx)
    for par, mb in reversed(hist):
        out.append(np.int64(mb[idx]))
        idx = int(par[idx])
    out.reverse()
    if tail_sync:
        out.append(np.int64(SYNC))
    return np.asarray(out, dtype=np.int64)


def _assemble(sol: dict, nmax: int, batch: float, upto: int) -> np.ndarray:
    """Strategy vector of the DP-optimal segmentation of layers 1..upto."""
    s = np.full(nmax, SYNC, dtype=np.int32)
    s[0] = int(batch)
    r = upto
    while r >= 1:
        l = int(sol["back"][r])
        s[l:r + 1] = sol["seg_tiling"][(l, r)].astype(np.int32)
        r = l - 1
    return s


def _result_from_sol(wl_np: dict, ch: _Chain, budget: float, nmax: int,
                     sol: dict, t0: float) -> OptimalResult:
    n = ch.n
    feasible = sol["dp"][n] < _INF
    if feasible:
        strategy = _assemble(sol, nmax, ch.B, n)
    else:
        strategy = np.full(nmax, SYNC, dtype=np.int32)
        strategy[0] = int(ch.B)
    ref = ref_model.evaluate_ref(
        scaled_wl_np(wl_np, ch.hw), strategy, ch.B, budget, ch.hw)
    if feasible:
        if ref["latency"] != sol["dp"][n] or not ref["valid"]:
            raise AssertionError(
                "optimal-DP self-check failed: reconstructed strategy "
                f"re-evaluates to {ref['latency']!r} (valid={ref['valid']})"
                f" but the DP claims {sol['dp'][n]!r} — the DP arithmetic "
                "has drifted from ref_model.evaluate_ref")
    elif ref["valid"]:
        raise AssertionError(
            "optimal-DP claims the budget is infeasible but the all-sync "
            "fallback fits — the per-segment feasibility test has drifted")
    return OptimalResult(
        strategy=strategy, latency=float(ref["latency"]),
        peak_mem=float(ref["peak_mem"]), traffic=float(ref["traffic"]),
        valid=bool(ref["valid"]), n_groups=int(ref["n_groups"]),
        n_states=int(sol["max_front"]), n_evals=int(sol["n_evals"]),
        wall_s=time.perf_counter() - t0)


def optimal_search(wl_np: dict, batch: float, budget_bytes: float,
                   hw: AccelConfig, nmax: int | None = None, *,
                   front_cap: int = 4096) -> OptimalResult:
    """Exact optimum from packed host arrays, in float64 on the host.

    If no strategy fits the budget the all-sync fallback is returned with
    ``valid=False`` (same contract as the search stack)."""
    t0 = time.perf_counter()
    ch = _Chain(wl_np, batch, hw)
    nmax = nmax or len(ch.A)
    sol = _solve(ch, float(budget_bytes), front_cap)
    return _result_from_sol(wl_np, ch, float(budget_bytes), nmax, sol, t0)


def optimal_mapping(env, *, certify: bool = True,
                    front_cap: int = 4096) -> OptimalResult:
    """Exact optimum for one ``FusionEnv`` condition, optionally certified
    against the production f32 evaluator on the env's device.

    Certification composes every candidate final cut -- the DP-optimal
    prefix through l-1 glued to the optimal last segment [l..n], for every
    feasible l -- and scores all of them in one ``evaluate_population``
    call (one ``fusion_eval`` launch on the card): the DP's winner must
    also win under f32, within rounding."""
    t0 = time.perf_counter()
    ch = _Chain(env.wl_np, env.batch, env.hw)
    budget = float(env.budget_bytes)
    sol = _solve(ch, budget, front_cap)
    base = _result_from_sol(env.wl_np, ch, budget, env.nmax, sol, t0)
    if not (certify and base.valid):
        return base
    n = ch.n
    cuts = [l for l in range(1, n + 1)
            if sol["dp"][l - 1] < _INF and sol["segL"][l, n] < _INF]
    win = cuts.index(int(sol["back"][n]))
    pop = torch.as_tensor(
        np.stack([_compose_cut(sol, l, n, env.nmax, ch.B) for l in cuts]),
        device=env.device)
    # pad to nmax rows with copies of the winner (the minimum is unchanged),
    # so every condition's call has one input signature
    if len(pop) < env.nmax:
        pop = torch.cat([pop, pop[win].expand(env.nmax - len(pop), -1)])
    out = cm.evaluate_population(env.wl, pop, float(ch.B), budget, env.hw)
    host = [x.cpu().numpy() for x in out]
    lats = host[0].astype(np.float64)  # repro_torch: noqa[TDET002] -- the f64 optimal oracle's host readback
    # f32 may reorder near-ties among cuts, but never beyond rounding
    if lats[win] > lats.min() * (1.0 + 1e-5):
        raise AssertionError(
            f"certification failed: DP winner (cut l={cuts[win]}) has f32 "
            f"latency {lats[win]:.6e} but another cut achieves "
            f"{lats.min():.6e} — beyond f32 rounding of a true tie")
    certified = cm.CostOut(*(x[win] for x in host))
    return OptimalResult(
        strategy=base.strategy, latency=base.latency,
        peak_mem=base.peak_mem, traffic=base.traffic, valid=base.valid,
        n_groups=base.n_groups, n_states=base.n_states,
        n_evals=base.n_evals + len(cuts),
        wall_s=time.perf_counter() - t0, certified=certified)


def _compose_cut(sol: dict, l: int, n: int, nmax: int,
                 batch: float) -> np.ndarray:
    """DP-optimal prefix through l-1 + optimal final segment [l..n]."""
    s = _assemble(sol, nmax, batch, upto=l - 1)
    s[l:n + 1] = sol["seg_tiling"][(l, n)].astype(np.int32)
    return s


def optimal_grid(workloads, hws, batches, budgets_bytes, *,
                 nmax: int = 64, front_cap: int = 4096,
                 certify: bool = True, device=None) -> list[OptimalResult]:
    """Exact optima for an aligned condition list, certified in one
    ``evaluate_grid`` call on ``device`` (``cuda`` unless ``"cpu"``): one
    ``fusion_eval`` launch on the card, the grid counterpart of
    ``optimal_mapping``'s population certification.

    ``workloads``/``hws``/``batches``/``budgets_bytes`` are equal-length
    lists; entry c is one (workload, accelerator, batch, budget) cell."""
    C = len(workloads)
    assert len(hws) == len(batches) == len(budgets_bytes) == C
    packs = [cm.pack_workload(w, a, nmax, device=device)
             for w, a in zip(workloads, hws)]
    results = [optimal_search({k: v.cpu().numpy() for k, v in p.items()},
                              b, g, a, nmax, front_cap=front_cap)
               for p, a, b, g in zip(packs, hws, batches, budgets_bytes)]
    if not certify:
        return results
    stacked = cm.stack_workloads(packs)
    strategies = np.stack([r.strategy for r in results])[:, None, :]
    out = cm.evaluate_grid(stacked, strategies,
                           np.asarray(batches, np.float32),
                           np.asarray(budgets_bytes, np.float32), hws)
    host = [x[:, 0].cpu().numpy() for x in out]
    certified = []
    for c, r in enumerate(results):
        cell = cm.CostOut(*(x[c] for x in host))
        if r.valid:
            rel = abs(float(cell.latency) - r.latency) / max(r.latency,
                                                             1e-30)
            if rel > 1e-4:
                raise AssertionError(
                    f"grid certification: condition {c} f32/f64 latency "
                    f"drift {rel:.2e} exceeds rounding tolerance")
            if float(cell.peak_mem) > budgets_bytes[c] * (1.0 + 1e-5):
                raise AssertionError(
                    f"grid certification: condition {c} optimal strategy "
                    "is budget-valid in f64 but violates the budget by "
                    "more than f32 rounding under the production evaluator")
        certified.append(OptimalResult(
            strategy=r.strategy, latency=r.latency, peak_mem=r.peak_mem,
            traffic=r.traffic, valid=r.valid, n_groups=r.n_groups,
            n_states=r.n_states, n_evals=r.n_evals, wall_s=r.wall_s,
            certified=cell))
    return certified


# ---------------------------------------------------------------------------
# brute force (the DP's own oracle)
# ---------------------------------------------------------------------------

def enumerate_strategies(n: int, batch: int, nmax: int, *,
                         mb_values=None, limit: int = 2_000_000
                         ) -> np.ndarray:
    """Every strategy of an n-layer chain as an int32 array [S, nmax]:
    positions 1..n range over {SYNC} U mb_values (default 1..batch),
    position 0 is pinned to ``batch`` (its value is cost-irrelevant — the
    property tests verify that too).  Raises if the space exceeds
    ``limit`` rows: this is an oracle for SMALL chains by construction."""
    vals = ([SYNC] + list(range(1, int(batch) + 1)) if mb_values is None
            else [SYNC] + [int(v) for v in mb_values])
    S = len(vals) ** n
    if S > limit:
        raise ValueError(f"strategy space {S} exceeds limit={limit}; "
                         "shrink n/batch or pass mb_values")
    out = np.full((S, nmax), SYNC, dtype=np.int32)
    out[:, 0] = int(batch)
    for row, combo in enumerate(product(vals, repeat=n)):
        out[row, 1:n + 1] = combo
    return out


def brute_force_optimal(wl_np: dict, batch: float, budget_bytes: float,
                        hw: AccelConfig, nmax: int | None = None, *,
                        mb_values=None, limit: int = 300_000
                        ) -> OptimalResult:
    """Exhaustive float64 optimum via ``ref_model.evaluate_ref`` — the
    independent ground truth the DP is pinned against, with the identical
    infeasible-budget fallback contract."""
    t0 = time.perf_counter()
    wl = scaled_wl_np(wl_np, hw)      # ref takes byte arrays as-is
    n = int(wl["n"])
    nmax = nmax or len(np.asarray(wl["A"]))
    pop = enumerate_strategies(n, int(batch), nmax, mb_values=mb_values,
                               limit=limit)
    best = None
    for s in pop:
        r = ref_model.evaluate_ref(wl, s, float(batch),
                                   float(budget_bytes), hw)
        if r["valid"] and (best is None or r["latency"] < best[0]):
            best = (r["latency"], s, r)
    if best is None:
        s = np.full(nmax, SYNC, dtype=np.int32)
        s[0] = int(batch)
        r = ref_model.evaluate_ref(wl, s, float(batch),
                                   float(budget_bytes), hw)
        best = (r["latency"], s, r)
    lat, s, r = best
    return OptimalResult(
        strategy=np.asarray(s, dtype=np.int32), latency=float(lat),
        peak_mem=float(r["peak_mem"]), traffic=float(r["traffic"]),
        valid=bool(r["valid"]), n_groups=int(r["n_groups"]),
        n_states=len(pop), n_evals=len(pop),
        wall_s=time.perf_counter() - t0)
