"""Teacher-data collection and replay buffer (paper §4.4, §4.5.1).

Port of ``repro.core.dataset``.  Two pipelines produce the same
:class:`TrajectoryDataset`, whose fields are numpy arrays (the trainer
moves each batch to the model's device):

- ``collect_teacher_data``: the host loop, one ``gsampler_search`` per
  (workload, budget) condition and one ``FusionEnv.decorate`` per elite;
- ``generate_teacher_corpus``: the grid pipeline.  ``gsampler_search_grid``
  searches every condition of the (workload x accelerator x budget) grid
  at once, and ``_decorate_grid`` (one ``cost_model.prefix_scan`` over all
  [C x K] candidates) relabels every elite into (returns-to-go, state,
  action) trajectories.  Deterministic per seed on a given device.  With
  ``teacher="optimal"`` the exact DP (``core/optimal.py``) gives each
  condition's one optimal strategy in place of the GA's elites.

``window_dataset`` cuts long trajectories into fixed-length windows with
absolute-time offsets (``t0``).

Not carried over: the ``evaluator`` switch (the port has one population
evaluator, the ``fusion_eval`` kernel).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from . import cost_model as cm
from .accel import HW_FEATURE_DIM, AccelConfig, accel_features, stack_hw
from .env import (STATE_DIM, FusionEnv, _budget_feat, _shape_feats,
                  encode_action, returns_to_go)
from .gsampler import GSamplerConfig, gsampler_search, gsampler_search_grid
from .optimal import optimal_search

__all__ = ["TrajectoryDataset", "collect_teacher_data", "merge_datasets",
           "generate_teacher_corpus", "window_dataset"]

MB = float(2 ** 20)


@dataclass
class TrajectoryDataset:
    rtg: np.ndarray        # [N, T] f32
    states: np.ndarray     # [N, T, STATE_DIM] f32
    actions: np.ndarray    # [N, T] f32 (encoded)
    mask: np.ndarray       # [N, T] f32
    # (workload, budget_mb, speedup, accel) a row
    meta: list = field(default_factory=list)
    t0: np.ndarray | None = None   # [N] i32 absolute window offsets
    hw: np.ndarray | None = None   # [N, HW_FEATURE_DIM] f32 accel condition

    def __post_init__(self):
        if self.t0 is None:
            self.t0 = np.zeros(self.rtg.shape[0], np.int32)
        if self.hw is None:
            self.hw = np.zeros((self.rtg.shape[0], HW_FEATURE_DIM),
                               np.float32)

    def __len__(self):
        return self.rtg.shape[0]

    @property
    def max_steps(self) -> int:
        return self.rtg.shape[1]

    def hw_feats(self) -> np.ndarray:
        """Per-trajectory hw condition rows (zeros when none were kept)."""
        h = getattr(self, "hw", None)
        if h is None:
            h = np.zeros((len(self), HW_FEATURE_DIM), np.float32)
        return h

    def sample(self, rng: np.random.Generator, batch_size: int) -> dict:
        idx = rng.integers(0, len(self), size=batch_size)
        return {"rtg": self.rtg[idx], "states": self.states[idx],
                "actions": self.actions[idx], "mask": self.mask[idx],
                "t0": self.t0[idx], "hw": self.hw_feats()[idx]}

    def split(self, frac: float, seed: int = 0):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        k = max(1, int(len(self) * frac))
        tr, va = perm[k:], perm[:k]
        pick = lambda ix: TrajectoryDataset(
            self.rtg[ix], self.states[ix], self.actions[ix], self.mask[ix],
            [self.meta[i] for i in ix], self.t0[ix], self.hw_feats()[ix])
        return pick(tr), pick(va)


def _pad(traj: dict, T: int) -> tuple[np.ndarray, ...]:
    L = int(traj["length"])
    rtg = np.zeros(T, np.float32)
    rtg[:L] = traj["rtg"]
    st = np.zeros((T, STATE_DIM), np.float32)
    st[:L] = traj["states"]
    ac = np.zeros(T, np.float32)
    ac[:L] = traj["actions"]
    mk = np.zeros(T, np.float32)
    mk[:L] = 1.0
    return rtg, st, ac, mk


def collect_teacher_data(workloads: list, hw: AccelConfig, batch: int,
                         budgets_mb: list[float], *, max_steps: int = 64,
                         top_k: int = 8, ga_cfg: GSamplerConfig | None = None,
                         seed: int = 0, augment_jitter: int = 2,
                         device=None) -> TrajectoryDataset:
    """Run the host teacher over ``workloads x budgets_mb`` on ``device``
    and decorate its elites.

    ``augment_jitter`` also decorates small random perturbations of the
    elite strategies (re-scored by the cost model) for replay-buffer
    diversity."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    feats = accel_features(hw).numpy()
    rows, meta = [], []
    for wi, wl in enumerate(workloads):
        for budget in budgets_mb:
            env = FusionEnv(wl, hw, batch=batch, budget_bytes=budget * MB,
                            nmax=max_steps, device=dev)
            cfg = ga_cfg or GSamplerConfig(seed=seed + 31 * wi + int(budget))
            res = gsampler_search(env, cfg, top_k=top_k)
            cands = list(res.elites) or [res.strategy]
            extra = []
            for s in cands[:max(1, top_k // 2)]:
                for _ in range(augment_jitter):
                    j = s.copy()
                    pos = rng.integers(1, env.n + 1)
                    if j[pos] >= 1:
                        j[pos] = int(np.clip(j[pos] + rng.integers(-4, 5),
                                             1, batch))
                    extra.append(j)
            for s in cands + extra:
                traj = env.decorate(s)
                sp, _, valid = env.speedup(s)
                if not valid:
                    continue
                rows.append(_pad(traj, max_steps))
                meta.append((wl.name, budget, sp, hw.name))
    if not rows:
        raise RuntimeError("teacher produced no valid trajectories")
    rtg, st, ac, mk = (np.stack(x) for x in zip(*rows))
    return TrajectoryDataset(rtg, st, ac, mk, meta,
                             hw=np.tile(feats, (len(rows), 1)))


def merge_datasets(ds: list[TrajectoryDataset]) -> TrajectoryDataset:
    return TrajectoryDataset(
        np.concatenate([d.rtg for d in ds]),
        np.concatenate([d.states for d in ds]),
        np.concatenate([d.actions for d in ds]),
        np.concatenate([d.mask for d in ds]),
        sum([d.meta for d in ds], []),
        np.concatenate([d.t0 for d in ds]),
        np.concatenate([d.hw_feats() for d in ds]))


def _decorate_grid(wls: dict, strategies, batches, budgets, hw):
    """Decorate candidates ``strategies`` [C, K, P] of the stacked
    conditions ``wls`` [C, P] into padded trajectories.

    Per strategy this is ``FusionEnv.decorate``, with the prefix costs from
    one :func:`cost_model.prefix_scan` over all C x K rows instead of
    ``prefix_trace``.  ``batches``/``budgets`` are [C]; ``hw`` is anything
    ``accel.stack_hw`` accepts.  Returns tensors on the rows' device:
    (states [C,K,P,STATE_DIM], rtg [C,K,P], actions [C,K,P],
    mask [C,K,P], final CostOut [C,K])."""
    dev = wls["A"].device
    S = torch.as_tensor(strategies, device=dev).to(torch.int32)
    C, K, P = S.shape
    b = torch.as_tensor(batches, dtype=torch.float32, device=dev)
    m = torch.as_tensor(budgets, dtype=torch.float32, device=dev)
    hwv = stack_hw(hw, C, dev)
    rows = {k: v.repeat_interleave(K, dim=0) for k, v in wls.items()}
    bK, mK = b.repeat_interleave(K), m.repeat_interleave(K)
    trace, final = cm.prefix_scan(rows, S.reshape(C * K, P), bK, mK,
                                  hwv.repeat_interleave(K, dim=0))
    base = cm.baseline_grid(wls, b, hwv).latency                   # [C]
    pos = torch.arange(P, device=dev)
    n = wls["n"].long()
    valid = (pos[None, :] <= n[:, None]).float()                   # [C, P]
    idx = torch.minimum(pos[None, :], n[:, None])
    feats = _shape_feats(wls["SHAPE6"]).gather(
        1, idx[..., None].expand(C, P, 6))                         # [C, P, 6]
    lat = trace.latency.reshape(C, K, P)
    perf = torch.log1p(base[:, None, None] / torch.clamp_min(lat, 1e-12))
    vk = valid[:, None, :]
    states = torch.cat([
        feats[:, None].expand(C, K, P, 6),
        _budget_feat(m)[:, None, None, None].expand(C, K, P, 1),
        perf[..., None]], dim=-1) * vk[..., None]
    rtg = returns_to_go(trace.peak_mem.reshape(C, K, P),
                        m[:, None, None]) * vk
    acts = encode_action(S, b[:, None, None]) * vk
    mask = vk.expand(C, K, P)
    final = cm.CostOut(*(x.reshape(C, K) for x in final))
    return states, rtg, acts, mask, final


def _augment_candidates(rng: np.random.Generator, elites: np.ndarray,
                        ns: np.ndarray, batch: int, top_k: int,
                        augment_jitter: int) -> np.ndarray:
    """Jittered copies of the top elites (the grid twin of the host
    pipeline's replay-diversity trick): perturb one micro-batch position
    per copy; the cost model re-scores them during decoration."""
    C, K, P = elites.shape
    K2 = max(1, top_k // 2)
    extra = []
    for _ in range(augment_jitter):
        j = elites[:, :K2].copy()
        sel = rng.integers(1, ns[:, None] + 1, size=(C, K2))
        delta = rng.integers(-4, 5, size=(C, K2))
        cur = np.take_along_axis(j, sel[..., None], axis=2)[..., 0]
        new = np.where(cur >= 1, np.clip(cur + delta, 1, batch), cur)
        np.put_along_axis(j, sel[..., None], new[..., None].astype(np.int32),
                          axis=2)
        extra.append(j)
    return np.concatenate([elites] + extra, axis=1) if extra else elites


def generate_teacher_corpus(workloads: list, hw, *,
                            batch: int = 64, budgets_mb: list[float],
                            max_steps: int = 64, top_k: int = 8,
                            ga_cfg: GSamplerConfig | None = None,
                            seed: int = 0, augment_jitter: int = 2,
                            teacher: str = "gsampler",
                            front_cap: int = 4096,
                            extra_elites: dict | None = None,
                            device=None) -> TrajectoryDataset:
    """The grid teacher pipeline on ``device``: the scalable twin of
    :func:`collect_teacher_data`.

    ``gsampler_search_grid`` searches the whole ``workloads x accels x
    budgets_mb`` grid (``hw`` is one :class:`AccelConfig` or a sequence of
    them), ``_decorate_grid`` relabels every elite and its jittered copies
    into returns-to-go trajectories, and the host keeps the valid rows,
    dropping exact duplicates.  Each trajectory stores its accelerator's
    normalized features (``TrajectoryDataset.hw``).  A fixed ``seed``
    reproduces the corpus bit for bit on a given device.

    ``teacher`` selects the label source: ``"gsampler"`` (default) runs the
    grid GA; ``"optimal"`` replaces its elites with the one provably
    optimal strategy of each condition from the exact DP
    (:func:`optimal.optimal_search`, host float64; ``front_cap`` is passed
    on, and the DP raises rather than approximates past it, so keep
    ``"optimal"`` to small and mid-sized chains).  Everything downstream --
    jitter, decoration, the validity filter, the dataset's schema -- is the
    same for both teachers.

    ``extra_elites`` injects strategies into the elite pool: a dict keyed
    ``(workload_name, accel_name, budget_mb)`` (budget matched after
    ``round(..., 6)``) whose values are lists of strategy arrays of length
    at most ``max_steps`` (the tail pads to SYNC).  Conditions without
    extras are padded with copies of their own first elite, which the
    duplicate filter drops again."""
    if teacher not in ("gsampler", "optimal"):
        raise ValueError(f"unknown teacher {teacher!r}; "
                         "expected 'gsampler' or 'optimal'")
    accels = list(hw) if isinstance(hw, (list, tuple)) else [hw]
    if any(not isinstance(a, AccelConfig) for a in accels):
        raise TypeError("generate_teacher_corpus needs AccelConfig presets "
                        "(packing + naming); got " + repr(accels))
    dev = resolve_device(device)
    conds = [(w, a, float(b)) for w in workloads for a in accels
             for b in budgets_mb]
    wl_list = [w for w, _, _ in conds]
    hw_list = [a for _, a, _ in conds]
    budgets = np.asarray([b * MB for _, _, b in conds], np.float32)
    batches = np.full(len(conds), float(batch), np.float32)
    ns = np.asarray([w.n for w in wl_list], np.int64)
    cfg = ga_cfg or GSamplerConfig(seed=seed)

    # pack the grid once: the search and the decoration share it
    packed = [cm.pack_workload(w, a, max_steps, device=dev)
              for w, a, _ in conds]
    wls = cm.stack_workloads(packed)
    if teacher == "optimal":
        elites = np.stack([
            optimal_search({k: v.cpu().numpy() for k, v in p.items()},
                           batch, float(bud), a,
                           front_cap=front_cap).strategy
            for p, (_, a, _), bud in zip(packed, conds, budgets)
        ])[:, None, :]                                    # [C, 1, P]
        base_lat = cm.baseline_grid(wls, batches,
                                    hw_list).latency.cpu().numpy()
    else:
        res = gsampler_search_grid(wl_list, hw_list, batches, budgets,
                                   nmax=max_steps, cfg=cfg, top_k=top_k,
                                   packed=wls, device=dev)
        elites, base_lat = res.strategies, res.baseline_latency
    if extra_elites:
        per_cond = [extra_elites.get((w.name, a.name, round(float(b), 6)), ())
                    for w, a, b in conds]
        kx = max((len(lst) for lst in per_cond), default=0)
        if kx:
            extra = np.repeat(elites[:, :1], kx, axis=1).copy()  # [C,kx,P]
            for c, lst in enumerate(per_cond):
                for k, s in enumerate(lst[:kx]):
                    s = np.asarray(s, np.int32).ravel()
                    if s.shape[0] > max_steps:
                        continue            # oversized: keep the filler
                    row = np.full(max_steps, cm.SYNC, np.int32)
                    row[: s.shape[0]] = s
                    extra[c, k] = row
            elites = np.concatenate([elites, extra], axis=1)
    rng = np.random.default_rng(seed)
    cand = _augment_candidates(rng, elites, ns, batch, top_k, augment_jitter)

    st, rtg, ac, mk, fin = _decorate_grid(wls, cand, batches, budgets,
                                          hw_list)
    st, rtg, ac, mk = (x.cpu().numpy() for x in (st, rtg, ac, mk))
    valid = fin.valid.cpu().numpy()
    speedup = base_lat[:, None] / np.maximum(fin.latency.cpu().numpy(),
                                             1e-12)
    feats = accel_features(stack_hw(hw_list, len(conds))).numpy()  # [C, F]

    rows, meta, hw_rows = [], [], []
    for c, (wl, acc, budget) in enumerate(conds):
        seen = set()
        for k in range(cand.shape[1]):
            key = cand[c, k, : wl.n + 1].tobytes()
            if not valid[c, k] or key in seen:
                continue
            seen.add(key)
            rows.append((rtg[c, k], st[c, k], ac[c, k], mk[c, k]))
            meta.append((wl.name, budget, float(speedup[c, k]), acc.name))
            hw_rows.append(feats[c])
    if not rows:
        raise RuntimeError("teacher produced no valid trajectories")
    r, s, a, m = (np.stack(x) for x in zip(*rows))
    return TrajectoryDataset(r, s, a, m, meta, hw=np.stack(hw_rows))


def window_dataset(ds: TrajectoryDataset, T: int,
                   stride: int | None = None) -> TrajectoryDataset:
    """Cut trajectories into length-``T`` windows with absolute offsets.

    Windows step by ``stride`` (default ``T``); a final window flush with
    the trajectory's end is appended so no suffix is dropped.  Each window
    carries ``t0``, its absolute start step, so the model embeds the same
    time positions as in the full trajectory (``dt_apply``'s ``t0``).  The
    hw condition row copies to every window."""
    if T >= ds.max_steps:
        return ds
    stride = stride or T
    hw_full = ds.hw_feats()
    rows, meta, offs, hw_rows = [], [], [], []
    for i in range(len(ds)):
        L = int(ds.mask[i].sum())
        starts = list(range(0, max(L - T, 0) + 1, stride))
        if not starts:
            starts = [0]
        if starts[-1] + T < L:
            starts.append(L - T)
        for s0 in starts:
            rows.append((ds.rtg[i, s0:s0 + T], ds.states[i, s0:s0 + T],
                         ds.actions[i, s0:s0 + T], ds.mask[i, s0:s0 + T]))
            meta.append(ds.meta[i] if i < len(ds.meta) else None)
            offs.append(int(ds.t0[i]) + s0)
            hw_rows.append(hw_full[i])
    r, s, a, m = (np.stack(x) for x in zip(*rows))
    return TrajectoryDataset(r, s, a, m, meta, np.asarray(offs, np.int32),
                             np.stack(hw_rows))
