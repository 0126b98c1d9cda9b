"""G-Sampler: the paper's search-based teacher (§4.4.2).

Port of ``repro.core.gsampler``: a genetic algorithm with heuristic
seeding (all-sync and the naive uniform micro-batch), fusion-aware
mutation and a constraint-repair operator that targets the most
over-budget fused group.  Every fitness and repair evaluation goes through
the ``fusion_eval`` kernel.  Two forms:

- ``gsampler_search``, the host search of one condition (a ``FusionEnv``):
  numpy draws from ``np.random.default_rng(cfg.seed)`` in the reference's
  order, one population evaluation a generation and one per repair round,
  so its strategies equal the reference's exactly wherever the two cost
  models rank the population alike;
- ``gsampler_search_grid``, every condition of a (workload x accelerator x
  budget) grid at once over a [C, POP, P] strategy tensor.

Differences of the grid form from the reference, none of which changes
the operator:

- randomness comes from one ``torch.Generator`` on the search's device
  (``jax.random.categorical`` becomes ``torch.multinomial``), so results
  are deterministic per seed within the port but not equal to JAX's;
- sorts pass ``stable=True``, as ``jnp.argsort`` is stable;
- the repair loop runs its fixed ``repair_tries`` rounds with per-child
  masking instead of exiting early once the brood is valid: a round over a
  valid brood changes nothing, and the GA makes no device-to-host read.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from . import cost_model as cm
from .accel import AccelConfig, stack_hw

__all__ = ["GSamplerConfig", "GSamplerResult", "gsampler_search",
           "naive_uniform_mb", "GridTeacherResult", "gsampler_search_grid"]


@dataclass(frozen=True)
class GSamplerConfig:
    population: int = 40          # paper §5.1
    generations: int = 50         # paper §5.1 (=> 2k samples)
    elite: int = 4
    p_mut_gene: float = 3.0       # expected mutated genes per child
    p_sync_mut: float = 0.25
    repair_tries: int = 6
    seed: int = 0


@dataclass
class GSamplerResult:
    strategy: np.ndarray
    speedup: float
    latency: float
    peak_mem: float
    valid: bool
    n_evals: int
    wall_s: float
    history: list = field(default_factory=list)     # best speedup per gen
    elites: list = field(default_factory=list)      # top-k distinct strategies


def naive_uniform_mb(env, max_mb: int | None = None) -> np.ndarray:
    """Paper §3's naive strategy: one uniform micro-batch for the whole net,
    the largest that stages all intermediates on-chip (binary search)."""
    B = env.batch
    hi = max_mb or B
    best = None
    lo = 1
    while lo <= hi:
        mid = (lo + hi) // 2
        s = np.full(env.nmax, cm.SYNC, dtype=np.int32)
        s[: env.n + 1] = mid
        _, _, valid = env.speedup(s)
        if valid:
            best, lo = s, mid + 1
        else:
            hi = mid - 1
    if best is None:
        best = np.full(env.nmax, cm.SYNC, dtype=np.int32)
        best[0] = 1
    return best


def _repair_population(env, pop: np.ndarray, cfg: GSamplerConfig,
                       rng: np.random.Generator) -> np.ndarray:
    """Constraint repair of a whole brood: while any child is over budget,
    split or shrink its worst fused group (one stats-form evaluation a
    round supplies the group ids and memories)."""
    s = pop.copy()
    mask = env.wl_np["mask"]
    for _ in range(cfg.repair_tries):
        out, gid, M_g = cm.evaluate_population_stats(
            env.wl, s, float(env.batch), float(env.budget_bytes), env.hw)
        invalid = ~out.valid.cpu().numpy()
        if not invalid.any():
            break
        gid = gid.cpu().numpy()
        M_g = M_g.cpu().numpy()
        for i in np.where(invalid)[0]:
            worst = int(np.argmax(M_g[i]))
            span = np.where((gid[i] == worst) & mask)[0]
            start, end = int(span[0]), int(span[-1])
            if end > start and rng.random() < 0.5:
                s[i, (start + end) // 2] = cm.SYNC     # split the group
            else:
                seg = s[i, start: end + 1]
                mbs = np.where(seg > 1, seg, 0)
                if mbs.max() > 1:
                    j = start + int(np.argmax(mbs))
                    s[i, j] = max(1, s[i, j] // 2)     # shrink largest stage
                elif end > start:
                    s[i, (start + end) // 2] = cm.SYNC
                # else: single layer already minimal -- leave it
    return s


def _fitness(latency: np.ndarray, peak: np.ndarray,
             budget: float) -> np.ndarray:
    over = np.maximum(0.0, peak / budget - 1.0)
    return np.where(over > 0.0, -1e3 * (1.0 + over) - latency, -latency)


def _costs(env, pop: np.ndarray):
    """(latency, peak) of population ``pop`` as host arrays."""
    out = cm.evaluate_population(env.wl, pop, float(env.batch),
                                 float(env.budget_bytes), env.hw)
    return out.latency.cpu().numpy(), out.peak_mem.cpu().numpy()


def gsampler_search(env, cfg: GSamplerConfig = GSamplerConfig(),
                    top_k: int = 8) -> GSamplerResult:
    """Search one ``FusionEnv`` condition on the env's device."""
    rng = np.random.default_rng(cfg.seed)
    t0 = time.perf_counter()
    P, n, B = cfg.population, env.n, env.batch

    pop = np.stack([cm.random_strategy(rng, n, env.nmax, B, p_sync=0.4)
                    for _ in range(P)])
    pop[0] = np.full(env.nmax, cm.SYNC, dtype=np.int32)
    pop[0][0] = B
    pop[1] = naive_uniform_mb(env)
    n_evals = 0
    history = []
    seen_elites: dict[bytes, tuple[float, np.ndarray]] = {}

    for _ in range(cfg.generations):
        lat, peak = _costs(env, pop)
        n_evals += P
        fit = _fitness(lat, peak, env.budget_bytes)
        order = np.argsort(-fit)
        for idx in order[: cfg.elite]:
            if fit[idx] > -1e3:     # valid
                key = pop[idx, : n + 1].tobytes()
                seen_elites[key] = (float(fit[idx]), pop[idx].copy())
        best = order[0]
        history.append(env.baseline_latency / lat[best]
                       if fit[best] > -1e3 else 0.0)

        # --- next generation ---------------------------------------------
        nxt = [pop[i].copy() for i in order[: cfg.elite]]
        ranks = np.empty(P)
        ranks[order] = np.arange(P)
        p_sel = (P - ranks) / (P * (P + 1) / 2)
        while len(nxt) < P:
            pa, pb = rng.choice(P, size=2, p=p_sel)
            cut = rng.integers(1, n + 1)
            child = np.concatenate([pop[pa][:cut], pop[pb][cut:]])
            for j in range(n + 1):            # mutation
                if rng.random() < cfg.p_mut_gene / (n + 1):
                    r = rng.random()
                    if j > 0 and r < cfg.p_sync_mut:
                        child[j] = cm.SYNC if child[j] != cm.SYNC \
                            else int(rng.integers(1, B + 1))
                    elif r < 0.6 and child[j] >= 1:
                        child[j] = int(np.clip(
                            child[j] * (2 if rng.random() < 0.5 else 0.5),
                            1, B))
                    else:
                        child[j] = int(rng.integers(1, B + 1))
            if child[0] < 1:
                child[0] = int(rng.integers(1, B + 1))
            nxt.append(child)
        brood = _repair_population(env, np.stack(nxt[cfg.elite:]), cfg, rng)
        pop = np.concatenate([np.stack(nxt[: cfg.elite]), brood])

    lat, peak = _costs(env, pop)             # final evaluation
    n_evals += P
    fit = _fitness(lat, peak, env.budget_bytes)
    best = int(np.argmax(fit))
    for idx in np.argsort(-fit)[: cfg.elite]:
        if fit[idx] > -1e3:
            key = pop[idx, : n + 1].tobytes()
            seen_elites[key] = (float(fit[idx]), pop[idx].copy())

    elites = [s for _, s in sorted(seen_elites.values(),
                                   key=lambda kv: -kv[0])][:top_k]
    return GSamplerResult(
        strategy=pop[best].copy(),
        speedup=env.baseline_latency / float(lat[best]),
        latency=float(lat[best]), peak_mem=float(peak[best]),
        valid=bool(fit[best] > -1e3), n_evals=n_evals,
        wall_s=time.perf_counter() - t0, history=history, elites=elites)


@dataclass
class GridTeacherResult:
    """Top-k elite strategies per condition plus their exact costs."""
    strategies: np.ndarray   # [C, K, P] int32
    latency: np.ndarray      # [C, K]
    peak_mem: np.ndarray     # [C, K]
    speedup: np.ndarray      # [C, K]
    valid: np.ndarray        # [C, K] bool
    history: np.ndarray      # [G, C] best valid speedup per generation
    baseline_latency: np.ndarray   # [C]
    n_evals: int
    wall_s: float


def _randint_1_to_B(gen, shape, B) -> torch.Tensor:
    """Uniform int in [1, B] with per-condition (broadcast) B."""
    u = torch.rand(shape, generator=gen, device=B.device)
    return (1.0 + torch.floor(u * B)).to(torch.int32)


def _fitness_grid(latency, peak, budget):
    over = torch.clamp_min(peak / budget - 1.0, 0.0)
    return torch.where(over > 0.0, -1e3 * (1.0 + over) - latency, -latency)


def _naive_uniform_grid(wls, batches, budgets, hw, iters: int = 18):
    """Per-condition binary search for the largest uniform micro-batch that
    stages everything on-chip (the paper §3 naive strategy)."""
    C, P = wls["A"].shape
    dev = wls["A"].device
    n = wls["n"]
    pos = torch.arange(P, device=dev)
    valid_pos = pos[None, :] <= n[:, None]
    fallback = torch.where(pos == 0, 1, cm.SYNC).to(torch.int32)
    best = fallback.expand(C, P)
    lo = torch.ones(C, dtype=torch.int32, device=dev)
    hi = batches.to(torch.int32)
    for _ in range(iters):
        done = lo > hi
        mid = torch.clamp_min((lo + hi) // 2, 1)
        s = torch.where(valid_pos, mid[:, None], cm.SYNC).to(torch.int32)
        out = cm.evaluate_grid(wls, s[:, None, :], batches, budgets, hw)
        ok = out.valid[:, 0] & ~done
        best = torch.where(ok[:, None], s, best)
        lo = torch.where(done, lo, torch.where(ok, mid + 1, lo))
        hi = torch.where(done, hi, torch.where(ok, hi, mid - 1))
    return best


def _mutate_grid(gen, child, valid_pos, n, B, cfg: GSamplerConfig):
    """Fusion-aware mutation over [C, K, P] children."""
    C, K, P = child.shape
    dev = child.device
    pos = torch.arange(P, device=dev)
    Bc = B[:, None, None]
    p_gene = cfg.p_mut_gene / (n.to(torch.float32) + 1.0)
    mut = (torch.rand((C, K, P), generator=gen, device=dev)
           < p_gene[:, None, None]) & valid_pos[:, None, :]
    r = torch.rand((C, K, P), generator=gen, device=dev)
    rand_val = _randint_1_to_B(gen, (C, K, P), Bc)
    sync_flip = (pos > 0) & (r < cfg.p_sync_mut)
    flipped = torch.where(child != cm.SYNC, cm.SYNC, rand_val)
    grow = torch.rand((C, K, P), generator=gen, device=dev) < 0.5
    Bi = Bc.to(torch.int32)
    scaled = torch.minimum(torch.clamp_min(
        torch.where(grow, child * 2, child // 2), 1), Bi)
    scale_ok = (r < 0.6) & (child >= 1)
    new = torch.where(sync_flip, flipped,
                      torch.where(scale_ok, scaled, rand_val))
    child = torch.where(mut, new, child)
    # the input micro-batch (position 0) can never sync
    c0 = child[..., 0]
    fix = _randint_1_to_B(gen, (C, K), B[:, None])
    child = child.clone()
    child[..., 0] = torch.where(c0 < 1, fix, c0)
    return child


def _repair_grid(gen, wls, brood, batches, budgets, hw, cfg: GSamplerConfig):
    """Constraint repair of every condition's brood: an over-budget child
    splits its worst fused group or halves that group's largest staged
    micro-batch, for ``cfg.repair_tries`` rounds."""
    C, K, P = brood.shape
    pos = torch.arange(P, device=brood.device)
    mask = wls["mask"]
    s = brood
    for _ in range(cfg.repair_tries):
        u = torch.rand((C, K), generator=gen, device=brood.device)
        out, gid, M_g = cm.evaluate_grid_stats(wls, s, batches, budgets, hw)
        invalid = ~out.valid
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
        split_s = torch.where(onehot_mid, cm.SYNC, s)
        shrink_s = torch.where(onehot_j, torch.clamp_min(s // 2, 1), s)
        alt_s = torch.where(multi[..., None] & onehot_mid, cm.SYNC, s)
        shr = torch.where(has_mb[..., None], shrink_s, alt_s)
        do_split = multi & (u < 0.5)
        new = torch.where(do_split[..., None], split_s, shr)
        apply = invalid & members.any(-1)
        s = torch.where(apply[..., None], new, s).to(torch.int32)
    return s


def _ga_grid(gen, wls, batches, budgets, hw, cfg: GSamplerConfig,
             top_k: int) -> dict:
    """The whole grid GA; returns elites [C, top_k, P] with exact costs and
    the best-valid-speedup history, as tensors."""
    C, P = wls["A"].shape
    dev = wls["A"].device
    POP, E = cfg.population, cfg.elite
    n = wls["n"]
    pos = torch.arange(P, device=dev)
    valid_pos = pos[None, :] <= n[:, None]
    B = batches
    base = cm.baseline_grid(wls, batches, hw).latency

    vals = _randint_1_to_B(gen, (C, POP, P), B[:, None, None])
    syncs = torch.rand((C, POP, P), generator=gen, device=dev) < 0.4
    syncs[:, :, 0] = False
    pop = torch.where(syncs, cm.SYNC, vals)
    pop = torch.where(valid_pos[:, None, :], pop, cm.SYNC).to(torch.int32)
    pop[:, 0, :] = torch.where(pos == 0, B[:, None].to(torch.int32), cm.SYNC)
    pop[:, 1, :] = _naive_uniform_grid(wls, batches, budgets, hw)

    num = POP - E
    history = []
    for _ in range(cfg.generations):
        out = cm.evaluate_grid(wls, pop, batches, budgets, hw)
        fit = _fitness_grid(out.latency, out.peak_mem, budgets[:, None])
        order = torch.argsort(-fit, dim=1, stable=True)
        elites = torch.take_along_dim(pop, order[:, :E, None], dim=1)
        ranks = torch.argsort(order, dim=1, stable=True)
        p_sel = (POP - ranks).to(torch.float32) / (POP * (POP + 1) / 2)
        parents = torch.multinomial(p_sel, 2 * num, replacement=True,
                                    generator=gen).view(C, num, 2)
        pa = torch.take_along_dim(pop, parents[..., 0:1], dim=1)
        pb = torch.take_along_dim(pop, parents[..., 1:2], dim=1)
        cut = 1 + torch.floor(torch.rand((C, num), generator=gen, device=dev)
                              * n[:, None]).to(torch.int32)
        child = torch.where(pos < cut[..., None], pa, pb)
        child = _mutate_grid(gen, child, valid_pos, n, B, cfg)
        brood = _repair_grid(gen, wls, child, batches, budgets, hw, cfg)
        pop = torch.cat([elites, brood], dim=1).contiguous()
        sp = base[:, None] / torch.clamp_min(out.latency, 1e-12)
        history.append(torch.amax(torch.where(out.valid, sp, 0.0), dim=1))

    out = cm.evaluate_grid(wls, pop, batches, budgets, hw)
    fit = _fitness_grid(out.latency, out.peak_mem, budgets[:, None])
    order = torch.argsort(-fit, dim=1, stable=True)[:, :top_k]
    take = lambda x: torch.take_along_dim(x, order, dim=1)
    lat = take(out.latency)
    return dict(strategies=torch.take_along_dim(pop, order[..., None], dim=1),
                latency=lat, peak_mem=take(out.peak_mem),
                valid=take(out.valid) & (take(fit) > -1e3),
                speedup=base[:, None] / torch.clamp_min(lat, 1e-12),
                history=torch.stack(history), baseline_latency=base)


def gsampler_search_grid(workloads: list, hw, batches, budgets_bytes, *,
                         nmax: int = 64,
                         cfg: GSamplerConfig = GSamplerConfig(),
                         top_k: int = 8, packed=None,
                         device=None) -> GridTeacherResult:
    """Search every (workloads[c], hw[c], batches[c], budgets_bytes[c])
    condition at once on ``device``.

    ``hw`` is one ``AccelConfig`` or a length-C sequence of them;
    ``packed`` optionally supplies the ``stack_workloads`` dict of the
    same grid, each condition packed for its own accelerator.
    Deterministic for a fixed ``cfg.seed`` on a given device."""
    if not len(workloads) == len(batches) == len(budgets_bytes):
        raise ValueError("workloads, batches and budgets differ in length")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    C = len(workloads)
    hws = [hw] * C if isinstance(hw, AccelConfig) else list(hw)
    if packed is None:
        packed = cm.stack_workloads([cm.pack_workload(w, h, nmax, device=dev)
                                     for w, h in zip(workloads, hws)])
    hwv = stack_hw(hws, C, dev)
    B = torch.as_tensor(np.asarray(batches, np.float32), device=dev)
    budgets = torch.as_tensor(np.asarray(budgets_bytes, np.float32),
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    out = _ga_grid(gen, packed, B, budgets, hwv, cfg, top_k)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    n_evals = C * cfg.population * (cfg.generations
                                    * (1 + cfg.repair_tries) + 1)
    return GridTeacherResult(
        strategies=out["strategies"], latency=out["latency"],
        peak_mem=out["peak_mem"], speedup=out["speedup"],
        valid=out["valid"], history=out["history"],
        baseline_latency=out["baseline_latency"], n_evals=n_evals,
        wall_s=time.perf_counter() - t0)
