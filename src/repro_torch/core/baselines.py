"""Black-box baseline optimizers of Table 1 (paper §5.1).

Port of ``repro.core.baselines``.  The paper compares the G-Sampler with
nevergrad's PSO, CMA-ES, DE, TBPSA and stdGA, plus random search and an
A2C agent (``a2c.py``).  The five optimizers are written here from their
standard formulations, over a continuous relaxation of the strategy
vector (decoded to {SYNC} u [1..B]).  As in the paper they get no domain
knowledge (no heuristic seeding, no repair operator) and a budget of 2k
samples, which is why they miss the memory constraint in Table 1.

The optimizers are host numpy, drawing from ``np.random.default_rng(seed)``
with the reference's arithmetic, so a run follows the reference's
trajectory.  Each generation's candidates are scored by one
``evaluate_population`` call -- one ``fusion_eval`` launch on the env's
device and one readback -- and the best strategy by one
``FusionEnv.evaluate_strategy``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import cost_model as cm

__all__ = ["SearchResult", "run_baseline", "BASELINE_METHODS"]

_PENALTY = 1e3


@dataclass
class SearchResult:
    method: str
    strategy: np.ndarray
    speedup: float
    latency: float
    peak_mem: float
    valid: bool
    n_evals: int
    wall_s: float


def _decode(z: np.ndarray, batch: int, nmax: int, n: int) -> np.ndarray:
    """Continuous genome -> strategy.

    The paper's map-space has "64 tiling choices per layer" (§2): choice 0 is
    SYNC, choices 1..B are micro-batch sizes.  Under an uninformed init the
    sync choice is hit w.p. ~1/(B+1), so random candidates fuse nearly
    everything and blow the memory budget — exactly the Table 1 behaviour of
    the domain-agnostic baselines (usages of 100-400 MB, marked N/A).
    """
    idx = np.floor(np.clip(z, 0.0, batch + 0.999)).astype(np.int32)
    s = np.full((z.shape[0], nmax), cm.SYNC, dtype=np.int32)
    s[:, : n + 1] = np.where(idx[:, : n + 1] == 0, cm.SYNC, idx[:, : n + 1])
    s[:, 0] = np.maximum(s[:, 0], 1)
    return s


def _score(env, z: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched objective (lower better).

    Faithful to the paper's Table 1 protocol: the domain-agnostic baselines
    minimize raw latency; the memory constraint is checked *post hoc* and
    over-budget solutions are reported N/A with their (100-400 MB) usages.
    Since fusing more monotonically reduces modeled latency, unconstrained
    optimizers drift deep into the invalid region — the paper's observation
    that they "cannot meet the constraint within the 2K sampling budget".
    """
    strat = _decode(z, env.batch, env.nmax, env.n)
    out = cm.evaluate_population(env.wl, torch.as_tensor(strat,
                                                         device=env.device),
                                 float(env.batch), float(env.budget_bytes),
                                 env.hw)
    lat, peak = torch.stack((out.latency, out.peak_mem)).cpu().numpy() \
        .astype(np.float64)                # one readback a generation
    return lat.copy(), lat, peak


def _finish(env, method: str, zbest: np.ndarray, n_evals: int,
            t0: float) -> SearchResult:
    strat = _decode(zbest[None], env.batch, env.nmax, env.n)[0]
    out = env.evaluate_strategy(strat)
    lat, peak = float(out.latency), float(out.peak_mem)
    return SearchResult(method, strat, env.baseline_latency / lat, lat, peak,
                        bool(out.valid), n_evals, time.perf_counter() - t0)


def _init_pop(rng, pop: int, dim: int, batch: int) -> np.ndarray:
    """Uninformed init: uniform over the B+1 tiling choices."""
    return rng.uniform(0.0, batch + 1.0, size=(pop, dim))


def pso(env, budget: int = 2000, seed: int = 0, pop: int = 40) -> SearchResult:
    rng = np.random.default_rng(seed); t0 = time.perf_counter()
    dim = env.n + 1
    x = _init_pop(rng, pop, dim, env.batch)
    v = rng.normal(0, 1, size=(pop, dim))
    obj, _, _ = _score(env, x); n_evals = pop
    pbest, pobj = x.copy(), obj.copy()
    g = int(np.argmin(obj)); gbest, gobj = x[g].copy(), obj[g]
    w, c1, c2 = 0.7, 1.5, 1.5
    while n_evals + pop <= budget:
        r1, r2 = rng.random((pop, dim)), rng.random((pop, dim))
        v = w * v + c1 * r1 * (pbest - x) + c2 * r2 * (gbest - x)
        x = x + v
        obj, _, _ = _score(env, x); n_evals += pop
        imp = obj < pobj
        pbest[imp], pobj[imp] = x[imp], obj[imp]
        g = int(np.argmin(pobj))
        if pobj[g] < gobj:
            gbest, gobj = pbest[g].copy(), pobj[g]
    return _finish(env, "PSO", gbest, n_evals, t0)


def de(env, budget: int = 2000, seed: int = 0, pop: int = 40) -> SearchResult:
    rng = np.random.default_rng(seed); t0 = time.perf_counter()
    dim = env.n + 1
    x = _init_pop(rng, pop, dim, env.batch)
    obj, _, _ = _score(env, x); n_evals = pop
    F, CR = 0.8, 0.9
    while n_evals + pop <= budget:
        idx = np.array([rng.choice(pop, 3, replace=False) for _ in range(pop)])
        mutant = x[idx[:, 0]] + F * (x[idx[:, 1]] - x[idx[:, 2]])
        cross = rng.random((pop, dim)) < CR
        cross[np.arange(pop), rng.integers(0, dim, pop)] = True
        trial = np.where(cross, mutant, x)
        tobj, _, _ = _score(env, trial); n_evals += pop
        imp = tobj < obj
        x[imp], obj[imp] = trial[imp], tobj[imp]
    b = int(np.argmin(obj))
    return _finish(env, "DE", x[b], n_evals, t0)


def cma_es(env, budget: int = 2000, seed: int = 0, pop: int = 40) -> SearchResult:
    """(mu/mu_w, lambda)-CMA-ES (Hansen 2006), full covariance."""
    rng = np.random.default_rng(seed); t0 = time.perf_counter()
    dim = env.n + 1
    mean = rng.uniform(0, env.batch / 2, size=dim)
    sigma = env.batch / 4.0
    lam = pop; mu = lam // 2
    wts = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    wts /= wts.sum(); mueff = 1.0 / np.sum(wts ** 2)
    cc = (4 + mueff / dim) / (dim + 4 + 2 * mueff / dim)
    cs = (mueff + 2) / (dim + mueff + 5)
    c1 = 2 / ((dim + 1.3) ** 2 + mueff)
    cmu = min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((dim + 2) ** 2 + mueff))
    damps = 1 + 2 * max(0, np.sqrt((mueff - 1) / (dim + 1)) - 1) + cs
    pc = np.zeros(dim); ps = np.zeros(dim); C = np.eye(dim)
    chiN = np.sqrt(dim) * (1 - 1 / (4 * dim) + 1 / (21 * dim ** 2))
    n_evals = 0; best, bobj = mean.copy(), np.inf
    while n_evals + lam <= budget:
        try:
            Bm = np.linalg.cholesky((C + C.T) / 2 + 1e-10 * np.eye(dim))
        except np.linalg.LinAlgError:
            C = np.eye(dim); Bm = C
        z = rng.normal(size=(lam, dim))
        x = mean + sigma * z @ Bm.T
        obj, _, _ = _score(env, x); n_evals += lam
        order = np.argsort(obj)
        if obj[order[0]] < bobj:
            best, bobj = x[order[0]].copy(), obj[order[0]]
        xsel = x[order[:mu]]
        old_mean = mean
        mean = wts @ xsel
        y = (mean - old_mean) / sigma
        Cinvsqrt = np.linalg.pinv(Bm)
        ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mueff) * (Cinvsqrt @ y)
        hsig = (np.linalg.norm(ps) / np.sqrt(1 - (1 - cs) ** (2 * n_evals / lam))
                / chiN) < (1.4 + 2 / (dim + 1))
        pc = (1 - cc) * pc + hsig * np.sqrt(cc * (2 - cc) * mueff) * y
        artmp = (xsel - old_mean) / sigma
        C = ((1 - c1 - cmu) * C + c1 * (np.outer(pc, pc)
             + (not hsig) * cc * (2 - cc) * C)
             + cmu * artmp.T @ np.diag(wts) @ artmp)
        sigma *= np.exp((cs / damps) * (np.linalg.norm(ps) / chiN - 1))
        sigma = float(np.clip(sigma, 1e-3, env.batch))
    return _finish(env, "CMA", best, n_evals, t0)


def tbpsa(env, budget: int = 2000, seed: int = 0, pop: int = 40) -> SearchResult:
    """Test-based population-size adaptation (simplified (mu, lambda)-ES
    with averaged elites, nevergrad's noisy-optimization default)."""
    rng = np.random.default_rng(seed); t0 = time.perf_counter()
    dim = env.n + 1
    mean = rng.uniform(0, env.batch / 2, size=dim)
    sigma = np.full(dim, env.batch / 4.0)
    lam = pop; mu = max(2, lam // 4)
    n_evals = 0; best, bobj = mean.copy(), np.inf
    while n_evals + lam <= budget:
        x = mean + sigma * rng.normal(size=(lam, dim))
        obj, _, _ = _score(env, x); n_evals += lam
        order = np.argsort(obj)
        if obj[order[0]] < bobj:
            best, bobj = x[order[0]].copy(), obj[order[0]]
        elite = x[order[:mu]]
        mean = elite.mean(axis=0)
        sigma = 0.9 * sigma + 0.1 * elite.std(axis=0) * np.sqrt(mu / dim + 1.0)
        sigma = np.clip(sigma, 1e-2, env.batch)
    return _finish(env, "TBPSA", best, n_evals, t0)


def std_ga(env, budget: int = 2000, seed: int = 0, pop: int = 40) -> SearchResult:
    """Generic GA: uniform crossover + gene resample, NO domain operators."""
    rng = np.random.default_rng(seed); t0 = time.perf_counter()
    dim = env.n + 1
    x = _init_pop(rng, pop, dim, env.batch)
    obj, _, _ = _score(env, x); n_evals = pop
    while n_evals + pop <= budget:
        order = np.argsort(obj)
        elite = x[order[:4]]
        children = [e.copy() for e in elite]
        while len(children) < pop:
            pa, pb = x[order[rng.integers(0, pop // 2)]], \
                x[order[rng.integers(0, pop // 2)]]
            child = np.where(rng.random(dim) < 0.5, pa, pb)
            mut = rng.random(dim) < 0.1
            child[mut] = rng.uniform(0.0, env.batch + 1.0, size=mut.sum())
            children.append(child)
        x = np.stack(children)
        obj, _, _ = _score(env, x); n_evals += pop
    b = int(np.argmin(obj))
    return _finish(env, "stdGA", x[b], n_evals, t0)


def random_search(env, budget: int = 2000, seed: int = 0,
                  pop: int = 40) -> SearchResult:
    rng = np.random.default_rng(seed); t0 = time.perf_counter()
    dim = env.n + 1
    best, bobj, n_evals = None, np.inf, 0
    while n_evals + pop <= budget:
        x = _init_pop(rng, pop, dim, env.batch)
        obj, _, _ = _score(env, x); n_evals += pop
        b = int(np.argmin(obj))
        if obj[b] < bobj:
            best, bobj = x[b].copy(), obj[b]
    return _finish(env, "Random", best, n_evals, t0)


BASELINE_METHODS = {
    "PSO": pso, "CMA": cma_es, "DE": de, "TBPSA": tbpsa,
    "stdGA": std_ga, "Random": random_search,
}


def run_baseline(env, method: str, budget: int = 2000,
                 seed: int = 0) -> SearchResult:
    return BASELINE_METHODS[method](env, budget=budget, seed=seed)
