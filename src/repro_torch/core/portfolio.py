"""Warm-started searcher portfolio: DE + diagonal CMA-ES.

Port of ``repro.core.portfolio``.  Two population searchers beside the
G-Sampler GA, built for one job: ESCALATION.  When the one-shot mapper (or
its gradient polish) leaves a request budget-violating, the engine
re-searches the condition warm-started from the proposal, so the search
spends its evaluations refining a good incumbent instead of rediscovering
it.

Search space -- the ENCODED ACTION space of ``env.encode_action``: a
genome is ``y`` in ``[-1, 1]^P`` where ``y < 0`` decodes to SYNC and
``y >= 0`` to the tile ``clip(round(y * B), 1, B)`` (position 0 and
padding follow the serving rules: the input position cannot sync,
positions past ``n`` always do).  Warm start is therefore exact:
``encode_action(proposal)`` decodes back to the proposal bit for bit.

Both searchers evolve every condition's population at once over
``[C, POP, P]`` genomes; fitness is one ``cost_model.evaluate_grid`` call
per generation (one ``fusion_eval`` launch on the card), and selection is
elitist: the returned strategy is never worse (by fitness) than the best
warm seed, which includes the proposal itself.

Randomness: each condition draws from its own stream,
``np.random.default_rng([cfg.seed, salts[c]])``, all of a run's numbers at
once on the host, then one copy to the device.  A lane's numbers are
therefore a function of ``(seed, salt)`` alone: a single-condition run
with ``salts=[c]`` reproduces row ``c`` of a grid run, a lane's result
does not depend on how many lanes run beside it or which they are, and the
card and the CPU draw the same numbers.  Every device operation is
elementwise or reduces in a fixed order (``cost_model.fixed_sum``), so the
arithmetic is lane-independent too.  The streams are not JAX's threefry
streams, so against the reference the searchers are held to quality.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from . import cost_model as cm
from .accel import AccelConfig, stack_hw
from .env import encode_action
from .gsampler import _fitness_grid

__all__ = ["PortfolioConfig", "PortfolioResult", "de_search_grid",
           "cmaes_search_grid"]


@dataclass(frozen=True)
class PortfolioConfig:
    """Shared searcher knobs (the reference's defaults)."""
    population: int = 24
    generations: int = 30
    seed: int = 0
    warm_sigma: float = 0.12   # genome jitter around a warm proposal
    # -- differential evolution --
    de_f: float = 0.6          # differential weight
    de_cr: float = 0.7         # crossover rate
    # -- diagonal CMA-ES --
    cma_mu: int = 0            # parents (0 -> population // 2)
    cma_lr_sigma: float = 0.2  # per-dim variance adaptation rate
    sigma0: float = 0.4        # cold-start step size
    sigma_min: float = 1e-3
    sigma_max: float = 0.8


@dataclass
class PortfolioResult:
    """Best-ever strategy per condition plus the convergence history."""
    strategies: np.ndarray        # [C, P] int32
    latency: np.ndarray           # [C]
    peak_mem: np.ndarray          # [C]
    speedup: np.ndarray           # [C]
    valid: np.ndarray             # [C] bool
    history: np.ndarray           # [G, C] best valid latency so far (inf)
    baseline_latency: np.ndarray  # [C]
    n_evals: int                  # exact cost evaluations performed
    wall_s: float


def _decode_grid(y: torch.Tensor, B: torch.Tensor,
                 valid_pos: torch.Tensor) -> torch.Tensor:
    """Genomes [C, POP, P] -> strategies: the serving decode rules.

    Matches ``env.decode_action`` for ``y >= 0``; position 0 decodes its
    magnitude (the input micro-batch can never sync) and padding positions
    stay SYNC."""
    Bc = B[:, None, None]
    mb = torch.minimum(torch.clamp_min(torch.round(y.abs() * Bc), 1.0), Bc)
    s = torch.where(y < 0.0, float(cm.SYNC), mb)
    s = torch.cat([mb[..., :1], s[..., 1:]], dim=-1)
    s = torch.where(valid_pos[:, None, :], s, float(cm.SYNC))
    return s.to(torch.int32).contiguous()


def _draws(seeds, method: str, warm: bool, cfg: PortfolioConfig,
           P: int) -> dict:
    """Every random number of a run, lane by lane from
    ``default_rng([seed, salt])``, stacked [C, ...] (host numpy)."""
    POP, G = cfg.population, cfg.generations
    out: dict = {}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        d = {"init": (rng.standard_normal((POP, P), dtype=np.float32) if warm
                      else rng.uniform(-1.0, 1.0, (POP, P))
                      .astype(np.float32))}
        if method == "de":
            d["r"] = rng.integers(0, POP, (G, POP, 3))
            d["jrand"] = rng.integers(0, P, (G, POP))
            d["u"] = rng.random((G, POP, P), dtype=np.float32)
        else:
            d["z"] = rng.standard_normal((G, POP, P), dtype=np.float32)
        for k, v in d.items():
            out.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in out.items()}


def _portfolio(draws: dict, wls, batches, budgets, hw, y0, method: str,
               warm: bool, cfg: PortfolioConfig) -> dict:
    C, P = wls["A"].shape
    dev = wls["A"].device
    POP, G = cfg.population, cfg.generations
    d = {k: torch.as_tensor(v, device=dev) for k, v in draws.items()}
    pos = torch.arange(P, device=dev)
    valid_pos = pos[None, :] <= wls["n"][:, None]
    B = batches
    base = cm.baseline_grid(wls, batches, hw).latency
    bud = budgets[:, None]

    def fitness(y):
        out = cm.evaluate_grid(wls, _decode_grid(y, B, valid_pos), batches,
                               budgets, hw)
        fit = _fitness_grid(out.latency, out.peak_mem, bud)
        vlat = torch.amin(torch.where(out.valid, out.latency, float("inf")),
                          dim=1)
        return fit, vlat

    def track(best, y, fit, vlat):
        best_fit, best_y, best_lat = best
        idx = torch.argmax(fit, dim=1)                 # first maximum
        top = fit.gather(1, idx[:, None])[:, 0]
        upd = top > best_fit
        cand = torch.take_along_dim(y, idx[:, None, None], dim=1)[:, 0]
        return (torch.where(upd, top, best_fit),
                torch.where(upd[:, None], cand, best_y),
                torch.minimum(best_lat, vlat))

    if warm:
        pop = torch.clamp(y0[:, None, :] + cfg.warm_sigma * d["init"],
                          -1.0, 1.0)
        pop[:, 0, :] = y0                      # member 0: the exact proposal
    else:
        pop = d["init"].clone()
    allsync = torch.full((P,), -0.5, device=dev)
    allsync[0] = 1.0
    pop[:, 1, :] = allsync                     # full-batch input, all SYNC

    fit, vlat = fitness(pop)
    best = (torch.full((C,), float("-inf"), device=dev), pop[:, 0].clone(),
            torch.full((C,), float("inf"), device=dev))
    best = track(best, pop, fit, vlat)
    history = []
    if method == "de":
        for g in range(G):
            r = d["r"][:, g]
            x1, x2, x3 = (torch.take_along_dim(pop, r[..., i:i + 1], dim=1)
                          for i in range(3))
            mutant = torch.clamp(x1 + cfg.de_f * (x2 - x3), -1.0, 1.0)
            cross = (d["u"][:, g] < cfg.de_cr) \
                | (pos == d["jrand"][:, g][..., None])
            trial = torch.where(cross, mutant, pop)
            tfit, tvlat = fitness(trial)
            best = track(best, trial, tfit, tvlat)
            sel = tfit >= fit
            pop = torch.where(sel[..., None], trial, pop)
            fit = torch.where(sel, tfit, fit)
            history.append(best[2])
    elif method == "cmaes":
        MU = cfg.cma_mu or POP // 2
        w = np.log(MU + 0.5) - np.log(np.arange(1, MU + 1))
        w = torch.as_tensor((w / w.sum()).astype(np.float32),
                            device=dev)[None, :, None]
        mean = y0 if warm else torch.zeros((C, P), device=dev)
        sigma = torch.full((C, P), cfg.warm_sigma if warm else cfg.sigma0,
                           device=dev)
        for g in range(G):
            z = d["z"][:, g].clone()
            z[:, 0, :] = 0.0                   # sample 0: the mean itself
            x = torch.clamp(mean[:, None, :] + sigma[:, None, :] * z,
                            -1.0, 1.0)
            xfit, xvlat = fitness(x)
            best = track(best, x, xfit, xvlat)
            order = torch.argsort(-xfit, dim=1, stable=True)[:, :MU, None]
            xsel = torch.take_along_dim(x, order, dim=1)
            zsel = torch.take_along_dim(z, order, dim=1)
            mean = cm.fixed_sum(w * xsel, dim=1)
            var_step = cm.fixed_sum(w * (zsel ** 2 - 1.0), dim=1)
            sigma = torch.clamp(
                sigma * torch.exp(0.5 * cfg.cma_lr_sigma * var_step),
                cfg.sigma_min, cfg.sigma_max)
            history.append(best[2])
    else:
        raise ValueError(f"unknown portfolio method {method!r}")

    best_s = _decode_grid(best[1][:, None, :], B, valid_pos)
    out = cm.evaluate_grid(wls, best_s, batches, budgets, hw)
    lat = out.latency[:, 0]
    return dict(strategies=best_s[:, 0], latency=lat,
                peak_mem=out.peak_mem[:, 0], valid=out.valid[:, 0],
                speedup=base / torch.clamp_min(lat, 1e-12),
                history=torch.stack(history), baseline_latency=base)


def _prepare_grid(workloads, hw, C: int, nmax: int, packed, dev):
    """Pack/stack the condition grid on ``dev``: ``AccelConfig`` hw packs
    on demand; an already-stacked hw tensor requires ``packed=``."""
    if isinstance(hw, AccelConfig) or isinstance(hw, (list, tuple)):
        hws = list(hw) if isinstance(hw, (list, tuple)) else [hw] * C
        if len(hws) != C:
            raise ValueError(f"got {len(hws)} accelerators for {C} "
                             f"conditions")
        if packed is None:
            if workloads is None:
                raise ValueError("pass workloads= or packed=")
            packed = cm.stack_workloads(
                [cm.pack_workload(w, h, nmax, device=dev)
                 for w, h in zip(workloads, hws)])
        hwv = stack_hw(hws, C, dev)
    else:
        if packed is None:
            raise ValueError("stacked hw rows require `packed=` -- "
                             "pack_workload needs AccelConfigs")
        hwv = stack_hw(hw, C, dev)
    if packed["A"].device != dev:
        raise ValueError(f"workloads are on {packed['A'].device}, the "
                         f"search runs on {dev}")
    return packed, hwv


def _search_grid(method: str, workloads, hw, batches, budgets_bytes, *,
                 nmax, cfg, init_strategies, salts, packed,
                 device) -> PortfolioResult:
    dev = resolve_device(device)
    t0 = time.perf_counter()
    batches = np.asarray(batches, np.float32).reshape(-1)
    budgets = np.asarray(budgets_bytes, np.float32).reshape(-1)
    C = len(batches)
    wls, hwv = _prepare_grid(workloads, hw, C, nmax, packed, dev)
    P = wls["A"].shape[-1]
    salts = np.arange(C) if salts is None else np.asarray(salts, np.uint32)
    if salts.shape != (C,):
        raise ValueError(f"salts has shape {salts.shape}, expected ({C},)")
    warm = init_strategies is not None
    if warm:
        init = np.asarray(init_strategies, np.int32)
        if init.shape != (C, P):
            raise ValueError(f"init_strategies has shape {init.shape}, "
                             f"expected {(C, P)}")
        y0 = torch.as_tensor(np.stack([
            encode_action(init[c], int(batches[c])) for c in range(C)]),
            device=dev)
    else:
        y0 = None
    draws = _draws([[cfg.seed, int(s)] for s in salts], method, warm, cfg, P)
    out = _portfolio(draws, wls, torch.as_tensor(batches, device=dev),
                     torch.as_tensor(budgets, device=dev), hwv, y0, method,
                     warm, cfg)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    n_evals = C * cfg.population * (cfg.generations + 1) + C
    return PortfolioResult(
        strategies=out["strategies"], latency=out["latency"],
        peak_mem=out["peak_mem"], speedup=out["speedup"],
        valid=out["valid"], history=out["history"],
        baseline_latency=out["baseline_latency"], n_evals=n_evals,
        wall_s=time.perf_counter() - t0)


def de_search_grid(workloads, hw, batches, budgets_bytes, *,
                   nmax: int = 64,
                   cfg: PortfolioConfig = PortfolioConfig(),
                   init_strategies=None, salts=None, packed=None,
                   device=None) -> PortfolioResult:
    """Differential evolution over every condition of the grid at once on
    ``device`` (``cuda`` unless ``"cpu"``; rand/1/bin, elitist
    replacement).

    ``init_strategies`` [C, P] int32 warm-starts the population from a
    proposal per condition (member 0 is the exact proposal; the rest are
    ``warm_sigma`` genome jitters of it).  ``salts`` [C] picks each
    condition's random stream (default ``arange(C)``): a single-condition
    run with ``salts=[c]`` reproduces grid row ``c``.  ``history[g, c]``
    is the best VALID exact latency seen up to generation ``g`` (inf
    until one exists); ``n_evals`` counts exact cost evaluations.
    ``packed`` (a ``stack_workloads`` dict on ``device``) with ``hw`` as
    stacked rows replaces ``workloads``."""
    return _search_grid("de", workloads, hw, batches, budgets_bytes,
                        nmax=nmax, cfg=cfg,
                        init_strategies=init_strategies, salts=salts,
                        packed=packed, device=device)


def cmaes_search_grid(workloads, hw, batches, budgets_bytes, *,
                      nmax: int = 64,
                      cfg: PortfolioConfig = PortfolioConfig(),
                      init_strategies=None, salts=None, packed=None,
                      device=None) -> PortfolioResult:
    """Diagonal (separable) CMA-ES over the same grid contract as
    :func:`de_search_grid`: rank-weighted recombination of the top
    ``cma_mu`` samples, per-dimension variance adaptation, the mean
    re-evaluated every generation (sample 0), best-ever elitism across
    all evaluations.  Warm start sets the initial mean to the proposal
    and the step size to ``warm_sigma``."""
    return _search_grid("cmaes", workloads, hw, batches, budgets_bytes,
                        nmax=nmax, cfg=cfg,
                        init_strategies=init_strategies, salts=salts,
                        packed=packed, device=device)
