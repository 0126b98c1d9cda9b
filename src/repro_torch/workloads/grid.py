"""The condition grid the port's smoke run and profiler answer: every
``CNN_ZOO`` network x every ``ACCEL_ZOO`` part x a set of on-chip budgets,
at one batch (the paper's 64) and one ``nmax`` bucket; and the bursty
request stream their serving phases drive."""
from __future__ import annotations

import numpy as np

from .cnn_zoo import CNN_ZOO

__all__ = ["paper_grid", "serving_stream", "SERVE_BUDGETS_MB"]

MB = 2.0 ** 20


def paper_grid(parts: list[str], budgets_mb=(8, 16, 32, 64),
               batch: int = 64):
    """``(conditions, workloads, batches, budgets_bytes)``: conditions are
    (network, part, budget MB) triples in sorted network, part, budget
    order; ``batches``/``budgets_bytes`` are f32 numpy vectors."""
    nets = {n: CNN_ZOO[n]() for n in sorted(CNN_ZOO)}
    conds = [(n, p, b) for n in nets for p in sorted(parts)
             for b in budgets_mb]
    workloads = [nets[n] for n, _, _ in conds]
    batches = np.full(len(conds), float(batch), np.float32)
    budgets = np.array([b * MB for _, _, b in conds], np.float32)
    return conds, workloads, batches, budgets


SERVE_BUDGETS_MB = (8, 12, 16, 24, 32, 48, 64)
SERVE_BATCHES = (16, 64)
BURST = (16, 64)          # requests a burst, at least / at most
BURST_GAP_S = 2.0         # between burst starts, on the scheduler's clock
BURST_SPACING_S = 1e-4    # between a burst's requests


def serving_stream(parts: list[str], n: int = 480, seed: int = 0):
    """``(conditions, arrivals)`` of a bursty serving stream: ``n`` seeded
    requests as (network, part, budget MB, batch) tuples drawn uniformly
    over ``CNN_ZOO`` x ``parts`` x ``SERVE_BUDGETS_MB`` x
    ``SERVE_BATCHES``, arriving in bursts of ``BURST`` requests
    ``BURST_GAP_S`` apart (seconds on the scheduler's clock)."""
    rng = np.random.default_rng(seed)
    nets, parts = sorted(CNN_ZOO), sorted(parts)
    conds, arrivals, t = [], [], 0.0
    while len(conds) < n:
        size = min(int(rng.integers(BURST[0], BURST[1] + 1)), n - len(conds))
        for k in range(size):
            conds.append((
                nets[rng.integers(len(nets))],
                parts[rng.integers(len(parts))],
                float(SERVE_BUDGETS_MB[rng.integers(len(SERVE_BUDGETS_MB))]),
                int(SERVE_BATCHES[rng.integers(len(SERVE_BATCHES))])))
            arrivals.append(t + k * BURST_SPACING_S)
        t += BURST_GAP_S
    return conds, arrivals
