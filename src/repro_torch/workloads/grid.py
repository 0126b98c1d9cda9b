"""The condition grid the port's smoke run and profiler answer: every
``CNN_ZOO`` network x every ``ACCEL_ZOO`` part x a set of on-chip budgets,
at one batch (the paper's 64) and one ``nmax`` bucket."""
from __future__ import annotations

import numpy as np

from .cnn_zoo import CNN_ZOO

__all__ = ["paper_grid"]

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
