"""The one traffic generator: it reads a mix's parameters (a JSON file
under ``perfbench/traffic/``) and draws the work from the run's seed.

A quantity of a mix is given by a distribution spec:

- ``{"dist": "choice", "values": [...]}``: one of the values;
- ``{"dist": "uniform", "lo": a, "hi": b, "step": s}``: a multiple of
  ``s`` in [a, b], every one as likely;
- ``{"dist": "log_uniform", "lo": a, "hi": b}``: log-uniform on [a, b],
  rounded to a multiple of ``"step"`` when the spec has one.

``stratified(spec, k)`` gives the same k values for every seed (the
distribution's quantiles at (i + 0.5) / k), and ``cycles`` hands them out
a whole cycle at a time, each in a new order drawn from the seed: a run
that ends on a cycle's end has done the same set of sizes for every seed,
only their order differs.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["quantile", "draw", "stratified", "cycles", "rng_for"]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of the run's ``seed`` (any
    non-negative whole number)."""
    return np.random.default_rng([int(seed), int(stream)])


def _round_step(x: np.ndarray, spec: dict) -> np.ndarray:
    step = spec.get("step")
    if step is None:
        return x
    lo, hi = spec["lo"], spec["hi"]
    return np.clip(np.round(x / step) * step, lo, hi).astype(np.int64)


def quantile(spec: dict, u: np.ndarray) -> np.ndarray:
    """The spec's inverse distribution function at ``u`` in [0, 1)."""
    u = np.asarray(u, np.float64)
    kind = spec["dist"]
    if kind == "choice":
        vals = np.asarray(spec["values"])
        return vals[np.minimum((u * len(vals)).astype(np.int64),
                               len(vals) - 1)]
    if kind == "uniform":
        step = spec["step"]
        n = (spec["hi"] - spec["lo"]) // step + 1
        k = np.minimum((u * n).astype(np.int64), n - 1)
        return spec["lo"] + k * step
    if kind == "log_uniform":
        lo, hi = math.log(spec["lo"]), math.log(spec["hi"])
        return _round_step(np.exp(lo + u * (hi - lo)), spec)
    raise ValueError(f"unknown distribution {kind!r}")


def draw(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` independent draws."""
    return quantile(spec, rng.random(n))


def stratified(spec: dict, k: int) -> np.ndarray:
    """The same ``k`` values for every seed: quantiles at (i + 0.5) / k."""
    return quantile(spec, (np.arange(k) + 0.5) / k)


def cycles(values, rng: np.random.Generator):
    """Endless: lists of all of ``values``, each in a new order drawn from
    ``rng``."""
    values = list(values)
    while True:
        yield [values[i] for i in rng.permutation(len(values))]
