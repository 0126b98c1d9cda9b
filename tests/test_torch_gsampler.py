"""Port checks: the grid G-Sampler.

The seeding search is deterministic and equals the reference's exactly.
The GA draws from a torch generator, not JAX's threefry, so it is held to
be deterministic per seed within the port and compared with the
reference on quality: every elite the port flags valid is valid under the
reference's XLA evaluator, with its reported cost within rtol 1e-5 of the
reference's re-score, and its best speedups at the same config stay
within a stated tolerance of the reference's (see ``_QUALITY_TOL``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, MB, port_workload, to_np
from repro.core import cost_model as jcm, gsampler as jgs
from repro.core.accel import ACCEL_ZOO as JZOO, stack_hw as jstack_hw
from repro.workloads import mobilenet_v2, resnet18, tiny_cnn
from repro_torch.core import accel as taccel, cost_model as tcm
from repro_torch.core import gsampler as tgs

NMAX = 32
CFG = dict(population=12, generations=8, elite=2, repair_tries=3, seed=0)
# the port's mean best speedup over the grid is at least this fraction of
# the reference's (both runs are short GAs with different random streams)
_QUALITY_TOL = 0.9


def _grid():
    conds = [(f, p, b) for f in (tiny_cnn, resnet18)
             for p in ("edge", "datacenter") for b in (2, 16)]
    jw = [f() for f, _, _ in conds]
    tw = [port_workload(w) for w in jw]
    jh = [JZOO[p] for _, p, _ in conds]
    th = [taccel.ACCEL_ZOO[p] for _, p, _ in conds]
    batches = np.full(len(conds), 32.0, np.float32)
    budgets = np.array([b * MB for _, _, b in conds], np.float32)
    return jw, tw, jh, th, batches, budgets


def test_naive_uniform_grid_equals_reference():
    ws = [resnet18(), mobilenet_v2(), tiny_cnn(), resnet18()]
    parts = ["edge", "nano", "datacenter", "laptop"]
    batches = np.array([64, 32, 16, 64], np.float32)
    budgets = np.array([4, 1, 8, 0.01], np.float32) * MB
    jwls = jcm.stack_workloads([jcm.pack_workload(w, JZOO[p], 64)
                                for w, p in zip(ws, parts)])
    want = jgs._naive_uniform_grid(jwls, jnp.asarray(batches),
                                   jnp.asarray(budgets),
                                   jstack_hw([JZOO[p] for p in parts], 4),
                                   evaluator="xla")
    twls = tcm.stack_workloads([
        tcm.pack_workload(port_workload(w), taccel.ACCEL_ZOO[p], 64,
                          device=CPU) for w, p in zip(ws, parts)])
    got = tgs._naive_uniform_grid(
        twls, torch.as_tensor(batches), torch.as_tensor(budgets),
        taccel.stack_hw([taccel.ACCEL_ZOO[p] for p in parts], 4))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.fixture(scope="module")
def searches():
    jw, tw, jh, th, batches, budgets = _grid()
    cfg = tgs.GSamplerConfig(**CFG)
    a = tgs.gsampler_search_grid(tw, th, batches, budgets, nmax=NMAX,
                                 cfg=cfg, top_k=3, device=CPU)
    b = tgs.gsampler_search_grid(tw, th, batches, budgets, nmax=NMAX,
                                 cfg=cfg, top_k=3, device=CPU)
    c = tgs.gsampler_search_grid(tw, th, batches, budgets, nmax=NMAX,
                                 cfg=tgs.GSamplerConfig(**{**CFG, "seed": 1}),
                                 top_k=3, device=CPU)
    ref = jgs.gsampler_search_grid(jw, jh, batches, budgets, nmax=NMAX,
                                   cfg=jgs.GSamplerConfig(**CFG), top_k=3,
                                   evaluator="xla")
    return a, b, c, ref


def test_gsampler_grid_is_deterministic_per_seed(searches):
    a, b, c, _ = searches
    for k in ("strategies", "latency", "peak_mem", "valid", "history"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    assert not np.array_equal(a.strategies, c.strategies)
    assert a.n_evals == 8 * 12 * (8 * (1 + 3) + 1)


def test_gsampler_grid_elites_hold_under_reference(searches):
    a, _, _, _ = searches
    jw, _, jh, _, batches, budgets = _grid()
    jwls = jcm.stack_workloads([jcm.pack_workload(w, h, NMAX)
                                for w, h in zip(jw, jh)])
    re = jcm.evaluate_grid(jwls, jnp.asarray(a.strategies),
                           jnp.asarray(batches), jnp.asarray(budgets), jh,
                           evaluator="xla")
    valid = np.asarray(re.valid)
    assert a.valid.any()
    assert (valid[a.valid]).all()
    np.testing.assert_allclose(a.latency, np.asarray(re.latency), rtol=1e-5)
    np.testing.assert_allclose(a.peak_mem, np.asarray(re.peak_mem),
                               rtol=1e-5)
    base = np.asarray(jcm.baseline_grid(jwls, jnp.asarray(batches),
                                        jh).latency)
    np.testing.assert_allclose(a.baseline_latency, base, rtol=1e-5)


def test_gsampler_grid_quality_matches_reference(searches):
    a, _, _, ref = searches
    best = np.where(a.valid, a.speedup, 0.0).max(1)
    ref_best = np.where(ref.valid, ref.speedup, 0.0).max(1)
    assert ((best > 0) == (ref_best > 0)).all()
    assert best.mean() >= _QUALITY_TOL * ref_best.mean(), (best, ref_best)
    # history: best valid speedup per generation never falls below the
    # seeds' (the elites survive)
    assert (np.diff(a.history, axis=0) >= -1e-6).all()
