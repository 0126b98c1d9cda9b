"""Port checks: the warm-started searcher portfolio
(``repro_torch.core.portfolio``).

Mirrors ``tests/test_portfolio.py`` on the port (deterministic per seed,
valid shapes, warm start never worse than its proposal, a grid row equal
to the single-condition run with its salt, the warm seed round-trips
exactly, never below the reference's certified optimum), adds lane
independence (a lane's result does not change with the number of lanes
or with its neighbours), and holds quality against the reference: the
port's streams are numpy's, not JAX's threefry, so DE and CMA-ES are held
to a mean best speedup of at least ``_QUALITY_TOL`` of the reference's on
the same grid (as ``test_torch_gsampler.py`` holds the GA).
"""
import numpy as np
import pytest
import torch

import _adversarial as adv
from _torch_parity import CPU, MB, port_accel, port_workload
from repro.core import portfolio as jpf
from repro.core.accel import ACCEL_ZOO as JZOO
from repro.workloads import resnet18, tiny_cnn, vgg16
from repro_torch.core import accel as taccel, cost_model as tcm
from repro_torch.core.env import encode_action
from repro_torch.core.portfolio import (PortfolioConfig, _decode_grid,
                                        cmaes_search_grid, de_search_grid)

NMAX = 32
CFG = PortfolioConfig(population=16, generations=10, seed=0)
SEARCHERS = {"de": de_search_grid, "cmaes": cmaes_search_grid}
TZOO = taccel.ACCEL_ZOO
_QUALITY_TOL = 0.9


def _grid():
    wls = [port_workload(tiny_cnn()), port_workload(resnet18())]
    hws = [TZOO["edge"], TZOO["mobile"]]
    batches = np.asarray([64.0, 32.0], np.float32)
    budgets = np.asarray([4 * MB, 10 * MB], np.float32)
    return wls, hws, batches, budgets


def _proposal(wls, batches):
    out = []
    for w, b in zip(wls, batches):
        s = np.full(NMAX, tcm.SYNC, np.int32)
        s[: w.n + 1] = max(1, int(b) // 8)
        out.append(s)
    return np.stack(out)


def _run(method, *args, **kw):
    return SEARCHERS[method](*args, nmax=NMAX, cfg=kw.pop("cfg", CFG),
                             device=CPU, **kw)


@pytest.mark.parametrize("method", sorted(SEARCHERS))
def test_portfolio_deterministic(method):
    a = _run(method, *_grid())
    b = _run(method, *_grid())
    assert np.array_equal(a.strategies, b.strategies)
    assert np.array_equal(a.latency, b.latency)
    assert np.array_equal(a.history, b.history)
    c = _run(method, *_grid(), cfg=PortfolioConfig(population=16,
                                                   generations=10, seed=1))
    assert not np.array_equal(a.history, c.history)


@pytest.mark.parametrize("method", sorted(SEARCHERS))
def test_portfolio_valid_and_shapes(method):
    wls, hws, batches, budgets = _grid()
    res = _run(method, wls, hws, batches, budgets)
    C = len(batches)
    assert res.strategies.shape == (C, NMAX)
    assert res.history.shape == (CFG.generations, C)
    assert res.valid.all()
    assert (res.latency > 0).all()
    assert res.n_evals == C * CFG.population * (CFG.generations + 1) + C
    h = res.history
    assert (h[1:] <= h[:-1]).all()
    assert np.array_equal(h[-1], res.latency)
    np.testing.assert_allclose(res.speedup,
                               res.baseline_latency / res.latency, rtol=1e-6)


@pytest.mark.parametrize("method", sorted(SEARCHERS))
def test_warm_start_never_worse_than_proposal(method):
    wls, hws, batches, budgets = _grid()
    init = _proposal(wls, batches)
    res = _run(method, wls, hws, batches, budgets, init_strategies=init)
    packed = tcm.stack_workloads([tcm.pack_workload(w, h, NMAX, device=CPU)
                                  for w, h in zip(wls, hws)])
    pout = tcm.evaluate_grid(packed, init[:, None, :], batches, budgets, hws)
    for c in range(len(batches)):
        if bool(pout.valid[c, 0]):
            assert res.valid[c]
            assert res.latency[c] <= float(pout.latency[c, 0])


@pytest.mark.parametrize("method", sorted(SEARCHERS))
def test_grid_reproduces_single_condition_run(method):
    wls, hws, batches, budgets = _grid()
    for warm in (False, True):
        init = _proposal(wls, batches) if warm else None
        grid = _run(method, wls, hws, batches, budgets, init_strategies=init)
        c = 1
        single = _run(method, [wls[c]], [hws[c]], batches[c:c + 1],
                      budgets[c:c + 1], salts=[c],
                      init_strategies=None if init is None else init[c:c + 1])
        assert np.array_equal(grid.strategies[c], single.strategies[0])
        assert grid.latency[c] == single.latency[0]
        assert np.array_equal(grid.history[:, c], single.history[:, 0])


@pytest.mark.parametrize("method", sorted(SEARCHERS))
def test_lane_independent_of_count_and_neighbours(method):
    """Lane 0 (tiny_cnn on edge, salt 0) alone, beside one neighbour, and
    beside three others of other nets, parts and budgets: bit-identical."""
    wls, hws, batches, budgets = _grid()
    extra = [port_workload(vgg16()), port_workload(tiny_cnn())]
    rows = [
        ([wls[0]], [hws[0]], batches[:1], budgets[:1]),
        (wls, hws, batches, budgets),
        ([wls[0], extra[0], extra[1], wls[1]],
         [hws[0], TZOO["datacenter"], TZOO["nano"], hws[1]],
         np.asarray([64.0, 16.0, 16.0, 32.0], np.float32),
         np.asarray([4 * MB, 30 * MB, 0.5 * MB, 10 * MB], np.float32)),
    ]
    outs = []
    for w, h, b, m in rows:
        init = _proposal(w, b)
        salts = np.zeros(len(b), np.uint32)      # the engine's constant salts
        outs.append(_run(method, w, h, b, m, init_strategies=init,
                         salts=salts))
    for o in outs[1:]:
        assert np.array_equal(o.strategies[0], outs[0].strategies[0])
        assert o.latency[0] == outs[0].latency[0]
        assert o.peak_mem[0] == outs[0].peak_mem[0]
        assert np.array_equal(o.history[:, 0], outs[0].history[:, 0])


def test_warm_seed_roundtrip_exact():
    w = resnet18()
    s = np.full(NMAX, tcm.SYNC, np.int32)
    s[: w.n + 1] = [max(1, (i * 7) % 64) if i % 3 else tcm.SYNC
                    for i in range(w.n + 1)]
    s[0] = 16
    y = encode_action(s, 64)
    dec = _decode_grid(torch.as_tensor(y)[None, None, :],
                       torch.tensor([64.0]),
                       torch.as_tensor(np.arange(NMAX)[None, :] <= w.n))
    assert np.array_equal(dec[0, 0].numpy(), s)


def test_portfolio_never_below_certified_optimum():
    from repro.core import optimal as op
    checked = 0
    for name, wl, batch, budget, pack_hw, serve_hw in adv.cases():
        if name.startswith("boundary") or pack_hw is not serve_hw:
            continue
        try:
            opt = op.optimal_search(adv.packed(wl, serve_hw), batch,
                                    float(budget), serve_hw, front_cap=4096)
        except RuntimeError:
            continue
        for method in SEARCHERS:
            res = SEARCHERS[method](
                [port_workload(wl)], [port_accel(serve_hw)], [float(batch)],
                [float(budget)], nmax=adv.NMAX, cfg=CFG, device=CPU)
            if res.valid[0] and opt.valid:
                assert res.latency[0] >= opt.latency * (1 - 1e-5), name
                checked += 1
    assert checked >= 6


def _quality_grid():
    nets = [tiny_cnn(), resnet18(), vgg16()]
    parts = ["edge", "datacenter", "nano"]
    conds = [(w, p, b) for w in nets for p in parts for b in (2, 16)]
    return (conds, np.full(len(conds), 32.0, np.float32),
            np.asarray([b * MB for _, _, b in conds], np.float32))


@pytest.mark.parametrize("method", sorted(SEARCHERS))
def test_quality_matches_reference(method):
    conds, batches, budgets = _quality_grid()
    jcfg = jpf.PortfolioConfig(population=16, generations=10, seed=0)
    ref = getattr(jpf, f"{method}_search_grid")(
        [w for w, _, _ in conds], [JZOO[p] for _, p, _ in conds], batches,
        budgets, nmax=NMAX, cfg=jcfg, evaluator="xla")
    got = _run(method, [port_workload(w) for w, _, _ in conds],
               [TZOO[p] for _, p, _ in conds], batches, budgets)
    best = np.where(got.valid, got.speedup, 0.0)
    ref_best = np.where(ref.valid, ref.speedup, 0.0)
    assert ((best > 0) == (ref_best > 0)).all()
    assert best.mean() >= _QUALITY_TOL * ref_best.mean(), (best, ref_best)
