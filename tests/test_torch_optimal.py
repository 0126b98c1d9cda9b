"""Port parity: the exact optimum (``core/optimal.py``) and its f64 loop
model (``core/ref_model.py``) against the JAX reference's.

Both packages compute these in float64 numpy on the host, expression for
expression, so the loop model's outputs, the DP's optimum (strategy,
latency, peak, traffic, ``n_groups``) and its effort counters are held
bit-equal.  Certification runs through the port's ``fusion_eval`` twin (the
CPU path of the kernel).  The optimal-teacher corpus is held to the
reference's at the XLA evaluator: actions, masks and ``valid`` equal,
states and returns-to-go within rtol 1e-5 (the f32 cost models agree in
f32, not bit for bit).
"""
import numpy as np
import pytest
import torch

import _adversarial as adv
from _torch_parity import CPU, MB, port_accel, port_workload
from repro.core import cost_model as jcm, dataset as jds
from repro.core import optimal as jop, ref_model as jref
from repro.core.accel import ACCEL_ZOO as JZOO, PAPER_ACCEL as JPAPER
from repro.workloads import tiny_cnn
from repro.workloads.layer import Layer, Workload
from repro_torch.core import accel as taccel, cost_model as tcm
from repro_torch.core import dataset as tds
from repro_torch.core import env as tenv, gsampler as tgs
from repro_torch.core import optimal as top, ref_model as tref
from repro_torch.core.accel import ACCEL_ZOO as TZOO, PAPER_ACCEL as TPAPER

NMAX = adv.NMAX
ACCELS = sorted(JZOO)
_RESULT_FIELDS = ("latency", "peak_mem", "traffic", "valid", "n_groups",
                  "n_states", "n_evals")


def _chain(seed):
    """A random chain of 1-5 layers with skips (the reference's property
    test's generator), with its batch, accelerator and budget."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    layers = []
    for i in range(n):
        macs, out_e, w_e = (10.0 ** rng.uniform(2, 7),
                            10.0 ** rng.uniform(1, 4),
                            10.0 ** rng.uniform(1, 4))
        skip = int(rng.integers(-2, i + 1))
        layers.append(Layer.op(f"l{i}", macs=float(macs),
                               out_elems=float(out_e), w_elems=float(w_e),
                               shape6=(4, 4, 4, 4, 1, 1),
                               skip_src=skip if 0 <= skip < i + 1 else -1))
    wl = Workload(name=f"rand{n}", layers=layers, input_elems=64.0,
                  input_shape6=(4, 4, 4, 4, 1, 1))
    batch = int(rng.integers(2, 5))
    hw = JZOO[ACCELS[int(rng.integers(0, len(ACCELS)))]]
    return wl, batch, float(10.0 ** rng.uniform(-2, 2)) * MB, hw, hw


def _cases():
    out = [(f"random{s}",) + _chain(s) for s in range(12)]
    return out + list(adv.cases())


_CASES = _cases()


def _packed(wl, pack_hw):
    """(reference, port) packed host arrays of one workload at NMAX."""
    j = {k: np.asarray(v)
         for k, v in jcm.pack_workload(wl, pack_hw, NMAX).items()}
    t = {k: v.numpy() for k, v in tcm.pack_workload(
        port_workload(wl), port_accel(pack_hw), NMAX, device=CPU).items()}
    return j, t


def _same_result(got, want):
    np.testing.assert_array_equal(got.strategy, want.strategy)
    assert got.strategy.dtype == want.strategy.dtype
    for k in _RESULT_FIELDS:
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c[0])
def test_loop_model_bit_equal_to_reference(case):
    name, wl, batch, budget, pack_hw, serve_hw = case
    jwl, twl = _packed(wl, pack_hw)
    for k in jwl:
        np.testing.assert_array_equal(twl[k], jwl[k], err_msg=k)
    rows = {k: torch.as_tensor(v)[None] for k, v in twl.items()}
    jwl = jop.scaled_wl_np(jwl, serve_hw)
    twl = top.scaled_wl_np(twl, port_accel(serve_hw))
    for k in jwl:
        np.testing.assert_array_equal(twl[k], jwl[k], err_msg=k)
    # the oracle's bytes are the ones the port's evaluators rescale to
    A, W = tcm._scaled_AW(rows, taccel.stack_hw(port_accel(serve_hw), 1))
    np.testing.assert_array_equal(twl["A"], A[0].numpy())
    np.testing.assert_array_equal(twl["W"], W[0].numpy())
    rng = np.random.default_rng(len(name))
    for p in (0.0, 0.3, 0.7, 1.0):
        s = jcm.random_strategy(rng, wl.n, NMAX, batch, p_sync=p)
        want = jref.evaluate_ref(jwl, s, batch, budget, serve_hw)
        got = tref.evaluate_ref(twl, s, batch, budget, port_accel(serve_hw))
        for k in ("latency", "peak_mem", "traffic", "valid", "n_groups"):
            assert got[k] == want[k], (k, p)
        assert [vars(g) for g in got["groups"]] == \
            [vars(g) for g in want["groups"]]
    assert tref.baseline_ref(twl, batch, port_accel(serve_hw)) == \
        jref.baseline_ref(jwl, batch, serve_hw)


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c[0])
def test_optimal_search_bit_equal_to_reference(case):
    """Strategy, latency, peak, traffic, n_groups, validity and the DP's
    effort counters, bit for bit."""
    name, wl, batch, budget, pack_hw, serve_hw = case
    jwl, twl = _packed(wl, pack_hw)
    want = jop.optimal_search(jwl, batch, budget, serve_hw)
    got = top.optimal_search(twl, batch, budget, port_accel(serve_hw))
    _same_result(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_dp_equals_brute_force(seed):
    wl, batch, budget, hw, _ = _chain(100 + seed)
    _, twl = _packed(wl, hw)
    thw = port_accel(hw)
    dp = top.optimal_search(twl, batch, budget, thw)
    bf = top.brute_force_optimal(twl, batch, budget, thw)
    want = jop.brute_force_optimal(_packed(wl, hw)[0], batch, budget, hw)
    assert dp.valid == bf.valid == want.valid
    assert bf.latency == want.latency and bf.n_evals == want.n_evals
    if dp.valid:
        assert dp.latency == bf.latency and dp.peak_mem == bf.peak_mem


def test_budget_boundary_bit_flip():
    """At exactly the optimum's peak the DP stays feasible (<=); one ulp
    below it must change the argmin or turn invalid -- in both packages
    alike."""
    wl, hw = adv.depthwise_capped(), JZOO["edge"]
    jwl, twl = _packed(wl, hw)
    thw = port_accel(hw)
    loose = top.brute_force_optimal(twl, 8, 1e30, thw)
    at = float(loose.peak_mem)
    below = np.nextafter(at, 0.0)
    for budget in (at, below):
        got = top.optimal_search(twl, 8, budget, thw)
        _same_result(got, jop.optimal_search(jwl, 8, budget, hw))
        bf = top.brute_force_optimal(twl, 8, budget, thw)
        assert got.valid == bf.valid
        if got.valid:
            assert got.latency == bf.latency
    assert top.optimal_search(twl, 8, at, thw).latency == loose.latency
    lo = top.optimal_search(twl, 8, below, thw)
    assert (not lo.valid) or lo.peak_mem <= below


def test_optimal_mapping_certifies_through_the_twin():
    """One evaluate_population call (the fusion_eval twin on the CPU) of
    every candidate cut, padded to nmax rows; the certified CostOut is the
    f32 score of the DP's strategy, and the optimum is the reference's."""
    env = tenv.FusionEnv(port_workload(tiny_cnn()), TZOO["edge"], 8, 4 * MB,
                         nmax=16, device=CPU)
    calls = []
    real = tcm.evaluate_population

    def spy(wl, pop, *a):
        calls.append(tuple(pop.shape))
        return real(wl, pop, *a)

    tcm.evaluate_population = spy
    try:
        res = top.optimal_mapping(env)
    finally:
        tcm.evaluate_population = real
    assert calls == [(16, 16)]
    assert res.valid and res.certified is not None
    np.testing.assert_allclose(float(res.certified.latency), res.latency,
                               rtol=1e-5)
    assert bool(res.certified.valid)
    out = env.evaluate_strategy(res.strategy)
    assert float(out.latency) == float(res.certified.latency)
    jwl = {k: np.asarray(v)
           for k, v in jcm.pack_workload(tiny_cnn(), JZOO["edge"], 16).items()}
    want = jop.optimal_search(jwl, 8, 4 * MB, JZOO["edge"])
    np.testing.assert_array_equal(res.strategy, want.strategy)
    assert res.latency == want.latency
    assert res.n_evals > want.n_evals      # + one per certified cut


def test_optimal_grid_matches_reference_and_per_condition_search():
    wls = [tiny_cnn(), adv.mixed_magnitude()]
    hws = [JZOO["edge"], JZOO["datacenter"]]
    args = ([8, 16], [4 * MB, 24 * MB])
    want = jop.optimal_grid(wls, hws, *args, nmax=16)
    got = top.optimal_grid([port_workload(w) for w in wls],
                           [port_accel(h) for h in hws], *args, nmax=16,
                           device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.strategy, w.strategy)
        assert (g.latency, g.valid, g.n_groups) == \
            (w.latency, w.valid, w.n_groups)
        np.testing.assert_allclose(float(g.certified.latency),
                                   float(w.certified.latency), rtol=1e-5)
        assert bool(g.certified.valid) == bool(w.certified.valid)


def test_front_cap_raises_rather_than_approximates():
    twl = {k: v.numpy() for k, v in tcm.pack_workload(
        port_workload(tiny_cnn()), TPAPER, 16, device=CPU).items()}
    with pytest.raises(RuntimeError, match="front"):
        top.optimal_search(twl, 64, 16 * MB, TPAPER, front_cap=1)


def test_enumerate_strategies_counts_and_limit():
    pop = top.enumerate_strategies(2, 3, NMAX)
    np.testing.assert_array_equal(pop, jop.enumerate_strategies(2, 3, NMAX))
    assert pop.shape == ((3 + 1) ** 2, NMAX)
    assert len({row.tobytes() for row in pop}) == len(pop)
    np.testing.assert_array_equal(
        top.enumerate_strategies(3, 8, NMAX, mb_values=(1, 4, 8)),
        jop.enumerate_strategies(3, 8, NMAX, mb_values=(1, 4, 8)))
    with pytest.raises(ValueError):
        top.enumerate_strategies(8, 64, NMAX, limit=1000)


def test_optimal_teacher_corpus_matches_reference():
    """teacher="optimal": the DP optimum replaces the GA elites and rides the
    same jitter, decoration and validity filter."""
    kw = dict(batch=8, budgets_mb=[2.0, 6.0], max_steps=12, top_k=4,
              seed=3, augment_jitter=1, teacher="optimal")
    want = jds.generate_teacher_corpus([tiny_cnn()], [JPAPER, JZOO["nano"]],
                                       evaluator="xla", **kw)
    got = tds.generate_teacher_corpus([port_workload(tiny_cnn())],
                                      [TPAPER, TZOO["nano"]], device=CPU,
                                      **kw)
    again = tds.generate_teacher_corpus([port_workload(tiny_cnn())],
                                        [TPAPER, TZOO["nano"]], device=CPU,
                                        **kw)
    assert len(got) == len(want) > 0
    for k in ("actions", "mask", "t0"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    for k in ("states", "rtg", "hw"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(getattr(got, k), getattr(again, k))
    assert [m[:2] + m[3:] for m in got.meta] == \
        [m[:2] + m[3:] for m in want.meta]
    np.testing.assert_allclose([m[2] for m in got.meta],
                               [m[2] for m in want.meta], rtol=1e-5)
    # the best row of each condition is the DP optimum
    for acc in (TPAPER, TZOO["nano"]):
        for b in kw["budgets_mb"]:
            env = tenv.FusionEnv(port_workload(tiny_cnn()), acc, 8, b * MB,
                                 nmax=12, device=CPU)
            opt = top.optimal_mapping(env, certify=False)
            best = max(m[2] for m in got.meta
                       if m[1] == b and m[3] == acc.name)
            assert best == pytest.approx(env.baseline_latency / opt.latency,
                                         rel=1e-5)


def test_gsampler_never_beats_the_optimum():
    env = tenv.FusionEnv(port_workload(tiny_cnn()), TZOO["edge"], 8, 4 * MB,
                         nmax=16, device=CPU)
    opt = top.optimal_mapping(env)
    gs = tgs.gsampler_search(env, tgs.GSamplerConfig(generations=8,
                                                     population=64, seed=0))
    assert gs.valid and opt.latency <= float(gs.latency) * (1 + 1e-5)
