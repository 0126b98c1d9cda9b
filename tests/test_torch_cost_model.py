"""Port parity: conditions and the cost model against the JAX reference.

The reference runs through its XLA evaluator (``evaluator="xla"``, via
``kernels/ref.fusion_eval_grid_ref``) and the f64 loop model
``core/ref_model.evaluate_ref``; the port runs its plain PyTorch twin of
the ``fusion_eval`` kernel on the CPU.  Tolerances: integer outputs
(``gid`` under the mask, ``valid``, ``n_groups``) equal; latency, peak,
traffic and ``M_g`` within rtol 1e-5 of XLA; latency, peak and traffic
within 1e-5 (relative, floor 1) of the f64 model, as tests/test_kernels.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _adversarial import cases as adversarial_cases, packed as adv_packed
from _torch_parity import (CPU, MB, assert_costout_close, port_accel,
                           port_workload, to_np)
from repro.core import cost_model as jcm
from repro.core import ref_model
from repro.core.accel import ACCEL_ZOO as JZOO, accel_features as j_feats
from repro.kernels import ref as jref
from repro.workloads import CNN_ZOO as JCNN, resnet18, tiny_cnn, vgg16
from repro_torch.core import accel as taccel, cost_model as tcm
from repro_torch.runtime import obs
from repro_torch.workloads import CNN_ZOO as TCNN


@pytest.mark.parametrize("name", sorted(JCNN))
def test_workload_arrays_equal(name):
    want = JCNN[name]().arrays(64, bytes_per_elem=2.0)
    got = TCNN[name]().arrays(64, bytes_per_elem=2.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("part", sorted(JZOO))
def test_accel_features_equal(part):
    """Raw hw vector and normalized features equal; the features invert."""
    ta = taccel.ACCEL_ZOO[part]
    assert ta == port_accel(JZOO[part])
    got = to_np(taccel.accel_features(ta))
    np.testing.assert_array_equal(got, np.asarray(j_feats(JZOO[part])))
    back = taccel.accel_from_features(got, name=part)
    assert back.npe == ta.npe and back.pe_lanes == ta.pe_lanes
    np.testing.assert_allclose(taccel.hw_array(back).numpy(),
                               taccel.hw_array(ta).numpy(), rtol=1e-5)


def _grid_inputs(seed, wl_fns, pack_parts, serve_parts, budgets_mb, pop,
                 nmax=64):
    rng = np.random.default_rng(seed)
    jw = [f() for f in wl_fns]
    strats = np.stack([
        np.stack([jcm.random_strategy(rng, w.n, nmax, 32, p_sync=0.35)
                  for _ in range(pop)]) for w in jw])
    batches = np.full(len(jw), 32.0, np.float32)
    budgets = np.asarray(budgets_mb, np.float32) * MB
    jwls = jcm.stack_workloads([jcm.pack_workload(w, JZOO[a], nmax)
                                for w, a in zip(jw, pack_parts)])
    twls = tcm.stack_workloads([
        tcm.pack_workload(port_workload(w), taccel.ACCEL_ZOO[a], nmax,
                          device=CPU) for w, a in zip(jw, pack_parts)])
    jhw = [JZOO[a] for a in serve_parts]
    thw = [taccel.ACCEL_ZOO[a] for a in serve_parts]
    return jw, strats, batches, budgets, jwls, twls, jhw, thw


def _assert_grid_stats_match(got, want, mask):
    (gout, ggid, gM), (wout, wgid, wM) = got, want
    assert_costout_close(gout, wout)
    m = np.broadcast_to(to_np(mask)[:, None, :], to_np(ggid).shape)
    np.testing.assert_array_equal(to_np(ggid)[m], np.asarray(wgid)[m])
    np.testing.assert_allclose(to_np(gM), np.asarray(wM), rtol=1e-5, atol=0)


def test_evaluate_grid_stats_matches_xla_heterogeneous():
    """Heterogeneous workloads x parts x budgets, a non-power-of-two
    population, pack/serve BPE mismatch (edge packing on datacenter)."""
    jw, strats, batches, budgets, jwls, twls, jhw, thw = _grid_inputs(
        0, [resnet18, vgg16, tiny_cnn, resnet18],
        ["edge", "datacenter", "nano", "edge"],
        ["datacenter", "edge", "mobile", "laptop"], [20, 64, 2, 8], pop=13)
    want = jref.fusion_eval_grid_ref(jwls, strats, batches, budgets, jhw)
    got = tcm.evaluate_grid_stats(twls, torch.as_tensor(strats), batches,
                                  budgets, thw)
    _assert_grid_stats_match(got, want, twls["mask"])


@pytest.mark.parametrize("case", adversarial_cases(), ids=lambda c: c[0])
def test_adversarial_cases_match_xla_and_ref_model(case):
    name, wl, batch, budget, pack_hw, serve_hw = case
    nmax = 8
    rng = np.random.default_rng(3)
    strats = np.stack([jcm.random_strategy(rng, wl.n, nmax, batch,
                                           p_sync=p)
                       for p in (0.0, 0.2, 0.5, 1.0) for _ in range(4)])
    jwl = jcm.pack_workload(wl, pack_hw, nmax)
    twl = tcm.pack_workload(port_workload(wl), port_accel(pack_hw), nmax,
                            device=CPU)
    want = jcm.evaluate_population_stats(
        jwl, jnp.asarray(strats), float(batch), float(budget), serve_hw,
        evaluator="xla")
    got = tcm.evaluate_population_stats(twl, strats, float(batch),
                                        float(budget), port_accel(serve_hw))
    assert_costout_close(got[0], want[0])
    m = np.broadcast_to(to_np(twl["mask"]), strats.shape)
    np.testing.assert_array_equal(to_np(got[1])[m], np.asarray(want[1])[m])
    np.testing.assert_allclose(to_np(got[2]), np.asarray(want[2]), rtol=1e-5)
    # the f64 loop model, with the workload packed at the serving datatype
    wl_serve = adv_packed(wl, serve_hw)
    for i, s in enumerate(strats):
        ref = ref_model.evaluate_ref(wl_serve, s, batch, budget, serve_hw)
        for k in ("latency", "peak_mem", "traffic"):
            a = float(to_np(getattr(got[0], k))[i])
            assert abs(a - ref[k]) <= 1e-5 * max(abs(ref[k]), 1.0), \
                (name, i, k, a, ref[k])
        assert int(to_np(got[0].n_groups)[i]) == ref["n_groups"]


@pytest.mark.parametrize("part", sorted(JZOO))
def test_zoo_parts_match_ref_model(part):
    """Every zoo part serving an edge packing (BPE rescale on datacenter)
    against the f64 loop model packed directly at the part's datatype."""
    w = resnet18()
    rng = np.random.default_rng(5)
    strats = np.stack([jcm.random_strategy(rng, w.n, 64, 32, p_sync=0.3)
                       for _ in range(24)])
    twl = tcm.pack_workload(port_workload(w), taccel.ACCEL_ZOO["edge"], 64,
                            device=CPU)
    got = tcm.evaluate_population(twl, strats, 32.0, 20 * MB,
                                  taccel.ACCEL_ZOO[part])
    wl_serve = {k: np.asarray(v) for k, v in
                jcm.pack_workload(w, JZOO[part], 64).items()}
    for i, s in enumerate(strats):
        ref = ref_model.evaluate_ref(wl_serve, s, 32, 20 * MB, JZOO[part])
        for k in ("latency", "peak_mem", "traffic"):
            a = float(to_np(getattr(got, k))[i])
            assert abs(a - ref[k]) <= 1e-5 * max(abs(ref[k]), 1.0), \
                (part, i, k, a, ref[k])
        assert bool(to_np(got.valid)[i]) == ref["valid"]
        assert int(to_np(got.n_groups)[i]) == ref["n_groups"]


def test_baseline_grid_matches_xla():
    jw, strats, batches, budgets, jwls, twls, jhw, thw = _grid_inputs(
        1, [resnet18, vgg16, tiny_cnn], ["edge", "datacenter", "edge"],
        ["datacenter", "edge", "nano"], [8, 8, 8], pop=2)
    want = jcm.baseline_grid(jwls, jnp.asarray(batches), jhw)
    got = tcm.baseline_grid(twls, batches, thw)
    assert_costout_close(got, want)
    one = tcm.baseline_no_fusion(
        tcm.pack_workload(port_workload(jw[0]), taccel.ACCEL_ZOO["edge"],
                          64, device=CPU), 32.0, thw[0])
    np.testing.assert_allclose(float(one.latency), float(got.latency[0]),
                               rtol=1e-6)


def _rows(w, part, nmax, R):
    wl = tcm.pack_workload(port_workload(w), taccel.ACCEL_ZOO[part], nmax,
                           device=CPU)
    return {k: v.expand(R, *v.shape) for k, v in wl.items()}, wl


@pytest.mark.parametrize("wl_fn", [vgg16, resnet18, tiny_cnn])
def test_prefix_carry_equals_evaluate(wl_fn):
    """``prefix_out`` after n+1 ``prefix_step``s equals ``evaluate``, for a
    batch of rows moving in lockstep (tests/test_infer_fused.py:33)."""
    w = wl_fn()
    R = 8
    rows, wl = _rows(w, "edge", 64, R)
    hw = taccel.stack_hw(taccel.ACCEL_ZOO["mobile"], R)
    rng = np.random.default_rng(0)
    strats = np.stack([jcm.random_strategy(rng, w.n, 64, 64, p_sync=0.35)
                       for _ in range(R)])
    B = torch.full((R,), 64.0)
    budget = torch.full((R,), 20 * MB)
    consts = tcm.prefix_consts(rows, B, budget, hw)
    carry = tcm.prefix_init(consts)
    for t in range(w.n + 1):
        carry = tcm.prefix_step(consts, carry, torch.as_tensor(strats[:, t]),
                                hw)
    fin = tcm.prefix_out(consts, carry, hw)
    full = tcm.evaluate_population(wl, strats, 64.0, 20 * MB, hw[0])
    assert_costout_close(fin, full)


def test_prefix_probe_peak_matches_composed_probe():
    """tests/test_infer_fused.py:54, batched over the probed actions."""
    w = resnet18()
    acts = torch.tensor([1, 5, 32, 64])
    R = len(acts)
    rows, _ = _rows(w, "edge", 64, R)
    hw = taccel.stack_hw(taccel.ACCEL_ZOO["edge"], R)
    consts = tcm.prefix_consts(rows, torch.full((R,), 64.0),
                               torch.full((R,), 20 * MB), hw)
    carry = tcm.prefix_init(consts)
    rng = np.random.default_rng(1)
    s = jcm.random_strategy(rng, w.n, 64, 64)
    for t in range(w.n + 1):
        ref = tcm.prefix_out(consts, tcm.prefix_step(consts, carry, acts, hw),
                             hw).peak_mem
        fast = tcm.prefix_probe_peak(consts, carry, acts, hw)
        assert torch.equal(ref, fast), t
        carry = tcm.prefix_step(consts, carry,
                                torch.full((R,), int(s[t])), hw)


def test_fixed_sum_sums_each_row_in_one_order():
    """``fixed_sum`` is a sum (to f32 rounding), and a row's sum is the same
    bits alone, in a stack of rows, and along another axis."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((7, 37)).astype(np.float32))
    full = tcm.fixed_sum(x)
    np.testing.assert_allclose(full.numpy(), x.double().sum(-1).numpy(),
                               rtol=1e-5, atol=1e-5)
    for i in range(7):
        assert torch.equal(tcm.fixed_sum(x[i:i + 1])[0], full[i])
    assert torch.equal(tcm.fixed_sum(x.T.contiguous(), dim=0), full)
    assert torch.equal(tcm.fixed_sum(x[:, :1]), x[:, 0])


# -- the front door's stacks: a round's rows built from its distinct rows --
def _parts_of(C, seed=0):
    rng = np.random.default_rng(seed)
    parts = [taccel.ACCEL_ZOO[p] for p in sorted(taccel.ACCEL_ZOO)]
    return [parts[i] for i in rng.integers(0, len(parts), C)]


def _traced_count(name, fn):
    """``fn()`` with tracing on, and what it added to counter ``name``."""
    before = obs.counters(traced=True).get(name, 0)
    obs.enable()
    try:
        out = fn()
    finally:
        obs.disable()
    return out, obs.counters(traced=True).get(name, 0) - before


def test_stack_hw_of_repeated_parts_equals_the_rows_stacked():
    """3840 conditions over the 5 parts: the same tensor as a row a
    condition, each distinct part converted once."""
    hws = _parts_of(3840)
    got, n = _traced_count("stack_hw.distinct",
                           lambda: taccel.stack_hw(hws, 3840))
    want = torch.stack([taccel.hw_array(h) for h in hws]).contiguous()
    assert torch.equal(got, want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous()
    assert n == 5
    # distinct by identity: an equal copy is converted on its own
    twin = dataclasses.replace(hws[0])
    got, n = _traced_count("stack_hw.distinct",
                           lambda: taccel.stack_hw(hws[:3] + [twin], 4))
    assert torch.equal(got, want[[0, 1, 2, 0]]) and n == len(
        {id(h) for h in hws[:3]}) + 1


def test_stack_hw_of_mixed_rows_and_wrong_length():
    hws = _parts_of(6, seed=1)
    mixed = [h if i % 2 else taccel.hw_array(h).numpy()
             for i, h in enumerate(hws)]
    want = torch.stack([taccel.hw_array(h) for h in hws]).contiguous()
    got = taccel.stack_hw(mixed, 6)
    assert torch.equal(got, want) and got.is_contiguous()
    for hw in (hws, mixed):
        with pytest.raises(ValueError, match="accelerators for"):
            taccel.stack_hw(hw, 5)


def _packs(parts, nmax=64):
    return [tcm.pack_workload(TCNN[n](), taccel.ACCEL_ZOO[p], nmax,
                              device=CPU)
            for n in sorted(TCNN) for p in parts]


@pytest.mark.parametrize("distinct,C", [(30, 3840), (1, 64), (30, 30)],
                         ids=["30_of_3840", "1_of_64", "all_distinct"])
def test_stack_workloads_gathers_repeated_dicts(distinct, C):
    """Key by key the plain per-key stack, bit for bit, in dtype, shape,
    contiguity and device; the dicts stacked are counted once each; the
    live positions still sum over every row."""
    packs = _packs(sorted(taccel.ACCEL_ZOO))[:distinct]
    assert len(packs) == distinct
    rng = np.random.default_rng(C)
    pick = rng.permutation(C) % distinct if C > distinct else range(C)
    wls = [packs[i] for i in pick]
    got, n = _traced_count("stack_workloads.distinct",
                           lambda: tcm.stack_workloads(wls))
    assert n == distinct
    want = {k: torch.stack([w[k] for w in wls]) for k in wls[0]}
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert torch.equal(g, w), k
        assert (g.dtype, g.shape, g.device) == (w.dtype, w.shape, w.device)
        assert g.is_contiguous(), k
    assert tcm.live_positions(got) == sum(tcm.live_positions(w)
                                          for w in wls)


@pytest.mark.parametrize("repeat", [False, True])
def test_stack_workloads_refuses_mixed_nmax(repeat):
    a, b = (tcm.pack_workload(TCNN["tiny_cnn"](), taccel.PAPER_ACCEL, nmax,
                              device=CPU) for nmax in (64, 32))
    wls = [a, b, a, b] if repeat else [a, b]
    with pytest.raises(ValueError, match="different nmax"):
        tcm.stack_workloads(wls)
