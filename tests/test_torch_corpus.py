"""Port parity: the teacher corpus (prefix trace and scan, the host env
episode, the host G-Sampler, the host and grid corpus pipelines).

Tolerances: cost-model floats (latency, peak, traffic, and the states and
returns-to-go built from them) within rtol 1e-5 (the cost models agree in
f32, not bit for bit); integers (strategies, elites, ``valid``,
``n_groups``, masks, encoded actions of equal strategies) equal; the
numpy-only pieces (jitter augmentation, windows, merge, split, sample)
bit-equal.  The grid corpus draws its GA from a torch generator, so it is
held to be deterministic per seed within the port and compared with the
reference on quality (``_QUALITY_TOL``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (CPU, MB, assert_costout_close, port_workload,
                           to_np)
from repro.core import cost_model as jcm, dataset as jds, env as jenv
from repro.core import gsampler as jgs
from repro.core.accel import ACCEL_ZOO as JZOO
from repro.workloads import mobilenet_v2, resnet18, tiny_cnn
from repro_torch.core import accel as taccel, cost_model as tcm
from repro_torch.core import dataset as tds, env as tenv, gsampler as tgs

RTOL = 1e-5
# the port's grid corpus keeps at least this fraction of the reference's
# mean teacher speedup (two short GAs with different random streams)
_QUALITY_TOL = 0.9
GRID_NETS = (tiny_cnn, resnet18)
GRID_PARTS = ("edge", "datacenter")
GRID_BUDGETS = (2.0, 16.0)
GRID = dict(batch=32, max_steps=32, top_k=4, seed=0, augment_jitter=1)
GRID_GA = dict(population=12, generations=6, elite=2, repair_tries=3,
               seed=0)


def _pair(w, part="edge", batch=32, budget_mb=8.0, nmax=64):
    """The reference's and the port's FusionEnv of one condition."""
    j = jenv.FusionEnv(w, JZOO[part], batch, budget_mb * MB, nmax=nmax)
    t = tenv.FusionEnv(port_workload(w), taccel.ACCEL_ZOO[part], batch,
                       budget_mb * MB, nmax=nmax, device=CPU)
    return j, t


@pytest.mark.parametrize("net,part,serve,budget", [
    (resnet18, "edge", "mobile", 12.0), (mobilenet_v2, "nano", "nano", 1.0),
    (tiny_cnn, "datacenter", "edge", 4.0)])
def test_prefix_trace_and_scan_match_reference(net, part, serve, budget):
    w = net()
    rng = np.random.default_rng(5)
    S = np.stack([jcm.random_strategy(rng, w.n, 64, 32, p_sync=p)
                  for p in (0.0, 0.3, 0.7)])
    jwl = jcm.pack_workload(w, JZOO[part], 64)
    twl = tcm.pack_workload(port_workload(w), taccel.ACCEL_ZOO[part], 64,
                            device=CPU)
    rows = {k: v.expand(len(S), *v.shape) for k, v in twl.items()}
    thw = taccel.ACCEL_ZOO[serve]
    trace, final = tcm.prefix_scan(rows, S, [32.0] * len(S),
                                   [budget * MB] * len(S), thw)
    for r, s in enumerate(S):
        args = (32.0, budget * MB)
        jt = jcm.prefix_trace(jwl, jnp.asarray(s), *args, JZOO[serve])
        tt = tcm.prefix_trace(twl, s, *args, thw)
        assert_costout_close(tt, jt, rtol=RTOL)
        jtr, jf = jcm.prefix_scan(jwl, jnp.asarray(s), *args, JZOO[serve])
        row = lambda c: tcm.CostOut(*(x[r] for x in c))
        assert_costout_close(row(trace), jtr, rtol=RTOL)
        assert_costout_close(row(final), jf, rtol=RTOL)
        # the carry's final equals a full evaluation of the strategy
        assert_costout_close(row(final),
                             tcm.evaluate(twl, s, *args, thw), rtol=RTOL)


def test_host_env_episode_and_decorate_match_reference():
    w = resnet18()
    j, t = _pair(w, "mobile", 32, 6.0)
    rng = np.random.default_rng(11)
    s = jcm.random_strategy(rng, w.n, 64, 32, p_sync=0.3)
    np.testing.assert_allclose(t.baseline_latency, j.baseline_latency,
                               rtol=RTOL)
    np.testing.assert_allclose(t.hw_features, j.hw_features, rtol=1e-6)
    np.testing.assert_array_equal(t.shape_feats, j.shape_feats)
    np.testing.assert_allclose(j.reset(), t.reset(), rtol=RTOL, atol=1e-6)
    for a in s[: w.n + 1]:
        assert t.reward_to_go == pytest.approx(j.reward_to_go, rel=RTOL,
                                               abs=1e-6)
        js, jr, jd = j.step(int(a))
        ts, tr, td = t.step(int(a))
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=1e-6)
        assert tr == pytest.approx(jr, rel=RTOL) and td == jd
    assert jd and td
    np.testing.assert_array_equal(t.actions, j.actions)
    with pytest.raises(RuntimeError):
        t.step(1)
    jdec, tdec = j.decorate(s), t.decorate(s)
    for k in ("states", "rtg"):
        np.testing.assert_allclose(tdec[k], jdec[k], rtol=RTOL, atol=1e-6)
    for k in ("actions", "raw_actions", "length"):
        np.testing.assert_array_equal(tdec[k], jdec[k])
    sp_t, sp_j = t.speedup(s), j.speedup(s)
    np.testing.assert_allclose(sp_t[:2], sp_j[:2], rtol=RTOL)
    assert sp_t[2] == sp_j[2]


def test_host_codecs_match_reference():
    y = np.array([-0.3, 0.0, 0.0234375, 0.5078125, 1.2], np.float32)
    np.testing.assert_array_equal(tenv.decode_action(y, 64),
                                  jenv.decode_action(y, 64))
    a = np.array([-1, 1, 17, 64], np.int32)
    np.testing.assert_array_equal(tenv.encode_action(a, 64),
                                  jenv.encode_action(a, 64))
    peak = np.array([0.0, 3e6, 9e6], np.float32)
    np.testing.assert_array_equal(tenv.returns_to_go(peak, 8 * MB),
                                  jenv.returns_to_go(peak, 8 * MB))


@pytest.mark.parametrize("net,part,batch,budget", [
    (resnet18, "edge", 64, 4.0), (mobilenet_v2, "nano", 32, 1.0),
    (tiny_cnn, "laptop", 16, 8.0), (resnet18, "edge", 64, 0.01)])
def test_naive_uniform_mb_equals_reference(net, part, batch, budget):
    j, t = _pair(net(), part, batch, budget)
    np.testing.assert_array_equal(tgs.naive_uniform_mb(t),
                                  jgs.naive_uniform_mb(j))


@pytest.mark.parametrize("net,budget,seed", [
    (resnet18, 2.0, 3), (resnet18, 8.0, 3), (mobilenet_v2, 4.0, 1)])
def test_host_gsampler_equals_reference(net, budget, seed):
    j, t = _pair(net(), "edge", 32, budget)
    cfg = dict(population=10, generations=5, repair_tries=3, seed=seed)
    a = jgs.gsampler_search(j, jgs.GSamplerConfig(**cfg), top_k=4)
    b = tgs.gsampler_search(t, tgs.GSamplerConfig(**cfg), top_k=4)
    np.testing.assert_array_equal(b.strategy, a.strategy)
    assert len(b.elites) == len(a.elites)
    for x, y in zip(b.elites, a.elites):
        np.testing.assert_array_equal(x, y)
    assert b.valid == a.valid and b.n_evals == a.n_evals
    np.testing.assert_allclose(b.history, a.history, rtol=RTOL)
    np.testing.assert_allclose([b.speedup, b.latency, b.peak_mem],
                               [a.speedup, a.latency, a.peak_mem], rtol=RTOL)


def test_collect_teacher_data_matches_reference():
    kw = dict(batch=32, budgets_mb=[2.0, 8.0], max_steps=16, top_k=4,
              seed=0, augment_jitter=1)
    want = jds.collect_teacher_data(
        [tiny_cnn()], JZOO["edge"], ga_cfg=jgs.GSamplerConfig(
            population=10, generations=4, seed=0), **kw)
    got = tds.collect_teacher_data(
        [port_workload(tiny_cnn())], taccel.ACCEL_ZOO["edge"],
        ga_cfg=tgs.GSamplerConfig(population=10, generations=4, seed=0),
        device=CPU, **kw)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.actions, want.actions)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_allclose(got.states, want.states, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got.rtg, want.rtg, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got.hw, want.hw, rtol=1e-6)
    assert [m[:2] + m[3:] for m in got.meta] == \
        [m[:2] + m[3:] for m in want.meta]
    np.testing.assert_allclose([m[2] for m in got.meta],
                               [m[2] for m in want.meta], rtol=RTOL)


def _grid_conds():
    conds = [(f, p, b) for f in GRID_NETS for p in GRID_PARTS
             for b in GRID_BUDGETS]
    jw = [f() for f, _, _ in conds]
    return (conds, jw, [port_workload(w) for w in jw],
            [JZOO[p] for _, p, _ in conds],
            [taccel.ACCEL_ZOO[p] for _, p, _ in conds])


@pytest.fixture(scope="module")
def ref_grid():
    """The reference's grid elites and their jittered candidates."""
    conds, jw, _, jh, _ = _grid_conds()
    batches = np.full(len(conds), float(GRID["batch"]), np.float32)
    budgets = np.array([b * MB for _, _, b in conds], np.float32)
    wls = jcm.stack_workloads([jcm.pack_workload(w, h, GRID["max_steps"])
                               for w, h in zip(jw, jh)])
    res = jgs.gsampler_search_grid(jw, jh, batches, budgets,
                                   nmax=GRID["max_steps"],
                                   cfg=jgs.GSamplerConfig(**GRID_GA),
                                   top_k=GRID["top_k"], packed=wls,
                                   evaluator="xla")
    ns = np.array([w.n for w in jw])
    cand = jds._augment_candidates(np.random.default_rng(0), res.strategies,
                                   ns, GRID["batch"], GRID["top_k"], 2)
    return cand, batches, budgets, wls, jh


def test_decorate_grid_on_reference_elites(ref_grid):
    cand, batches, budgets, wls, jh = ref_grid
    want = jds._decorate_grid(wls, jnp.asarray(cand), jnp.asarray(batches),
                              jnp.asarray(budgets), jh)
    _, _, tw, _, th = _grid_conds()
    twls = tcm.stack_workloads([
        tcm.pack_workload(w, h, GRID["max_steps"], device=CPU)
        for w, h in zip(tw, th)])
    got = tds._decorate_grid(twls, cand, batches, budgets, th)
    for name, g, w in zip(("states", "rtg"), got[:2], want[:2]):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=RTOL,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(to_np(got[3]), np.asarray(want[3]))
    assert_costout_close(got[4], want[4], rtol=RTOL)


def test_augment_candidates_is_bit_equal(ref_grid):
    cand = ref_grid[0]
    elites = cand[:, :GRID["top_k"]]
    ns = np.array([w.n for w in _grid_conds()[1]])
    for jitter in (0, 1, 3):
        np.testing.assert_array_equal(
            tds._augment_candidates(np.random.default_rng(4), elites, ns, 32,
                                    4, jitter),
            jds._augment_candidates(np.random.default_rng(4), elites, ns, 32,
                                    4, jitter))


def _random_dataset(pkg, n=7, T=12, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.integers(3, T + 1, size=n)
    mask = (np.arange(T)[None, :] < L[:, None]).astype(np.float32)
    return pkg.TrajectoryDataset(
        rng.random((n, T), dtype=np.float32),
        rng.random((n, T, 8), dtype=np.float32),
        rng.random((n, T), dtype=np.float32), mask,
        [("net", float(i), 1.0 + i, "edge") for i in range(n)],
        hw=rng.random((n, 10), dtype=np.float32))


def _same(a, b):
    for k in ("rtg", "states", "actions", "mask", "t0"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    np.testing.assert_array_equal(a.hw_feats(), b.hw_feats())
    assert a.meta == b.meta


def test_window_merge_split_sample_are_bit_equal():
    t, j = _random_dataset(tds), _random_dataset(jds)
    for T, stride in ((5, None), (4, 3), (12, None)):
        _same(tds.window_dataset(t, T, stride), jds.window_dataset(j, T,
                                                                   stride))
    _same(tds.merge_datasets([t, _random_dataset(tds, seed=1)]),
          jds.merge_datasets([j, _random_dataset(jds, seed=1)]))
    for a, b in zip(t.split(0.3, seed=2), j.split(0.3, seed=2)):
        _same(a, b)
    got = t.sample(np.random.default_rng([0, 5]), 9)
    want = j.sample(np.random.default_rng([0, 5]), 9)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


@pytest.fixture(scope="module")
def corpora():
    _, jw, tw, _, _ = _grid_conds()
    parts = list(GRID_PARTS)
    want = jds.generate_teacher_corpus(
        jw[::len(parts) * len(GRID_BUDGETS)], [JZOO[p] for p in parts],
        budgets_mb=list(GRID_BUDGETS), ga_cfg=jgs.GSamplerConfig(**GRID_GA),
        evaluator="xla", **GRID)
    nets = tw[::len(parts) * len(GRID_BUDGETS)]
    kw = dict(budgets_mb=list(GRID_BUDGETS),
              ga_cfg=tgs.GSamplerConfig(**GRID_GA), device=CPU, **GRID)
    hws = [taccel.ACCEL_ZOO[p] for p in parts]
    a = tds.generate_teacher_corpus(nets, hws, **kw)
    b = tds.generate_teacher_corpus(nets, hws, **kw)
    return a, b, want


def test_grid_corpus_is_deterministic_per_seed(corpora):
    a, b, _ = corpora
    _same(a, b)


def test_grid_corpus_quality_holds_against_reference(corpora):
    a, _, want = corpora
    conds = lambda ds: {m[:2] + m[3:] for m in ds.meta}
    # every condition the reference labels, the port labels too
    assert conds(a) >= conds(want)
    sp = np.mean([m[2] for m in a.meta])
    sp_ref = np.mean([m[2] for m in want.meta])
    assert sp >= _QUALITY_TOL * sp_ref, (sp, sp_ref)
    assert (a.mask.sum(1) == np.array([
        {"tiny_cnn": tiny_cnn().n, "resnet18": resnet18().n}[m[0]] + 1
        for m in a.meta])).all()
    assert np.isfinite(a.states).all() and np.isfinite(a.rtg).all()


def test_grid_corpus_rejects_the_optimal_teacher():
    """Since slice 9 the grid corpus takes ``teacher="optimal"`` (held to
    the reference in ``test_torch_optimal.py``) and rejects only a teacher
    it does not know."""
    kw = dict(budgets_mb=[4.0], batch=8, max_steps=8, device=CPU)
    ds = tds.generate_teacher_corpus([port_workload(tiny_cnn())],
                                     taccel.PAPER_ACCEL, teacher="optimal",
                                     **kw)
    assert len(ds) > 0
    with pytest.raises(ValueError, match="teacher"):
        tds.generate_teacher_corpus([port_workload(tiny_cnn())],
                                    taccel.PAPER_ACCEL, teacher="dp", **kw)


def test_grid_corpus_takes_extra_elites():
    """An injected strategy rides augmentation, decoration and the validity
    filter like a teacher elite; an oversized one is skipped."""
    w = port_workload(tiny_cnn())
    extra = np.full(w.n + 1, 3, np.int32)       # uniform micro-batch 3
    kw = dict(budgets_mb=[16.0], batch=32, max_steps=16, top_k=2, seed=0,
              augment_jitter=0, device=CPU,
              ga_cfg=tgs.GSamplerConfig(population=8, generations=2))
    base = tds.generate_teacher_corpus([w], taccel.PAPER_ACCEL, **kw)
    key = (w.name, "edge", 16.0)
    got = tds.generate_teacher_corpus(
        [w], taccel.PAPER_ACCEL,
        extra_elites={key: [extra, np.ones(17, np.int32)]}, **kw)
    enc = tenv.encode_action(extra, 32)
    rows = [i for i in range(len(got))
            if np.array_equal(got.actions[i, : w.n + 1], enc)]
    assert len(got) == len(base) + 1 and len(rows) == 1
    np.testing.assert_array_equal(got.actions[:len(base)], base.actions)
