"""Port parity: the serving stack (``repro_torch.serving``).

Mirrors ``tests/test_serving.py``, ``test_scheduler.py`` and
``test_drift.py``:

- the pure-Python modules (bucketing, config, the strategy cache, drift)
  give the reference's outputs bit for bit on the same calls;
- the port's engine against the reference engine on the same weights (the
  reference's checkpoint read by the port): trimmed strategies, ``valid``
  and ``cached`` equal; latency, peak and speedup within rtol 1e-5 (the
  cost models agree in f32, not bitwise); every counter equal;
- the determinism contract inside the port: a request served alone, in a
  tick, and in permuted streams through the scheduler gives bit-identical
  responses in all five fields (the reference's own test of this is red
  on one f32 ulp of ``speedup``, so it is not this test's oracle);
- signatures after warmup, cache persistence, hot swap, ``upgrade_pytree``
  and the refresh loop's mechanics (not the reference's quality test);
- the batched episode at the smoke grid's shape against the reference.
"""
import copy
import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, MB, port_workload, to_np
from repro.checkpoint import save_pytree
from repro.core import cost_model as jcm, infer as jinf, model as jm
from repro.core.accel import ACCEL_ZOO as JZOO
from repro.serving import bucketing as jbk, cache as jcache, config as jconf
from repro.serving import drift as jdrift, engine as jeng
from repro.workloads import CNN_ZOO as JCNN, resnet18, tiny_cnn, vgg16
import repro_torch
from repro_torch import serving as ts
from repro_torch.checkpoint import (Checkpointer, dt_params_from_reference,
                                    load_reference, upgrade_pytree)
from repro_torch.core import accel as taccel, cost_model as tcm
from repro_torch.core import dataset as tds, gsampler as tgs
from repro_torch.core import infer as tinf, model as tm, train as ttrain
from repro_torch.serving import (bucketing as tbk, cache as tcache,
                                 config as tconf, drift as tdrift,
                                 engine as teng, refresh as trefresh)

PARTS = sorted(JZOO)
JNETS = {w.name: w for w in (vgg16(), resnet18(), tiny_cnn())}
TNETS = {k: port_workload(w) for k, w in JNETS.items()}
TZOO = taccel.ACCEL_ZOO


def _ref_weights(tmp_path_factory, seed, **kw):
    jcfg = jm.DTConfig(**kw)
    params = jm.dt_init(jax.random.PRNGKey(seed), jcfg)
    path = tmp_path_factory.mktemp("dt") / "ckpt"
    save_pytree(params, path)
    return jcfg, params, dt_params_from_reference(load_reference(path),
                                                  device=CPU)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A DT of the reference's serving tests (max_steps 20), hw-aware."""
    return _ref_weights(tmp_path_factory, 2, max_steps=20, hw_dim=10)


@pytest.fixture(scope="module")
def weights2(tmp_path_factory):
    return _ref_weights(tmp_path_factory, 9, max_steps=20, hw_dim=10)


def _req(pkg, net, batch, budget_mb, part):
    if pkg == "ref":
        return jeng.MapRequest(JNETS[net], batch, budget_mb * MB, JZOO[part])
    return ts.MapRequest(TNETS[net], batch, budget_mb * MB, TZOO[part])


def _engine(model, **kw):
    return ts.MapperEngine(model, device=CPU, **kw)


def _same(a, b):
    """All five fields bit for bit (and the two flags)."""
    assert np.array_equal(a.strategy, b.strategy)
    assert (a.latency, a.peak_mem, a.speedup, a.valid) == \
        (b.latency, b.peak_mem, b.speedup, b.valid)


# --- pure-Python modules against the reference -------------------------------

def test_bucketing_matches_reference():
    for c in range(1, 40):
        assert tbk.batch_bucket(c) == jbk.batch_bucket(c)
        assert tbk.pow2_buckets(c) == jbk.pow2_buckets(c)
        for cap in (1, 3, 7, 8, 16):
            assert tbk.pow2_chunks(c, cap) == jbk.pow2_chunks(c, cap)
    for ms in (8, 9, 20, 32, 64, 100):
        assert tbk.default_nmax_buckets(ms) == jbk.default_nmax_buckets(ms)
    for n in range(1, 21):
        assert tbk.nmax_bucket(n, (8, 16, 20)) == \
            jbk.nmax_bucket(n, (8, 16, 20))
    for b in (1.0, 1000.0, 20 * MB, 20 * MB + 1000, 63.9 * MB):
        for q in (MB, 64 * MB):
            assert tbk.budget_bucket(b, q) == jbk.budget_bucket(b, q)
    key = lambda x: x % 3
    assert tbk.coalesce(range(10), key) == jbk.coalesce(range(10), key)
    for mod in (tbk, jbk):
        with pytest.raises(ValueError):
            mod.nmax_bucket(21, (8, 16, 20))
        with pytest.raises(ValueError):
            mod.batch_bucket(0)
        with pytest.raises(ValueError):
            mod.pow2_chunks(0, 8)
        with pytest.raises(ValueError):
            mod.budget_bucket(0.0)


def _warned(mod, kwargs):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cfg = mod.config_from_kwargs("MapperEngine", mod._ENGINE_FIELDS,
                                     kwargs)
    # the kwarg each warning names: "Owner(..., <kwarg>=...) is ..."
    return cfg, [str(r.message).split(", ")[1].split("=")[0] for r in rec
                 if issubclass(r.category, DeprecationWarning)]


def test_config_matches_reference():
    ref = dataclasses.asdict(jconf.ServingConfig())
    got = dataclasses.asdict(tconf.ServingConfig())
    assert got == ref
    assert dataclasses.asdict(tconf.DriftConfig()) == \
        dataclasses.asdict(jconf.DriftConfig())
    assert tconf._ENGINE_FIELDS == jconf._ENGINE_FIELDS
    assert tconf._SCHEDULER_FIELDS == jconf._SCHEDULER_FIELDS
    # the deprecation shim: once per kwarg per process, none for the
    # post-config kwargs, identical configs
    for mod in (tconf, jconf):
        mod._reset_deprecation_warnings()
    calls = [{"max_coalesce": 8, "approx_budget_sharing": True},
             {"max_coalesce": 8}, {"polish": True, "escalate": True},
             {"cache_path": None, "max_coalesce": 4}]
    for kw in calls:
        tcfg, tw = _warned(tconf, kw)
        jcfg, jw = _warned(jconf, kw)
        assert tw == jw
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    # the rejections
    for mod in (tconf, jconf):
        with pytest.raises(TypeError, match="bogus"):
            mod.config_from_kwargs("MapperEngine", mod._ENGINE_FIELDS,
                                   {"bogus": 1})
        with pytest.raises(TypeError, match="flush_ms"):
            mod.config_from_kwargs("MapperEngine", mod._ENGINE_FIELDS,
                                   {"flush_ms": 2.0})
    # replicas: accepted by the reference, refused by the port (one card)
    assert jconf.ServingConfig(replicas=2).replicas == 2
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 8"):
        tconf.ServingConfig(replicas=2)


def test_accel_key_matches_reference():
    for p in PARTS:
        assert teng._accel_key(TZOO[p]) == jeng._accel_key(JZOO[p])
    odd = taccel.AccelConfig(name="odd", npe=3000, freq_hz=1.3e9,
                             bytes_per_elem=2.0)
    jodd = type(JZOO["edge"])(**dataclasses.asdict(odd))
    assert teng._accel_key(odd) == jeng._accel_key(jodd)


def _cache_ops(mod, key_fn):
    c = mod.StrategyCache(capacity=3, context={"checkpoint": "x"})
    log = [c.get(key_fn(0)), c.misses]
    for i in range(5):
        c.put(key_fn(i), (np.arange(i + 1, dtype=np.int32), 0.5 + i,
                          1e6 * i, 1.25 * i))
        log.append(len(c))
    for i in (0, 3, 4, 3, 1):
        v = c.get(key_fn(i))
        log.append(None if v is None else (v[0].tolist(), *v[1:]))
    log += [c.hits, c.misses, c.hit_rate, key_fn(2) in c]
    log.append(c.invalidate(lambda k: k[1] == 4))
    log.append(sorted(c.snapshot()))
    return c, log


def test_strategy_cache_matches_reference(tmp_path):
    key = lambda i: (f"net{i % 2}", 4 * i, float(i) * MB,
                     (0.1 * i, 0.25, 1.0))
    tc, tlog = _cache_ops(tcache, key)
    jc, jlog = _cache_ops(jcache, key)
    assert tlog == jlog
    assert tcache.CACHE_FORMAT == jcache.CACHE_FORMAT
    # the files: same payload, and each package loads the other's
    assert tc.save(tmp_path / "t.json") == jc.save(tmp_path / "j.json")
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    for mod, path in ((tcache, "j.json"), (jcache, "t.json")):
        fresh = mod.StrategyCache(8, context={"checkpoint": "x"})
        assert fresh.load(tmp_path / path) == len(tc.snapshot())
        other = mod.StrategyCache(8, context={"checkpoint": "y"})
        assert other.load(tmp_path / path) == 0 and other.stale_skipped == 1


def _records(mod, nets, zoo):
    """A stream: two clean windows, then one on an unseen part, then a
    hit-rate decay window, then a violation window."""
    R = mod.ReplayRecord
    tiny, vgg = nets["tiny_cnn"], nets["vgg16"]
    recs = [R(tiny, 32, 8.0 * MB, zoo["edge"], True, True, 1.5)] * 8
    recs += [R(tiny, 64, (40.0 + i) * MB, zoo["datacenter"], True, False,
               2.0) for i in range(3)]
    recs += [R(vgg, 64, 40.0 * MB, zoo["datacenter"], True, False, 2.5)]
    recs += [R(tiny, 32, 8.0 * MB, zoo["edge"], True, False, 1.5)] * 4
    recs += [R(tiny, 32, 8.0 * MB, zoo["edge"], False, True, 1.5)] * 4
    return recs


def _drift_log(mod, nets, zoo, **kw):
    mon = mod.DriftMonitor(mod.DriftConfig(window=4, replay_capacity=6),
                           **kw)
    log = []
    for rec in _records(mod, nets, zoo):
        rep = mon.observe(rec)
        log.append(None if rep is None else (
            rep.triggers, rep.window_index, rep.unseen_accel_rate,
            rep.unseen_workload_rate, rep.hit_rate, rep.baseline_hit_rate,
            rep.violation_rate, [a.name for a in rep.accels],
            [w.name for w in rep.workloads], rep.budgets_mb,
            rep.region_capped))
    log.append(len(mon.pop_reports()))
    log.append(mon.stats())
    log.append([r.budget_bytes for r in mon.replay.recent(3)])
    return log


def test_drift_matches_reference():
    for kw in ({"known_accels": ("edge",), "known_workloads": ("tiny_cnn",)},
               {}):                              # declared / self-calibrated
        tlog = _drift_log(tdrift, TNETS, TZOO, **kw)
        jlog = _drift_log(jdrift, JNETS, JZOO, **kw)
        assert tlog == jlog
        assert any(e is not None and not isinstance(e, (int, dict, list))
                   for e in tlog)                # something fired
    keys = [(n, 64, 1.0, teng._accel_key(TZOO[p]))
            for n in TNETS for p in PARTS]
    tp = tdrift.region_key_predicate([TNETS["resnet18"]],
                                     [TZOO["datacenter"]], teng._accel_key)
    jp = jdrift.region_key_predicate([JNETS["resnet18"]],
                                     [JZOO["datacenter"]], jeng._accel_key)
    assert [tp(k) for k in keys] == [jp(k) for k in keys]
    assert sum(tp(k) for k in keys) == len(PARTS) + len(TNETS) - 1


# --- the engine against the reference engine ---------------------------------

TICKS = [
    # (net, batch, budget MB, part): in-tick duplicates, every part
    [("vgg16", 64, 20, "edge"), ("resnet18", 32, 14, "mobile"),
     ("tiny_cnn", 64, 3, "edge"), ("vgg16", 16, 9, "laptop"),
     ("resnet18", 32, 14, "mobile"), ("vgg16", 64, 6, "datacenter")],
    # repeats (cache hits), new conditions, a nano part
    [("vgg16", 64, 20, "edge"), ("resnet18", 64, 30, "nano"),
     ("tiny_cnn", 16, 2, "nano"), ("tiny_cnn", 32, 5, "datacenter"),
     ("vgg16", 32, 12, "mobile"), ("resnet18", 16, 7, "datacenter"),
     ("tiny_cnn", 64, 3, "edge"), ("vgg16", 64, 1, "nano")],
]


def test_engine_matches_reference_engine(weights):
    jcfg, params, model = weights
    ref = jeng.MapperEngine(params, jcfg)
    eng = _engine(model)
    for tick in TICKS:
        want = ref.serve([_req("ref", *c) for c in tick])
        got = eng.serve([_req("port", *c) for c in tick])
        for g, w in zip(got, want):
            assert g.workload == w.workload
            np.testing.assert_array_equal(g.strategy, w.strategy)
            assert (g.valid, g.cached) == (w.valid, w.cached)
            np.testing.assert_allclose(
                [g.latency, g.peak_mem, g.speedup],
                [w.latency, w.peak_mem, w.speedup], rtol=1e-5)
    ts_, rs = eng.stats(), ref.stats()
    assert set(ts_) == set(rs)
    assert set(ts_["strategy_cache"]) == set(rs["strategy_cache"])
    assert set(ts_["drift"]) == set(rs["drift"])
    for k in ("requests_served", "device_calls", "compile_count",
              "compiled_shapes", "chunk_cap", "rows_padded", "tick_dedup",
              "coalesce_width_hist", "packed_workloads", "strategy_hits",
              "strategy_misses", "strategy_hit_rate", "replicas"):
        assert ts_[k] == rs[k], k
    assert ts_["cost_evaluator"] == "fusion_eval_plain"
    assert ts_["tick_dedup"] == 1 and ts_["strategy_hits"] == 2


def test_reference_cache_file_loads_in_port(weights, tmp_path):
    """A file the reference writes under a checkpoint id loads in the port
    under the same id, and answers the same requests from cache."""
    jcfg, params, model = weights
    ref = jeng.MapperEngine(params, jcfg, checkpoint_id="fixed")
    tick = TICKS[0]
    want = ref.serve([_req("ref", *c) for c in tick])
    path = tmp_path / "strategies.json"
    ref.save_cache(path)
    eng = _engine(model, checkpoint_id="fixed", cache_path=path)
    assert eng.strategies.loads == len(ref.strategies.snapshot())
    got = eng.serve([_req("port", *c) for c in tick])
    assert eng.device_calls == 0 and eng.compile_count == 0
    for g, w in zip(got, want):
        assert g.cached
        np.testing.assert_array_equal(g.strategy, w.strategy)
        assert (g.latency, g.peak_mem, g.speedup, g.valid) == \
            (w.latency, w.peak_mem, w.speedup, w.valid)
    other = _engine(model, checkpoint_id="other")
    assert other.load_cache(path) == 0


# --- the determinism contract inside the port ---------------------------------

def _stream():
    """A small mixed stream with duplicate conditions across nets/parts."""
    nets = ["vgg16", "resnet18", "tiny_cnn"]
    parts = ["edge", "mobile", "datacenter"]
    reqs = [_req("port", nets[i % 3], 16 << (i % 3), 8 + (i % 5),
                 parts[i % 3]) for i in range(10)]
    return reqs + reqs[:4]                       # 4 exact repeats


def test_bit_identical_alone_in_a_tick_and_permuted(weights):
    _, _, model = weights
    reqs = _stream()
    alone = [_engine(model).serve_one(r) for r in reqs]
    tick = _engine(model).serve(reqs)
    for a, b in zip(alone, tick):
        _same(a, b)
    solo = _engine(model)
    base = [solo.serve_one(r) for r in reqs]
    rng = np.random.default_rng(0)
    orders = [list(range(len(reqs))), list(rng.permutation(len(reqs))),
              list(rng.permutation(len(reqs)))]
    configs = [dict(flush_ms=0.0, max_wave=4), dict(flush_ms=5.0, max_wave=4),
               dict(flush_ms=1e3, max_wave=2), dict(flush_ms=1e3, max_wave=8)]
    snap = solo.strategies.snapshot()
    for order, kw in zip(orders + orders[:1], configs):
        eng = _engine(model)
        sched = ts.AsyncMapperScheduler(
            eng, config=ts.ServingConfig(**kw))
        futs = {}
        for t, i in enumerate(order):
            futs[i] = sched.submit(reqs[i], now=t * 1e-3)
            sched.pump(now=t * 1e-3)
        sched.drain(now=len(order) * 1e-3)
        for i, b in enumerate(base):
            _same(futs[i].result(), b)
            _same(alone[i], b)
        s = eng.strategies.snapshot()
        assert s.keys() == snap.keys()
        for k, (st, *rest) in s.items():
            assert np.array_equal(st, snap[k][0]) and rest == list(snap[k][1:])


def test_zero_new_signatures_after_warmup_and_oversized_ticks(weights):
    _, _, model = weights
    eng = _engine(model, max_coalesce=16)
    compiled = eng.warmup([TNETS["vgg16"], TNETS["tiny_cnn"]], TZOO["edge"],
                          max_tick=8)
    assert compiled == eng.compile_count == 2 * 4      # 2 buckets x 1,2,4,8
    assert eng.chunk_cap == 8
    before = eng.compile_count
    reqs = [ts.MapRequest(TNETS["tiny_cnn"], 1 + i % 4, (6 + i) * MB,
                          TZOO[PARTS[i % 5]]) for i in range(23)]
    out = eng.serve(reqs)
    rng = np.random.default_rng(1)
    for width in (1, 2, 3, 5, 7, 8, 11):
        eng.serve([ts.MapRequest(TNETS[("vgg16", "tiny_cnn")[i % 2]],
                                 int(rng.choice([16, 32, 64])),
                                 float(rng.integers(2, 48)) * MB,
                                 TZOO[PARTS[int(rng.integers(5))]])
                   for i in range(width)])
    assert eng.compile_count == before, "new signature in steady state"
    assert eng.coalesce_hist.get(8, 0) >= 2 and eng.coalesce_hist[7] == 1
    solo = _engine(model)
    for req, resp in zip(reqs, out):
        _same(resp, solo.serve_one(req))


def test_scheduler_flushes_admission_and_stats(weights):
    _, _, model = weights
    tiny, edge = TNETS["tiny_cnn"], TZOO["edge"]
    eng = _engine(model)
    sched = ts.AsyncMapperScheduler(
        eng, config=ts.ServingConfig(flush_ms=10.0, max_wave=2))
    a = sched.submit(ts.MapRequest(tiny, 16, 8 * MB, edge), now=0.0)
    sched.pump(now=0.001)
    assert not a.done and sched.queue_depth == 1
    b = sched.submit(ts.MapRequest(tiny, 32, 9 * MB, edge), now=0.002)
    sched.pump(now=0.002)
    assert a.done and b.done and sched.flushes["width"] == 1
    c = sched.submit(ts.MapRequest(tiny, 16, 11 * MB, edge), now=0.1)
    sched.pump(now=0.105)
    assert not c.done
    sched.pump(now=0.111)
    assert c.done and sched.flushes["deadline"] == 1
    d = sched.submit(ts.MapRequest(tiny, 16, 8 * MB, edge), now=0.2)
    assert d.done and d.result().cached and sched.resolved_at_submit == 1
    _same(d.result(), a.result())
    small = ts.AsyncMapperScheduler(
        _engine(model), config=ts.ServingConfig(max_queue=2, flush_ms=1e3))
    r = [ts.MapRequest(tiny, 16, (8 + i) * MB, edge) for i in range(3)]
    small.submit(r[0], now=0.0)
    small.submit(r[1], now=0.0)
    with pytest.raises(ts.AdmissionError):
        small.submit(r[2], now=0.0)
    assert small.rejected == 1 and small.submitted == 2
    small.drain(now=0.01)
    assert small.submit(r[2], now=0.02) is not None
    s = eng.stats()
    for key in ("scheduler", "drift", "strategy_cache", "escalations"):
        assert key in s
    assert s["scheduler"]["submitted"] == 4
    assert s["drift"]["replay_depth"] == 4
    # the config is inherited from the engine, and the deprecated kwarg
    # form is identical to the config form
    tconf._reset_deprecation_warnings()
    inherited = ts.AsyncMapperScheduler(_engine(
        model, config=ts.ServingConfig(flush_ms=3.0, max_queue=7)))
    assert inherited.flush_s == 0.003 and inherited.max_queue == 7
    with pytest.warns(DeprecationWarning, match="flush_ms"):
        legacy = ts.AsyncMapperScheduler(eng, flush_ms=5.0)
    assert legacy.flush_s == 0.005
    with pytest.raises(TypeError, match="not both"):
        ts.AsyncMapperScheduler(eng, config=ts.ServingConfig(),
                                flush_ms=2.0)


# --- persistence, swap, upgrade -----------------------------------------------

def test_cache_persists_across_engines_and_rejects_stale(weights, weights2,
                                                         tmp_path):
    _, _, model = weights
    path = tmp_path / "strategies.json"
    eng = _engine(model)
    reqs = [_req("port", "vgg16", 64, 20, "edge"),
            _req("port", "tiny_cnn", 16, 3, "mobile")]
    first = eng.serve(reqs)
    assert eng.save_cache(path) == len(reqs)
    fresh = _engine(model, cache_path=path)
    again = fresh.serve(reqs)
    assert fresh.device_calls == 0 and fresh.compile_count == 0
    for a, b in zip(first, again):
        assert b.cached
        _same(a, b)
    assert fresh.strategies.shared_hits == len(reqs)
    other = _engine(weights2[2])
    assert other.load_cache(path) == 0 and other.strategies.stale_skipped == 1
    with pytest.raises(ValueError, match="incompatible"):
        other.load_cache(path, strict=True)
    assert _engine(model, approx_budget_sharing=True).load_cache(path) == 0


def test_hot_swap_keeps_signatures_and_non_drifted_answers(weights, weights2):
    _, _, model = weights
    model2 = weights2[2]
    eng = _engine(model, max_coalesce=4)
    eng.warmup([TNETS["vgg16"], TNETS["tiny_cnn"]], TZOO["edge"], max_tick=2)
    keep = _req("port", "vgg16", 64, 20, "edge")
    drop = _req("port", "tiny_cnn", 32, 5, "edge")
    before_keep, _ = eng.serve([keep])[0], eng.serve([drop])[0]
    compiles, old_id = eng.compile_count, eng.checkpoint_id
    live = {k: v.clone() for k, v in model.state_dict().items()}
    pred = ts.region_key_predicate([TNETS["tiny_cnn"]], [], teng._accel_key)
    n = eng.swap_params(model2, invalidate=pred)
    assert n >= 1 and eng.swaps_accepted == 1 and eng.cache_invalidated == n
    assert all(k[0] != "tiny_cnn" for k in eng.strategies.snapshot())
    assert eng.checkpoint_id != old_id
    assert eng.strategies.context["checkpoint"] == eng.checkpoint_id
    assert eng.checkpoint_id == teng._fingerprint(model2)
    after_keep, after_drop = eng.serve([keep])[0], eng.serve([drop])[0]
    assert eng.compile_count == compiles
    assert after_keep.cached
    _same(after_keep, before_keep)
    assert not after_drop.cached
    _same(after_drop, _engine(model2).serve_one(drop))
    # the old model is untouched, the engine serves the new one
    assert all(torch.equal(v, live[k]) for k, v in model.state_dict().items())
    assert eng.model is model2
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params({"not": np.zeros(3)})
    bigger = tm.dt_init(tm.DTConfig(max_steps=64, hw_dim=10), device=CPU)
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params(bigger)
    with pytest.raises(ValueError, match="signature"):
        eng.swap_params(copy.deepcopy(model2).double())
    assert eng.swaps_accepted == 1 and eng.model is model2


def test_upgrade_pytree_preserves_function(weights2, tmp_path):
    _, _, model2 = weights2
    Checkpointer(tmp_path / "a").save(1, {"params": tm.param_tree(model2),
                                          "opt": {"t": 0}})
    template = tm.param_tree(tm.dt_init(model2.cfg, seed=5, device=CPU))
    tree, missing = upgrade_pytree(Checkpointer(tmp_path / "a").path(),
                                   template, prefix="params")
    assert missing == []
    for k, v in tm.param_tree(model2).items():
        assert torch.equal(tree[k], v)
    # an unconditioned checkpoint into an hw-aware template: emb_h is
    # zero-filled, and the upgraded model answers as the old one did
    old = tm.dt_init(tm.DTConfig(max_steps=20), seed=3, device=CPU)
    Checkpointer(tmp_path / "b").save(1, {"params": tm.param_tree(old)})
    new = tm.dt_init(tm.DTConfig(max_steps=20, hw_dim=10), seed=4,
                     device=CPU)
    tree, missing = upgrade_pytree(Checkpointer(tmp_path / "b").path(),
                                   tm.param_tree(new), prefix="params")
    assert sorted(missing) == ["emb_h/b", "emb_h/w"]
    tm.load_param_tree(new, tree)
    wl = tcm.pack_workload(TNETS["vgg16"], TZOO["edge"], 20, device=CPU)
    args = ([64.0, 32.0], [20 * MB, 9 * MB], [TZOO["edge"], TZOO["nano"]])
    a = tinf.dnnfuser_infer_batch(old, [wl, wl], *args, device=CPU)
    b = tinf.dnnfuser_infer_batch(new, [wl, wl], *args, device=CPU)
    assert torch.equal(a["strategy"], b["strategy"])
    bad = dict(tm.param_tree(new), **{"time/emb": torch.zeros(64, 128)})
    Checkpointer(tmp_path / "c").save(1, {"params": bad})
    with pytest.raises(ValueError, match="only fills"):
        upgrade_pytree(Checkpointer(tmp_path / "c").path(),
                       tm.param_tree(new), prefix="params")


# --- the refresh loop (mechanics) ----------------------------------------------

@pytest.fixture(scope="module")
def live_model():
    """A mapper briefly imitation-trained on tiny_cnn@edge (4-8 MB)."""
    cfg = tm.DTConfig(max_steps=20)
    ds = tds.generate_teacher_corpus(
        [TNETS["tiny_cnn"]], [TZOO["edge"]], batch=64, budgets_mb=[4, 8],
        max_steps=20, top_k=4,
        ga_cfg=tgs.GSamplerConfig(population=16, generations=8), device=CPU)
    model, _ = ttrain.train_model(
        tm.dt_loss, tm.dt_init(cfg, seed=0, device=CPU), ds,
        ttrain.TrainConfig(steps=60, batch_size=16), device=CPU)
    return model


def _drifted_engine(model):
    eng = _engine(model, config=ts.ServingConfig(
        max_coalesce=8, drift=ts.DriftConfig(window=8, replay_capacity=64)))
    eng.warmup([TNETS["tiny_cnn"]], TZOO["edge"], max_tick=4)
    for i in range(8):                            # in-distribution window
        eng.serve([ts.MapRequest(TNETS["tiny_cnn"], 32, (4 + i % 4) * MB,
                                 TZOO["edge"])])
    for i in range(8):                            # drifted window
        eng.serve([ts.MapRequest(TNETS["tiny_cnn"], 64, (40 + i) * MB,
                                 TZOO["datacenter"])])
    assert eng.monitor.reports_fired == 1
    return eng


def test_refresh_accepts_and_swaps(live_model, tmp_path):
    eng = _drifted_engine(live_model)
    keep = ts.MapRequest(TNETS["tiny_cnn"], 32, 5 * MB, TZOO["edge"])
    before = eng.serve_one(keep)
    compiles = eng.compile_count
    worker = ts.RefreshWorker(
        eng, train=ttrain.TrainConfig(steps=40, batch_size=16, lr=1e-4,
                                      warmup=5),
        ga=tgs.GSamplerConfig(population=16, generations=8), batch=64,
        top_k=4, max_probe=4, ckpt_dir=tmp_path, gate_tol=1e9)
    res = worker.poll()
    assert res is not None and res["accepted"]
    assert res["region"]["accels"] == ["datacenter"]
    assert res["corpus_size"] > 0 and res["cache_invalidated"] >= 1
    assert eng.swaps_accepted == 1 and eng.model is not live_model
    assert "datacenter" in eng.monitor.known_accels
    assert worker.poll() is None                  # reports were drained
    after = eng.serve_one(keep)                   # outside the region
    assert after.cached and eng.compile_count == compiles
    _same(after, before)
    # the swapped weights are the checkpoint's, read back
    cand = trefresh.probe_score(eng.model, [(TNETS["tiny_cnn"], 64, 45 * MB,
                                             TZOO["datacenter"])])
    assert np.isfinite(cand)
    s = eng.stats()["drift"]
    assert s["swaps_accepted"] == 1 and s["reports_fired"] == 1


def test_refresh_gate_rejects_bad_candidate(live_model, tmp_path,
                                            monkeypatch):
    eng = _engine(live_model)
    eng.serve_one(ts.MapRequest(TNETS["tiny_cnn"], 64, 6 * MB, TZOO["edge"]))
    entries = len(eng.strategies)
    monkeypatch.setattr(
        trefresh, "probe_score",
        lambda model, conds, repair=True: 1.0 if model is eng.model else 0.5)
    worker = ts.RefreshWorker(
        eng, train=ttrain.TrainConfig(steps=5, batch_size=16, lr=1e-4,
                                      warmup=1),
        ga=tgs.GSamplerConfig(population=16, generations=8), batch=64,
        top_k=4, max_probe=4, ckpt_dir=tmp_path)
    res = worker.refresh([TNETS["tiny_cnn"]], [TZOO["edge"]], [4.0, 8.0])
    assert not res["accepted"]
    assert eng.model is live_model
    assert eng.swaps_rejected == 1 and eng.swaps_accepted == 0
    assert len(eng.strategies) == entries
    with pytest.raises(ValueError, match="non-empty"):
        worker.refresh([], [TZOO["edge"]], [4.0])


def test_probe_score_ranks_trained_above_random(live_model):
    conds = [(TNETS["tiny_cnn"], 64, 6 * MB, TZOO["edge"]),
             (TNETS["tiny_cnn"], 64, 7 * MB, TZOO["edge"])]
    rand = tm.dt_init(tm.DTConfig(max_steps=20), seed=2, device=CPU)
    assert trefresh.probe_score(live_model, conds) >= \
        trefresh.probe_score(rand, conds)
    assert trefresh.probe_score(live_model, []) == 0.0


def test_s2s_config_and_wrong_device_raise(weights):
    @dataclasses.dataclass(frozen=True)
    class S2SConfig:
        max_steps: int = 20

    with pytest.raises(TypeError, match="ROADMAP queue 1 item 5"):
        trefresh._loss_for(S2SConfig())
    with pytest.raises(ValueError, match="max_steps"):
        _engine(weights[2], nmax_buckets=(8, 64))
    with pytest.raises(ValueError, match="nmax bucket"):
        _engine(weights[2]).serve_one(ts.MapRequest(
            port_workload(JCNN["mobilenet_v2"]()), 64, 20 * MB,
            TZOO["edge"]))
    meta = torch.nn.Linear(1, 1, device="meta")
    meta.cfg = weights[2].cfg
    with pytest.raises(ValueError, match="model is on meta"):
        ts.MapperEngine(meta, device=CPU)


def test_serve_factory(weights):
    _, _, model = weights
    sched = repro_torch.serve(
        model, ts.ServingConfig(max_coalesce=4, flush_ms=0.0),
        warm=[TNETS["tiny_cnn"]], accel=TZOO["edge"], device=CPU)
    assert isinstance(sched, ts.AsyncMapperScheduler)
    eng = sched.engine
    assert eng.compile_count == 3 and eng.serving_config.max_coalesce == 4
    assert "tiny_cnn" in eng.monitor.known_workloads
    fut = sched.submit(ts.MapRequest(TNETS["tiny_cnn"], 32, 5 * MB,
                                     TZOO["edge"]), now=0.0)
    sched.drain(0.0)
    assert fut.result().workload == "tiny_cnn"
    assert eng.compile_count == 3 and sched.flush_s == 0.0
    assert repro_torch.MapperEngine is ts.MapperEngine


# --- satellite: the batched episode at the smoke grid's shape ---------------

def test_episode_at_smoke_grid_shape_matches_reference(tmp_path_factory):
    """6 CNNs x 5 parts x 4 budgets, batch 64, nmax 64, each row packed for
    its own part, on the paper-width hw-conditioned DT (reference
    weights)."""
    jcfg, params, model = _ref_weights(tmp_path_factory, 11,
                                       hw_dim=taccel.HW_FEATURE_DIM)
    conds = [(n, p, b) for n in sorted(JCNN) for p in PARTS
             for b in (8, 16, 32, 64)]
    jw = {n: JCNN[n]() for n in JCNN}
    tw = {n: port_workload(w) for n, w in jw.items()}
    batches = np.full(len(conds), 64.0, np.float32)
    budgets = np.array([b * MB for _, _, b in conds], np.float32)
    jrows = [jcm.pack_workload(jw[n], JZOO[p], 64) for n, p, _ in conds]
    trows = [tcm.pack_workload(tw[n], TZOO[p], 64, device=CPU)
             for n, p, _ in conds]
    want = jinf.dnnfuser_infer_batch(params, jcfg, jrows, batches, budgets,
                                     [JZOO[p] for _, p, _ in conds])
    got = tinf.dnnfuser_infer_batch(model, trows, batches, budgets,
                                    [TZOO[p] for _, p, _ in conds],
                                    device=CPU)
    assert len(conds) == 120
    np.testing.assert_array_equal(to_np(got["strategy"]), want["strategy"])
    np.testing.assert_array_equal(to_np(got["valid"]), want["valid"])
    for k in ("latency", "peak_mem", "speedup"):
        np.testing.assert_allclose(to_np(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)
