"""Port parity: the Seq2Seq baseline mapper (``core/seq2seq.py``).

Weights come from the reference's ``s2s_init``, saved with
``checkpoint.save_pytree`` and loaded unchanged into the port's ``S2S`` by
``load_param_tree`` (the parameter names are the reference's pytree
paths), with and without the hw-condition embedding.  Tolerances: the
teacher-forced predictions and the streaming steps within 1e-5 + 1e-5
|ref|, the loss within 1e-5 relative; the cell-by-cell decode replays the
port's own ``s2s_apply``; the fused episode's strategies and ``valid`` are
integer-equal to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, MB, port_workload, to_np
from repro.checkpoint import save_pytree
from repro.core import cost_model as jcm, env as jenv, infer as jinf
from repro.core import seq2seq as jsq
from repro.core.accel import ACCEL_ZOO as JZOO
from repro.workloads import resnet18, tiny_cnn, vgg16
from repro_torch import serving as ts
from repro_torch.checkpoint import Checkpointer, load_reference, upgrade_pytree
from repro_torch.core import accel as taccel, backend as tbk
from repro_torch.core import cost_model as tcm, dataset as tds, env as tenv
from repro_torch.core import infer as tinf, model as tm, seq2seq as tsq
from repro_torch.core import train as ttrain
from repro_torch.serving import refresh as trefresh

TZOO = taccel.ACCEL_ZOO
PARTS = sorted(JZOO)
HW_DIMS = (0, 10)
HIDDEN, STEPS = 32, 20
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=HW_DIMS, ids=lambda d: f"hw{d}")
def weights(request, tmp_path_factory):
    jcfg = jsq.S2SConfig(hidden=HIDDEN, max_steps=STEPS,
                         hw_dim=request.param)
    params = jsq.s2s_init(jax.random.PRNGKey(3), jcfg)
    path = tmp_path_factory.mktemp("s2s") / "ckpt"
    save_pytree(params, path)
    cfg = tsq.S2SConfig(hidden=HIDDEN, max_steps=STEPS,
                        hw_dim=request.param)
    model = tm.load_param_tree(tsq.s2s_init(cfg, seed=0, device=CPU),
                               load_reference(path))
    return jcfg, params, model


def _inputs(T=STEPS, B=3, seed=0, hw_dim=0):
    rng = np.random.default_rng(seed)
    rtg = rng.random((B, T)).astype(np.float32)
    states = rng.random((B, T, 8)).astype(np.float32)
    actions = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    mask = (rng.random((B, T)) < 0.8).astype(np.float32)
    hw = rng.random((B, hw_dim)).astype(np.float32) if hw_dim else None
    return rtg, states, actions, mask, hw


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def test_parameters_carry_over_unchanged(weights):
    jcfg, params, model = weights
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    tree = tm.param_tree(model)
    assert set(tree) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(to_np(tree[k]), v, err_msg=k)
    assert "enc_lstm/wh/b" not in tree and "enc_lstm/wx/b" in tree
    assert tbk.backend_for(model.cfg) is tsq.S2SBackend


def test_apply_and_loss_match_reference(weights):
    jcfg, params, model = weights
    rtg, states, actions, mask, hw = _inputs(hw_dim=jcfg.hw_dim)
    want = jsq.s2s_apply(params, jcfg, _j(rtg), _j(states), _j(actions),
                         _j(hw))
    with torch.no_grad():
        got = tsq.s2s_apply(model, _t(rtg), _t(states), _t(actions), _t(hw))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    batch = dict(rtg=rtg, states=states, actions=actions, mask=mask)
    if hw is not None:
        batch["hw"] = hw
    jl = jsq.s2s_loss(params, jcfg, {k: _j(v) for k, v in batch.items()})
    tl = tsq.s2s_loss(model, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)


def test_decode_step_replays_apply(weights):
    """``s2s_encode`` then ``s2s_decode_step`` cell by cell gives the
    port's own teacher-forced ``s2s_apply``."""
    jcfg, _, model = weights
    rtg, states, actions, _, hw = _inputs(seed=1, hw_dim=jcfg.hw_dim)
    rtg, states, actions, hw = map(_t, (rtg, states, actions, hw))
    with torch.no_grad():
        full = tsq.s2s_apply(model, rtg, states, actions, hw)
        cache = tsq.s2s_decode_start(tsq.s2s_encode(model, rtg, states, hw))
        prev = torch.zeros_like(actions[:, 0])
        for t in range(STEPS):
            pred, cache = tsq.s2s_decode_step(model, cache, rtg[:, t],
                                              states[:, t], prev, hw)
            torch.testing.assert_close(pred, full[:, t], rtol=0, atol=0)
            prev = actions[:, t]


def test_stream_step_matches_reference(weights):
    jcfg, params, model = weights
    rtg, states, actions, _, hw = _inputs(seed=2, hw_dim=jcfg.hw_dim)
    B = rtg.shape[0]
    jc = jsq.s2s_stream_init(jcfg, B)
    tc = tsq.s2s_stream_init(model.cfg, B, device=CPU)
    prev = np.zeros(B, np.float32)
    for t in range(8):
        jp, jc = jsq.s2s_stream_step(params, jcfg, jc, _j(rtg[:, t]),
                                     _j(states[:, t]), _j(prev), _j(hw))
        with torch.no_grad():
            tp, tc = tsq.s2s_stream_step(model, tc, _t(rtg[:, t]),
                                         _t(states[:, t]), _t(prev), _t(hw))
        np.testing.assert_allclose(to_np(tp), np.asarray(jp), **TOL)
        for k in ("eh", "ec", "h", "c"):
            np.testing.assert_allclose(to_np(tc[k]), np.asarray(jc[k]),
                                       **TOL, err_msg=k)
        assert tc["t"] == int(jc["t"]) == t + 1
        prev = actions[:, t]


def _grid(nmax):
    conds = [(f, part, b) for f in (tiny_cnn, resnet18) for part in PARTS
             for b in (1, 16)]
    jrows = [jcm.pack_workload(f(), JZOO["edge"], nmax) for f, _, _ in conds]
    trows = [tcm.pack_workload(port_workload(f()), TZOO["edge"], nmax,
                               device=CPU) for f, _, _ in conds]
    batches = np.array([16.0 if i % 2 else 32.0 for i in range(len(conds))],
                       np.float32)
    budgets = np.array([b * MB for _, _, b in conds], np.float32)
    return (jrows, trows, batches, budgets, [JZOO[p] for _, p, _ in conds],
            [TZOO[p] for _, p, _ in conds])


def test_fused_episode_matches_reference(weights):
    """``dnnfuser_infer_batch`` with an S2S over heterogeneous conditions,
    and ``s2s_infer_fused`` on one env: strategies and ``valid`` equal."""
    jcfg, params, model = weights
    jrows, trows, batches, budgets, jhw, thw = _grid(STEPS)
    want = jinf.dnnfuser_infer_batch(params, jcfg, jrows, batches, budgets,
                                     jhw)
    got = tinf.dnnfuser_infer_batch(model, trows, batches, budgets, thw,
                                    device=CPU)
    np.testing.assert_array_equal(to_np(got["strategy"]), want["strategy"])
    np.testing.assert_array_equal(to_np(got["valid"]), want["valid"])
    for k in ("latency", "peak_mem", "speedup"):
        np.testing.assert_allclose(to_np(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)
    j = jenv.FusionEnv(tiny_cnn(), JZOO["nano"], 64, 3 * MB, nmax=STEPS)
    t = tenv.FusionEnv(port_workload(tiny_cnn()), TZOO["nano"], 64, 3 * MB,
                       nmax=STEPS, device=CPU)
    jr = jinf.s2s_infer_fused(params, jcfg, j)
    tr = tinf.s2s_infer_fused(model, t)
    np.testing.assert_array_equal(tr.strategy, jr.strategy)
    assert tr.valid == jr.valid
    np.testing.assert_allclose(tr.speedup, jr.speedup, rtol=1e-5)
    # the host rollout (the reference's s2s_infer) on the same env
    jh, th = jinf.s2s_infer(params, jcfg, j), tinf.s2s_infer(model, t)
    np.testing.assert_array_equal(th.strategy, jh.strategy)


def test_episode_costs_match_rescore_and_lane_blocks(weights):
    """The episode's costs equal a re-score through the evaluator, and a
    row's answer does not depend on the batch's size or on the lane blocks
    the card runs it on (emulated here with a block of 4)."""
    _, _, model = weights
    _, trows, batches, budgets, _, thw = _grid(STEPS)
    out = tinf.dnnfuser_infer_batch(model, trows, batches, budgets, thw,
                                    device=CPU)
    re = tcm.evaluate_grid(tcm.stack_workloads(trows),
                           out["strategy"][:, None, :], batches, budgets, thw)
    for k in ("latency", "peak_mem", "traffic"):
        np.testing.assert_allclose(to_np(getattr(re, k))[:, 0],
                                   to_np(out[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(to_np(re.valid)[:, 0], to_np(out["valid"]))
    real = tinf.lane_block
    tinf.lane_block = lambda device: 4
    try:
        blocked = tinf.dnnfuser_infer_batch(model, trows, batches, budgets,
                                            thw, device=CPU)
        alone = tinf.dnnfuser_infer_batch(model, trows[5:6], batches[5:6],
                                          budgets[5:6], thw[5:6], device=CPU)
    finally:
        tinf.lane_block = real
    assert torch.equal(blocked["strategy"], out["strategy"])
    assert torch.equal(alone["strategy"][0], out["strategy"][5])


def _corpus():
    return tds.generate_teacher_corpus(
        [port_workload(tiny_cnn())], [TZOO["edge"]], batch=32,
        budgets_mb=[2, 8], max_steps=STEPS, top_k=4, seed=0,
        augment_jitter=1, device=CPU,
        ga_cfg=tds.GSamplerConfig(population=12, generations=4))


@pytest.mark.parametrize("hw_dim", HW_DIMS)
def test_training_is_deterministic_per_seed(hw_dim):
    ds = _corpus()
    cfg = tsq.S2SConfig(hidden=HIDDEN, max_steps=STEPS, hw_dim=hw_dim)
    tc = ttrain.TrainConfig(steps=6, batch_size=8, log_every=2, warmup=2)
    runs = [ttrain.train_model(tsq.s2s_loss,
                               tsq.s2s_init(cfg, seed=4, device=CPU), ds, tc,
                               device=CPU) for _ in range(2)]
    a, b = (tm.param_tree(m) for m, _ in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert runs[0][1]["losses"] == runs[1][1]["losses"]
    fresh = tm.param_tree(tsq.s2s_init(cfg, seed=4, device=CPU))
    assert any(not torch.equal(a[k], fresh[k]) for k in a)


def test_refresh_loss_and_upgrade_for_s2s(tmp_path):
    cfg = tsq.S2SConfig(hidden=HIDDEN, max_steps=STEPS)
    assert trefresh._loss_for(cfg) is tsq.s2s_loss
    with pytest.raises(TypeError):
        trefresh._loss_for(object())
    # an unconditioned checkpoint into an hw-aware template: emb_h is
    # zero-filled and the upgraded model answers as the old one did
    old = tsq.s2s_init(cfg, seed=3, device=CPU)
    Checkpointer(tmp_path / "b").save(1, {"params": tm.param_tree(old)})
    new = tsq.s2s_init(tsq.S2SConfig(hidden=HIDDEN, max_steps=STEPS,
                                     hw_dim=10), seed=4, device=CPU)
    tree, missing = upgrade_pytree(Checkpointer(tmp_path / "b").path(),
                                   tm.param_tree(new), prefix="params")
    assert sorted(missing) == ["emb_h/b", "emb_h/w"]
    tm.load_param_tree(new, tree)
    wl = tcm.pack_workload(port_workload(vgg16()), TZOO["edge"], STEPS,
                           device=CPU)
    args = ([64.0, 32.0], [20 * MB, 9 * MB], [TZOO["edge"], TZOO["nano"]])
    a = tinf.dnnfuser_infer_batch(old, [wl, wl], *args, device=CPU)
    b = tinf.dnnfuser_infer_batch(new, [wl, wl], *args, device=CPU)
    assert torch.equal(a["strategy"], b["strategy"])


def test_engine_serves_s2s(weights):
    """A ``MapperEngine`` over an S2S: the answers are
    ``dnnfuser_infer_batch``'s, and steady traffic adds no signature after
    warmup."""
    _, _, model = weights
    eng = ts.MapperEngine(model, config=ts.ServingConfig(max_coalesce=8),
                          device=CPU)
    nets = [port_workload(vgg16()), port_workload(tiny_cnn())]
    eng.warmup(nets, TZOO["edge"], max_tick=4)
    before = eng.compile_count
    reqs = [ts.MapRequest(nets[i % 2], (16, 32, 64)[i % 3], (3 + 2 * i) * MB,
                          TZOO[PARTS[i % 5]]) for i in range(11)]
    out = eng.serve(reqs)
    assert eng.compile_count == before
    for req, resp in zip(reqs, out):
        n = req.workload.n + 1
        wl = tcm.pack_workload(req.workload, req.accel, STEPS, device=CPU)
        want = tinf.dnnfuser_infer_batch(model, [wl], [req.batch],
                                         [req.budget_bytes], req.accel,
                                         device=CPU)
        np.testing.assert_array_equal(resp.strategy,
                                      to_np(want["strategy"][0, :n]))
        assert resp.valid == bool(want["valid"][0])
