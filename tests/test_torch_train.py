"""Port parity: the loss, the optimizer, the trainer, checkpoints and the
host mapper.

The reference's weights cross into the port through its checkpoint
format; corpora are the port's (numpy arrays), wrapped for the reference
where it trains on them.  Tolerances, stated per test:

- ``dt_loss`` and its gradients: rtol 1e-5 (loss), atol 1e-6 + rtol 1e-4
  (gradients: f32 sums over a batch of 16 x 36 tokens in another order);
- the schedules: rtol 1e-6 (both evaluate the same f32 formula; ``cos``
  may differ in its last bit);
- AdamW / SGD over several steps with the clip active: rtol 1e-5, atol
  1e-7 (elementwise f32 operations in the same order; the global norm is
  summed in another order);
- the loss log of ``train_model`` against the reference's over the same
  batches: ``LOSS_RTOL`` (the two runs drift apart by f32 rounding);
- within the port (resume, fine-tune, checkpoints, the host mapper
  against the fused episode): bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, MB, port_workload, to_np
from repro import optim as joptim
from repro.checkpoint import Checkpointer as JCheckpointer, save_pytree
from repro.checkpoint import restore_pytree as jrestore
from repro.checkpoint.checkpointer import _flatten
from repro.core import dataset as jds, env as jenv, infer as jinf
from repro.core import cost_model as jcm, model as jm, train as jtr
from repro.core.accel import ACCEL_ZOO as JZOO
from repro.workloads import resnet18, tiny_cnn
from repro_torch import optim as toptim
from repro_torch.checkpoint import (Checkpointer, dt_params_from_reference,
                                    load_reference, restore_pytree,
                                    save_pytree as port_save)
from repro_torch.core import accel as taccel, cost_model as tcm
from repro_torch.core import dataset as tds, env as tenv
from repro_torch.core import gsampler as tgs, infer as tinf, model as tm
from repro_torch.core import train as ttr

T = 12
JCFG = jm.DTConfig(n_blocks=1, n_heads=1, d_model=32, d_ff=64, max_steps=T,
                   hw_dim=10)
TC = dict(steps=24, batch_size=16, lr=1e-3, warmup=4, log_every=4, seed=0)
# loss logs of the two packages over TC's 24 steps agree this closely (the
# CPU runs differ by at most 7e-7 relative)
LOSS_RTOL = 1e-5


def _ref_weights(tmp_path, seed=0):
    params = jm.dt_init(jax.random.PRNGKey(seed), JCFG)
    path = tmp_path / f"ref_{seed}"
    save_pytree(params, path)
    return params, path


def _port_model(path):
    return dt_params_from_reference(load_reference(path), n_heads=1,
                                    device=CPU)


@pytest.fixture(scope="module")
def corpus():
    """A small corpus (the port's grid pipeline) and its reference twin."""
    ds = tds.generate_teacher_corpus(
        [port_workload(tiny_cnn())], taccel.PAPER_ACCEL, batch=64,
        budgets_mb=[2.0, 6.0], max_steps=T, top_k=4,
        ga_cfg=tgs.GSamplerConfig(population=16, generations=6, seed=0),
        seed=0, augment_jitter=1, device=CPU)
    ref = jds.TrajectoryDataset(ds.rtg, ds.states, ds.actions, ds.mask,
                                ds.meta, ds.t0, ds.hw)
    return ds, ref


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("weights")


def _batch(ds, n=16, seed=3):
    """Windows of 4 steps with their offsets ``t0`` (the model embeds 12)."""
    b = tds.window_dataset(ds, 4, 2).sample(np.random.default_rng(seed), n)
    assert b["t0"].max() > 0
    return b


def test_dt_loss_and_grads_match_reference(corpus, ref_dir):
    ds, _ = corpus
    params, path = _ref_weights(ref_dir)
    model = _port_model(path)
    b = _batch(ds)
    loss_j, g_j = jax.value_and_grad(
        lambda p: jm.dt_loss(p, JCFG, {k: jnp.asarray(v) for k, v in
                                       b.items()}))(params)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    tree = tm.param_tree(model)
    loss_t, g_t = toptim.value_and_grad(lambda x: tm.dt_loss(model, x),
                                        tree, tb)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    flat_j, _ = _flatten(g_j)
    assert set(flat_j) == set(g_t)
    for k, g in g_t.items():
        np.testing.assert_allclose(to_np(g), np.asarray(flat_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name,args", [
    ("cosine_with_warmup", (3e-4, 5, 40)),
    ("cosine_with_warmup", (1e-3, 0, 7)),
    ("linear_warmup", (1e-3, 6)), ("constant", (2e-4,))])
def test_schedules_match_reference(name, args):
    jf, tf = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for s in range(0, 45):
        want = float(jf(jnp.int32(s)))
        assert tf(s) == pytest.approx(want, rel=1e-6), s


def _tree(rng):
    return {"a/w": rng.normal(size=(4, 3)).astype(np.float32),
            "a/b": rng.normal(size=(3,)).astype(np.float32),
            "blocks/0/emb": rng.normal(size=(5, 2)).astype(np.float32)}


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_optimizer_steps_match_reference(opt):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [{k: 3.0 * v for k, v in _tree(rng).items()} for _ in range(6)]
    if opt == "adamw":
        make = lambda pkg: pkg.adamw(pkg.cosine_with_warmup(1e-2, 2, 6),
                                     weight_decay=1e-2, max_grad_norm=1.0)
    else:
        make = lambda pkg: pkg.sgd(pkg.linear_warmup(1e-2, 3),
                                   max_grad_norm=1.0)
    jtx, ttx = make(joptim), make(toptim)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        # the clip is active: every step's global norm is above 1
        assert float(toptim.global_norm(
            {k: torch.as_tensor(v) for k, v in g.items()})) > 1.0
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.as_tensor(v) for k, v in g.items()},
                            ts, tp)
        toptim.apply_updates(tp, tu)
        for k in p0:
            np.testing.assert_allclose(to_np(tp[k]), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        assert int(ts.step) == int(js.step)
    moments = ("mu", "nu") if opt == "adamw" else ("mom",)
    for m in moments:
        for k in p0:
            np.testing.assert_allclose(to_np(getattr(ts, m)[k]),
                                       np.asarray(getattr(js, m)[k]),
                                       rtol=1e-5, atol=1e-9)


def test_accumulated_value_and_grad_matches_reference(corpus, ref_dir):
    ds, _ = corpus
    params, path = _ref_weights(ref_dir)
    model = _port_model(path)
    b = {k: np.asarray(v).reshape((2, 8) + np.asarray(v).shape[1:])
         for k, v in _batch(ds).items()}
    lj, gj = joptim.accumulated_value_and_grad(
        lambda p, x: jm.dt_loss(p, JCFG, x), params,
        {k: jnp.asarray(v) for k, v in b.items()})
    lt, gt = toptim.accumulated_value_and_grad(
        lambda x: tm.dt_loss(model, x), tm.param_tree(model),
        {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(lt) == pytest.approx(float(lj), rel=1e-5)
    flat, _ = _flatten(gj)
    for k, g in gt.items():
        np.testing.assert_allclose(to_np(g), np.asarray(flat[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _loss(model, b):
    return tm.dt_loss(model, b)


def _equal(a, b):
    ta, tb = tm.param_tree(a), tm.param_tree(b)
    return set(ta) == set(tb) and all(torch.equal(ta[k], tb[k]) for k in ta)


def test_train_model_loss_log_matches_reference(corpus, ref_dir):
    ds, ref_ds = corpus
    params, path = _ref_weights(ref_dir)
    _, jlog = jtr.train_model(lambda p, b: jm.dt_loss(p, JCFG, b), params,
                              ref_ds, jtr.TrainConfig(**TC))
    _, tlog = ttr.train_model(_loss, _port_model(path), ds,
                              ttr.TrainConfig(**TC), device=CPU)
    assert [s for s, _ in tlog["losses"]] == [s for s, _ in jlog["losses"]]
    np.testing.assert_allclose([l for _, l in tlog["losses"]],
                               [l for _, l in jlog["losses"]],
                               rtol=LOSS_RTOL)
    assert tlog["losses"][-1][1] < tlog["losses"][0][1]


@pytest.fixture(scope="module")
def trained(corpus, ref_dir, tmp_path_factory):
    ds, _ = corpus
    _, path = _ref_weights(ref_dir)
    ckpt = tmp_path_factory.mktemp("ckpt_full")
    cfg = ttr.TrainConfig(**TC, ckpt_every=8, grad_accum=2)
    model, log = ttr.train_model(_loss, _port_model(path), ds, cfg,
                                 ckpt_dir=str(ckpt), device=CPU)
    return model, log, str(ckpt), cfg


def test_resume_is_bit_exact(corpus, ref_dir, trained, tmp_path):
    ds, _ = corpus
    _, path = _ref_weights(ref_dir)
    full, _, _, cfg = trained
    ttr.train_model(_loss, _port_model(path), ds, cfg, ckpt_dir=str(tmp_path),
                    crash_at=12, device=CPU)
    assert Checkpointer(tmp_path).latest_step() == 8
    resumed, log = ttr.train_model(_loss, _port_model(path), ds, cfg,
                                   ckpt_dir=str(tmp_path), device=CPU)
    assert log["start_step"] == 8
    assert _equal(resumed, full)
    again, _ = ttr.train_model(_loss, _port_model(path), ds, cfg, device=CPU)
    assert _equal(again, full)


def test_restore_params_and_fine_tune_from_a_directory(corpus, ref_dir,
                                                       trained):
    ds, _ = corpus
    full, _, ckpt, _ = trained
    _, other = _ref_weights(ref_dir, seed=1)
    template = _port_model(other)
    restored = ttr.restore_params(ckpt, template)
    assert _equal(restored, full) and not _equal(template, full)
    ft = ttr.TrainConfig(steps=6, batch_size=8, lr=1e-4, warmup=2,
                         log_every=2, seed=1)
    a, la = ttr.fine_tune(_loss, ckpt, ds, ft, template=template, device=CPU)
    b, lb = ttr.fine_tune(_loss, full, ds, ft, device=CPU)
    assert _equal(a, b) and la["losses"] == lb["losses"]
    assert _equal(restored, full)           # the caller's model survives
    with pytest.raises(ValueError):
        ttr.fine_tune(_loss, ckpt, ds, ft, device=CPU)


def test_checkpoints_cross_both_ways(trained, ref_dir, tmp_path):
    full, _, ckpt, _ = trained
    jparams, _ = _ref_weights(ref_dir)
    jtx = joptim.adamw(1e-3)
    template = {"params": jparams, "opt_state": jtx.init(jparams)}
    # port -> reference, digest verified on the way in
    step, tree = JCheckpointer(ckpt).restore(template)
    assert step == 24 and int(tree["opt_state"].step) == 24
    for k, v in tm.param_tree(full).items():
        node = tree["params"]
        for part in k.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        np.testing.assert_array_equal(np.asarray(node), to_np(v))
    # the reference writes the same tree byte for byte
    JCheckpointer(tmp_path / "ref").save(24, tree)
    mine = Checkpointer(ckpt).path(24)
    theirs = tmp_path / "ref" / "ckpt_00000024"
    assert (mine / "meta.json").read_text() == \
        (theirs / "meta.json").read_text()
    # reference -> port, through a template of the port's tree
    ttx = toptim.adamw(1e-3)
    model = _port_model(_ref_weights(ref_dir, seed=1)[1])
    params = tm.param_tree(model)
    got = restore_pytree(theirs, {"params": params,
                                  "opt_state": ttx.init(params)})
    assert int(got["opt_state"].step) == 24
    assert _equal(tm.load_param_tree(model, got["params"]), full)
    flat = restore_pytree(theirs)
    for k, v in got["opt_state"].mu.items():
        np.testing.assert_array_equal(to_np(v), flat[f"opt_state/.mu/{k}"])
    (theirs / "leaf_00000.npy").write_bytes(
        (theirs / "leaf_00001.npy").read_bytes())
    with pytest.raises(IOError):
        restore_pytree(theirs)


@pytest.mark.parametrize("net,part,budget", [
    (tiny_cnn, "edge", 2.0), (resnet18, "mobile", 6.0),
    (tiny_cnn, "datacenter", 0.5)])
def test_host_mapper_matches_reference_and_fused_episode(ref_dir, net, part,
                                                         budget):
    cfg = jm.DTConfig(n_blocks=1, n_heads=1, d_model=32, d_ff=64,
                      max_steps=32, hw_dim=10)
    params = jm.dt_init(jax.random.PRNGKey(2), cfg)
    save_pytree(params, ref_dir / "host32")
    model = _port_model(ref_dir / "host32")
    w = net()
    jenv_ = jenv.FusionEnv(w, JZOO[part], 64, budget * MB, nmax=32)
    tenv_ = tenv.FusionEnv(port_workload(w), taccel.ACCEL_ZOO[part], 64,
                           budget * MB, nmax=32, device=CPU)
    want = jinf.dnnfuser_infer(params, cfg, jenv_)
    got = tinf.dnnfuser_infer(model, tenv_)
    np.testing.assert_array_equal(got.strategy, want.strategy)
    assert got.valid == want.valid and got.n_model_calls == w.n + 1
    assert got.speedup == pytest.approx(want.speedup, rel=1e-5)
    fused = tinf.dnnfuser_infer_fused(model, tenv_)
    np.testing.assert_array_equal(got.strategy, fused.strategy)


def test_trained_weights_answer_alike_in_both_packages(trained, tmp_path):
    """The port's trained weights, crossed into the reference through the
    checkpoint format, give the reference's batched episode the port's
    strategies: the port answers what the reference would with them."""
    full, _, _, _ = trained
    port_save(tm.param_tree(full), tmp_path / "w")
    jparams = jrestore(tmp_path / "w", jm.dt_init(jax.random.PRNGKey(5),
                                                  JCFG))
    parts = sorted(JZOO)
    budgets = np.array([b * MB for _ in parts for b in (0.5, 2.0, 6.0)],
                       np.float32)
    hw = [p for p in parts for _ in range(3)]
    batches = np.full(len(hw), 64.0, np.float32)
    w = tiny_cnn()
    jw = jcm.stack_workloads([jcm.pack_workload(w, JZOO[p], T) for p in hw])
    tw = tcm.stack_workloads([tcm.pack_workload(
        port_workload(w), taccel.ACCEL_ZOO[p], T, device=CPU) for p in hw])
    want = jinf.dnnfuser_infer_batch(jparams, JCFG, jw, jnp.asarray(batches),
                                     jnp.asarray(budgets),
                                     [JZOO[p] for p in hw])
    got = tinf.dnnfuser_infer_batch(full, tw, batches, budgets,
                                    [taccel.ACCEL_ZOO[p] for p in hw],
                                    device=CPU)
    np.testing.assert_array_equal(to_np(got["strategy"]),
                                  np.asarray(want["strategy"]))
    np.testing.assert_array_equal(to_np(got["valid"]),
                                  np.asarray(want["valid"]))
    np.testing.assert_allclose(to_np(got["speedup"]),
                               np.asarray(want["speedup"]), rtol=1e-5)
