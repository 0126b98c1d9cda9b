"""Port parity: LM training (``repro_torch.launch.train``, the kernels'
refusal of gradients, the training-checkpoint conversions) against the
reference's ``repro.launch.train``.

Tolerances, stated per test:

- each family's ``loss_fn`` gradients against ``jax.grad`` of the
  reference's at ``impl="xla"``, on the same weights: leaf by leaf within
  ``GRAD_TOL`` of the leaf's largest gradient (the reference's model
  tolerance, 2e-4, scaled to the leaf; the worst seen is RWKV6's, 5.9e-5:
  f32 sums over the chunked WKV form in another order), the loss within
  2e-4;
- ``make_local_train_step`` at ``grad_accum`` 1, 2 and 4 against the
  reference's (an SGD step of lr 1, whose update is minus the gradient):
  the loss within 2e-4, the gradients within ``GRAD_TOL`` as above;
  ``grad_accum`` 2 against 1 in the port: the loss within rtol 1e-6, each
  gradient within atol 1e-7 + rtol 1e-5 (two f32 means of halves against
  one mean);
- the mapper: with the same DT weights, strategy, micro-batch and
  ``grad_accum`` equal; with the G-Sampler, on quality (speedup not below
  the reference's by more than rtol 1e-5);
- the training-checkpoint conversions: bit-equal both ways;
- a run resumed in the other package: the losses and final parameters
  within ``RESUME_TOL`` of the other package's own run (see there).
"""
import inspect
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, TOL, lm_pair
from repro import configs as jconfigs
from repro.checkpoint import save_pytree
from repro.checkpoint.checkpointer import _flatten
from repro.core import model as jdt
from repro.launch import train as jtrain
from repro_torch import configs as tconfigs, optim as toptim
from repro_torch.checkpoint import (Checkpointer, dt_params_from_reference,
                                    lm_train_state_from_reference,
                                    lm_train_state_to_reference,
                                    load_reference, restore_pytree)
from repro_torch.checkpoint.checkpointer import _flatten as _flatten_port
from repro_torch.checkpoint.reference import _stack
from repro_torch.core.model import param_tree
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention as fa, flash_decode as fd
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec, hymba, lm, registry, rwkv_lm

FAMILIES = {"dense": "gemma3_1b", "moe": "qwen3_moe_235b", "ssm": "rwkv6_3b",
            "hybrid": "hymba_15b", "encdec": "whisper_base",
            "vlm": "qwen2_vl_72b"}
GRAD_TOL = 2e-4


def _batch(cfg, *, B=2, S=32, step=0, seed=1) -> dict:
    """``launch.train``'s batch of ``cfg`` (numpy)."""
    src = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed,
                      embed_dim=cfg.d_model if cfg.embed_inputs else None,
                      dec_len=max(S // 8, 8) if cfg.family == "encdec"
                      else None)
    b = src.batch_at(step)
    return {k: b[k] for k in ttrain.batch_keys(cfg)}


def _torch(b: dict) -> dict:
    return {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind == "i"
                               else v) for k, v in b.items()}


def _grads(model, loss) -> dict:
    """The port's gradients under the reference's stacked paths."""
    pt = param_tree(model)
    g = torch.autograd.grad(loss, list(pt.values()), allow_unused=True,
                            materialize_grads=True)
    return _stack(dict(zip(pt, g)), model.cfg)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_gradients_match_reference(tmp_path, family):
    """The default ``loss_fn`` (``impl="dense"``) gives ``jax.grad``'s
    gradient on every leaf: nothing is cut."""
    cfg, jmod, params, model = lm_pair(tmp_path, FAMILIES[family])
    b = _batch(cfg)
    want, jg = jax.value_and_grad(lambda p: jmod.loss_fn(
        p, cfg, {k: jnp.asarray(v) for k, v in b.items()}, impl="xla"))(
            params)
    jg = {k: np.asarray(v) for k, v in _flatten(jg)[0].items()}
    loss = registry.get_model(model.cfg).loss_fn(model, _torch(b))
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    got = _grads(model, loss)
    assert sorted(got) == sorted(jg)
    for k in jg:                # a leaf the loss does not reach: zeros
        np.testing.assert_allclose(got[k], jg[k], rtol=0,
                                   atol=GRAD_TOL * np.abs(jg[k]).max(),
                                   err_msg=k)


def test_loss_fn_defaults_to_dense_and_the_rest_to_the_kernels():
    for mod in (lm, rwkv_lm, hymba, encdec):
        impl = lambda f: inspect.signature(f).parameters["impl"].default
        assert impl(mod.loss_fn) == "dense", mod.__name__
        for f in (mod.forward, mod.prefill, mod.decode_step):
            assert impl(f) == "kernel", (mod.__name__, f.__name__)
    assert impl(ttrain.make_local_train_step) == "dense"


def _kernel_calls():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 2, 64, generator=g)
    kv = torch.randn(1, 6, 1, 64, generator=g)
    r, k, v, w = torch.rand(4, 1, 5, 2, 16, generator=g).unbind(0)
    u, s0 = torch.rand(2, 16, generator=g), torch.zeros(1, 2, 16, 16)
    return {"flash_attention": (fa.flash_attention, (q, kv, kv)),
            "flash_decode": (fd.flash_decode, (q[:, :1], kv, kv, 5)),
            "wkv6": (rk.wkv6, (r, k, v, w, u, s0))}


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode", "wkv6"])
def test_kernels_refuse_inputs_that_require_grad(name):
    fn, args = _kernel_calls()[name]
    want = fn(*args)                                      # no grad: runs
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    for i in range(len(tensors)):
        grad_args = [a.clone().requires_grad_() if a is tensors[i] else a
                     for a in args]
        with pytest.raises(RuntimeError, match=r'no backward.*impl="dense"'):
            fn(*grad_args)
        with torch.no_grad():
            got = fn(*grad_args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("family", ["dense", "ssm", "encdec"])
def test_loss_at_the_kernels_refuses_to_differentiate(tmp_path, family):
    """``impl="kernel"`` under grad mode raises instead of training on a
    gradient cut at the kernels (on the card they write fresh tensors)."""
    cfg, _, _, model = lm_pair(tmp_path, FAMILIES[family])
    mod = registry.get_model(model.cfg)
    b = _torch(_batch(cfg))
    with pytest.raises(RuntimeError, match="no backward"):
        mod.loss_fn(model, b, impl="kernel")
    with torch.no_grad():
        torch.testing.assert_close(mod.loss_fn(model, b, impl="kernel"),
                                   mod.loss_fn(model, b), **TOL)


def _sgd_step(pkg, model_or_params, cfg, batch, grad_accum):
    """(loss, -update) of one ``make_local_train_step`` with SGD at lr 1
    (the update is minus the gradient), numpy under the stacked paths."""
    if pkg == "port":
        pt = param_tree(model_or_params)
        before = {k: v.detach().clone() for k, v in pt.items()}
        tx = toptim.sgd(lr=1.0, momentum=0.0)
        step = ttrain.make_local_train_step(model_or_params.cfg, tx,
                                            grad_accum=grad_accum)
        _, _, loss = step(model_or_params, tx.init(pt), _torch(batch))
        g = {k: before[k] - v.detach() for k, v in pt.items()}
        for k, v in pt.items():                 # leave the model as it was
            v.data.copy_(before[k])
        return float(loss), _stack(g, model_or_params.cfg)
    from repro import optim as joptim
    tx = joptim.sgd(lr=1.0, momentum=0.0)
    step = jtrain.make_local_train_step(cfg, tx, grad_accum=grad_accum)
    p0 = jax.tree.map(jnp.copy, model_or_params)       # the step donates
    p1, _, loss = step(p0, tx.init(p0), {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    g = jax.tree.map(lambda a, b: a - b, model_or_params, p1)
    return float(loss), {k: np.asarray(v) for k, v in _flatten(g)[0].items()}


@pytest.mark.parametrize("grad_accum", [1, 2, 4])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_accumulated_step_matches_reference(tmp_path, family, grad_accum):
    """The step cuts the batch into ``[grad_accum, mb]`` chunks as the
    reference does (for MoE the aux loss is a product of batch means, so
    the chunking changes the loss in both packages alike)."""
    cfg, _, params, model = lm_pair(tmp_path, FAMILIES[family])
    b = _batch(cfg, B=4)
    want, jg = _sgd_step("ref", params, cfg, b, grad_accum)
    got, g = _sgd_step("port", model, cfg, b, grad_accum)
    np.testing.assert_allclose(got, want, **TOL)
    for k in jg:
        np.testing.assert_allclose(g[k], jg[k], rtol=0,
                                   atol=GRAD_TOL * np.abs(jg[k]).max(),
                                   err_msg=k)


def test_grad_accum_two_equals_one(tmp_path):
    """Without an aux loss, two half-batch means average to the batch
    mean."""
    cfg, _, _, model = lm_pair(tmp_path, FAMILIES["dense"])
    b = _batch(cfg, B=4)
    (l1, g1), (l2, g2) = (_sgd_step("port", model, cfg, b, ga)
                          for ga in (1, 2))
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(g2[k], g1[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("arch,reduced,budget", [
    ("gemma3_1b", False, 24.0), ("gemma3_1b", True, 8.0),
    ("rwkv6_3b", True, 1.0), ("whisper_base", True, 4.0)])
def test_mapper_microbatch_with_a_carried_dt_equals_reference(
        tmp_path, arch, reduced, budget):
    jcfg = jconfigs.get_config(arch, reduced=reduced)
    n = jtrain.lm_workload(jcfg, seq_len=128, batch=8, mode="train").n
    dt_cfg = jdt.DTConfig(n_blocks=1, n_heads=1, d_model=32, d_ff=64,
                          max_steps=max(16, n + 1))
    params = jdt.dt_init(jax.random.PRNGKey(3), dt_cfg)
    save_pytree(params, tmp_path / "dt")
    dt = dt_params_from_reference(load_reference(tmp_path / "dt"),
                                  n_heads=1, device=CPU)
    want = jtrain.mapper_microbatch(jcfg, seq_len=128, global_batch=8,
                                    act_budget_mb=budget, dt_params=params,
                                    dt_cfg=dt_cfg)
    got = ttrain.mapper_microbatch(
        tconfigs.get_config(arch, reduced=reduced), seq_len=128,
        global_batch=8, act_budget_mb=budget, dt_params=dt, device=CPU)
    np.testing.assert_array_equal(got["strategy"], want["strategy"])
    assert (got["micro_batch"], got["grad_accum"]) == \
        (want["micro_batch"], want["grad_accum"])
    assert got["speedup"] == pytest.approx(want["speedup"], rel=1e-5)


@pytest.mark.parametrize("arch,reduced", [("gemma3_1b", False),
                                          ("qwen3_moe_235b", True)])
def test_mapper_microbatch_search_is_as_good_as_the_reference(arch, reduced):
    want = jtrain.mapper_microbatch(jconfigs.get_config(arch, reduced=reduced),
                                    seq_len=128, global_batch=8,
                                    act_budget_mb=24.0)
    got = ttrain.mapper_microbatch(tconfigs.get_config(arch, reduced=reduced),
                                   seq_len=128, global_batch=8,
                                   act_budget_mb=24.0, device=CPU)
    assert got["speedup"] >= want["speedup"] * (1 - 1e-5)
    assert 8 % got["micro_batch"] == 0
    assert got["grad_accum"] * got["micro_batch"] == 8


# A run resumed in the other package continues within these tolerances of
# the first package's own run (N steps, resumed after K, where ``train``'s
# cadence max(N // 4, 10) saved): the loss within test_torch_train's
# LOSS_RTOL for the DT trainer, each parameter within 1e-6 (seen: 6e-8,
# f32 roundings of the two packages' gradients through nine AdamW steps).
N_STEPS, CRASH_AT = 20, 10
RESUME_TOL = dict(loss=dict(rtol=1e-5, atol=0), params=1e-6)


def _ref_train(d, **kw):
    return jtrain.train("gemma3_1b", steps=N_STEPS, ckpt_dir=str(d), **kw)


def _port_train(d, **kw):
    return ttrain.train("gemma3_1b", steps=N_STEPS, ckpt_dir=str(d),
                        device=CPU, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's run of N steps straight through, and its checkpoint
    directory after a crash at step K."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    for pkg, fn in (("ref", _ref_train), ("port", _port_train)):
        with pytest.raises(RuntimeError, match="simulated"):
            fn(root / f"{pkg}_crashed", crash_at=CRASH_AT)
        loop, _ = fn(root / f"{pkg}_straight")
        out[pkg] = {"crashed": root / f"{pkg}_crashed", "loop": loop}
    return out


def _final_params(pkg, loop) -> dict:
    if pkg == "port":
        return _stack(param_tree(loop.model), loop.model.cfg)
    return {k: np.asarray(v) for k, v in _flatten(loop.params)[0].items()}


@pytest.mark.parametrize("first,then", [("ref", "port"), ("port", "ref")])
def test_a_run_resumes_in_the_other_package(runs, tmp_path, first, then):
    """``first`` trains to step K (and crashes); ``then`` resumes from a copy
    of that directory to N, and ends where ``first``'s own straight run
    ended."""
    d = tmp_path / "resumed"
    shutil.copytree(runs[first]["crashed"], d)
    loop, _ = (_port_train if then == "port" else _ref_train)(d)
    assert loop.start_step == CRASH_AT + 1
    own = runs[first]["loop"]
    (s, got), (s_own, want) = loop.losses[-1], own.losses[-1]
    assert s == s_own == N_STEPS - 1
    np.testing.assert_allclose(got, want, **RESUME_TOL["loss"])
    a, b = _final_params(then, loop), _final_params(first, own)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0,
                                   atol=RESUME_TOL["params"], err_msg=k)


def test_training_checkpoints_convert_bit_exactly_both_ways(runs):
    """The reference's crash checkpoint -> the port's (model, AdamWState,
    step) -> the reference's tree again: every leaf's bytes and dtype."""
    ck = Checkpointer(runs["ref"]["crashed"])
    flat = restore_pytree(ck.path())
    model, opt, step = lm_train_state_from_reference(
        flat, tconfigs.get_config("gemma3_1b", reduced=True), device=CPU)
    assert step == CRASH_AT == ck.latest_step()
    assert int(opt.step) == CRASH_AT + 1
    back = {k: np.asarray(v) for k, v in _flatten_port(
        lm_train_state_to_reference(model, opt, step)).items()}
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        assert back[k].tobytes() == flat[k].tobytes(), k
    with pytest.raises(KeyError, match="opt/.nu"):
        lm_train_state_from_reference(
            {k: v for k, v in flat.items() if k != "opt/.nu/ln_f/g"},
            model.cfg, device=CPU)



def test_example_trains_with_a_learned_mapper(tmp_path, capsys):
    """``examples/train_with_mapper_torch.py`` at a tiny size on the CPU:
    corpus, DT training, the DT's micro-batch steering the LM's loop; a
    re-run reuses the mapper and resumes the finished loop."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
        "train_with_mapper_torch.py"
    spec = importlib.util.spec_from_file_location("_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--device", "cpu", "--steps", "4", "--mapper-steps", "20",
            "--artifacts", str(tmp_path)]
    loop, info = example.main(argv)
    assert info["micro_batch"] * info["grad_accum"] == 8
    assert [s for s, _ in loop.losses] == [0, 3] and loop.start_step == 0
    assert all(np.isfinite(l) for _, l in loop.losses)
    again, info2 = example.main(argv)
    assert "reusing it" in capsys.readouterr().out
    assert again.start_step == 4 and info2["micro_batch"] == \
        info["micro_batch"]
