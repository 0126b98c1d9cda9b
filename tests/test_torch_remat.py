"""Block rematerialisation (``nn.transformer.remat_call``, the
``remat=`` of every family's ``loss_fn``; ``launch.steps.
build_train_step`` trains at ``remat="full"``, the reference's default):

- at ``remat="full"`` each family's loss and every gradient equal
  ``remat="none"``'s bit for bit (the recomputed forward is the same
  forward), and the reference's ``loss_fn(remat="full")`` gradients
  within ``GRAD_TOL`` of each leaf's largest;
- the recompute keeps fewer activations: a fake-tensor step of reduced
  qwen3_8b at 8 x 512 peaks lower at ``"full"``;
- an unknown ``remat`` raises.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, lm_pair
from repro.checkpoint.checkpointer import _flatten
from repro_torch.checkpoint.reference import _stack
from repro_torch.configs import Shape, get_config
from repro_torch.core.model import param_tree
from repro_torch.data import SyntheticLM
from repro_torch.launch import dryrun, train as ttrain
from repro_torch.models import registry
from repro_torch.nn.transformer import remat_call

FAMILIES = {"dense": "gemma3_1b", "moe": "qwen3_moe_235b", "ssm": "rwkv6_3b",
            "hybrid": "hymba_15b", "encdec": "whisper_base",
            "vlm": "qwen2_vl_72b"}
GRAD_TOL = 2e-4


def _batch(cfg, *, B=2, S=32) -> dict:
    src = SyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=1,
                      embed_dim=cfg.d_model if cfg.embed_inputs else None,
                      dec_len=max(S // 8, 8) if cfg.family == "encdec"
                      else None)
    b = src.batch_at(0)
    return {k: b[k] for k in ttrain.batch_keys(cfg)}


def _grads(model, loss) -> dict:
    pt = param_tree(model)
    g = torch.autograd.grad(loss, list(pt.values()), allow_unused=True,
                            materialize_grads=True)
    return dict(zip(pt, g))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_full_remat_equals_none_and_the_reference(tmp_path, family):
    cfg, jmod, params, model = lm_pair(tmp_path, FAMILIES[family])
    b = _batch(cfg)
    tb = {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind == "i"
                             else v) for k, v in b.items()}
    loss_fn = registry.get_model(model.cfg).loss_fn
    plain = loss_fn(model, tb, remat="none")
    g_plain = _grads(model, plain)
    full = loss_fn(model, tb, remat="full")
    g_full = _grads(model, full)
    assert torch.equal(full.detach(), plain.detach())
    for k in g_plain:
        assert torch.equal(g_full[k], g_plain[k]), k
    want, jg = jax.value_and_grad(lambda p: jmod.loss_fn(
        p, cfg, {k: jnp.asarray(v) for k, v in b.items()}, impl="xla",
        remat="full"))(params)
    jg = {k: np.asarray(v) for k, v in _flatten(jg)[0].items()}
    np.testing.assert_allclose(float(full.detach()), float(want), **TOL)
    got = _stack(g_full, model.cfg)
    assert sorted(got) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(got[k], jg[k], rtol=0,
                                   atol=GRAD_TOL * np.abs(jg[k]).max(),
                                   err_msg=k)


def test_full_remat_keeps_fewer_activations(monkeypatch):
    cfg = dryrun.with_layers(get_config("qwen3_8b", reduced=True), 4)
    shape = Shape("t", 512, 8, "train")
    run, peaks = dryrun._run_step, {}
    for remat in ("none", "full"):
        monkeypatch.setattr(dryrun, "_run_step",
                            functools.partial(run, remat=remat))
        peaks[remat] = dryrun._temporaries(cfg, shape, torch.float32)[0]
    assert 0 < peaks["full"] < peaks["none"], peaks


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="dots"):
        remat_call(torch.nn.Identity(), torch.ones(2), remat="dots")
