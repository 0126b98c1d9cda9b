"""Port parity: the losses (``nn.losses``) and the LMs' ``loss_fn``
against the JAX reference.

``vocab_parallel_ce`` and ``fused_linear_ce`` (in one piece at S <= 512,
chunked at S 530 with a pad and pad labels -1 inside the sequence) give
the reference's value and gradients (against ``jax.grad``) within 1e-5;
``rwkv_lm.loss_fn`` and the dense ``lm.loss_fn`` give the reference's
loss within 2e-4 (the model tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, lm_pair, to_np
from repro.nn import losses as jloss
from repro_torch.models import lm as tlm, rwkv_lm as trwkv
from repro_torch.nn import losses as tloss


def _labels(rng, B, S, V, pads):
    lab = rng.integers(0, V, (B, S))
    if pads:
        lab[:, ::7] = -1
    return lab


@pytest.mark.parametrize("pads", [False, True])
@pytest.mark.parametrize("B,S,V", [(2, 9, 50), (1, 33, 512)])
def test_vocab_parallel_ce_matches_reference(B, S, V, pads):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(B, S, V)) * 3).astype(np.float32)
    lab = _labels(rng, B, S, V, pads)
    want = jloss.vocab_parallel_ce(jnp.asarray(logits),
                                   jnp.asarray(lab, jnp.int32))
    got = tloss.vocab_parallel_ce(torch.as_tensor(logits),
                                  torch.as_tensor(lab))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("S,pads", [(100, False), (512, True), (530, False),
                                    (530, True), (1100, True)])
def test_fused_linear_ce_value_and_grads_match_reference(S, pads):
    rng = np.random.default_rng(1)
    B, d, V = 2, 16, 96
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) / 4).astype(np.float32)
    lab = _labels(rng, B, S, V, pads)
    jl = jnp.asarray(lab, jnp.int32)
    want, (gx, gw) = jax.value_and_grad(
        lambda a, b: jloss.fused_linear_ce(a, b, jl), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = tloss.fused_linear_ce(tx, tw, torch.as_tensor(lab))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(tw.grad), np.asarray(gw), rtol=1e-5,
                               atol=1e-6)


def test_fused_linear_ce_chunks_equal_the_whole():
    """Past one chunk, the masked CE summed by chunks over B * S equals
    the one-piece masked mean's sum (labels all valid)."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(2, 700, 8)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(8, 40)), dtype=torch.float32)
    lab = torch.as_tensor(rng.integers(0, 40, (2, 700)))
    whole = tloss.vocab_parallel_ce(x @ w, lab)
    torch.testing.assert_close(tloss.fused_linear_ce(x, w, lab), whole,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,S", [("rwkv6_3b", 40), ("rwkv6_3b", 530),
                                    ("qwen3_8b", 40), ("gemma3_1b", 530)])
def test_model_loss_fn_matches_reference(tmp_path, name, S):
    cfg, jmod, params, model = lm_pair(tmp_path, name)
    rng = np.random.default_rng(3)
    b = {"tokens": rng.integers(0, cfg.vocab, (2, S)),
         "labels": _labels(rng, 2, S, cfg.vocab, True)}
    want = jmod.loss_fn(params, cfg, {k: jnp.asarray(v, jnp.int32)
                                      for k, v in b.items()}, impl="xla")
    tmod = trwkv if cfg.family == "ssm" else tlm
    got = tmod.loss_fn(model, {k: torch.as_tensor(v) for k, v in b.items()},
                       impl="dense")
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    got.backward()
    assert all(p.grad is not None for p in model.parameters())
