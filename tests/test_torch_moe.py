"""Port parity: the mixture of experts and the MoE LMs (qwen3_moe_235b,
grok1_314b) against the JAX reference.

``moe_apply`` is held to ``repro.nn.moe.moe_apply`` at capacity factors
1.25 and 0.5 (where tokens are dropped); its integer routing (the chosen
experts ``idx``, the capacity ``C`` and the ``keep`` mask over the stably
sorted pairs) equals the reference's, computed from the reference's
router with the reference's own integer steps (``jax.lax.top_k``, a stable
``argsort``, ``searchsorted``; ``repro/nn/moe.py:63-83``).  The models are
reduced configs (2 layers, d 64, 4 experts top-2) with perturbed reference
weights; logits, the summed aux loss, prefill + decode and ``loss_fn``
within 2e-4 relative and absolute (the reference's model tolerance),
greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, lm_pair, serve_pair, to_np
from repro.nn import moe as jmoe
from repro_torch.models import lm as tlm
from repro_torch.nn import moe as tmoe

MOES = ["qwen3_moe_235b", "grok1_314b"]


def _moe_pair(d, d_ff, E, seed=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), d, d_ff, E)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype), p)
    t = tmoe.MoE(d, d_ff, E)
    t.load_state_dict({"router.w": torch.tensor(np.asarray(p["router"]["w"])),
                       **{k: torch.tensor(np.asarray(p[k]))
                          for k in ("gate", "up", "down")}})
    return p, t


def _reference_routing(p, x, top_k, cf):
    """idx [B,S,k], C and keep [B,S*k] by the reference's own steps."""
    B, S, _ = x.shape
    E = p["gate"].shape[0]
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"]["w"], axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    SK = S * top_k
    C = max(1, int(SK / E * cf))
    keeps = []
    for b in range(B):
        flat_e = idx[b].reshape(SK)
        se = flat_e[jnp.argsort(flat_e, stable=True)]
        pos = jnp.arange(SK) - jnp.searchsorted(se, jnp.arange(E))[se]
        keeps.append(np.asarray(pos < C))
    return np.asarray(idx), C, np.stack(keeps)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("B,S,d,d_ff,E,k", [(2, 40, 16, 24, 4, 2),
                                            (3, 17, 32, 16, 8, 3),
                                            (1, 1, 16, 24, 4, 2)])
def test_moe_apply_matches_reference(B, S, d, d_ff, E, k, cf):
    p, t = _moe_pair(d, d_ff, E)
    x = np.random.default_rng(1).normal(size=(B, S, d)).astype(np.float32)
    want, want_aux = jmoe.moe_apply(p, jnp.asarray(x), top_k=k,
                                    capacity_factor=cf)
    with torch.no_grad():
        got, aux = tmoe.moe_apply(t, torch.as_tensor(x), top_k=k,
                                  capacity_factor=cf)
        r = tmoe.moe_route(t, torch.as_tensor(x), top_k=k,
                           capacity_factor=cf)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    idx, C, keep = _reference_routing(p, x, k, cf)
    assert r.C == C
    np.testing.assert_array_equal(to_np(r.idx), idx)
    np.testing.assert_array_equal(to_np(r.keep), keep)
    if cf == 0.5 and S > 1:
        assert not keep.all()                     # tokens were dropped


def test_moe_drops_only_past_capacity():
    """Each expert keeps exactly min(count, C) pairs, in token order."""
    _, t = _moe_pair(16, 24, 4)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 64, 16)),
                        dtype=torch.float32)
    with torch.no_grad():
        r = tmoe.moe_route(t, x, top_k=2, capacity_factor=0.5)
    se = r.idx.reshape(2, -1).gather(1, r.order)
    for b in range(2):
        for e in range(4):
            kept = r.keep[b][se[b] == e]
            n = int(r.count[b, e])
            assert int(kept.sum()) == min(n, r.C)
            assert kept[:min(n, r.C)].all()


@pytest.fixture(scope="module", params=MOES)
def moe_lm(request, tmp_path_factory):
    return lm_pair(tmp_path_factory.mktemp("moe"), request.param)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_moe_forward_and_aux_match_reference(moe_lm, impl):
    cfg, jmod, params, model = moe_lm
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 40))
    want, want_aux = jmod.forward(params, cfg, {"tokens": jnp.asarray(
        toks, jnp.int32)}, impl="xla")
    got, aux = tlm.forward_aux(model, {"tokens": torch.as_tensor(toks)},
                               impl=impl)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    torch.testing.assert_close(
        tlm.forward(model, {"tokens": torch.as_tensor(toks)}, impl=impl),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_moe_prefill_and_decode_match_reference(moe_lm, ref_impl):
    cfg, jmod, params, model = moe_lm
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 24))
    want, got = serve_pair(jmod, params, cfg, tlm, model, {"tokens": toks},
                           32, 4, ref_impl, "kernel")
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_moe_loss_matches_reference(moe_lm):
    cfg, jmod, params, model = moe_lm
    rng = np.random.default_rng(3)
    b = {"tokens": rng.integers(0, cfg.vocab, (2, 40)),
         "labels": rng.integers(0, cfg.vocab, (2, 40))}
    want = jmod.loss_fn(params, cfg, {k: jnp.asarray(v, jnp.int32)
                                      for k, v in b.items()}, impl="xla")
    got = tlm.loss_fn(model, {k: torch.as_tensor(v) for k, v in b.items()},
                      impl="dense")
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    got.backward()
    assert model.blocks[0].moe.gate.grad is not None
    assert torch.isfinite(model.blocks[0].moe.router.w.grad).all()
    model.zero_grad(set_to_none=True)


def test_moe_forward_is_deterministic(moe_lm):
    _, _, _, model = moe_lm
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, 512, (2, 33)))
    a = tlm.forward_aux(model, {"tokens": toks})
    b = tlm.forward_aux(model, {"tokens": toks})
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
