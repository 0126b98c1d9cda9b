"""Port parity: the Qwen2-VL backbone (``qwen2_vl_72b``: M-RoPE over
precomputed input embeddings) against the JAX reference.

``mrope_freqs`` is held to the reference's at a text-only and an
image-grid ``pos_thw``; the reduced model (2 layers, d 64, sections (4, 2,
2)) with perturbed reference weights gives the reference's logits on
embeddings, with and without a position grid, its prefill + decode (zero
embeddings a step, as the reference serves) and its ``loss_fn``, within
2e-4 relative and absolute; greedy tokens equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, lm_pair, serve_pair, to_np
from repro.nn import rope as jrope
from repro_torch.models import lm as tlm
from repro_torch.nn import mrope_freqs, rope_freqs

NAME = "qwen2_vl_72b"


def _grid(B, S, side, offset=0):
    """pos_thw [3, B, S]: the first side*side positions an image grid (t
    fixed, h and w its rows and columns), then text positions continuing
    past the grid's largest id, as Qwen2-VL numbers them."""
    t = np.zeros(S, np.int64)
    h = np.zeros(S, np.int64)
    w = np.zeros(S, np.int64)
    n = side * side
    h[:n], w[:n] = np.divmod(np.arange(n), side)
    rest = np.arange(S - n) + side
    t[n:], h[n:], w[n:] = rest, rest, rest
    g = np.stack([t, h, w]) + offset
    return np.broadcast_to(g[:, None], (3, B, S)).copy()


@pytest.mark.parametrize("sections,hd", [((4, 2, 2), 16),
                                         ((16, 24, 24), 128)])
@pytest.mark.parametrize("kind", ["text", "grid"])
def test_mrope_freqs_match_reference(sections, hd, kind):
    B, S = 2, 40
    if kind == "text":
        pos = np.broadcast_to(np.arange(S), (3, B, S)).copy()
    else:
        pos = _grid(B, S, 4)
    cos, sin = mrope_freqs(torch.as_tensor(pos), hd, sections, 1e6)
    jcos, jsin = jrope.mrope_freqs(jnp.asarray(pos), hd, sections, 1e6)
    assert cos.shape == (B, S, hd // 2)
    np.testing.assert_allclose(to_np(cos), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(to_np(sin), np.asarray(jsin), atol=1e-6)
    if kind == "text":                # all three ids agree: plain RoPE
        rc, rs = rope_freqs(torch.arange(S), hd, 1e6)
        torch.testing.assert_close(cos[0], rc, rtol=0, atol=0)
        torch.testing.assert_close(sin[0], rs, rtol=0, atol=0)


def test_mrope_rejects_sections_not_summing_to_half():
    with pytest.raises(ValueError, match="sum"):
        mrope_freqs(torch.zeros(3, 4, dtype=torch.long), 16, (4, 2, 3))


@pytest.fixture(scope="module")
def vlm(tmp_path_factory):
    return lm_pair(tmp_path_factory.mktemp("vlm"), NAME)


@pytest.mark.parametrize("S", [40, 530])
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_vlm_forward_on_embeds_matches_reference(vlm, S, grid, impl):
    cfg, jmod, params, model = vlm
    e = np.random.default_rng(1).normal(size=(2, S, cfg.d_model))
    b = {"embeds": e.astype(np.float32)}
    if grid:
        b["pos_thw"] = _grid(2, S, 5)
    want, _ = jmod.forward(params, cfg, {k: jnp.asarray(v)
                                         for k, v in b.items()}, impl="xla")
    got = tlm.forward(model, {k: torch.as_tensor(v) for k, v in b.items()},
                      impl=impl)
    assert got.shape == (2, S, cfg.vocab_padded)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_vlm_embeds_are_not_scaled(vlm):
    """An embed_inputs config takes the embeddings as they are: scaling
    them changes the logits (the token path's sqrt(d) is not applied)."""
    _, _, _, model = vlm
    e = torch.as_tensor(np.random.default_rng(5).normal(size=(1, 8, 64)),
                        dtype=torch.float32)
    a = tlm.forward(model, {"embeds": e})
    b = tlm.forward(model, {"embeds": e * 8.0})
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_vlm_prefill_and_decode_match_reference(vlm, ref_impl):
    cfg, jmod, params, model = vlm
    e = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model))
    zero = np.zeros((2, 1, cfg.d_model), np.float32)
    want, got = serve_pair(jmod, params, cfg, tlm, model,
                           {"embeds": e.astype(np.float32)}, 32, 4, ref_impl,
                           "kernel", step_batch=lambda t: {"embeds": zero})
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_vlm_loss_matches_reference(vlm):
    cfg, jmod, params, model = vlm
    rng = np.random.default_rng(3)
    e = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    lab = rng.integers(0, cfg.vocab, (2, 40))
    want = jmod.loss_fn(params, cfg, {"embeds": jnp.asarray(e),
                                      "labels": jnp.asarray(lab, jnp.int32)},
                        impl="xla")
    got = tlm.loss_fn(model, {"embeds": torch.as_tensor(e),
                              "labels": torch.as_tensor(lab)}, impl="dense")
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
