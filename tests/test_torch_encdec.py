"""Port parity: cross-attention and the Whisper-style encoder-decoder
(``whisper_base``) against the JAX reference.

``MHA(xkv=...)`` is held to ``repro.nn.attention.mha_apply(xkv=...)``;
the reduced model (2 + 2 layers, d 64, 4/2 heads, GELU MLPs, LayerNorm,
tied head) with perturbed reference weights gives the reference's decoder
logits, prefill + decode and ``loss_fn``, within 2e-4 relative and
absolute; greedy tokens equal.  The reference is run at ``impl="xla"``
only: at ``impl="pallas"`` its cross-attention reaches the Pallas
``flash_attention`` in interpret mode, which fails on this JAX (``pl.load``
is gone; ROADMAP queue 3), so it is no oracle here.
"""
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, lm_pair, serve_pair, to_np
from repro.nn import attention as jattn
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as ted
from repro_torch.nn import MHA

NAME = "whisper_base"


@pytest.mark.parametrize("S,T,Hq,Hkv", [(5, 40, 4, 2), (1, 40, 4, 4),
                                        (600, 33, 2, 1)])
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_cross_attention_matches_reference(S, T, Hq, Hkv, impl):
    d, hd = 32, 16
    p = jattn.mha_init(jax.random.PRNGKey(0), d, n_heads=Hq, kv_heads=Hkv,
                       head_dim=hd)
    rng = np.random.default_rng(0)
    p = jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype), p)
    m = MHA(d, n_heads=Hq, head_dim=hd, kv_heads=Hkv)
    m.load_state_dict({f"{k}.w": torch.tensor(np.asarray(p[k]["w"]))
                       for k in ("q", "k", "v", "o")})
    x = rng.normal(size=(2, S, d)).astype(np.float32)
    mem = rng.normal(size=(2, T, d)).astype(np.float32)
    cos, sin = (np.ones((S, hd // 2), np.float32),) * 2   # ignored by xkv
    want, _ = jattn.mha_apply(p, jnp.asarray(x), cos=jnp.asarray(cos),
                              sin=jnp.asarray(sin), xkv=jnp.asarray(mem),
                              causal=False, n_heads=Hq, kv_heads=Hkv,
                              head_dim=hd)
    with torch.no_grad():
        got, cache = m(torch.as_tensor(x), cos=torch.as_tensor(cos),
                       sin=torch.as_tensor(sin), xkv=torch.as_tensor(mem),
                       impl=impl)
    assert cache is None
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def whisper(tmp_path_factory):
    return lm_pair(tmp_path_factory.mktemp("wh"), NAME)


def _batch(cfg, S_enc, S_dec, seed):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.normal(size=(2, S_enc, cfg.d_model)).astype(
                np.float32),
            "tokens": rng.integers(0, cfg.vocab, (2, S_dec))}


@pytest.mark.parametrize("S_enc,S_dec", [(320, 40), (600, 9)])
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_whisper_forward_matches_reference(whisper, S_enc, S_dec, impl):
    cfg, jmod, params, model = whisper
    b = _batch(cfg, S_enc, S_dec, 1)
    want, _ = jmod.forward(params, cfg, {"embeds": jnp.asarray(b["embeds"]),
                                         "tokens": jnp.asarray(
                                             b["tokens"], jnp.int32)},
                           impl="xla")
    got = ted.forward(model, {k: torch.as_tensor(v) for k, v in b.items()},
                      impl=impl)
    assert got.shape == (2, S_dec, cfg.vocab_padded)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_whisper_prefill_and_decode_match_reference(whisper, impl):
    cfg, jmod, params, model = whisper
    b = _batch(cfg, 160, 20, 2)
    want, got = serve_pair(jmod, params, cfg, ted, model, b, 28, 4, "xla",
                           impl)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_whisper_decode_state_holds_the_memory(whisper):
    cfg, _, _, model = whisper
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 160, 20, 3).items()}
    _, st = ted.prefill(model, b, 28, cache_dtype=torch.float32)
    assert st["idx"] == 20 and st["memory"].shape == (2, 160, cfg.d_model)
    torch.testing.assert_close(st["memory"], ted._enc(model, b["embeds"],
                                                      "dense"))
    spec = ted.init_decode_state(cfg, 2, 28, device="cpu")
    assert spec["memory"].shape == (2, 28 * ted.DEC_FRAC, cfg.d_model)


def test_whisper_loss_matches_reference(whisper):
    cfg, jmod, params, model = whisper
    b = _batch(cfg, 320, 40, 4)
    b["labels"] = np.random.default_rng(5).integers(0, cfg.vocab, (2, 40))
    want = jmod.loss_fn(params, cfg, {
        "embeds": jnp.asarray(b["embeds"]),
        "tokens": jnp.asarray(b["tokens"], jnp.int32),
        "labels": jnp.asarray(b["labels"], jnp.int32)}, impl="xla")
    got = ted.loss_fn(model, {k: torch.as_tensor(v) for k, v in b.items()},
                      impl="dense")
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)


def test_serve_main_runs_whisper_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--arch", "whisper_base", "--device", "cpu",
                     "--prompt-len", "64", "--gen", "4"])
    text = out.getvalue()
    assert "tok/s" in text and "first sequence:" in text
