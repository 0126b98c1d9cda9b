"""Port parity: the selective SSM and the Hymba hybrid LM (``hymba_15b``)
against the JAX reference.

``SSM`` is held to ``repro.nn.ssm.ssm_apply`` with and without a state,
and a decode state carried step by step equals one pass over the whole
sequence (both packages).  The reduced model (2 layers, d 64, SSM state 8,
windows of 32) with perturbed reference weights gives the reference's
logits at S 48 and 530 (past the window, and the chunked attention), its
prefill + decode (the reference at ``impl="xla"`` and ``"pallas"``) and
its ``loss_fn``, within 2e-4 relative and absolute; greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, lm_pair, serve_pair, to_np
from repro.nn import ssm as jssm
from repro_torch.models import hymba as thy
from repro_torch.nn import SSM, ssm_init_state

NAME = "hymba_15b"


def _ssm_pair(d, N, K, seed=0):
    p = jssm.ssm_init(jax.random.PRNGKey(seed), d, state=N, conv=K)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype), p)
    t = SSM(d, state=N, conv=K)
    flat = {"conv": p["conv"], "wbc.w": p["wbc"]["w"],
            "wdt1.w": p["wdt1"]["w"], "wdt2.w": p["wdt2"]["w"],
            "wdt2.b": p["wdt2"]["b"], "A_log": p["A_log"], "D": p["D"]}
    t.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in flat.items()})
    return p, t


@pytest.mark.parametrize("d,N,K,T", [(32, 8, 4, 40), (64, 16, 4, 7),
                                     (16, 4, 2, 1)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_matches_reference(d, N, K, T, with_state):
    p, t = _ssm_pair(d, N, K)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, T, d)).astype(np.float32)
    jst = tst = None
    if with_state:                    # a non-zero state from a first pass
        x0 = rng.normal(size=(2, 5, d)).astype(np.float32)
        _, jst = jssm.ssm_apply(p, jnp.asarray(x0),
                                state=jssm.ssm_init_state(2, d, N, K))
        with torch.no_grad():
            _, tst = t(torch.as_tensor(x0),
                       state=ssm_init_state(2, d, N, K))
    want, jnew = jssm.ssm_apply(p, jnp.asarray(x), state=jst)
    with torch.no_grad():
        got, tnew = t(torch.as_tensor(x), state=tst)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    if with_state:
        for key in ("h", "cwin"):
            np.testing.assert_allclose(to_np(tnew[key]),
                                       np.asarray(jnew[key]), rtol=1e-4,
                                       atol=1e-4)
    else:
        assert tnew is None and jnew is None


def test_ssm_decode_state_equals_one_pass():
    """Feeding tokens one at a time through the carried state gives the
    one-pass outputs and final state."""
    _, t = _ssm_pair(32, 8, 4)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 12, 32)),
                        dtype=torch.float32)
    with torch.no_grad():
        whole, st_whole = t(x, state=ssm_init_state(2, 32, 8, 4))
        st = ssm_init_state(2, 32, 8, 4)
        steps = []
        for i in range(12):
            y, st = t(x[:, i:i + 1], state=st)
            steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), whole, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(st["h"], st_whole["h"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st["cwin"], st_whole["cwin"], rtol=0, atol=0)


@pytest.fixture(scope="module")
def hymba(tmp_path_factory):
    return lm_pair(tmp_path_factory.mktemp("hy"), NAME)


@pytest.mark.parametrize("S", [48, 530])
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_hymba_forward_matches_reference(hymba, S, impl):
    cfg, jmod, params, model = hymba
    assert max(cfg.windows()) == 32 < S
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    want, _ = jmod.forward(params, cfg, {"tokens": jnp.asarray(
        toks, jnp.int32)}, impl="xla")
    got = thy.forward(model, {"tokens": torch.as_tensor(toks)}, impl=impl)
    assert got.shape == (2, S, cfg.vocab_padded)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_hymba_prefill_and_decode_match_reference(hymba, ref_impl):
    """A 40-token prompt (past the window) and 4 decode steps."""
    cfg, jmod, params, model = hymba
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 40))
    want, got = serve_pair(jmod, params, cfg, thy, model, {"tokens": toks},
                           48, 4, ref_impl, "kernel")
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_hymba_decode_reproduces_forward(hymba):
    """Within the port: prefill + decode logits equal a forward over the
    prompt and the greedy tokens (the carried KV and SSM states)."""
    cfg, _, _, model = hymba
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 36)))
    logits, st = thy.prefill(model, {"tokens": toks}, 48,
                             cache_dtype=torch.float32)
    out, seq = [logits], [toks]
    for _ in range(5):
        tok = logits[:, -1].argmax(-1)[:, None]
        seq.append(tok)
        logits, st = thy.decode_step(model, st, {"tokens": tok})
        out.append(logits)
    assert st["kv"]["idx"] == 41
    fwd = thy.forward(model, {"tokens": torch.cat(seq, 1)})
    torch.testing.assert_close(torch.cat(out, 1), fwd[:, 35:], **TOL)


def test_hymba_loss_matches_reference(hymba):
    cfg, jmod, params, model = hymba
    rng = np.random.default_rng(4)
    b = {"tokens": rng.integers(0, cfg.vocab, (2, 48)),
         "labels": rng.integers(0, cfg.vocab, (2, 48))}
    want = jmod.loss_fn(params, cfg, {k: jnp.asarray(v, jnp.int32)
                                      for k, v in b.items()}, impl="xla")
    got = thy.loss_fn(model, {k: torch.as_tensor(v) for k, v in b.items()},
                      impl="dense")
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
