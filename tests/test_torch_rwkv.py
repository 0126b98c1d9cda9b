"""Port parity: the RWKV6 substrate (``wkv6`` twin, block, LM, serving)
against the JAX reference.

The recurrence is held to the reference's sequential ``nn.rwkv.wkv_scan``
(its ``ref.wkv6_ref``), the oracle, at the JAX sweep's shapes
(``tests/test_kernels.py:55-57``, decays in U(0.75, 0.9995)) and at strong
decay (U(0.05, 0.3)); to the reference's Pallas ``wkv6`` in interpret
mode at the sweep's mild decays only, since its chunked closed form fails
under strong decay (ROADMAP queue 3, reference fault 3); and the port's
``wkv_chunked`` to the reference's.  Tolerance: the sweep's 5e-5,
relative and absolute, in f32.

Model tests use the reduced config (2 layers, d 64, 4 heads x 16, vocab
512): the reference parameters come from ``rwkv_lm.init(PRNGKey(0), cfg,
f32)`` with every leaf perturbed by seeded numpy noise, are saved with
``save_pytree`` and carried in by ``lm_params_from_reference``.  Logits
are held within 2e-4 relative and absolute (the reference's own model
tolerance, ``tests/test_kernels.py:264``), at ``impl="kernel"`` against
the reference's ``"pallas"`` and at ``"dense"`` against its ``"xla"``;
greedy tokens are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, to_np
from repro import configs as jconfigs
from repro.checkpoint import save_pytree
from repro.kernels import ops as jops
from repro.models import rwkv_lm as jrwkv_lm
from repro.nn import rwkv as jrwkv
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import load_reference, lm_params_from_reference
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.launch import serve_greedy
from repro_torch.models import rwkv_lm as trwkv_lm
from repro_torch.nn import RWKVBlock
from repro_torch.nn import rwkv as trwkv

ARCH = "rwkv6_3b"
WKV_TOL = dict(rtol=5e-5, atol=5e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
SWEEP = [(1, 64, 2, 32, 32), (2, 130, 3, 64, 64), (1, 256, 1, 16, 64)]
DECAYS = {"mild": (0.75, 0.9995), "strong": (0.05, 0.3)}


def _wkv_inputs(B, T, H, n, decay="mild", seed=0):
    """numpy r, k, v, w, u, s0 (f32), w drawn from ``DECAYS[decay]``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(*DECAYS[decay], size=(B, T, H, n)).astype(np.float32)
    u = rng.normal(size=(H, n)).astype(np.float32)
    s0 = rng.normal(size=(B, H, n, n)).astype(np.float32)
    return r, k, v, w, u, s0


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _j_dict(d):
    return {k: jnp.asarray(a) for k, a in d.items()}


# -- the recurrence ----------------------------------------------------------

@pytest.mark.parametrize("decay", ["mild", "strong"])
@pytest.mark.parametrize("B,T,H,n,chunk", SWEEP)
def test_wkv6_plain_and_wkv_scan_match_reference_scan(B, T, H, n, chunk,
                                                      decay):
    ins = _wkv_inputs(B, T, H, n, decay)
    want_y, want_s = jrwkv.wkv_scan(*_j(ins))
    for fn in (rk.wkv6_plain, trwkv.wkv_scan):
        y, s = fn(*_t(ins))
        assert y.dtype == s.dtype == torch.float32
        np.testing.assert_allclose(to_np(y), np.asarray(want_y), **WKV_TOL)
        np.testing.assert_allclose(to_np(s), np.asarray(want_s), **WKV_TOL)


@pytest.mark.parametrize("B,T,H,n,chunk", SWEEP)
def test_wkv6_plain_matches_reference_pallas_at_mild_decay(B, T, H, n,
                                                           chunk):
    ins = _wkv_inputs(B, T, H, n, "mild", seed=1)
    want_y, want_s = jops.wkv6(*_j(ins), chunk=chunk, interpret=True)
    y, s = rk.wkv6_plain(*_t(ins))
    np.testing.assert_allclose(to_np(y), np.asarray(want_y), **WKV_TOL)
    np.testing.assert_allclose(to_np(s), np.asarray(want_s), **WKV_TOL)


@pytest.mark.parametrize("B,T,H,n,chunk", SWEEP)
def test_wkv_chunked_matches_reference_chunked(B, T, H, n, chunk):
    ins = _wkv_inputs(B, T, H, n, "mild", seed=2)
    want_y, want_s = jrwkv.wkv_chunked(*_j(ins))
    y, s = trwkv.wkv_chunked(*_t(ins))
    np.testing.assert_allclose(to_np(y), np.asarray(want_y), **WKV_TOL)
    np.testing.assert_allclose(to_np(s), np.asarray(want_s), **WKV_TOL)


def test_cpu_wrapper_runs_plain_twin_and_counts_no_launch():
    r, k, v, w, u, s0 = _t(_wkv_inputs(2, 130, 3, 64))
    before = rk.STATS.launches
    y, s = rk.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u, s0,
                   chunk=64)
    assert rk.STATS.launches == before
    want = rk.wkv6_plain(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u, s0)
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])
    assert y.dtype == torch.float32 and y.shape == (2, 130, 3, 64)
    # a strided view of each input is taken as it is
    rkvw = torch.stack([r, k, v, w], 2)
    y2, _ = rk.wkv6(*rkvw.unbind(2), u, s0)
    assert torch.equal(y2, rk.wkv6_plain(r, k, v, w, u, s0)[0])


def _bad_wkv(case):
    r, k, v, w, u, s0 = _t(_wkv_inputs(1, 8, 2, 16))
    args = dict(r=r, k=k, v=v, w=w, u=u, s0=s0)
    if case == "dtype_rkv":
        args["k"] = k.bfloat16()
    elif case == "dtype_f16":
        args.update(r=r.half(), k=k.half(), v=v.half())
    elif case == "dtype_w":
        args["w"] = w.bfloat16()
    elif case == "shape_w":
        args["w"] = w[:, :4]
    elif case == "shape_s0":
        args["s0"] = s0[:, :1]
    elif case == "head_dim":
        args.update({n: a[..., :12] for n, a in
                     (("r", r), ("k", k), ("v", v), ("w", w), ("u", u))})
        args["s0"] = s0[..., :12, :12]
    elif case == "strided":
        args["r"] = r.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "device":
        args["v"] = v.to("meta")
    elif case == "meta":
        args = {n: a.to("meta") for n, a in args.items()}
    elif case == "chunk":
        return args, dict(chunk=0)
    return args, {}


@pytest.mark.parametrize("case,exc", [
    ("dtype_rkv", TypeError), ("dtype_f16", TypeError), ("dtype_w", TypeError),
    ("shape_w", ValueError), ("shape_s0", ValueError),
    ("head_dim", ValueError), ("strided", ValueError), ("device", ValueError),
    ("meta", ValueError), ("chunk", ValueError)])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, exc):
    args, kw = _bad_wkv(case)
    before = rk.STATS.launches
    with pytest.raises(exc):
        rk.wkv6(*args.values(), **kw)
    assert rk.STATS.launches == before


# -- the block and the LM ----------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = torch.as_tensor(np.array(val))
    return out


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype),
        tree)


@pytest.mark.parametrize("impl,ref_impl", [("kernel", "pallas"),
                                           ("dense", "xla")])
@pytest.mark.parametrize("with_state", [False, True])
def test_block_matches_reference(impl, ref_impl, with_state):
    cfg = jconfigs.get_config(ARCH, reduced=True)
    p = _noisy(jrwkv.rwkv_block_init(jax.random.PRNGKey(0), cfg.d_model,
                                     n_heads=cfg.n_heads, head_dim=cfg.hd,
                                     d_ff=cfg.d_ff, dtype=jnp.float32), 0)
    blk = RWKVBlock(cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.hd,
                    d_ff=cfg.d_ff)
    blk.load_state_dict(_flatten(p), strict=True)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 70, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"s": rng.normal(size=(2, cfg.n_heads, cfg.hd, cfg.hd)),
                 "x_tm": rng.normal(size=(2, cfg.d_model)),
                 "xc_tm": rng.normal(size=(2, cfg.d_model))}
        state = {k: a.astype(np.float32) for k, a in state.items()}
    want, want_st = jrwkv.rwkv_block_apply(
        p, jnp.asarray(x), n_heads=cfg.n_heads, head_dim=cfg.hd,
        state=None if state is None else _j_dict(state), impl=ref_impl)
    with torch.no_grad():
        got, got_st = blk(torch.as_tensor(x), impl=impl,
                          state=None if state is None else
                          {k: torch.as_tensor(a) for k, a in state.items()})
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert (got_st is None) == (want_st is None)
    if with_state:
        for key in ("s", "x_tm", "xc_tm"):
            np.testing.assert_allclose(to_np(got_st[key]),
                                       np.asarray(want_st[key]), **TOL)


def test_block_rejects_an_unknown_impl():
    blk = RWKVBlock(64, n_heads=4, head_dim=16, d_ff=128)
    with pytest.raises(ValueError, match="impl"):
        blk(torch.zeros(1, 3, 64), impl="pallas")


def _pair(tmp_path, seed=0):
    """(reference cfg, perturbed reference params, port model)."""
    cfg = jconfigs.get_config(ARCH, reduced=True)
    params = _noisy(jrwkv_lm.init(jax.random.PRNGKey(seed), cfg,
                                  dtype=jnp.float32), seed)
    save_pytree(params, tmp_path / ARCH)
    model = lm_params_from_reference(load_reference(tmp_path / ARCH),
                                     tconfigs.get_config(ARCH, reduced=True),
                                     device=CPU)
    return cfg, params, model


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("rwkv"))


def test_converted_parameters_split_the_stacked_layers(pair):
    cfg, params, model = pair
    assert isinstance(model, trwkv_lm.RWKVLM)
    assert len(model.blocks) == cfg.n_layers
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        b = model.blocks[i]
        for got, want in ((b.mu["r"], blocks["mu"]["r"]),
                          (b.mu_c["k"], blocks["mu_c"]["k"]),
                          (b.w0, blocks["w0"]), (b.u, blocks["u"]),
                          (b.gn.g, blocks["gn"]["g"]),
                          (b.w1.w, blocks["w1"]["w"]),
                          (b.cv.w, blocks["cv"]["w"])):
            np.testing.assert_array_equal(to_np(got), np.asarray(want[i]))
    np.testing.assert_array_equal(to_np(model.head.w),
                                  np.asarray(params["head"]["w"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("case,exc,match", [
    ("missing", RuntimeError, "Missing"),
    ("extra", RuntimeError, "Unexpected"),
    ("misshapen", RuntimeError, "size mismatch"),
    ("layers", ValueError, "layers")])
def test_conversion_raises_on_missing_extra_or_misshapen_leaves(
        tmp_path, case, exc, match):
    _pair(tmp_path)
    flat = load_reference(tmp_path / ARCH)
    cfg = tconfigs.get_config(ARCH, reduced=True)
    if case == "missing":
        flat = {k: v for k, v in flat.items() if k != "blocks/mu_c/r"}
    elif case == "extra":
        flat = dict(flat, **{"blocks/mu/z": flat["blocks/mu/r"]})
    elif case == "misshapen":
        flat = dict(flat, **{"blocks/u": flat["blocks/u"][:, :2]})
    else:
        flat = dict(flat, **{"blocks/w0": flat["blocks/w0"][:1]})
    with pytest.raises(exc, match=match):
        lm_params_from_reference(flat, cfg, device=CPU)


@pytest.mark.parametrize("S", [40, 130])
@pytest.mark.parametrize("impl,ref_impl", [("kernel", "pallas"),
                                           ("dense", "xla")])
def test_forward_matches_reference(pair, S, impl, ref_impl):
    cfg, params, model = pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    want, _ = jrwkv_lm.forward(params, cfg, {"tokens": jnp.asarray(
        toks, jnp.int32)}, impl=ref_impl)
    got = trwkv_lm.forward(model, {"tokens": torch.as_tensor(toks)},
                           impl=impl)
    assert got.shape == (2, S, cfg.vocab_padded)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def _jax_serve(params, cfg, toks, steps, impl):
    logits, state = jrwkv_lm.prefill(params, cfg, {"tokens": jnp.asarray(
        toks, jnp.int32)}, 0, impl=impl, cache_dtype=jnp.float32)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(steps):
        logits, state = jrwkv_lm.decode_step(params, cfg, state,
                                             {"tokens": tok}, impl=impl)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    out = np.concatenate(out, 1)
    return out, out.argmax(-1)


def _port_serve(model, toks, steps, impl):
    logits, state = trwkv_lm.prefill(model, {"tokens": torch.as_tensor(toks)},
                                     toks.shape[1] + steps, impl=impl,
                                     cache_dtype=torch.float32)
    out = [logits]
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, state = trwkv_lm.decode_step(model, state, {"tokens": tok},
                                             impl=impl)
        out.append(logits)
    return to_np(torch.cat(out, 1)), state


@pytest.fixture(scope="module")
def served(pair):
    """The reference's prefill over a 100-token prompt and 4 greedy decode
    steps, at impl="xla" and impl="pallas"."""
    cfg, params, model = pair
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 100))
    ref = {impl: _jax_serve(params, cfg, toks, 4, impl)
           for impl in ("xla", "pallas")}
    return model, toks, ref


@pytest.mark.parametrize("impl,ref_impl", [("kernel", "pallas"),
                                           ("dense", "xla"),
                                           ("kernel", "xla")])
def test_prefill_and_decode_match_reference(served, impl, ref_impl):
    model, toks, ref = served
    want, want_tok = ref[ref_impl]
    got, state = _port_serve(model, toks, 4, impl)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want_tok)
    cfg = model.cfg
    assert state["s"].shape == (cfg.n_layers, 2, cfg.n_heads, cfg.hd, cfg.hd)
    assert state["x_tm"].shape == state["xc_tm"].shape == \
        (cfg.n_layers, 2, cfg.d_model)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_decode_reproduces_forward(served, impl):
    """Within the port: prefill + decode logits equal a forward over the
    prompt and the greedy tokens at the same positions."""
    model, toks, _ = served
    got, _ = _port_serve(model, toks, 4, impl)
    seq = np.concatenate([toks, got.argmax(-1)[:, :-1]], 1)
    fwd = to_np(trwkv_lm.forward(model, {"tokens": torch.as_tensor(seq)},
                                 impl=impl))
    np.testing.assert_allclose(got, fwd[:, 99:], **TOL)


def test_decode_state_is_o1_in_max_len_and_typed():
    cfg = tconfigs.get_config(ARCH, reduced=True)
    a = trwkv_lm.init_decode_state(cfg, 3, 8, device=CPU)
    b = trwkv_lm.init_decode_state(cfg, 3, 4096, dtype=torch.float32,
                                   device=CPU)
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}
    assert a["s"].dtype == b["s"].dtype == torch.float32
    assert a["x_tm"].dtype == torch.bfloat16 and b["x_tm"].dtype == \
        torch.float32
    assert not any(v.any() for v in a.values())
    a["s"][0] += 1                       # the layers do not share storage
    assert not a["s"][1].any()


def test_serve_greedy_is_seeded_and_consistent():
    kw = dict(batch=2, prompt_len=12, gen_len=5, reduced=True, device=CPU)
    a = serve_greedy(ARCH, seed=3, keep_logits=True, **kw)
    b = serve_greedy(ARCH, seed=3, impl="dense", **kw)
    assert a["tokens"].shape == (2, 5) and a["prompt"].shape == (2, 12)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["prompt"], b["prompt"])
    np.testing.assert_array_equal(to_np(a["logits"].argmax(-1)), a["tokens"])
    assert a["logits"].shape == (2, 5, 512) and "logits" not in b
    c = serve_greedy(ARCH, seed=4, **kw)
    assert not np.array_equal(a["prompt"], c["prompt"])
