"""Port parity: the dense LM substrate against the JAX reference.

Configs are copies and must be equal.  Model tests use reduced configs:
the reference parameters come from ``lm.init(PRNGKey(0), cfg, f32)`` with
every leaf (norm gains and biases too) perturbed by seeded numpy noise,
are saved with ``save_pytree``, read back through the port's
``load_reference`` and carried in by ``lm_params_from_reference``.  Logits
are held to the reference's ``impl="xla"`` (and, for decode, to its
``impl="pallas"``, whose single-token steps run the Pallas
``flash_decode`` in interpret mode) within 2e-4 relative and absolute,
the reference's own model tolerance (``tests/test_kernels.py:264``);
greedy tokens are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, to_np
from repro import configs as jconfigs
from repro.checkpoint import save_pytree
from repro.models import lm as jlm
from repro.nn import norms as jnorms, rope as jrope, transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import load_reference, lm_params_from_reference
from repro_torch.launch import serve_greedy
from repro_torch.models import get_model, lm as tlm, rwkv_lm as trwkv_lm
from repro_torch.nn import MLP, RMSNorm, apply_rope, rope_freqs

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_are_the_reference_configs(name, reduced):
    want = jconfigs.get_config(name, reduced=reduced)
    got = tconfigs.get_config(name, reduced=reduced)
    want_d, got_d = dataclasses.asdict(want), dataclasses.asdict(got)
    assert {k: got_d[k] for k in want_d} == want_d
    # the port-only fields (latent attention, the sigmoid router, ...) hold
    # their defaults, which do what the reference does
    extra = {f.name: f.default for f in dataclasses.fields(got)
             if f.name not in want_d}
    assert {k: got_d[k] for k in extra} == extra
    assert (got.hd, got.vocab_padded, got.windows(), got.param_count()) == \
        (want.hd, want.vocab_padded, want.windows(), want.param_count())


def test_cells_and_shapes_are_the_reference_ones():
    assert list(tconfigs.cells(include_skipped=True)) == \
        list(jconfigs.cells(include_skipped=True))
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


def test_rmsnorm_rope_and_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    g = rng.normal(1.0, 0.1, size=16).astype(np.float32)
    norm = RMSNorm(16)
    norm.g.data = torch.as_tensor(g)
    np.testing.assert_allclose(
        to_np(norm(torch.as_tensor(x))),
        np.asarray(jnorms.rmsnorm_apply({"g": jnp.asarray(g)},
                                        jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)
    pos = np.arange(5, 14)
    cos, sin = rope_freqs(torch.as_tensor(pos), 16, 1e6)
    jcos, jsin = jrope.rope_freqs(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(to_np(cos), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(
        to_np(apply_rope(torch.as_tensor(x), cos, sin)),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jcos, jsin)), atol=1e-5)
    w = {k: rng.normal(size=s).astype(np.float32) / 4
         for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                      ("down", (24, 16)))}
    mlp = MLP(16, 24)
    for k, a in w.items():
        getattr(mlp, k).w.data = torch.as_tensor(a)
    np.testing.assert_allclose(
        to_np(mlp(torch.as_tensor(x))),
        np.asarray(jtf.mlp_apply({k: {"w": jnp.asarray(a)}
                                  for k, a in w.items()}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def _pair(tmp_path, name, seed=0):
    """(reference cfg, perturbed reference params, port model)."""
    cfg = jconfigs.get_config(name, reduced=True)
    params = jlm.init(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype),
        params)
    save_pytree(params, tmp_path / name)
    model = lm_params_from_reference(load_reference(tmp_path / name),
                                     tconfigs.get_config(name, reduced=True),
                                     device=CPU)
    return cfg, params, model


def test_converted_parameters_split_the_stacked_layers(tmp_path):
    cfg, params, model = _pair(tmp_path, "qwen3_8b")
    assert len(model.blocks) == cfg.n_layers
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            to_np(model.blocks[i].attn.qn.g),
            np.asarray(params["blocks"]["attn"]["qn"]["g"][i]))
        np.testing.assert_array_equal(
            to_np(model.blocks[i].mlp.gate.w),
            np.asarray(params["blocks"]["mlp"]["gate"]["w"][i]))
    np.testing.assert_array_equal(to_np(model.head_w()),
                                  np.asarray(params["head"]["w"]))


def test_conversion_raises_on_missing_extra_or_misshapen_leaves(tmp_path):
    _pair(tmp_path, "qwen3_8b")
    flat = load_reference(tmp_path / "qwen3_8b")
    cfg = tconfigs.get_config("qwen3_8b", reduced=True)
    bad = {k: v for k, v in flat.items() if k != "blocks/attn/kn/g"}
    with pytest.raises(RuntimeError, match="Missing"):
        lm_params_from_reference(bad, cfg, device=CPU)
    with pytest.raises(RuntimeError, match="Unexpected"):
        lm_params_from_reference(dict(flat, extra=np.zeros(3)), cfg,
                                 device=CPU)
    with pytest.raises(RuntimeError, match="size mismatch"):
        lm_params_from_reference(dict(flat, **{"ln_f/g": np.ones(3)}), cfg,
                                 device=CPU)
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_reference(
            dict(flat, **{"blocks/ln1/g": flat["blocks/ln1/g"][:1]}), cfg,
            device=CPU)


_NEW_LEAVES = {
    "qwen3_moe_235b": [("blocks/moe/router/w", "blocks.{i}.moe.router.w"),
                       ("blocks/moe/gate", "blocks.{i}.moe.gate"),
                       ("blocks/moe/down", "blocks.{i}.moe.down")],
    "grok1_314b": [("blocks/moe/up", "blocks.{i}.moe.up")],
    "qwen2_vl_72b": [("blocks/attn/q/b", "blocks.{i}.attn.q.b")],
    "hymba_15b": [("blocks/ssm/conv", "blocks.{i}.ssm.conv"),
                  ("blocks/ssm/A_log", "blocks.{i}.ssm.A_log"),
                  ("blocks/ssm/wdt2/b", "blocks.{i}.ssm.wdt2.b"),
                  ("blocks/na/g", "blocks.{i}.na.g"),
                  ("blocks/ns/g", "blocks.{i}.ns.g")],
    "whisper_base": [("enc_blocks/attn/q/w", "enc_blocks.{i}.attn.q.w"),
                     ("dec_blocks/xattn/k/w", "dec_blocks.{i}.xattn.k.w"),
                     ("dec_blocks/lnx/b", "dec_blocks.{i}.lnx.b"),
                     ("pos/emb", "pos.emb"), ("enc_ln/g", "enc_ln.g")],
}


@pytest.mark.parametrize("name", sorted(_NEW_LEAVES))
def test_conversion_carries_every_family(tmp_path, name):
    """Each new family's leaves (MoE experts and router, SSM, Hymba's path
    norms, Whisper's two stacks, cross-attention and positions) land in
    the port's modules, and a missing, extra or misshapen one raises."""
    from repro.models import registry as jreg
    cfg = jconfigs.get_config(name, reduced=True)
    params = jreg.get_model(cfg).init(jax.random.PRNGKey(0), cfg,
                                      dtype=jnp.float32)
    save_pytree(params, tmp_path / name)
    flat = load_reference(tmp_path / name)
    tcfg = tconfigs.get_config(name, reduced=True)
    state = lm_params_from_reference(flat, tcfg, device=CPU).state_dict()
    assert len(state) == sum(
        v.shape[0] if k.split("/")[0].endswith("blocks") else 1
        for k, v in flat.items())
    for ref, port in _NEW_LEAVES[name]:
        rows = range(flat[ref].shape[0]) if "{i}" in port else [None]
        for i in rows:
            want = flat[ref] if i is None else flat[ref][i]
            np.testing.assert_array_equal(to_np(state[port.format(i=i)]),
                                          want)
    key = _NEW_LEAVES[name][0][0]
    with pytest.raises(RuntimeError, match="Missing"):
        lm_params_from_reference({k: v for k, v in flat.items() if k != key},
                                 tcfg, device=CPU)
    with pytest.raises(RuntimeError, match="Unexpected"):
        lm_params_from_reference(dict(flat, extra=np.zeros(3)), tcfg,
                                 device=CPU)
    with pytest.raises((RuntimeError, ValueError)):
        lm_params_from_reference(dict(flat, **{key: flat[key][..., :1]}),
                                 tcfg, device=CPU)


@pytest.mark.parametrize("name,S", [("qwen3_8b", 40), ("qwen15_4b", 40),
                                    ("minitron_4b", 40), ("gemma3_1b", 48),
                                    ("qwen3_8b", 530)])
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_forward_matches_reference(tmp_path, name, S, impl):
    """qwen3 (GQA + qk-norm), qwen1.5 (QKV bias, MHA), minitron (GQA),
    gemma3 (tied embeddings, 32-token windows at S 48) and a chunked S."""
    cfg, params, model = _pair(tmp_path, name)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))
    want, _ = jlm.forward(params, cfg, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)},
                          impl="xla")
    got = tlm.forward(model, {"tokens": torch.as_tensor(toks)}, impl=impl)
    assert got.shape == (2, S, cfg.vocab_padded)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def _jax_serve(params, cfg, toks, max_len, steps, impl):
    logits, state = jlm.prefill(params, cfg, {"tokens": jnp.asarray(
        toks, jnp.int32)}, max_len, impl=impl, cache_dtype=jnp.float32)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for _ in range(steps):
        logits, state = jlm.decode_step(params, cfg, state, {"tokens": tok},
                                        impl=impl)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    return np.concatenate(out, 1), np.concatenate(out, 1).argmax(-1)


def _port_serve(model, toks, max_len, steps, impl):
    logits, state = tlm.prefill(model, {"tokens": torch.as_tensor(toks)},
                                max_len, impl=impl,
                                cache_dtype=torch.float32)
    out = [logits]
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, state = tlm.decode_step(model, state, {"tokens": tok},
                                        impl=impl)
        out.append(logits)
    assert state["idx"] == toks.shape[1] + steps
    return to_np(torch.cat(out, 1))


@pytest.fixture(scope="module")
def served_qwen3(tmp_path_factory):
    """The reference's prefill over a 520-token prompt (the chunked path)
    and 4 greedy decode steps, at impl="xla" and impl="pallas"."""
    cfg, params, model = _pair(tmp_path_factory.mktemp("ck"), "qwen3_8b")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 520))
    ref = {impl: _jax_serve(params, cfg, toks, 540, 4, impl)
           for impl in ("xla", "pallas")}
    return model, toks, ref


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_prefill_and_decode_match_reference(served_qwen3, impl, ref_impl):
    model, toks, ref = served_qwen3
    want, want_tok = ref[ref_impl]
    got = _port_serve(model, toks, 540, 4, impl)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want_tok)


def test_decode_reproduces_forward(served_qwen3):
    """Within the port: prefill + decode logits equal a forward over the
    prompt and the greedy tokens, through either impl."""
    model, toks, _ = served_qwen3
    got = _port_serve(model, toks, 540, 4, "kernel")
    seq = np.concatenate([toks, got.argmax(-1)[:, :-1]], 1)
    fwd = to_np(tlm.forward(model, {"tokens": torch.as_tensor(seq)}))
    np.testing.assert_allclose(got, fwd[:, 519:], **TOL)


def test_serve_greedy_is_seeded_and_consistent():
    a = serve_greedy("qwen3_8b", batch=2, prompt_len=12, gen_len=5,
                     reduced=True, seed=3, device=CPU, keep_logits=True)
    b = serve_greedy("qwen3_8b", batch=2, prompt_len=12, gen_len=5,
                     reduced=True, seed=3, device=CPU, impl="dense")
    assert a["tokens"].shape == (2, 5) and a["prompt"].shape == (2, 12)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["prompt"], b["prompt"])
    np.testing.assert_array_equal(to_np(a["logits"].argmax(-1)), a["tokens"])
    assert a["logits"].shape == (2, 5, 512) and "logits" not in b
    assert a["tok_per_s"] > 0 and a["t_prefill_s"] > 0
    c = serve_greedy("qwen3_8b", batch=2, prompt_len=12, gen_len=5,
                     reduced=True, seed=4, device=CPU)
    assert not np.array_equal(a["prompt"], c["prompt"])


_FAMILY_MODULE = {"dense": "lm", "moe": "lm", "vlm": "lm", "ssm": "rwkv_lm",
                  "hybrid": "hymba", "encdec": "encdec"}


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_every_family_maps_to_its_model(name):
    """Every config builds: ``get_model`` returns its family's module, whose
    model class takes the reduced config on the CPU and which has a
    ``loss_fn``."""
    from repro_torch import models
    cfg = tconfigs.get_config(name, reduced=True)
    mod = get_model(cfg)
    assert mod is getattr(models, _FAMILY_MODULE[cfg.family])
    for fn in ("init", "forward", "loss_fn", "init_decode_state", "prefill",
               "decode_step"):
        assert callable(getattr(mod, fn)), fn
    model = mod.init(cfg, seed=0, dtype=torch.float32, device=CPU)
    assert isinstance(model, mod.MODEL) and model.cfg == cfg


def test_dense_family_maps_to_lm():
    assert get_model(tconfigs.get_config("qwen3_8b")) is tlm
    assert get_model(tconfigs.get_config("gemma3_1b")) is tlm


def test_ssm_family_maps_to_rwkv_lm():
    assert get_model(tconfigs.get_config("rwkv6_3b")) is trwkv_lm
    assert trwkv_lm.MODEL is trwkv_lm.RWKVLM
