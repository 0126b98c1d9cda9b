"""Latent attention (MLA), the dropless sigmoid-routed MoE with shared
experts, and the DeepSeek-V3 LM (``moonlight_16b_a3b``) against the plain
f32 reference ``perfbench/reference/deepseek_v3.py`` on the CPU.

A tiny config (d 64, 4 heads, latent 32, q/k 16 + 8 rope, v 16; 8 experts
of 32, top 2, 1 shared; 3 layers, the first dense of 128) in f32.  The
port and the reference compute the same products in f32 in other orders
(grouped products against one product an expert, a fused latent head
split against separate ones, the absorbed decode against up-projected
keys), so the tolerances are a few hundred f32 roundings: 2e-5 relative
to the largest output for one layer (two to four products deep), 1e-4 for
the logits of the whole 3-layer model and of each decode step, as
``perfbench/tests/test_perfbench_reference.py`` holds the Qwen3 reference
to the port (1e-4).  Routing is compared exactly: the port's selections
equal the reference's top k of ``s + b``.
"""
import dataclasses
import importlib.util
import json
import math
import pathlib

import pytest
import torch

from repro_torch import configs
from repro_torch.distributed import tp
from repro_torch.models import get_model, lm
from repro_torch.nn import moe as tmoe
from repro_torch.nn.mla import MLA
from repro_torch.nn.rope import rope_freqs
from repro_torch.runtime import obs

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "deepseek_v3_reference", ROOT / "perfbench/reference/deepseek_v3.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

BENCH_CFG = json.loads((ROOT / "perfbench/configs/moonlight_16b_a3b.json")
                       .read_text())
TINY = dataclasses.replace(
    configs.get_config("moonlight_16b_a3b", reduced=True), n_layers=3,
    d_ff=32, n_experts=8, n_shared_experts=1)
LAYER_TOL = 2e-5
MODEL_TOL = 1e-4


def ref_cfg(cfg=TINY) -> dict:
    """The reference's configuration keys of a port config."""
    return dict(
        BENCH_CFG, hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        n_routed_experts=cfg.n_experts, num_experts_per_tok=cfg.moe_top_k,
        n_shared_experts=cfg.n_shared_experts,
        intermediate_size=cfg.dense_d_ff, moe_intermediate_size=cfg.d_ff,
        vocab_size=cfg.vocab, first_k_dense_replace=cfg.first_dense,
        rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
        routed_scaling_factor=cfg.routed_scale)


def _close(got, want, tol):
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol, err


def _perturbed(module, seed):
    """Norm gains and the selection bias away from their 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(".g") or name == "g":
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return module


def _rope(S, cfg=TINY):
    return lm._rope_tables(cfg, {}, torch.arange(S))


def _moe_weights(p: tmoe.MoE) -> dict:
    return {"router": p.router.w, "bias": p.bias, "gate": p.gate,
            "up": p.up, "down": p.down, "shared_gate": p.shared_gate,
            "shared_up": p.shared_up, "shared_down": p.shared_down}


def _gemm(a, w):
    return a @ w


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_mla_layer_matches_reference(impl):
    gen = torch.Generator().manual_seed(0)
    att = _perturbed(MLA(64, n_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16, generator=gen),
                     1)
    x = torch.randn(2, 37, 64, generator=gen)
    cos, sin = _rope(37)
    with torch.no_grad():
        got, _ = att(x, cos=cos, sin=sin, impl=impl)
        w = {n: getattr(att, n).w for n in ("q", "kva", "kvb", "o")}
        want = ref.mla(x, w, att.kvn.g, ref_cfg(), cos, sin, torch.arange(37),
                       _gemm, q_block=8)
    _close(got, want, LAYER_TOL)


def test_mla_asks_for_the_dense_math_and_kernel_attend_refuses_it():
    """No kernel takes q/k 24 and v 16: ``attend(impl="kernel")`` refuses
    them, and an MLA at those widths asks for the dense math itself, so a
    ``"kernel"`` prefill and decode count no kernel call and no kernel
    fallback."""
    from repro_torch.nn.attention import attend
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 5, 4, 24, generator=gen)
    v = torch.randn(1, 5, 4, 16, generator=gen)
    with pytest.raises(ValueError, match="no kernel takes"):
        attend(q, q, v, impl="kernel")
    with pytest.raises(ValueError, match="no kernel takes"):
        attend(q.bfloat16(), q.bfloat16(), v.bfloat16(), impl="kernel")
    att = MLA(64, n_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
              qk_rope_head_dim=8, v_head_dim=16, generator=gen)
    cache = {"ckv": torch.zeros(2, 8, 32), "kpe": torch.zeros(2, 8, 8),
             "idx": 0}
    cos, sin = _rope(8)
    obs.reset()
    with torch.no_grad():
        att(torch.randn(2, 7, 64, generator=gen), cos=cos[:7], sin=sin[:7],
            cache=cache, impl="kernel")
        att(torch.randn(2, 1, 64, generator=gen), cos=cos[7:], sin=sin[7:],
            cache=cache, impl="kernel")
    counts = obs.counters()
    assert counts.get("attend.dense") == 2
    for route in ("attend.kernel_fallback", "attend.flash_attention",
                  "attend.flash_decode"):
        assert route not in counts
    with pytest.raises(ValueError, match="impl"):
        att(torch.randn(2, 1, 64), cos=cos[:1], sin=sin[:1], impl="flash")


def _mla_192_128(dtype):
    """An MLA at Moonlight's head dims (q/k 128 + 64, v 128) on a small
    model width, in ``dtype``."""
    gen = torch.Generator().manual_seed(3)
    att = MLA(64, n_heads=2, kv_lora_rank=32, qk_nope_head_dim=128,
              qk_rope_head_dim=64, v_head_dim=128, generator=gen)
    return att.to(dtype), torch.randn(2, 38, 64, generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mla_prompt_takes_flash_attention_where_the_kernel_takes_its_dims(
        dtype):
    """At q/k 192 and v 128 in bf16 a ``"kernel"`` prompt goes to
    ``flash_attention`` (one ``attend.flash_attention`` a prompt; on the
    CPU its plain twin, so it equals the ``"dense"`` prompt bit for bit);
    in f32 no kernel takes the pair and the layer asks for the dense math.
    The absorbed decode step after it counts no kernel call either way."""
    att, x = _mla_192_128(dtype)
    cos, sin = rope_freqs(torch.arange(38), 64, 50000.0)
    bf16 = dtype == torch.bfloat16
    outs = {}
    for impl in ("dense", "kernel"):
        cache = {"ckv": torch.zeros(2, 40, 32, dtype=dtype),
                 "kpe": torch.zeros(2, 40, 64, dtype=dtype), "idx": 0}
        obs.reset()
        with torch.no_grad():
            outs[impl], _ = att(x[:, :37], cos=cos[:37], sin=sin[:37],
                                cache=cache, impl=impl)
            prompt = obs.counters()
            att(x[:, 37:], cos=cos[37:], sin=sin[37:], cache=cache,
                impl=impl)
        counts = obs.counters()
        taken = bf16 and impl == "kernel"
        assert prompt.get("attend.flash_attention", 0) == int(taken)
        assert prompt.get("attend.dense", 0) == int(not taken)
        assert counts.get("attend.flash_attention", 0) == int(taken)
        assert counts.get("attend.dense", 0) == 1 + int(not taken)
        for route in ("attend.kernel_fallback", "attend.flash_decode",
                      "attend.chunked"):
            assert route not in counts
    assert torch.equal(outs["kernel"], outs["dense"])


def _moe(seed=0, **kw):
    gen = torch.Generator().manual_seed(seed)
    p = tmoe.MoE(64, 32, 8, router="sigmoid", n_shared=1, generator=gen)
    return _perturbed(p, seed + 1), torch.randn(3, 11, 64, generator=gen)


def test_moe_layer_matches_reference_and_bias_picks_only():
    """The selection bias changes some tokens' experts, and the weights
    stay the unbiased scores', normalised and scaled."""
    p, x = _moe()
    with torch.no_grad():
        p.bias.copy_(torch.linspace(-0.3, 0.3, 8))
        got = tmoe.moe_dropless(p, x, top_k=2, routed_scale=2.446)
        want, chosen = ref.moe(x.reshape(-1, 64), _moe_weights(p), ref_cfg(),
                               _gemm)
        w, idx = tmoe._choose(p, x.reshape(-1, 64), 2, 2.446)
    _close(got.reshape(-1, 64), want, LAYER_TOL)
    assert torch.equal(idx.sort(-1).values, chosen.sort(-1).values)
    s = torch.sigmoid(x.reshape(-1, 64) @ p.router.w)
    unbiased = s.topk(2, dim=-1).indices
    changed = (idx.sort(-1).values != unbiased.sort(-1).values).any(-1)
    assert 0 < int(changed.sum()) < changed.numel()
    top = s.gather(-1, idx)
    torch.testing.assert_close(w, top / top.sum(-1, keepdim=True) * 2.446)


def test_moe_one_expert_takes_every_token_and_none_is_dropped():
    """Expert 5 is in every token's top 2: all 66 pairs are computed, none
    dropped, where the capacity path (C = 6 at factor 1.25) would drop."""
    p, x = _moe(seed=3)
    with torch.no_grad():
        p.bias.zero_()
        p.bias[5] = 10.0
        obs.reset()
        got = tmoe.moe_dropless(p, x, top_k=2, routed_scale=2.446)
        want, _ = ref.moe(x.reshape(-1, 64), _moe_weights(p), ref_cfg(),
                          _gemm)
        _, idx = tmoe._choose(p, x.reshape(-1, 64), 2, 2.446)
    assert bool((idx == 5).any(-1).all())
    counts = obs.counters()
    assert counts["moe.pairs"] == 3 * 11 * 2 and counts["moe.dropped"] == 0
    assert tmoe.capacity(11, 2, 8, 1.25) < 11
    _close(got.reshape(-1, 64), want, LAYER_TOL)


def test_recording_gives_each_dropless_call_its_input_and_choices():
    """``moe.recording`` keeps, for each dropless call in its block, the
    call's input and the router's choices; nothing outside a block, and
    blocks do not nest."""
    p, x = _moe()
    with torch.no_grad():
        with tmoe.recording() as seen:
            tmoe.moe_dropless(p, x, top_k=2, routed_scale=2.446)
            tmoe.moe_dropless(p, x[:1], top_k=2, routed_scale=2.446)
            with pytest.raises(RuntimeError):
                with tmoe.recording():
                    pass
        tmoe.moe_dropless(p, x, top_k=2, routed_scale=2.446)
        _, idx = tmoe._choose(p, x.reshape(-1, 64), 2, 2.446)
    assert len(seen) == 2
    assert seen[0][0] is x and torch.equal(seen[0][1], idx.reshape(3, 11, 2))
    assert seen[1][1].shape == (1, 11, 2)


def _model(cfg=TINY, seed=0):
    return _perturbed(get_model(cfg).init(cfg, seed=seed,
                                          dtype=torch.float32, device="cpu"),
                      seed + 7)


def _weights(model, cfg=TINY) -> dict:
    """The reference's stacked weight layout of a port model."""
    blocks = list(model.blocks)
    att = [b.attn for b in blocks]
    dense, moes = blocks[:cfg.first_dense], [b.moe for b in
                                               blocks[cfg.first_dense:]]
    W = {"embed": model.embed.emb, "head": model.head_w(),
         "ln_f": model.ln_f.g,
         "ln1": torch.stack([b.ln1.g for b in blocks]),
         "ln2": torch.stack([b.ln2.g for b in blocks]),
         "kvn": torch.stack([a.kvn.g for a in att])}
    for n in ("q", "kva", "kvb", "o"):
        W[n] = torch.stack([getattr(a, n).w for a in att])
    for n in ("gate", "up", "down"):
        W["dense_" + n] = torch.stack([getattr(b.mlp, n).w for b in dense])
    for n, t in _moe_weights(moes[0]).items():
        W[n] = torch.stack([_moe_weights(m)[n] for m in moes])
    return W


def test_model_logits_match_reference():
    model = _model()
    tokens = torch.randint(0, 512, (2, 29),
                           generator=torch.Generator().manual_seed(4))
    logits = lm.forward(model, {"tokens": tokens})
    want = ref.last_logits(_weights(model), tokens, ref_cfg(), q_block=8,
                           row_block=16)
    _close(logits[:, -1, :512], want, MODEL_TOL)
    first, _ = lm.prefill(model, {"tokens": tokens}, 33,
                          cache_dtype=torch.float32)
    _close(first[:, 0, :512], want, MODEL_TOL)


def test_reference_follows_given_routing_and_reports_its_gap():
    """Following its own choices changes no bit and reports a gap of 0;
    following other choices moves the logits and reports how far below
    the reference's own k-th selection score they lie."""
    model = _model(seed=4)
    W, cfg = _weights(model), ref_cfg()
    tokens = torch.randint(0, 512, (2, 21),
                           generator=torch.Generator().manual_seed(8))
    own: dict = {}
    want = ref.last_logits(W, tokens, cfg, stats=own)
    chosen = own["chosen"]
    assert [c.shape for c in chosen] == [(2, 21, 2), (2, 1, 2)]
    replay = [c for c in chosen[:-1]] + [torch.cat(
        [torch.zeros(2, 20, 2, dtype=torch.long), chosen[-1]], 1)]
    st: dict = {}
    again = ref.last_logits(W, tokens, cfg, follow=replay, stats=st)
    assert torch.equal(again, want)
    assert (st["route_gap"], st["flips"]) == (0.0, 0)
    assert st["choices"] == 2 * 21 * 2 + 2 * 2
    moved = [(c + 3) % 8 for c in replay]      # other experts, distinct
    st = {}
    other = ref.last_logits(W, tokens, cfg, follow=moved, stats=st)
    assert st["flips"] > 0 and st["route_gap"] > 0
    assert float((other - want).abs().max()) > 1e-3


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_prefill_then_decode_through_the_latent_cache(impl):
    """A prefill of 20 tokens, then 4 decode steps in the absorbed form:
    each step's logits equal the full forward's at its position and the
    reference's for the prefix."""
    model = _model(seed=2)
    W = _weights(model)
    tokens = torch.randint(0, 512, (2, 24),
                           generator=torch.Generator().manual_seed(5))
    full = lm.forward(model, {"tokens": tokens}, impl=impl)
    logits, state = lm.prefill(model, {"tokens": tokens[:, :20]}, 24,
                               impl=impl, cache_dtype=torch.float32)
    _close(logits[:, 0], full[:, 19], MODEL_TOL)
    for t in range(20, 24):
        logits, state = lm.decode_step(model, state,
                                       {"tokens": tokens[:, t:t + 1]},
                                       impl=impl)
        _close(logits[:, 0], full[:, t], MODEL_TOL)
        want = ref.last_logits(W, tokens[:, :t + 1], ref_cfg(), q_block=8)
        _close(logits[:, 0, :512], want, MODEL_TOL)
    assert state["idx"] == 24


def test_latent_cache_shape_and_bytes():
    """The decode state holds the latent alone: 32 + 8 values a token a
    layer, never per-head keys or values; ``mla.latent_bytes`` counts what
    a prefill writes."""
    model = get_model(TINY).init(TINY, seed=0, dtype=torch.bfloat16,
                                 device="cpu")
    state = lm.init_decode_state(TINY, 2, 40, dtype=torch.bfloat16,
                                 device="cpu")
    assert set(state) == {"ckv", "kpe", "idx"}
    assert state["ckv"].shape == (3, 2, 40, 32)
    assert state["kpe"].shape == (3, 2, 40, 8)
    obs.reset()
    tokens = torch.randint(0, 512, (2, 17),
                           generator=torch.Generator().manual_seed(6))
    _, state = lm.prefill(model, {"tokens": tokens}, 40)
    assert obs.counters()["mla.latent_bytes"] == 3 * 2 * 17 * (32 + 8) * 2
    assert bool(state["ckv"][:, :, :17].abs().sum(-1).gt(0).all())
    assert not state["ckv"][:, :, 17:].any()
    full = configs.get_config("moonlight_16b_a3b")
    spec = lm.init_decode_state(full, 4, 6600, device="meta")
    per_token = sum(spec[k][0, 0, 0].numel() * spec[k].element_size()
                    for k in ("ckv", "kpe"))
    assert per_token == (512 + 64) * 2


def test_config_is_published_and_off_the_reference_grid():
    cfg = configs.get_config("moonlight_16b_a3b")
    assert cfg is configs.get_config("moonlight-16b-a3b")
    assert "moonlight_16b_a3b" not in configs.ARCH_NAMES
    assert all(a != "moonlight_16b_a3b" for a, *_ in configs.cells(True))
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == \
        (27, 2048, 16, 512, 128, 64, 128)
    assert (cfg.n_experts, cfg.moe_top_k, cfg.d_ff, cfg.n_shared_experts,
            cfg.first_dense, cfg.dense_d_ff, cfg.vocab) == \
        (64, 6, 1408, 2, 1, 11264, 163840)
    assert (cfg.router, cfg.routed_scale, cfg.norm_eps, cfg.rope_theta,
            cfg.rope_dim) == ("sigmoid", 2.446, 1e-5, 50000.0, 64)
    assert cfg.param_count() == pytest.approx(15.96e9, rel=1e-3)
    assert get_model(cfg) is lm


def test_every_block_norm_takes_the_config_eps():
    """qwen3_8b keeps 1e-6 in every norm; Moonlight's block and final
    norms take 1e-5 and its latent norm keeps the published 1e-6."""
    for name, eps in (("qwen3_8b", 1e-6), ("moonlight_16b_a3b", 1e-5)):
        cfg = dataclasses.replace(configs.get_config(name), n_layers=2)
        with torch.device("meta"):
            model = lm.LM(cfg)
        norms = {n: m.eps for n, m in model.named_modules()
                 if hasattr(m, "eps")}
        assert norms and all(v == (1e-6 if n.endswith("kvn") else eps)
                             for n, v in norms.items()), norms


def test_selection_bias_changes_some_choices_at_published_widths():
    """The benchmark's drawn bias scale (``init.bias_std``) moves some of
    the top 6 of 64 at d 2048 with the driver's weight scale, not all."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(512, 2048, generator=g)
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True))
    s = torch.sigmoid(x @ (torch.randn(2048, 64, generator=g) / math.sqrt(
        2048)))
    b = torch.randn(64, generator=g) * BENCH_CFG["init"]["bias_std"]
    plain = s.topk(6, dim=-1).indices.sort(-1).values
    biased = (s + b).topk(6, dim=-1).indices.sort(-1).values
    moved = int((plain != biased).any(-1).sum())
    assert 0.1 * 512 < moved < 512, moved


def test_no_parallel_plan_raises_clearly():
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        lm.init(TINY, device="cpu", shard=object())
    att = MLA(64, n_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
              qk_rope_head_dim=8, v_head_dim=16)
    p, x = _moe()
    par = tp.Parallel(tp=tp.Axis(None, 0, 2), dp=tp.Axis(None, 0, 1))
    cos, sin = _rope(11)
    with tp.parallel(par):
        with pytest.raises(NotImplementedError, match="MLA"):
            att(x, cos=cos, sin=sin)
        with pytest.raises(NotImplementedError, match="tensor-parallel"):
            tmoe.moe_dropless(p, x, top_k=2)
    with pytest.raises(ValueError, match="softmax router"):
        tmoe.moe_route(p, x, top_k=2)
