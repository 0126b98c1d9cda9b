"""The Moonlight-16B-A3B cell's yardstick, reference and comparison on the
CPU: ``harness/mla_moe_counts.py`` by hand at the published widths, the
driver's weights against the port through the reference in f32, and whole
toy runs of ``drivers/lm_prefill_mla.py`` in which a sound run is correct
and the control and planted faults are not: one routed expert left out,
the latent RMSNorm skipped, the selection bias ignored, the 2nd-best
expert swapped for the 3rd; and ``router_gap`` at the published router's
widths, where it also fails a router run in bf16."""
from __future__ import annotations

import contextlib
import json
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench.drivers import lm_prefill_mla as drv
from perfbench.harness import cell as harness, mla_moe_counts as counts
from perfbench.harness.peaks import H100_BF16_OPS_PER_S, H100_BYTES_PER_S
from perfbench.reference import deepseek_v3 as ref
from perfbench.tests import toy

from repro_torch.models import lm

SEED = 2 ** 31 + 5
CFG = json.loads((toy.PERFBENCH / "configs/moonlight_16b_a3b.json")
                 .read_text())
MIX = {"driver": "lm_prefill_mla", "batch": 2,
       "length": {"dist": "uniform", "lo": 16, "hi": 96, "step": 16},
       "strata": 4, "cache_extra": 8, "check_per_stratum": 1}


def toy_config() -> dict:
    cfg = dict(CFG)
    cfg.update(name="toy_mla", hidden_size=64, num_attention_heads=4,
               num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
               num_experts_per_tok=2, n_shared_experts=1,
               num_hidden_layers=3, intermediate_size=128,
               moe_intermediate_size=32, vocab_size=512)
    return cfg


def test_attention_and_prefill_counts_by_hand():
    # q 2048 x 16*192, kv_a 2048 x 576, kv_b 512 x 16*256, o 16*128 x 2048
    assert counts.attention_params(CFG) == (6291456 + 1179648 + 2097152
                                            + 4194304) == 13762560
    B, S = 4, 6592
    per_token = (27 * 13762560              # latent attention, every layer
                 + 3 * 2048 * 11264         # layer 0's SwiGLU
                 + 26 * (2048 * 64          # the router
                         + 8 * 3 * 2048 * 1408))   # 6 routed + 2 shared
    want = (2 * per_token * B * S
            + 2 * (128 + 64 + 128) * S * (S + 1) // 2 * B * 16 * 27
            + 2 * 2048 * 163840 * B)        # the head, last position
    assert counts.prefill_flops(CFG, B, S) == want


def test_experts_bound_by_hand():
    B, S = 4, 6592
    N = B * S
    ops = 2 * 8 * 3 * 2048 * 1408 * N * 26
    nbytes = 2 * ((64 + 2) * 3 * 2048 * 1408     # every expert read once
                  + 2 * N * 6 * 2048              # routed pairs in and out
                  + 2 * N * 2048) * 26            # shared tokens in and out
    ms, by, o, b = counts.experts_bound(CFG, B, S)
    assert (o, b) == (ops, nbytes)
    assert by == "operations"
    assert ms == pytest.approx(ops / H100_BF16_OPS_PER_S * 1e3)
    # one token: the weights' bytes bind
    ms, by, _, b = counts.experts_bound(CFG, 1, 1)
    assert by == "bytes" and ms == pytest.approx(b / H100_BYTES_PER_S * 1e3)


def test_driver_weights_through_the_reference_match_the_port_in_f32():
    cfg = toy_config()
    arch = drv.arch_config(cfg)
    W = drv.make_weights(cfg, arch.vocab_padded, 5, "cpu")
    W32 = {k: v.float() for k, v in W.items()}
    with torch.device("meta"):
        model = lm.LM(arch, dtype=torch.float32)
    model.load_state_dict(drv.state_dict(W32, arch.n_layers,
                                         arch.first_dense), assign=True)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 70),
                           generator=torch.Generator().manual_seed(1))
    logits, _ = lm.prefill(model.eval(), {"tokens": tokens}, 78,
                           impl="kernel", cache_dtype=torch.float32)
    want = ref.last_logits(W, tokens, cfg, q_block=16, row_block=32)
    got = logits[:, 0, :cfg["vocab_size"]]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    ctrl = ref.last_logits(W, tokens, cfg, prec=ref.FP8)
    assert float((ctrl - want).abs().max()) > 1e-3 * float(want.abs().max())


def test_published_bias_scale_moves_selections_in_the_drawn_weights():
    cfg = toy_config()
    W = drv.make_weights(cfg, 512, 3, "cpu")
    assert W["bias"].dtype == torch.float32
    assert float(W["bias"].std()) == pytest.approx(
        CFG["init"]["bias_std"], rel=0.6)
    # the drawn bias picks other experts for some tokens, not for all
    x = torch.randn(512, 64, generator=torch.Generator().manual_seed(3))
    s = torch.sigmoid(x @ W["router"][0].float())
    k = cfg["num_experts_per_tok"]
    plain = s.topk(k, dim=-1).indices.sort(-1).values
    biased = (s + W["bias"][0]).topk(k, dim=-1).indices.sort(-1).values
    moved = int((plain != biased).any(-1).sum())
    assert 0 < moved < 512 // 2, moved


@contextlib.contextmanager
def _patched(owner, attr, make):
    real = getattr(owner, attr)
    setattr(owner, attr, make(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)


def expert_left_out():
    """Routed expert 1's pairs come back as zeros."""
    from repro_torch.nn import moe

    def make(real):
        def call(p, xs, offs, x):
            ys, shared = real(p, xs, offs, x)
            ys = ys.clone()
            ys[int(offs[0]):int(offs[1])] = 0
            return ys, shared
        return call
    return _patched(moe, "_grouped_experts", make)


def latent_norm_skipped():
    """The latent RMSNorm passes c_kv through unchanged."""
    from repro_torch.nn.mla import MLA

    def make(real):
        def call(self, x, **kw):
            kvn, self.kvn = self.kvn, torch.nn.Identity()
            try:
                return real(self, x, **kw)
            finally:
                self.kvn = kvn
        return call
    return _patched(MLA, "forward", make)


def _router(pick):
    """A fault in the dropless router: ``pick(p, x, k)`` chooses the
    experts (the weights stay the unbiased scores')."""
    from repro_torch.nn import moe

    def make(real):
        def call(p, x, top_k, scale):
            s = torch.sigmoid(x.float() @ p.router.w.float())
            idx = pick(p, x, top_k)
            w = s.gather(-1, idx)
            return w / (w.sum(-1, keepdim=True) + 1e-20) * scale, idx
        return call
    return _patched(moe, "_choose", make)


def bias_ignored():
    """The top k of ``s``, not of ``s + b``."""
    return _router(lambda p, x, k: torch.topk(
        torch.sigmoid(x.float() @ p.router.w.float()), k, dim=-1).indices)


def next_best():
    """The k-th best expert swapped for the (k+1)-th."""
    def pick(p, x, k):
        s = torch.sigmoid(x.float() @ p.router.w.float()) + p.bias.float()
        idx = torch.topk(s, k + 1, dim=-1).indices
        return torch.cat([idx[:, :k - 1], idx[:, k:]], dim=-1)
    return _router(pick)


def bf16_router():
    """The router's product in bf16 (the published router's is f32)."""
    return _router(lambda p, x, k: torch.topk(
        torch.sigmoid((x.bfloat16() @ p.router.w.bfloat16()).float())
        + p.bias.float(), k, dim=-1).indices)


def run(control=False):
    c = SimpleNamespace(cell={"name": "toy_mla.prefill", "chips": 1},
                        config=toy_config(), mix=dict(MIX), driver=drv,
                        e2e=[], per_layer=[])
    torch.manual_seed(0)
    out = harness.run_resolved(c, SEED, 0.5, False, "cpu",
                               time.perf_counter(),
                               drv.CONTROL if control else None)
    return out["correct"], {k: v for k, (v, _) in out["checks"].items()}


def test_sound_toy_run_is_correct():
    ok, checks = run()
    assert ok, checks


def test_control_fails():
    ok, checks = run(control=True)
    assert not ok, checks
    assert checks["logit_err"] > drv.LIMITS["logit_err"]


@pytest.mark.parametrize("fault", [expert_left_out, latent_norm_skipped])
def test_planted_fault_fails(fault):
    with fault():
        ok, checks = run()
    assert not ok, checks
    assert checks["logit_err"] > drv.LIMITS["logit_err"], checks


@pytest.mark.parametrize("fault", [bias_ignored, next_best])
def test_planted_router_fault_fails_on_router_gap(fault):
    """Faults whose logits pass (the reference follows the choices made),
    failed by the router held to the reference's on the same inputs."""
    with fault():
        ok, checks = run()
    assert not ok, checks
    assert checks["router_gap"] > drv.LIMITS["router_gap"], checks
    assert checks["replay_diff"] == 0.0, checks


@pytest.mark.parametrize("fault,fails", [
    (contextlib.nullcontext, False), (bias_ignored, True),
    (next_best, True), (bf16_router, True)])
def test_router_gap_at_the_published_router_widths(fault, fails):
    """One dropless layer with the cell's router (d 2048, 64 experts, top
    6, the drawn bias's scale) over 2048 tokens in the program's bf16
    values: ``router_gap`` of the recorded choices is 0 for the sound
    router, and above its limit for each fault, the bf16 router's near-tie
    flips included."""
    from repro_torch.nn import moe
    gen = torch.Generator().manual_seed(SEED)
    d, E, k = CFG["hidden_size"], CFG["n_routed_experts"], \
        CFG["num_experts_per_tok"]
    p = moe.MoE(d, 8, E, router="sigmoid", n_shared=1, generator=gen)
    with torch.no_grad():
        p.router.w.copy_(torch.randn(d, E, generator=gen).mul(d ** -0.5)
                         .bfloat16().float())
        p.bias.copy_(torch.randn(E, generator=gen)
                     * CFG["init"]["bias_std"])
        x = torch.randn(2, 1024, d, generator=gen).bfloat16().float()
        with fault(), moe.recording() as seen:
            moe.moe_dropless(p, x, top_k=k,
                             routed_scale=CFG["routed_scaling_factor"])
    (xs, idx), = seen
    gap = ref.router_gap(xs.reshape(-1, d), p.router.w, p.bias,
                         idx.reshape(-1, k))
    assert (gap > drv.LIMITS["router_gap"]) == fails, gap
    if not fails:
        assert gap == 0.0


class _Trace:
    busy_s = 2.0
    layer_s = {"nn/mla": 1.5, "nn/moe": 0.1, "nn/moe.experts": 0.2}


@pytest.mark.parametrize("name,want", [
    ("mla_share.prefill_code", 75.0), ("moe_share.prefill_code", 5.0),
    ("moe_experts_roofline",
     100.0 * 2 * counts.experts_bound(CFG, 4, 320)[0] * 1e-3 / 0.2)])
def test_new_readers(name, want):
    ctx = SimpleNamespace(trace=_Trace(), config=CFG,
                          window={"batches": [(4, 320), (4, 320)]})
    assert harness.reader(name)(ctx) == pytest.approx(want)
    empty = SimpleNamespace(trace=SimpleNamespace(busy_s=0.0, layer_s={}),
                            config=CFG, window={"batches": []})
    assert harness.reader(name)(empty) is None
