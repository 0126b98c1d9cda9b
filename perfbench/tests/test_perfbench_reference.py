"""The plain references agree with the port at tiny sizes on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.drivers import lm_prefill
from perfbench.reference import fusion_cost as ref, qwen3
from perfbench.tests import toy

from repro_torch.core import cost_model as cm, gsampler as gs, ref_model
from repro_torch.core.accel import AccelConfig
from repro_torch.models import lm

CFG = toy.load(toy.PERFBENCH / "configs" / "dnnfuser_paper.json")
NMAX = CFG["nmax"]


def _workload(name):
    """The port's Workload of a configuration entry (as the driver builds
    it)."""
    from repro_torch.workloads.layer import Layer, Workload
    net = CFG["networks"][name]
    layers = [Layer(r[0], *r[1:10], macs_override=r[10],
                    out_elems_override=r[11], w_elems_override=r[12])
              for r in net["layers"]]
    return Workload(name, layers, net["input_elems"],
                    tuple(net["input_shape6"]))


@pytest.mark.parametrize("net", sorted(CFG["networks"]))
@pytest.mark.parametrize("part", ["edge", "datacenter"])
def test_cost_model_reference_matches_port(net, part):
    hw = CFG["parts"][part]
    acc = AccelConfig(name=part, **hw)
    w = _workload(net)
    arrs = w.arrays(NMAX, bytes_per_elem=hw["bytes_per_elem"])
    wl = ref.pack(CFG["networks"][net], NMAX, hw["bytes_per_elem"])
    for k in ("A", "W", "F", "OE", "UC", "SKIP"):
        np.testing.assert_array_equal(wl[k], arrs[k])
    packed = cm.pack_workload(w, acc, NMAX, device="cpu")
    rng = np.random.default_rng(7)
    for B in (16, 64):
        strats = np.stack([cm.random_strategy(rng, w.n, NMAX, B)
                           for _ in range(24)])
        got = cm.evaluate_population(packed, strats, B, 24 * 2 ** 20, acc)
        for i, s in enumerate(strats):
            want = ref.evaluate(wl, s, B, 24 * 2 ** 20, hw)
            oracle = ref_model.evaluate_ref(arrs, s, B, 24 * 2 ** 20, acc)
            assert want["latency"] == oracle["latency"]
            assert want["peak_mem"] == oracle["peak_mem"]
            assert want["n_groups"] == oracle["n_groups"]
            assert float(got.latency[i]) == pytest.approx(want["latency"],
                                                          rel=1e-5)
            assert float(got.peak_mem[i]) == pytest.approx(
                want["peak_mem"], rel=1e-5)
            assert bool(got.valid[i]) == want["valid"]
            assert ref.well_formed(s, w.n, B)


def test_naive_uniform_matches_port():
    names, parts = sorted(CFG["networks"]), sorted(CFG["parts"])
    rng = np.random.default_rng(3)
    C = 12
    ni = rng.integers(0, len(names), C)
    pi = rng.integers(0, len(parts), C)
    budgets = (np.exp(rng.uniform(np.log(8), np.log(64), C))
               * 2 ** 20).astype(np.float32)
    batches = rng.choice([16, 64], C)
    accs = [AccelConfig(name=parts[b], **CFG["parts"][parts[b]]) for b in pi]
    packed = cm.stack_workloads([cm.pack_workload(_workload(names[a]),
                                                  acc, NMAX, device="cpu")
                                 for a, acc in zip(ni, accs)])
    got = gs._naive_uniform_grid(packed, torch.as_tensor(batches).float(),
                                 torch.as_tensor(budgets), accs)
    for c in range(C):
        hw = CFG["parts"][parts[pi[c]]]
        wl = ref.pack(CFG["networks"][names[ni[c]]], NMAX,
                      hw["bytes_per_elem"])
        want = ref.naive_uniform(wl, float(batches[c]), float(budgets[c]), hw)
        mine = ref.evaluate(wl, got[c].numpy(), float(batches[c]),
                            float(budgets[c]), hw)
        assert mine["latency"] == want["latency"]


def test_bf16_control_departs_from_reference():
    hw = CFG["parts"]["edge"]
    wl = ref.pack(CFG["networks"]["resnet18"], NMAX, hw["bytes_per_elem"])
    s = cm.random_strategy(np.random.default_rng(1), wl["n"], NMAX, 64)
    a = ref.evaluate(wl, s, 64, 32 * 2 ** 20, hw)
    b = ref.evaluate(wl, s, 64, 32 * 2 ** 20, hw, q=ref.bf16)
    assert 1e-4 < abs(b["latency"] / a["latency"] - 1) < 5e-2
    assert ref.bf16(1.0 + 2 ** -9) == 1.0 and ref.bf16(3.0) == 3.0


def test_qwen3_reference_matches_port_in_f32():
    cfg = toy.lm_config()
    arch = lm_prefill.arch_config(cfg)
    W = lm_prefill.make_weights(cfg, arch.vocab_padded, 5, "cpu")
    W32 = {k: v.float() for k, v in W.items()}
    with torch.device("meta"):
        model = lm.LM(arch, dtype=torch.float32)
    model.load_state_dict(lm_prefill.state_dict(W32, arch.n_layers),
                          assign=True)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 70),
                           generator=torch.Generator().manual_seed(1))
    logits, _ = lm.prefill(model.eval(), {"tokens": tokens}, 78,
                           impl="kernel", cache_dtype=torch.float32)
    want = qwen3.last_logits(W, tokens, cfg, q_block=16, row_block=32)
    got = logits[:, 0, :cfg["vocab_size"]]
    assert want.shape == got.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    ctrl = qwen3.last_logits(W, tokens, cfg, prec=qwen3.FP8)
    assert float((ctrl - want).abs().max()) > 1e-3 * float(want.abs().max())
