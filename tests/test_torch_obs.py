"""The port's spans and counters (``repro_torch.runtime.obs``) and where
the program places them: tracing off records nothing, nesting and request
ids, the bounded buffer, the Chrome trace's clock, the attention routes'
counters, the G-Sampler's span tree, and the cost model's evaluation
attributes against what the benchmark's search driver records.  The file
imports nothing of JAX; its one card test runs with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs.py
"""
import json
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import accel, cost_model as cm, gsampler as gs
from repro_torch.models import lm
from repro_torch.nn.attention import Q_CHUNK, attend
from repro_torch.runtime import obs
from repro_torch.workloads import resnet18, tiny_cnn

ROOT = pathlib.Path(__file__).resolve().parents[1]
MB = 2.0 ** 20
KERNEL_COUNTERS = ("fusion_eval.launches", "flash_attention.launches",
                   "flash_attention.tensor_core",
                   "flash_attention.tensor_core_tf32x3",
                   "flash_attention.tensor_core_192_128",
                   "flash_decode.launches", "wkv6.launches")


@pytest.fixture(autouse=True)
def clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _no_record_function(*a, **k):
    raise AssertionError("record_function entered")


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    monkeypatch.setattr(obs._profiler, "record_function", _no_record_function)
    assert not obs.tracing()
    with obs.span("a", x=1):
        with obs.span("b"):
            obs.count("c", 2)
    assert obs.spans() == []
    assert obs.counters()["c"] == 2
    assert obs.counters(traced=True)["c"] == 0
    # on without a profiler session: spans record, no range is entered
    obs.enable()
    with obs.span("a"):
        obs.count("c")
    assert [s.name for s in obs.spans()] == ["a"]
    assert obs.counters(traced=True)["c"] == 1


def test_nesting_parent_and_request_ids():
    obs.enable()
    with obs.span("root", C=3) as r1:
        with obs.span("child") as c1:
            with obs.span("grandchild") as g1:
                pass
        with obs.span("child") as c2:
            pass
    with obs.span("root") as r2:
        with obs.span("child") as c3:
            pass
    got = {s.id: s for s in obs.spans()}
    assert [s.name for s in got.values()] == [
        "grandchild", "child", "child", "root", "child", "root"]
    assert got[r1.id].parent is None and got[r1.id].attrs == {"C": 3}
    assert got[c1.id].parent == got[c2.id].parent == r1.id
    assert got[g1.id].parent == c1.id
    assert {got[i].request for i in (r1.id, c1.id, c2.id, g1.id)} == {r1.id}
    assert got[c3.id].request == got[c3.id].parent == r2.id != r1.id
    for s in got.values():
        assert s.start_us <= s.end_us
    assert got[r1.id].start_us <= got[c1.id].start_us
    assert got[c2.id].end_us <= got[r1.id].end_us


def test_bounded_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(obs, "MAX_SPANS", 4)
    obs.reset()
    obs.enable()
    for i in range(10):
        with obs.span(f"s{i}"):
            pass
    assert [s.name for s in obs.spans()] == ["s6", "s7", "s8", "s9"]
    assert obs.counters()["obs.spans_dropped"] == 6


def test_counters_hold_under_threads():
    n_threads, n = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                obs.count("t")
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert obs.counters()["t"] == n_threads * n


def test_counters_report_the_kernels_stats():
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    from repro_torch.kernels import fusion_eval as fe, rwkv6_scan as rk
    fe.STATS.launches, fa.STATS.tensor_core, rk.STATS.launches = 3, 2, 5
    c = obs.counters()
    assert set(KERNEL_COUNTERS) <= set(c)
    assert (c["fusion_eval.launches"], c["flash_attention.tensor_core"],
            c["wkv6.launches"], c["flash_decode.launches"]) == (3, 2, 5, 0)
    assert not set(KERNEL_COUNTERS) & set(obs.counters(traced=True))
    obs.reset()
    assert all(obs.counters()[k] == 0 for k in KERNEL_COUNTERS)
    assert fe.STATS.launches == fa.STATS.tensor_core == fd.STATS.launches == 0


def test_span_is_on_the_chrome_trace_clock(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert obs.tracing()
        with obs.span("obs.test.sleep"):
            time.sleep(0.02)
        obs.count("inside")
    assert not obs.tracing()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ev = [e for e in events if e.get("name") == "obs.test.sleep"
          and e.get("ph") == "X"]
    assert len(ev) == 1
    (s,) = obs.spans()
    assert s.end_us - s.start_us >= 2e4
    assert abs(float(ev[0]["ts"]) - s.start_us) < 2e3
    assert abs(float(ev[0]["ts"]) + float(ev[0]["dur"]) - s.end_us) < 2e3
    assert obs.counters(traced=True)["inside"] == 1


def _qkv(S, T, B=1, Hq=4, Hkv=2, hd=8):
    g = torch.Generator().manual_seed(S * 1000 + T)
    q = torch.randn((B, S, Hq, hd), generator=g)
    k = torch.randn((B, T, Hkv, hd), generator=g)
    v = torch.randn((B, T, Hkv, hd), generator=g)
    return q, k, v


@pytest.mark.parametrize("impl,S,T,kw,routes", [
    ("kernel", 16, 16, {}, ["attend.flash_attention"]),
    ("kernel", 1, 32, dict(q_offset=20, kv_len=21), ["attend.flash_decode"]),
    ("kernel", 8, 32, dict(kv_len=8),
     ["attend.kernel_fallback", "attend.dense"]),
    ("kernel", Q_CHUNK + 8, Q_CHUNK + 16, dict(kv_len=Q_CHUNK + 8),
     ["attend.kernel_fallback", "attend.chunked"]),
    ("kernel", 1, 32, dict(q_offset=20, kv_len=21, window=8),
     ["attend.kernel_fallback", "attend.dense"]),
    ("dense", 16, 16, {}, ["attend.dense"]),
    ("dense", Q_CHUNK + 8, Q_CHUNK + 8, {}, ["attend.chunked"]),
])
def test_attend_counts_its_route(impl, S, T, kw, routes):
    q, k, v = _qkv(S, T)
    attend(q, k, v, impl=impl, **kw)
    c = {k: v for k, v in obs.counters().items() if k.startswith("attend.")}
    assert c == {r: 1 for r in routes}


def test_lm_prefill_and_decode_spans_and_routes():
    cfg = get_config("qwen3_8b", reduced=True)
    model = lm.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    obs.enable()
    _, state = lm.prefill(model, {"tokens": toks}, 16, impl="kernel",
                          cache_dtype=torch.float32)
    lm.decode_step(model, state, {"tokens": toks[:, :1]}, impl="kernel")
    obs.disable()
    c = obs.counters()
    L = cfg.n_layers
    assert c["attend.kernel_fallback"] == c["attend.dense"] == L
    assert c["attend.flash_decode"] == L
    sp = obs.spans()
    roots = [s for s in sp if s.parent is None]
    assert [(s.name, s.attrs) for s in roots] == [
        ("lm.prefill", {"B": 2, "S": 12}), ("lm.decode_step", {"B": 2, "S": 1})]
    by_id = {s.id: s for s in sp}
    for root in roots:
        mine = [s for s in sp if s.request == root.id and s is not root]
        names = [s.name for s in mine]
        assert names.count("nn/attention") == L
        assert names.count("nn/mlp") == L
        assert "nn/linear" in names and "nn/norms" in names
        for s in mine:
            if s.name == "nn/attention":
                assert s.parent == root.id
            if s.name == "nn/linear" and by_id[s.parent].name != root.name:
                assert by_id[s.parent].name in ("nn/attention", "nn/mlp")


def _round(seed=0):
    return gs.gsampler_search_grid(
        [tiny_cnn(), resnet18()], [accel.PAPER_ACCEL, accel.ACCEL_ZOO["nano"]],
        [16, 64], [8 * MB, 32 * MB], nmax=32, cfg=gs.GSamplerConfig(seed=seed),
        top_k=4, device="cpu")


def test_gsampler_span_tree():
    cfg = gs.GSamplerConfig()
    quiet = _round()
    obs.enable()
    loud = _round()
    obs.disable()
    np.testing.assert_array_equal(quiet.strategies, loud.strategies)
    sp = obs.spans()
    (root,) = [s for s in sp if s.parent is None]
    assert root.name == "gsampler.round"
    assert root.attrs == {"C": 2, "population": cfg.population,
                          "generations": cfg.generations}
    assert all(s.request == root.id for s in sp)
    kids = sorted((s for s in sp if s.parent == root.id),
                  key=lambda s: s.start_us)
    assert [s.name for s in kids] == (
        ["gsampler.prepare", "ga.init"] + ["ga.generation"] * cfg.generations
        + ["ga.final", "gsampler.to_host"])
    prep = [s.name for s in sp if s.parent == kids[0].id]
    assert prep.count("cost_model.stack_workloads") == 1
    for gen in kids[2:-2]:
        steps = sorted((s for s in sp if s.parent == gen.id),
                       key=lambda s: s.start_us)
        assert [s.name for s in steps] == ["ga.evaluate", "ga.select",
                                          "ga.mutate", "ga.repair"]
        rounds = [s for s in sp if s.parent == steps[3].id]
        assert [s.name for s in rounds] == ["ga.repair_round"] \
            * cfg.repair_tries
    evals = [s for s in sp if s.name == "cost_model.evaluate"]
    assert len(evals) == 18 + cfg.generations * (1 + cfg.repair_tries) + 1
    assert obs.counters()["gsampler.conditions"] == 4


def test_live_positions_of_packed_and_stacked_workloads():
    a = cm.pack_workload(tiny_cnn(), accel.PAPER_ACCEL, 32, device="cpu")
    b = cm.pack_workload(resnet18(), accel.PAPER_ACCEL, 32, device="cpu")
    assert cm.live_positions(a) == tiny_cnn().n
    assert cm.live_positions(cm.stack_workloads([a, b])) is None   # off
    obs.enable()
    stacked = cm.stack_workloads([a, b, a])
    assert cm.live_positions(stacked) == 2 * tiny_cnn().n + resnet18().n
    assert cm.live_positions({"n": a["n"].clone()}) is None


def test_evaluate_attrs_match_the_search_driver():
    sys.path.insert(0, str(ROOT))
    try:
        from perfbench.tests import toy
    finally:
        sys.path.remove(str(ROOT))
    c = toy.cell("search", generations=2)
    c.mix["conditions_per_round"] = 6
    run = c.driver.Run(c.config, c.mix, 2 ** 31 + 7, "cpu")
    run.setup()
    obs.enable()
    win = run.traced_window()
    obs.disable()
    got = [(a["form"], a["C"], a["POP"], a["P"], a["live"])
           for a in (s.attrs for s in obs.spans()
                     if s.name == "cost_model.evaluate")]
    assert got == win["fe_calls"]
    assert len(got) == 18 + 2 * (1 + 6) + 1


@pytest.mark.cuda
def test_card_spans_hold_their_device_work_and_count_allocations(tmp_path):
    """On the card: a device operation launched inside a span runs inside
    it on the Chrome trace's clock when the span waits for it, and a
    root span counts the caching allocator's device allocations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with obs.span("obs.test.root"):
            with obs.span("obs.test.sleep"):
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize()
            x = torch.empty(int(3.3 * MB) + 4096, dtype=torch.uint8,
                            device=dev)
            x.fill_(1)
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"
            and "spin" in e.get("name", "")]    # torch.cuda._sleep's kernel
    assert len(kern) == 1, [e.get("name") for e in events
                            if e.get("cat") == "kernel"]
    s = {x.name: x for x in obs.spans()}["obs.test.sleep"]
    a = float(kern[0]["ts"])
    assert s.start_us - 50 <= a and a + float(kern[0]["dur"]) <= s.end_us + 50
    assert obs.counters(traced=True)["cuda.device_allocs"] >= 1
