"""The yardstick's counts of operations and bytes, checked by hand at one
small shape, and the trace reduction on made-up events."""
from __future__ import annotations

import json
import pytest

from perfbench.harness import peaks, trace as tracing
from perfbench.harness.cell import ROOT


def test_fe_bound_by_hand():
    # C 2, POP 3, P 4, 5 live positions, the stats form (gid and M_g)
    ms, by, nbytes = peaks.fe_bound_ms(2, 3, 4, 5, 1)
    want = (2 * 3 * 4 * 4          # strategies
            + 2 * 4 * 24           # A W F OE UC (f32) and SKIP (i32)
            + 2 * 56               # n, batch, BPE, budget, 10 hw fields
            + 2 * 3 * 17           # latency, peak, traffic, valid, n_groups
            + 2 * 2 * 3 * 4 * 4)   # gid and M_g
    assert nbytes == want == 694
    assert by == "bytes"
    assert ms == pytest.approx(694 / 3.35e12 * 1e3)
    # operations bind once the live positions dominate: 48 per position
    ms, by, _ = peaks.fe_bound_ms(1, 1, 1, 10 ** 9, 0)
    assert by == "operations"
    assert ms == pytest.approx(48e9 / 67e12 * 1e3)


def test_attention_counts_by_hand():
    assert peaks.visible_pairs(4, 4, True, -1) == 1 + 2 + 3 + 4
    assert peaks.visible_pairs(4, 4, False, -1) == 16
    assert peaks.visible_pairs(5, 5, True, 2) == 1 + 2 + 2 + 2 + 2
    for S in (1, 7, 64, 129):
        assert peaks.causal_pairs(S) == peaks.visible_pairs(S, S, True, -1)
    # B 1, S = T = 4, Hq 2, Hkv 1, hd 8, bf16: 4*8*10*2 ops, q k v o bytes
    ms, by = peaks.fa_bound_ms(1, 4, 4, 2, 1, 8, True, -1, 2)
    ops, nbytes = 4 * 8 * 10 * 2, 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)
    assert by == "bytes"
    assert ms == pytest.approx(max(nbytes / 3.35e12, ops / 989e12) * 1e3)


def test_prefill_flops_by_hand():
    cfg = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
           "num_attention_heads": 2, "num_key_value_heads": 1,
           "head_dim": 4, "vocab_size": 10}
    # per layer: q 8x8, o 8x8, k and v 8x4 each, MLP 3 x 8x16
    assert peaks.block_params(cfg) == 64 + 64 + 32 + 32 + 384 == 576
    B, S = 3, 5
    want = (2 * 2 * 576 * B * S              # the blocks' products
            + 4 * 4 * 15 * B * 2 * 2         # causal pairs 15, 2 heads
            + 2 * 8 * 10 * B)                # the head, last position
    assert peaks.prefill_flops(cfg, B, S) == want


def test_qwen3_8b_flops_at_8192():
    cfg = json.loads((ROOT / "perfbench/configs/qwen3_8b.json").read_text())
    assert peaks.block_params(cfg) == 192937984
    f = peaks.prefill_flops(cfg, 1, 8192)
    assert f == pytest.approx(2 * 36 * 192937984 * 8192
                              + 4 * 128 * 8192 * 8193 // 2 * 32 * 36
                              + 2 * 4096 * 151936)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def test_trace_reduction_on_made_up_events():
    ev = [
        _x("user_annotation", tracing.WINDOW_SPAN, 0, 100),
        _x("user_annotation", tracing.LAYER_SPAN + "nn/attention", 0, 50),
        _x("user_annotation", tracing.LAYER_SPAN + "nn/linear", 1, 20),
        _x("gpu_user_annotation", tracing.LAYER_SPAN + "nn/linear", 1, 99,
           tid=7),
        _x("cpu_op", "aten::mm", 2, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=11),
        _x("cpu_op", "aten::exp", 30, 60),
        _x("cuda_driver", "cuLaunchKernelEx", 31, 1, correlation=12),
        _x("cuda_runtime", "cudaLaunchKernel", 70, 1, correlation=13),
        _x("kernel", "gemm", 10, 20, tid=7, correlation=11),
        _x("kernel", "gemm", 25, 10, tid=7, correlation=11),
        _x("kernel", "exp", 60, 5, tid=7, correlation=12),
        _x("gpu_memcpy", "late", 95, 25, tid=7, correlation=13),
    ]
    t = tracing.Trace(ev, 1e-4)
    # union: [10, 35], [60, 65], [95, 100] clipped to the window
    assert t.busy_s == pytest.approx(35e-6)
    assert t.launches == 4
    # launched inside nn/linear (innermost), nn/attention, and no span
    assert t.layer_s == {"nn/linear": pytest.approx(30e-6),
                         "nn/attention": pytest.approx(5e-6),
                         None: pytest.approx(5e-6)}
    assert t.seconds("gemm") == (pytest.approx(30e-6), 2)
    assert t.device_ops[0][0] == "gemm"
    # each gap is named by the innermost host operation at its midpoint
    assert dict(t.idle_gaps) == {
        "host in aten::mm": pytest.approx(10e-6),
        "host in aten::exp": pytest.approx(55e-6)}


def test_layer_spans_wrap_and_restore():
    from repro_torch.nn.linear import Dense
    real = Dense.forward
    spans = {"nn/linear": "repro_torch.nn.linear:Dense.forward"}
    dense = Dense(4, 3, generator=tracing.torch.Generator().manual_seed(0))
    x = tracing.torch.ones(2, 4)
    with tracing.torch.profiler.profile() as prof:
        with tracing.layer_spans(spans):
            assert Dense.forward is not real
            y = dense(x)
    assert Dense.forward is real
    assert tracing.torch.equal(y, real(dense, x))
    names = {e.name for e in prof.events()}
    assert tracing.LAYER_SPAN + "nn/linear" in names


class _Stub:
    """A reduced trace's fields that the wall-share readers read."""
    busy_s, window_s, launches = 0.6, 2.0, 3000


@pytest.mark.parametrize("name,want", [
    ("device_idle.search", 100.0 * (1 - 0.6 / 1.5)),
    ("device_idle.prefill", 100.0 * (1 - 0.6 / 1.5)),
    ("host_us_per_launch.search", 1.5e6 / 3000),
    ("prefill_mfu", 100.0 * 1.5e14 / (1.5 * peaks.H100_BF16_OPS_PER_S))])
def test_wall_shares_use_the_untraced_wall(name, want):
    """Shares of the wall are taken over the same work run without the
    profiler (1.5 s here), not over the profiled pass's own wall (2 s)."""
    from types import SimpleNamespace
    from perfbench.harness.cell import reader
    ctx = SimpleNamespace(trace=_Stub(), untraced_s=1.5,
                          window={"flops": 1.5e14})
    assert reader(name)(ctx) == pytest.approx(want)
    assert reader(name)(SimpleNamespace(trace=_Stub(), untraced_s=0.0,
                                        window={"flops": 1.5e14})) is None
