"""The readers of the program's own spans and counters
(``harness/program_spans.py`` and the metrics that use it) on hand-built
traces and spans with known answers, their silence where the program has
nothing to read, and the attention route's share in a whole toy run on
the CPU."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from perfbench.harness import cell as harness, program_spans
from perfbench.tests import toy
from repro_torch.runtime import obs

# device operations (name, start, duration) in us: idle 10-20 and 30-50
OPS = [("k", 0.0, 10.0), ("k", 20.0, 10.0), ("k", 50.0, 10.0)]


def span(name, a, b, i=1, parent=None):
    return obs.Span(name, i, parent, 1, float(a), float(b), {})


SPANS = [span("gsampler.round", -10, 70),
         span("cost_model.stack_workloads", -5, 12),
         span("ga.generation", 5, 25), span("ga.evaluate", 6, 8),
         span("ga.generation", 40, 45),
         span("gsampler.to_host", 45, 70)]


def ctx(ops=OPS):
    return SimpleNamespace(trace=SimpleNamespace(ops=ops), window={})


@pytest.fixture
def program(monkeypatch):
    """The program's ``obs`` with spans and counters put in by hand."""
    state = {"spans": SPANS, "counters": {}}
    monkeypatch.setattr(obs, "spans", lambda: state["spans"])
    monkeypatch.setattr(obs, "counters",
                        lambda traced=False: dict(state["counters"]))
    return state


def test_idle_gaps_and_overlap_by_hand():
    assert program_spans.idle_gaps(OPS) == [(10.0, 20.0), (30.0, 50.0)]
    assert program_spans.idle_gaps([("k", 0.0, 10.0), ("k", 5.0, 10.0)]) \
        == []


@pytest.mark.parametrize("metric,want", [
    ("idle_in_ga.search", 100.0 * (10 + 5) / 30),
    ("idle_in_front_door.search", 100.0 * (2 + 5) / 30)])
def test_idle_shares_by_hand(program, metric, want):
    assert harness.reader(metric)(ctx()) == pytest.approx(want)


def test_idle_shares_sum_to_at_most_100(program):
    got = sum(harness.reader(m)(ctx()) for m in (
        "idle_in_ga.search", "idle_in_front_door.search"))
    assert got <= 100.0


@pytest.mark.parametrize("metric", ["idle_in_ga.search",
                                    "idle_in_front_door.search"])
def test_idle_shares_silent_off_the_trace(program, metric):
    # no round meets the trace's operations: another pass, or clocks apart
    program["spans"] = [s._replace(start_us=s.start_us + 1e6,
                                   end_us=s.end_us + 1e6) for s in SPANS]
    assert harness.reader(metric)(ctx()) is None
    program["spans"] = SPANS
    assert harness.reader(metric)(ctx([])) is None


def test_idle_set_on_the_host_clock_by_the_anchors(program):
    """The device clock runs 1000 us ahead of the host's; each
    ``fusion_eval`` kernel starts 5 us after its ``cost_model.evaluate``
    span (host 5 and 175), so the gaps (device 1030-1150, 1160-1180) lie
    at host 25-145 and 155-175."""
    ops = [("fusion_eval_kernel", 1010.0, 10.0), ("k", 1020.0, 10.0),
           ("k", 1150.0, 10.0), ("fusion_eval_kernel", 1180.0, 10.0)]
    program["spans"] = [span("gsampler.round", 0, 200),
                        span("ga.generation", 0, 100),
                        span("cost_model.evaluate", 5, 8),
                        span("gsampler.prepare", 100, 200),
                        span("cost_model.evaluate", 175, 178)]
    at, off = program_spans.device_offsets(ops, program["spans"])
    assert (at, off) == ([1010.0, 1180.0], [1005.0, 1005.0])
    assert harness.reader("idle_in_ga.search")(ctx(ops)) \
        == pytest.approx(100.0 * 75 / 140)
    assert harness.reader("idle_in_front_door.search")(ctx(ops)) \
        == pytest.approx(100.0 * 65 / 140)


def test_device_allocs_per_round_by_hand(program):
    read = harness.reader("device_allocs_per_round.search")
    assert read(ctx()) is None                  # no counter: off the card
    program["counters"] = {"cuda.device_allocs": 6}
    program["spans"] = SPANS + [span("gsampler.round", 80, 90)]
    assert read(ctx()) == 3.0
    program["spans"] = []
    assert read(ctx()) is None


@pytest.mark.parametrize("counts,want", [
    ({"attend.kernel_fallback": 72, "attend.dense": 72}, 100.0),
    ({"attend.kernel_fallback": 24, "attend.flash_attention": 48,
      "attend.flash_decode": 24}, 25.0),
    ({"attend.dense": 10}, None)])
def test_kernel_fallback_by_hand(program, counts, want):
    program["counters"] = counts
    assert harness.reader("attention.kernel_fallback.prefill")(ctx()) == want


@pytest.mark.parametrize("metric", [
    "idle_in_ga.search", "idle_in_front_door.search",
    "device_allocs_per_round.search", "attention.kernel_fallback.prefill"])
def test_silent_where_the_program_has_no_spans(monkeypatch, metric):
    monkeypatch.setattr(program_spans, "obs", lambda: None)
    assert harness.reader(metric)(ctx()) is None


def test_kernel_fallback_in_a_traced_toy_prefill():
    """A traced toy prefill on the CPU: every ``attend`` call of
    ``lm.prefill`` asks for the kernels and falls back (the cache is
    written first), so the share reads 100."""
    obs.reset()
    c = toy.cell("prefill")
    c.per_layer = [{"name": "attention.kernel_fallback.prefill",
                    "unit": "%"}]
    out = harness.run_resolved(c, 2 ** 31 + 3, 0.0, True, "cpu",
                               time.perf_counter())
    assert out["metrics"]["attention.kernel_fallback.prefill"]["value"] \
        == 100.0
    assert out["correct"]
