"""The port's fault-tolerant training runtime (``repro_torch.runtime``):
``TrainLoop`` over ``launch.train`` on a reduced LM, on the CPU, and the
deterministic row gather (``nn.take_rows``) it rests on.

Within the port everything is bit-equal: a run crashed at step K and
restarted from its checkpoint ends on the same parameters, moments and
loss as a run straight through (the gathers' backward gives the same bits
on every run; a plain gather's adds repeated rows with atomics on the CPU
and did not).  ``StragglerMonitor`` flags a step slower than 3x the
trailing median once 8 steps are seen, as the reference's.
"""
import numpy as np
import pytest
import torch

from repro.runtime import StragglerMonitor as JStragglerMonitor
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.model import param_tree
from repro_torch.launch import train as ttrain
from repro_torch.nn.linear import segment_sum, take_rows
from repro_torch.runtime import StragglerMonitor, TrainLoop
from repro_torch.runtime import fault_tolerance as ft

torch.set_num_threads(2)
N_STEPS = 20


def _train(d, arch="gemma3_1b", **kw):
    return ttrain.train(arch, steps=N_STEPS, ckpt_dir=str(d), device="cpu",
                        **kw)[0]


def _state(loop) -> dict:
    out = {f"params/{k}": v.detach() for k, v in
           param_tree(loop.model).items()}
    out.update({f"mu/{k}": v for k, v in loop.opt_state.mu.items()})
    out.update({f"nu/{k}": v for k, v in loop.opt_state.nu.items()})
    return out


@pytest.mark.parametrize("arch", ["gemma3_1b", "rwkv6_3b", "whisper_base",
                                  "qwen3_moe_235b"])
@pytest.mark.parametrize("crash_at", [0, 10])
def test_crash_and_resume_is_bit_exact(tmp_path, arch, crash_at):
    straight = _train(tmp_path / "straight", arch)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        _train(tmp_path / "crashed", arch, crash_at=crash_at)
    resumed = _train(tmp_path / "crashed", arch)
    assert resumed.start_step == crash_at + 1
    assert resumed.losses[-1] == straight.losses[-1]
    assert int(resumed.opt_state.step) == int(straight.opt_state.step) \
        == N_STEPS
    a, b = _state(resumed), _state(straight)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_checkpoint_cadence_and_one_read_at_start(tmp_path, monkeypatch):
    """Saves at step 0, every max(N // 4, 10) steps and the last; keeps 3;
    reads a checkpoint once, when the loop starts, and logs the loss
    (a host sync) only at log steps."""
    loop = _train(tmp_path)
    assert Checkpointer(tmp_path).steps() == [0, 10, 19]
    assert [s for s, _ in loop.losses] == [0, 19]
    reads = []
    real = ft.restore_pytree
    monkeypatch.setattr(ft, "restore_pytree",
                        lambda *a, **kw: reads.append(a) or real(*a, **kw))
    again = ttrain.train("gemma3_1b", steps=N_STEPS + 15,
                         ckpt_dir=str(tmp_path), device="cpu")[0]
    assert len(reads) == 1 and again.start_step == N_STEPS
    assert Checkpointer(tmp_path).steps() == [20, 30, 34]


def test_trainloop_runs_nothing_past_its_end(tmp_path):
    loop = _train(tmp_path)
    model, opt = loop.model, loop.opt_state
    again = TrainLoop(lambda *a: pytest.fail("stepped"), model, opt,
                      lambda s: pytest.fail("batched"), ckpt_dir=tmp_path)
    assert again.start_step == N_STEPS
    m2, o2 = again.run(N_STEPS)
    assert int(o2.step) == N_STEPS and again.losses == []


@pytest.mark.parametrize("slow_at", [3, 8, 20])
def test_straggler_events_match_reference(slow_at):
    ours, theirs = StragglerMonitor(), JStragglerMonitor()
    rng = np.random.default_rng(0)
    for step in range(30):
        dt = 0.01 * (1 + 0.1 * rng.random()) * (5 if step == slow_at else 1)
        ours.observe(step, dt)
        theirs.observe(step, dt)
    assert ours.events == theirs.events
    assert [e["step"] for e in ours.events] == ([slow_at] if slow_at >= 7
                                                else [])
    assert ours.median == theirs.median


@pytest.mark.parametrize("shape", [(4, 300), (2, 3, 5), (1,), (0,)])
def test_take_rows_is_the_gather_and_repeats_its_backward(shape):
    """Forward bit-equal to ``table[ids]``; backward the same bits on every
    call and on 1 and 4 threads over repeated ids, and each row's sum of n
    gradients within the f32 summation bound (n - 1) 2^-24 sum |g| of the
    exact (f64) sum; rows no id picks get exact zeros."""
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.normal(size=(50, 128)),
                            dtype=torch.float32).requires_grad_()
    ids = torch.as_tensor(rng.zipf(1.5, size=shape) % 50)
    g = torch.as_tensor(rng.normal(size=shape + (128,)), dtype=torch.float32)
    got = []
    try:
        for threads in (4, 4, 1, 4):
            torch.set_num_threads(threads)
            assert torch.equal(take_rows(table, ids), table[ids])
            got.append(torch.autograd.grad((take_rows(table, ids) * g).sum(),
                                           table)[0])
    finally:
        torch.set_num_threads(2)
    assert all(torch.equal(got[0], x) for x in got[1:])
    flat, g64 = ids.reshape(-1), g.reshape(-1, 128).double()
    exact = torch.zeros(50, 128, dtype=torch.float64).index_add_(
        0, flat, g64)
    bound = torch.zeros_like(exact).index_add_(0, flat, g64.abs()) * \
        (torch.bincount(flat, minlength=50) - 1).clamp(min=0)[:, None] \
        * 2.0 ** -24
    assert ((got[0].double() - exact).abs() <= bound).all()
    with torch.no_grad():
        assert torch.equal(take_rows(table, ids), table[ids])


@pytest.mark.parametrize("n", [64, 4096])
def test_take_rows_keeps_memory_linear_in_the_ids(n):
    """What autograd keeps for the backward is the ids alone (n integers),
    whatever their number: no [n, n] spread nor gathered rows."""
    table = torch.zeros(97, 32, requires_grad=True)
    ids = torch.arange(n) % 97
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        out = take_rows(table, ids.reshape(4, -1))
    assert sum(saved) <= n
    out.sum().backward()
    assert torch.equal(table.grad, torch.bincount(
        ids, minlength=97).float()[:, None].expand(97, 32))


def test_segment_sum_is_index_add():
    """``segment_sum`` equals ``index_add_`` where every sum is exact
    (small integers in f32), runs of every length up to 300 included."""
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(rng.permutation(np.repeat(
        np.arange(40), rng.integers(1, 300, size=40))))
    g = torch.as_tensor(rng.integers(-8, 9, size=(ids.numel(), 5)),
                        dtype=torch.float32)
    want = torch.zeros(45, 5).index_add_(0, ids, g)
    assert torch.equal(segment_sum(g, ids, 45), want)
