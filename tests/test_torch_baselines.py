"""Port parity: the black-box baselines of Table 1 (``core/baselines.py``).

The optimizers are host numpy on ``np.random.default_rng(seed)`` in both
packages, so a run follows the reference's trajectory: the strategies,
``n_evals`` and ``valid`` are held equal, and speedup, latency and peak
within rtol 1e-5 (the f32 cost models agree in f32, not bit for bit).  A
run may part from the reference's only where a comparison of two
objectives within 1e-6 relative decides it (an f32 rounding tie); such a
run is named in ``_TIE_RUNS``, and the test checks that its split starts
at such a tie.  The port's runs are
held equal on the CPU twin of ``fusion_eval`` run to run, and the count of
``fusion_eval`` calls per run is the one the loop bounds give.
"""
import numpy as np
import pytest

from _torch_parity import CPU, MB, port_workload
from repro.core import baselines as jbl, env as jenv
from repro.core.accel import PAPER_ACCEL as JPAPER
from repro.workloads import tiny_cnn, vgg16
from repro_torch.core import baselines as tbl, env as tenv
from repro_torch.core.accel import PAPER_ACCEL as TPAPER
from repro_torch.kernels import fusion_eval as fe

METHODS = sorted(jbl.BASELINE_METHODS)
# (net, batch, budget MB, nmax, samples): tiny_cnn at a small budget, and
# Table 1's two VGG16 cases at the paper's 2000 samples
CONDS = {"tiny_cnn": (tiny_cnn, 32, 4.0, 16, 200),
         "vgg16_case1": (vgg16, 64, 20.0, 20, 2000),
         "vgg16_case2": (vgg16, 128, 40.0, 20, 2000)}
# runs whose trajectory parts from the reference's at an f32 rounding tie:
# at case 2 both land in the saturated, over-budget region, where many
# candidates score within an ulp or two of each other
_TIE_RUNS = {("CMA", "vgg16_case2"), ("DE", "vgg16_case2")}
TIE_REL = 1e-6


def _envs(cond):
    net, batch, budget, nmax, _ = CONDS[cond]
    j = jenv.FusionEnv(net(batch=batch), JPAPER, batch, budget * MB,
                       nmax=nmax)
    t = tenv.FusionEnv(port_workload(net(batch=batch)), TPAPER, batch,
                       budget * MB, nmax=nmax, device=CPU)
    return j, t


def _recorded(monkeypatch, module):
    """Wrap ``module._score`` to keep each generation's (candidates,
    objectives)."""
    log, real = [], module._score

    def score(env, z):
        out = real(env, z)
        log.append((np.array(z), np.array(out[0])))
        return out

    monkeypatch.setattr(module, "_score", score)
    return log


def _split_is_a_tie(want_log, got_log) -> bool:
    """The two runs score the same candidates up to some generation g and
    then part.  Every decision before g compares objectives of those
    generations; the runs can part only if some pair of them is ordered
    differently by the two packages.  True when such pairs exist and every
    one of them lies within TIE_REL relative in the reference's values."""
    g = next(i for i, ((zw, _), (zg, _)) in enumerate(zip(want_log, got_log))
             if not np.array_equal(zw, zg))
    ow = np.concatenate([o for _, o in want_log[:g]])
    og = np.concatenate([o for _, o in got_log[:g]])
    flip = np.sign(ow[:, None] - ow[None, :]) != \
        np.sign(og[:, None] - og[None, :])
    gap = np.abs(ow[:, None] - ow[None, :]) / np.abs(ow[:, None])
    return bool(flip.any() and (gap[flip] <= TIE_REL).all())


@pytest.mark.parametrize("cond", sorted(CONDS))
@pytest.mark.parametrize("method", METHODS)
def test_baseline_matches_reference(method, cond, monkeypatch):
    jenv_, tenv_ = _envs(cond)
    samples = CONDS[cond][-1]
    want_log = _recorded(monkeypatch, jbl)
    got_log = _recorded(monkeypatch, tbl)
    want = jbl.run_baseline(jenv_, method, budget=samples, seed=0)
    got = tbl.run_baseline(tenv_, method, budget=samples, seed=0)
    assert got.method == want.method and got.n_evals == want.n_evals
    if (method, cond) in _TIE_RUNS:
        assert not np.array_equal(got.strategy, want.strategy)
        assert _split_is_a_tie(want_log, got_log)
        np.testing.assert_allclose(got.speedup, want.speedup, rtol=TIE_REL)
        return
    np.testing.assert_array_equal(got.strategy, want.strategy)
    assert got.valid == want.valid
    for k in ("speedup", "latency", "peak_mem"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("method", METHODS)
def test_baseline_launches_and_determinism(method, monkeypatch):
    """At the paper's budget of 2000 samples and population 40 a run scores
    50 generations and its best strategy once: 51 ``fusion_eval`` calls,
    the same count the card's run launches; two runs of one seed agree."""
    _, env = _envs("tiny_cnn")
    calls = []
    real = fe._run
    monkeypatch.setattr(fe, "_run", lambda *a: calls.append(1) or real(*a))
    a = tbl.run_baseline(env, method, budget=2000, seed=0)
    assert len(calls) == 2000 // 40 + 1 and a.n_evals == 2000
    b = tbl.run_baseline(env, method, budget=2000, seed=0)
    np.testing.assert_array_equal(a.strategy, b.strategy)
    assert (a.latency, a.peak_mem, a.valid) == (b.latency, b.peak_mem,
                                               b.valid)
    out = env.evaluate_strategy(a.strategy)
    assert float(out.latency) == a.latency and bool(out.valid) == a.valid
