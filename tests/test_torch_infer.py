"""Port parity: the environment and the batched one-shot episode.

The same reference weights (JAX ``dt_init`` -> ``save_pytree`` -> the
port's reader) roll out the same stacked, heterogeneous conditions
(workloads x parts x budgets, per-row hardware) in both packages; the
emitted int strategies and ``valid`` must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, MB, port_workload, to_np
from repro.checkpoint import save_pytree
from repro.core import cost_model as jcm, env as jenv, infer as jinf
from repro.core import model as jm
from repro.core.accel import ACCEL_ZOO as JZOO
from repro.workloads import resnet18, tiny_cnn
from repro_torch.checkpoint import dt_params_from_reference, load_reference
from repro_torch.core import accel as taccel, cost_model as tcm
from repro_torch.core import env as tenv, infer as tinf

PARTS = sorted(JZOO)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = jm.DTConfig(n_blocks=2, n_heads=2, d_model=32, max_steps=32,
                       d_ff=64, hw_dim=10)
    params = jm.dt_init(jax.random.PRNGKey(7), jcfg)
    path = tmp_path_factory.mktemp("dt") / "ckpt"
    save_pytree(params, path)
    return jcfg, params, dt_params_from_reference(load_reference(path),
                                                  device=CPU)


def test_encode_decode_match_reference():
    y = np.array([-0.3, 0.0, 0.015625, 0.0234375, 0.5, 0.5078125, 1.2],
                 np.float32)
    B = np.full(y.shape, 64.0, np.float32)
    want = np.asarray(jenv.decode_action_jnp(jnp.asarray(y),
                                             jnp.asarray(B)))
    got = to_np(tenv.decode_action(torch.as_tensor(y), torch.as_tensor(B)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        to_np(tenv.decode_action(torch.as_tensor(y), 64)),
        jenv.decode_action(y, 64))
    # half-to-even: 0.0234375 * 64 = 1.5 -> 2, 0.5078125 * 64 = 32.5 -> 32
    assert list(got[3:6]) == [2, 32, 32]
    a = np.array([-1, 1, 17, 64], np.int32)
    np.testing.assert_array_equal(
        to_np(tenv.encode_action(torch.as_tensor(a), torch.full((4,), 64.))),
        np.asarray(jenv.encode_action_jnp(jnp.asarray(a), 64.0)))


def test_env_observe_matches_reference():
    """(r_t, s_t) along a strategy, rows batched, against the reference's
    single-row env."""
    w = resnet18()
    rng = np.random.default_rng(2)
    s = jcm.random_strategy(rng, w.n, 32, 32, p_sync=0.3)
    jwl = jcm.pack_workload(w, JZOO["edge"], 32)
    jc = jenv.env_make(jwl, 32.0, 12 * MB, JZOO["mobile"])
    twl = tcm.pack_workload(port_workload(w), taccel.ACCEL_ZOO["edge"], 32,
                            device=CPU)
    rows = {k: v[None] for k, v in twl.items()}
    hw = taccel.stack_hw(taccel.ACCEL_ZOO["mobile"], 1)
    tc = tenv.env_make(rows, [32.0], [12 * MB], hw)
    jcarry, tcarry = jenv.env_reset(jc), tenv.env_reset(tc)
    for t in range(w.n + 1):
        jr, js = jenv.env_observe(jc, jcarry, JZOO["mobile"])
        tr, ts = tenv.env_observe(tc, tcarry, hw)
        np.testing.assert_allclose(to_np(tr)[0], float(jr), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(to_np(ts)[0], np.asarray(js), rtol=1e-5,
                                   atol=1e-6)
        jcarry = jenv.env_step(jc, jcarry, int(s[t]), JZOO["mobile"])
        tcarry = tenv.env_step(tc, tcarry, torch.tensor([int(s[t])]), hw)
    jf = jenv.env_final(jc, jcarry, JZOO["mobile"])
    tf = tenv.env_final(tc, tcarry, hw)
    np.testing.assert_allclose(float(tf.latency[0]), float(jf.latency),
                               rtol=1e-5)
    assert int(tf.n_groups[0]) == int(jf.n_groups)


def _grid(wl_fns, nmax, budgets_mb):
    conds = [(f, part, b) for f in wl_fns for part in PARTS
             for b in budgets_mb]
    jw = {f: f() for f in wl_fns}
    jrows = [jcm.pack_workload(jw[f], JZOO["edge"], nmax) for f, _, _ in conds]
    trows = [tcm.pack_workload(port_workload(jw[f]), taccel.ACCEL_ZOO["edge"],
                               nmax, device=CPU) for f, _, _ in conds]
    batches = np.array([16.0 if i % 2 else 32.0 for i in range(len(conds))],
                       np.float32)
    budgets = np.array([b * MB for _, _, b in conds], np.float32)
    return (conds, jrows, trows, batches, budgets,
            [JZOO[p] for _, p, _ in conds],
            [taccel.ACCEL_ZOO[p] for _, p, _ in conds])


@pytest.mark.parametrize("repair", [True, False], ids=["guard", "noguard"])
@pytest.mark.parametrize("wl_fns,nmax", [((tiny_cnn,), 16),
                                         ((tiny_cnn, resnet18), 32)],
                         ids=["tiny16", "mixed32"])
def test_infer_batch_matches_reference(weights, wl_fns, nmax, repair):
    jcfg, params, model = weights
    conds, jrows, trows, batches, budgets, jhw, thw = _grid(
        wl_fns, nmax, [1, 4, 16])
    want = jinf.dnnfuser_infer_batch(params, jcfg, jrows, batches, budgets,
                                     jhw, repair=repair)
    got = tinf.dnnfuser_infer_batch(model, trows, batches, budgets, thw,
                                    repair=repair, device=CPU)
    np.testing.assert_array_equal(to_np(got["strategy"]), want["strategy"])
    np.testing.assert_array_equal(to_np(got["valid"]), want["valid"])
    for k in ("latency", "peak_mem", "speedup"):
        np.testing.assert_allclose(to_np(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)


def test_episode_costs_match_rescore(weights):
    """The episode's own env_final costs equal a re-score of its strategies
    through the evaluator (the check chip_smoke.py makes on the card)."""
    _, _, model = weights
    conds, _, trows, batches, budgets, _, thw = _grid((resnet18,), 32, [2, 8])
    out = tinf.dnnfuser_infer_batch(model, trows, batches, budgets, thw,
                                    device=CPU)
    wls = tcm.stack_workloads(trows)
    re = tcm.evaluate_grid(wls, out["strategy"][:, None, :], batches,
                           budgets, thw)
    for k in ("latency", "peak_mem", "traffic"):
        np.testing.assert_allclose(to_np(getattr(re, k))[:, 0],
                                   to_np(out[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(to_np(re.valid)[:, 0], to_np(out["valid"]))
    np.testing.assert_array_equal(to_np(re.n_groups)[:, 0],
                                  to_np(out["n_groups"]))


def test_infer_fused_single_row(weights):
    _, _, model = weights
    env = tenv.FusionEnv(port_workload(tiny_cnn()), taccel.ACCEL_ZOO["nano"],
                         32, 2 * MB, nmax=16, device=CPU)
    res = tinf.dnnfuser_infer_fused(model, env)
    batch = tinf.dnnfuser_infer_batch(model, [env], [32], [2 * MB],
                                      device=CPU)
    np.testing.assert_array_equal(res.strategy, to_np(batch["strategy"][0]))
    assert res.strategy[0] >= 1 and (res.strategy[env.n + 1:] == -1).all()


def test_guard_rounds():
    assert tinf.guard_rounds(1) == 1
    assert tinf.guard_rounds(64) == 7
    assert tinf.guard_rounds(63) == 6


def test_lane_blocks_change_no_row(weights, monkeypatch):
    """Run in blocks of 4 lanes (the last padded with copies of its last
    row), as the card runs blocks of ``LANE_BLOCK``, every row's outputs
    equal one episode over all rows bit for bit; the CPU runs one
    episode, the card fixed blocks."""
    assert tinf.lane_block("cpu") is None
    assert tinf.lane_block("cuda") == tinf.LANE_BLOCK == 128
    _, _, model = weights
    _, _, trows, batches, budgets, _, thw = _grid((tiny_cnn, resnet18), 32,
                                                  [1, 4, 16])
    C = 10
    wl = tcm.stack_workloads(trows[:C])
    hwv = taccel.stack_hw(thw[:C], C)
    args = (model, wl, torch.as_tensor(batches[:C]),
            torch.as_tensor(budgets[:C]), hwv, taccel.accel_features(hwv))
    one = tinf._fused_batch(*args, repair=True, max_batch=32)
    monkeypatch.setattr(tinf, "lane_block", lambda device: 4)
    blocks = tinf._fused_batch(*args, repair=True, max_batch=32)
    assert set(one) == set(blocks)
    for k in one:
        assert torch.equal(one[k], blocks[k]), k
