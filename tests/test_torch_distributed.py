"""The port's distributed paths on several ranks: ``torch.distributed``
over gloo on the CPU, one ``mp.spawn`` per group of checks, each rank's
results returned through files under ``tmp_path`` (its store is a
``file://`` there too, so parallel test workers never share a port).

- data-parallel DT training (``train_model(mesh=)``) at 2 and 4 ranks
  against one process and against the reference's ``train_model`` on the
  same carried weights and numpy batches: losses within ``LOSS_RTOL``,
  parameters within ``PARAM_ATOL`` (f32 sums over the ranks in another
  order, amplified by AdamW's normalisation on near-zero gradients).  The
  corpus's rows hold different mask counts, so the ranks' shares do too
  (checked): a mean of the ranks' means would miss the global mean;
- world size 1 bit-equal to ``mesh=None``;
- GPipe at S = 2 and 4 against sequential stages, the reference test's
  ``tanh(x @ W)``: err < 1e-5;
- ``build_train_step`` at (data=2, model=1), FSDP2, reduced gemma3_1b and
  qwen3_moe against the one-device step (``FSDP_TOL``);
- ``TrainLoop(shardings=)`` at 2 ranks: a run crashed and restarted ends
  bit-identical to a straight one;
- a (data=1, model=2) mesh: every step builder builds and runs (a train
  step, a prefill and a decode step; ``tests/test_torch_tp.py`` holds
  them to one device and to the reference).
"""
import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_workers as workers
from _torch_parity import CPU, port_workload
from repro.checkpoint import save_pytree
from repro.core import dataset as jds, model as jm, train as jtr
from repro.workloads import resnet18, tiny_cnn
from repro_torch.checkpoint import dt_params_from_reference, load_reference
from repro_torch.core import accel as taccel, dataset as tds
from repro_torch.core import gsampler as tgs, model as tm, train as ttr
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import data_parallel_mesh
from repro_torch.launch.mesh import process_group

T = 20
JCFG = jm.DTConfig(n_blocks=1, n_heads=1, d_model=32, d_ff=64, max_steps=T,
                   hw_dim=10)
TC = dict(steps=12, batch_size=16, lr=1e-3, warmup=4, log_every=2, seed=0)
LOSS_RTOL = 1e-5     # DP vs one process vs the reference, per logged step
PARAM_ATOL = 2e-5    # DP vs one process after TC's steps (lr 1e-3)
FSDP_TOL = {"gemma3_1b": (1e-5, 1e-5, 0),
            "qwen3_moe_235b": (1e-5, 1e-5, 2)}
# (loss rtol, param and first-moment atol, elements allowed past it) of
# the FSDP step against the one-device step after 3 steps at lr 3e-4.
# qwen3_moe's Switch aux loss is a product of two batch means: its
# routed-slot shares are summed over the ranks (``nn.moe``), so it is the
# global batch's, as the one-device step's.  An element may pass the
# param atol only where Adam's sqrt(v_hat) is below 10 eps, and by at
# most 3 lr: there the update is ~g / eps, so the rounding of a gradient
# that cancels to ~1e-8 moves it by a share of lr (one element of
# qwen3_moe's embedding, whose gradient is 1.7e-8 in one run and 0 in
# the other)
LR_STEPS = 3 * 3e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, the reference's weights (a checkpoint), and the runs of
    one process (the port and the reference) that the ranks are held
    to."""
    root = tmp_path_factory.mktemp("dist")
    ds = tds.generate_teacher_corpus(
        [port_workload(tiny_cnn()), port_workload(resnet18())],
        taccel.PAPER_ACCEL, batch=64,
        budgets_mb=[2.0, 6.0], max_steps=T, top_k=4,
        ga_cfg=tgs.GSamplerConfig(population=16, generations=6, seed=0),
        seed=0, augment_jitter=1, device=CPU)
    params = jm.dt_init(jax.random.PRNGKey(0), JCFG)
    weights = str(root / "weights")
    save_pytree(params, weights)
    corpus = dict(rtg=ds.rtg, states=ds.states, actions=ds.actions,
                  mask=ds.mask, meta=ds.meta, t0=ds.t0, hw=ds.hw)
    ref_ds = jds.TrajectoryDataset(**corpus)
    _, jlog = jtr.train_model(lambda p, b: jm.dt_loss(p, JCFG, b), params,
                              ref_ds, jtr.TrainConfig(**TC))
    one = dt_params_from_reference(load_reference(weights), n_heads=1,
                                   device=CPU)
    one, log = ttr.train_model(tm.dt_loss, one, ds, ttr.TrainConfig(**TC),
                               device=CPU)
    return dict(root=root, ds=ds, corpus=corpus, weights=weights,
                ref_losses=jlog["losses"], one=one, one_losses=log["losses"])


def _spawn(setup, n, jobs, inputs):
    out = setup["root"] / f"out{n}"
    out.mkdir(exist_ok=True)
    store = setup["root"] / f"store{n}"
    mp.spawn(workers.run, args=(n, str(store), str(out), jobs, inputs),
             nprocs=n, join=True)
    return {job: [torch.load(out / f"{job}_{r}.pt", weights_only=False)
                  for r in range(n)] for job in jobs}


def _mask_counts(ds, n):
    """Each rank's mask count on every step's batch."""
    counts = []
    for it in range(TC["steps"]):
        b = ds.sample(np.random.default_rng([TC["seed"], it]),
                      TC["batch_size"])
        m = np.asarray(b["mask"]).reshape(n, -1)
        counts.append(m.sum(1))
    return np.array(counts)


def _check_dp(setup, res, n):
    assert (np.ptp(_mask_counts(setup["ds"], n), axis=1) > 0).any(), \
        "no step's ranks hold different mask counts"
    one = tm.param_tree(setup["one"])
    for r in res:                          # every rank: the same run
        assert [s for s, _ in r["losses"]] == [s for s, _ in
                                               setup["one_losses"]]
        got = [l for _, l in r["losses"]]
        np.testing.assert_allclose(got, [l for _, l in setup["one_losses"]],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, [l for _, l in setup["ref_losses"]],
                                   rtol=LOSS_RTOL)
        for k, v in r["params"].items():
            np.testing.assert_allclose(v.numpy(), one[k].detach().numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=k)
    for k in res[0]["params"]:             # replicated: bit-equal ranks
        assert all(torch.equal(res[0]["params"][k], r["params"][k])
                   for r in res)


def test_two_ranks(setup):
    inputs = dict(corpus=setup["corpus"], weights=setup["weights"], tc=TC,
                  archs=list(FSDP_TOL), dir=str(setup["root"] / "loop2"),
                  fsdp_atol={a: t[1] for a, t in FSDP_TOL.items()})
    res = _spawn(setup, 2, ["dp_dt", "gpipe", "fsdp", "loop", "tp"], inputs)
    _check_dp(setup, res["dp_dt"], 2)
    assert max(res["gpipe"]) < 1e-5
    for arch, (lr, pa, n_past) in FSDP_TOL.items():
        r = res["fsdp"][0][arch]
        for got, want in r["losses"]:
            assert abs(got - want) <= lr * abs(want), (arch, r["losses"])
        assert r["param_err"] <= pa and r["mu_err"] <= pa, (arch, r)
        assert r["amplified"] <= n_past, (arch, r)
        assert r["amplified_err"] <= LR_STEPS, (arch, r)
        assert r["sharded"] > 0            # o/w, down/w: the plan's dim 1
    for loss, logits, tok in res["tp"]:    # a 'model' axis of 2: runs
        assert np.isfinite(loss) and tok == (2, 1)
        assert logits == (2, 1, get_config("gemma3_1b",
                                           reduced=True).vocab_padded)
    assert len({r[0] for r in res["tp"]}) == 1
    for r in res["loop"]:
        assert r["start"] == 3 and r["equal"], r   # last saved: step 2
        assert r["losses"][0] == r["losses"][1]


def test_four_ranks(setup):
    inputs = dict(corpus=setup["corpus"], weights=setup["weights"], tc=TC)
    res = _spawn(setup, 4, ["dp_dt", "gpipe"], inputs)
    _check_dp(setup, res["dp_dt"], 4)
    assert max(res["gpipe"]) < 1e-5


def test_world_size_one_is_bit_equal_to_no_mesh(setup, tmp_path):
    """A one-rank group: the weight is exactly 1 and the sums are copies,
    so the run (checkpoints included) equals ``mesh=None`` bit for bit."""
    cfg = ttr.TrainConfig(**TC, ckpt_every=4, grad_accum=2)
    model = lambda: dt_params_from_reference(load_reference(
        setup["weights"]), n_heads=1, device=CPU)
    plain, plog = ttr.train_model(tm.dt_loss, model(), setup["ds"], cfg,
                                  device=CPU)
    with process_group(CPU):
        mesh = data_parallel_mesh(device=CPU)
        dp, dlog = ttr.train_model(tm.dt_loss, model(), setup["ds"], cfg,
                                   mesh=mesh, ckpt_dir=str(tmp_path),
                                   device=CPU)
        tuned, _ = ttr.fine_tune(tm.dt_loss, str(tmp_path), setup["ds"],
                                 ttr.TrainConfig(steps=3, batch_size=8),
                                 template=model(), mesh=mesh, device=CPU)
    plain_tuned, _ = ttr.fine_tune(tm.dt_loss, plain, setup["ds"],
                                   ttr.TrainConfig(steps=3, batch_size=8),
                                   device=CPU)
    assert dlog["losses"] == plog["losses"]
    for a, b in ((dp, plain), (tuned, plain_tuned)):
        ta, tb = tm.param_tree(a), tm.param_tree(b)
        assert all(torch.equal(ta[k], tb[k]) for k in ta)


def test_a_mesh_needs_exactly_its_ranks():
    """No silent mesh: two ranks asked of a one-process group raise, and
    so does a second group."""
    with process_group(CPU):
        with pytest.raises(ValueError, match="need 2 ranks"):
            data_parallel_mesh(2, device=CPU)
        with pytest.raises(RuntimeError, match="already initialised"):
            with process_group(CPU):
                pass
