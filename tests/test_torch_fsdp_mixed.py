"""bf16 training of the mixed-type LMs under FSDP2 (``launch.steps``).

A bf16 model keeps the MoE router, RWKV's ``w0`` and ``u`` and the SSM's
``A_log`` and ``D`` in f32, as the reference does.  FSDP2 refuses a
trainable group of mixed types, so ``build_train_step`` at its default
``dtype=torch.bfloat16`` raised for qwen3_moe_235b, grok1_314b,
rwkv6_3b and hymba_15b, which the reference trains.  The step now keeps
those leaves whole on every rank (``Placement.whole``) and all-reduces
their gradients itself.

One spawned group of 2 gloo ranks (``tests/_torch_dist_workers.py::
_fsdp_mixed``) trains the four reduced archs at (data 2, model 1), and
qwen3_moe_235b and rwkv6_3b at (data 1, model 2), two bf16 steps each at
``remat="full"`` (the step's default), and hymba_15b at (2, 1) and the
other two at (1, 2) again at ``remat="dots"``, on the reference's
perturbed weights, against one process's bf16 ``make_local_train_step``:

- no leaf changes type, and the f32 leaves are the ones the step keeps
  whole;
- the losses within ``LOSS_RTOL``; every element of every f32 leaf
  moved, and each leaf's update is within ``UPDATE_RTOL`` (relative L2)
  of the local step's: the ranks sum bf16 partial results in another
  order, and Adam's first steps move an element by about lr whatever
  its gradient's size, so where a rounded gradient turns sign the update
  does too (0.26 the most measured, at (1, 2));
- the bytes each step's 'model' collectives moved equal
  ``cost_analysis.parallel_payloads`` at ``act_bytes=2``;
- the first loss within ``REF_LOSS_RTOL`` of the reference's bf16
  ``loss_fn`` at the same weights, and one process's gradients of the
  f32 leaves within a relative L2 distance of the reference's bf16
  ``jax.grad`` of ``max(REF_GRAD_RTOL, the reference's own distance
  from its f32 gradient at the same weights)``: RWKV's ``u`` gradient is
  mostly bf16 rounding (the reference's bf16 one is 0.43 from its f32
  one), the others within 0.05.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_workers as workers
from repro import configs as jconfigs
from repro.checkpoint import save_pytree
from repro.checkpoint.checkpointer import _flatten
from repro.models import registry as jreg
from repro_torch.checkpoint.reference import _stack
from repro_torch.configs import Shape, get_config
from repro_torch.core.model import param_tree
from repro_torch.launch import cost_analysis as ca, train as lt
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import registry

torch.set_num_threads(2)

ARCHS = ["qwen3_moe_235b", "grok1_314b", "rwkv6_3b", "hymba_15b"]
RUNS = [((2, 1), a, "full") for a in ARCHS] + [((2, 1), "hymba_15b",
                                                "dots")] + [
    ((1, 2), a, remat) for a in ("qwen3_moe_235b", "rwkv6_3b")
    for remat in ("full", "dots")]
F32 = {"qwen3_moe_235b": ("/moe/router/w",),
       "grok1_314b": ("/moe/router/w",), "rwkv6_3b": ("/w0", "/u"),
       "hymba_15b": ("/ssm/A_log", "/ssm/D")}
B, S, STEPS = 4, 32, 2
LOSS_RTOL = 2e-3
UPDATE_RTOL = 0.3
REF_LOSS_RTOL = 2e-3
REF_GRAD_RTOL = 0.1


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each arch's perturbed reference weights (f32 on disk; both packages
    cast them to a bf16 model's types)."""
    root = tmp_path_factory.mktemp("fsdp_mixed")
    out = {}
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch, reduced=True)
        jmod = jreg.get_model(jcfg)
        params = jmod.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        rng = np.random.default_rng(0)
        params = jax.tree.map(
            lambda x: x + jnp.asarray(rng.normal(0, 0.05, x.shape), x.dtype),
            params)
        save_pytree(params, root / arch)
        types = jmod.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
        params = jax.tree.map(lambda x, t: x.astype(t.dtype), params, types)
        out[arch] = ({"cfg": get_config(arch, reduced=True),
                      "weights": str(root / arch)}, (jcfg, jmod, params))
    return root, out


@pytest.fixture(scope="module")
def runs(cells):
    """The group's results by (mesh, arch), and the reference's first loss
    and f32 gradients with one process's, computed while the ranks run."""
    root, cell = cells
    out = root / "out"
    out.mkdir()
    inputs = {"runs": RUNS, "cells": {a: c[0] for a, c in cell.items()},
              "S": S, "B": B, "steps": STEPS}
    ctx = mp.spawn(workers.run, args=(2, str(root / "store"), str(out),
                                      ["fsdp_mixed"], inputs),
                   nprocs=2, join=False)
    ref = {a: _reference(c[0], *c[1]) for a, c in cell.items()}
    while not ctx.join():
        pass
    return [torch.load(out / f"fsdp_mixed_{r}.pt", weights_only=False)
            for r in range(2)], ref


def _reference(cell, jcfg, jmod, params):
    """(the reference's bf16 first loss, one process's port loss, and by
    f32 leaf (port bf16 gradient, reference bf16 gradient, reference f32
    gradient)) at the same weights."""
    cfg = cell["cfg"]
    b = lt.make_batch_fn(cfg, seq_len=S, global_batch=B, device="cpu")(0)
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}

    def jgrad(p):
        loss, g = jax.value_and_grad(lambda p: jmod.loss_fn(
            p, jcfg, jb, impl="xla"))(p)
        return float(loss), {k: np.asarray(v, np.float32)
                             for k, v in _flatten(g)[0].items()}
    loss, jg = jgrad(params)
    _, jg32 = jgrad(jax.tree.map(lambda x: x.astype(jnp.float32), params))
    model = workers.bf16_model(cell["weights"], cfg)
    pt = param_tree(model)
    tl = registry.get_model(cfg).loss_fn(model, b)
    g = torch.autograd.grad(tl, list(pt.values()), allow_unused=True,
                            materialize_grads=True)
    got = _stack(dict(zip(pt, g)), cfg)
    keys = [k for k in jg if k.endswith(F32[cfg.name])]
    return loss, float(tl.detach()), {k: (got[k], jg[k], jg32[k])
                                      for k in keys}


def _dist(a, b) -> float:
    """The relative L2 distance of ``a`` from ``b``."""
    a, b = (torch.tensor(np.asarray(x, np.float32)) for x in (a, b))
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("mesh,arch,remat", RUNS)
def test_bf16_step_keeps_types_and_holds_the_local_step(runs, mesh, arch,
                                                        remat):
    for rank in runs[0]:
        r = rank[(mesh, arch, remat)]
        assert r["f32"] and r["whole"] == r["f32"]
        assert all(k.endswith(F32[arch]) for k in r["f32"]), r["f32"]
        for k, (t0, t_fsdp, t_local) in r["types"].items():
            assert t0 == t_fsdp == t_local, k
            assert t0 == (torch.float32 if k in r["f32"] else torch.bfloat16)
        for got, want in r["losses"]:
            assert abs(got - want) <= LOSS_RTOL * abs(want), r["losses"]
        for k, (got, want) in r["update"].items():
            assert bool((got != 0).all()), k
            assert _dist(got, want) <= UPDATE_RTOL, (k, _dist(got, want))
        assert r["losses"] == runs[0][0][(mesh, arch, remat)]["losses"]


@pytest.mark.parametrize("mesh,arch,remat", RUNS)
def test_bf16_collective_bytes_equal_the_payload_model(runs, mesh, arch,
                                                       remat):
    want = ca.parallel_payloads(get_config(arch, reduced=True),
                                Shape("t", S, B, "train"),
                                MeshSpec(mesh, ("data", "model")),
                                act_bytes=2)
    assert (mesh[1] == 1) == (want == {})
    for rank in runs[0]:
        for moved in rank[(mesh, arch, remat)]["moved"]:
            assert moved == want


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_matches_the_reference(runs, arch):
    res, ref = runs
    jloss, tloss, grads = ref[arch]
    assert abs(tloss - jloss) <= REF_LOSS_RTOL * abs(jloss)
    for run in (r for r in RUNS if r[1] == arch):
        got = res[0][run]["losses"][0][0]
        assert abs(got - jloss) <= REF_LOSS_RTOL * abs(jloss), (run, got)
    assert len(grads) == len(F32[arch])
    for k, (got, want, want32) in grads.items():
        tol = max(REF_GRAD_RTOL, _dist(want, want32))
        assert _dist(got, want) <= tol, (k, _dist(got, want), tol)
