"""Tensor, expert and sequence parallelism of the port's step builders
(``launch.steps`` over ``distributed.tp``) on gloo CPU ranks.

One ``mp.spawn`` a mesh, (data 1, model 2), (1, 4), (2, 2) and (pod 2,
data 1, model 2), each rank running every cell of its mesh (the rank
bodies are ``tests/_torch_dist_workers.py::_tp_cells``); the reduced
configs of the ten archs, grok1 with 3 experts (expert-TP: 3 does not
divide over 'model') and hymba with 5 q-heads over 1 kv-head (attention
whole on every rank), on the reference's perturbed weights carried by
``lm_params_from_reference``:

- train: two ``build_train_step`` steps against ``make_local_train_step``
  (``tests/test_torch_distributed.py``'s recipe): losses within
  ``LOSS_RTOL``, parameters and first moments within ``PARAM_ATOL`` but
  where Adam's sqrt(v_hat) fell below 10 eps, and there by at most
  ``LR_STEPS``;
- serve: ``build_prefill`` + 3 ``build_decode_step`` steps against the
  one-device prefill and decode: tokens equal, logits within
  ``LOGIT_REL`` of the largest; a one-row batch at (2, 2), its cache cut
  over ('data', 'model');
- the reference: at (1, 2) the first loss and the served logits against
  the JAX package's ``loss_fn``/``prefill``/``decode_step`` at
  ``impl="xla"``, within ``TOL`` (``_torch_parity``'s);
- the bytes each step's TP, EP and SP collectives moved on a rank, by
  kind, equal to ``launch.cost_analysis.parallel_payloads``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_workers as workers
from _torch_parity import TOL
from repro import configs as jconfigs
from repro.checkpoint import save_pytree
from repro.models import registry as jreg
from repro_torch.configs import ARCH_NAMES, Shape, get_config
from repro_torch.launch import cost_analysis as ca, train as lt
from repro_torch.launch.mesh import MeshSpec

B, S, P = 4, 32, 24          # batch, train length and cache, prompt
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
LR_STEPS = 2 * 3e-4
LOGIT_REL = 1e-5

CELLS = {a: (a, {}) for a in ARCH_NAMES}
CELLS["grok1_314b/expert_tp"] = ("grok1_314b", {"n_experts": 3})
CELLS["hymba_15b/5_heads"] = ("hymba_15b", {"n_heads": 5, "kv_heads": 1})
MESHES = {
    "1x2": ((1, 2), list(CELLS)),
    "1x4": ((1, 4), ["qwen3_8b", "gemma3_1b", "qwen3_moe_235b", "rwkv6_3b",
                     "whisper_base"]),
    "2x2": ((2, 2), ["qwen3_8b", "qwen3_moe_235b", "hymba_15b",
                     "whisper_base", "qwen2_vl_72b"]),
    "2x1x2": ((2, 1, 2), ["gemma3_1b", "rwkv6_3b", "grok1_314b/expert_tp",
                          "hymba_15b"]),
}
BATCH1 = ("2x2", "qwen3_8b")
RUNS = [(m, c) for m, (_, cells) in MESHES.items() for c in cells]


def _cell(root, name):
    arch, rep = CELLS[name]
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True), **rep)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **rep)
    jmod = jreg.get_model(jcfg)
    params = jmod.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: x + jnp.asarray(rng.normal(0, 0.05, x.shape), x.dtype),
        params)
    weights = root / name.replace("/", "__")
    save_pytree(params, weights)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, P)).astype(np.int64)
    if cfg.family == "encdec":
        prompt = {"embeds": rng.normal(size=(B, 8 * P, cfg.d_model))
                  .astype(np.float32), "tokens": tokens}
        shape = Shape("serve", 8 * S, B, "prefill")
    elif cfg.embed_inputs:
        prompt = {"embeds": rng.normal(size=(B, P, cfg.d_model))
                  .astype(np.float32)}
        shape = Shape("serve", S, B, "prefill")
    else:
        prompt = {"tokens": tokens}
        shape = Shape("serve", S, B, "prefill")
    steps = rng.normal(size=(3, B, 1, cfg.d_model)).astype(np.float32)
    return {"cfg": cfg, "weights": str(weights),
            "serve": {"shape": shape, "prompt": prompt, "steps": steps}}, \
        (jcfg, jmod, params)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    made = {name: _cell(root, name) for name in CELLS}
    return root, {k: v[0] for k, v in made.items()}, \
        {k: v[1] for k, v in made.items()}


@pytest.fixture(scope="module")
def runs(cells):
    """Every mesh's spawn, started together, each rank with one thread;
    the reference's results are computed while they run."""
    root, cell, ref = cells
    started = {}
    for m, (shape, names) in MESHES.items():
        n = math.prod(shape)
        out = root / f"out_{m}"
        out.mkdir()
        inputs = {"mesh": shape, "cells": {c: cell[c] for c in names},
                  "S": S, "B": B,
                  "batch1": BATCH1[1] if m == BATCH1[0] else None}
        started[m] = (n, out, mp.spawn(
            workers.run, args=(n, str(root / f"store_{m}"), str(out),
                               ["tp_cells"], inputs), nprocs=n, join=False))
    want = {name: _reference(cell[name], *ref[name])
            for name in MESHES["1x2"][1]}
    res = {}
    for m, (n, out, ctx) in started.items():
        while not ctx.join():
            pass
        res[m] = [torch.load(out / f"tp_cells_{r}.pt", weights_only=False)
                  for r in range(n)]
    return res, want


def _reference(cell, jcfg, jmod, params):
    """The JAX package's first loss and served logits (greedy, ``impl=
    "xla"``, f32 caches)."""
    cfg, sv = cell["cfg"], cell["serve"]
    b = lt.make_batch_fn(cfg, seq_len=S, global_batch=B, device="cpu")(0)
    loss = float(jmod.loss_fn(params, jcfg, {k: jnp.asarray(v.numpy())
                                             for k, v in b.items()},
                              impl="xla"))
    from repro_torch.models.registry import decode_cache_len
    jb = {k: jnp.asarray(v) for k, v in sv["prompt"].items()}
    logits, state = jmod.prefill(params, jcfg, jb,
                                 decode_cache_len(cfg, sv["shape"]),
                                 impl="xla", cache_dtype=jnp.float32)
    out = [np.asarray(logits)]
    for i in range(3):
        if cfg.embed_inputs and cfg.family != "encdec":
            sb = {"embeds": jnp.asarray(sv["steps"][i])}
        else:
            sb = {"tokens": jnp.asarray(np.asarray(logits[:, -1]).argmax(-1)
                                        [:, None].astype(np.int32))}
        logits, state = jmod.decode_step(params, jcfg, state, sb,
                                         impl="xla")
        out.append(np.asarray(logits))
    return loss, np.concatenate(out, 1)


def _mesh_spec(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return MeshSpec(shape, names)


@pytest.mark.parametrize("mesh,name", RUNS)
def test_train_step_holds_the_one_device_step(runs, mesh, name):
    for rank in runs[0][mesh]:
        r = rank[name]["train"]
        for got, want in r["losses"]:
            assert abs(got - want) <= LOSS_RTOL * abs(want), r["losses"]
        assert r["param_err"] <= PARAM_ATOL and r["mu_err"] <= PARAM_ATOL, r
        assert r["amplified_err"] <= LR_STEPS, r
        assert r["tp_sharded"] > 0
        assert r["losses"] == runs[0][mesh][0][name]["train"]["losses"]


@pytest.mark.parametrize("mesh,name", RUNS)
def test_prefill_and_decode_hold_the_one_device_steps(runs, mesh, name):
    for rank in runs[0][mesh]:
        r = rank[name]["serve"]
        assert r["tokens_equal"], (mesh, name)
        assert r["logit_err"] <= LOGIT_REL * r["logit_max"], r["logit_err"]


def test_batch_of_one_decodes_over_data_and_model(runs):
    """A one-row batch at (2, 2): whole on every rank, the cache's
    positions over the four ranks."""
    mesh, name = BATCH1
    for rank in runs[0][mesh]:
        r = rank[name]["serve1"]
        assert r["tokens_equal"] and r["rows"] == 0
        assert r["logit_err"] <= LOGIT_REL * r["logit_max"]
        merge = r["moved"][1][("sp", "all-gather")]
        assert merge > 0


@pytest.mark.parametrize("name", MESHES["1x2"][1])
def test_sharded_steps_match_the_reference(runs, name):
    res, want = runs
    loss, logits = want[name]
    r = res["1x2"][0][name]
    np.testing.assert_allclose(r["train"]["losses"][0][0], loss, rtol=2e-4)
    np.testing.assert_allclose(r["serve"]["logits"], logits, **TOL)


@pytest.mark.parametrize("mesh,name", RUNS)
def test_collective_bytes_equal_the_payload_model(runs, cells, mesh, name):
    """What each executed step moved on a rank, by part and kind, equals
    ``cost_analysis.parallel_payloads`` at the cell's shapes."""
    cfg = cells[1][name]["cfg"]
    spec = _mesh_spec(MESHES[mesh][0])
    frames = 8 if cfg.family == "encdec" else 1   # whisper: frames a token
    want = {
        "train": ca.parallel_payloads(cfg, Shape("t", S, B, "train"), spec,
                                      act_bytes=4),
        "prefill": ca.parallel_payloads(
            cfg, Shape("p", frames * P, B, "prefill"), spec, act_bytes=4),
        "decode": ca.parallel_payloads(
            cfg, Shape("d", frames * S, B, "decode"), spec, act_bytes=4)}
    for rank in runs[0][mesh]:
        r = rank[name]
        assert r["train"]["moved"][0] == want["train"]
        assert r["train"]["moved"][1] == want["train"]
        assert r["serve"]["moved"][0] == want["prefill"]
        for step in r["serve"]["moved"][1:]:
            assert step == want["decode"]


def test_world_size_one_moves_nothing():
    cfg = get_config("qwen3_moe_235b", reduced=True)
    one = MeshSpec((4, 1), ("data", "model"))
    for kind in ("train", "prefill", "decode"):
        assert ca.parallel_payloads(cfg, Shape("x", S, B, kind), one,
                                    act_bytes=2) == {}


def test_a_train_step_refuses_a_model_placed_for_inference():
    """A placed model keeps its root for the next builder, but a train
    step does not take one an inference builder froze (a one-rank
    group)."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_mesh, process_group
    from repro_torch.models import get_model
    cfg = get_config("gemma3_1b", reduced=True)
    shape = Shape("t", 16, 2, "train")
    with process_group("cpu"):
        mesh = init_mesh((1, 1), ("data", "model"), "cpu")
        model = get_model(cfg).init(cfg, seed=0, dtype=torch.float32,
                                    device="cpu")
        pre, _ = steps.build_prefill(cfg, shape, mesh, dtype=torch.float32)
        assert pre.place(model) is model
        train, _ = steps.build_train_step(cfg, shape, mesh,
                                          dtype=torch.float32)
        with pytest.raises(ValueError, match="placed for inference"):
            train.place(model)
