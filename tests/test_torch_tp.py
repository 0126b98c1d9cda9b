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
  kind, equal to ``launch.cost_analysis.parallel_payloads``;
- the placement contract, in the (1, 2) group beside a (2, 1) mesh
  (``_tp_refusals``): a placed model refused by every builder on the
  other mesh, both orders; taken, with bit-equal logits, by a builder on
  the same mesh built again; refused by the family's local entry points;
  a decode state from the other mesh refused.  One-rank groups hold the
  rest: a step runs the model it is given, refuses one never placed, and
  a local call at one rank stays bit-equal.
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
REFUSALS = ["gemma3_1b", "rwkv6_3b"]   # the first for every check, the
                                       # rest for the decode state's
MESH_NAME = {"1x2": "(data 1, model 2) over ranks [[0, 1]]",
             "2x1": "(data 2, model 1) over ranks [[0], [1]]"}
ORDERS = [("1x2", "2x1"), ("2x1", "1x2")]


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
                  "batch1": BATCH1[1] if m == BATCH1[0] else None,
                  "refusals": REFUSALS, "dir": str(root / "refusals")}
        jobs = ["tp_cells"] + (["tp_refusals"] if m == "1x2" else [])
        started[m] = (n, out, mp.spawn(
            workers.run, args=(n, str(root / f"store_{m}"), str(out),
                               jobs, inputs), nprocs=n, join=False))
    want = {name: _reference(cell[name], *ref[name])
            for name in MESHES["1x2"][1]}
    res = {}
    for m, (n, out, ctx) in started.items():
        while not ctx.join():
            pass
        res[m] = [torch.load(out / f"tp_cells_{r}.pt", weights_only=False)
                  for r in range(n)]
    out = root / "out_1x2"
    res["refusals"] = [torch.load(out / f"tp_refusals_{r}.pt",
                                  weights_only=False) for r in range(2)]
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


@pytest.mark.parametrize("kind", ["prefill", "decode", "train",
                                  "prefill call", "decode call"])
@pytest.mark.parametrize("first,second", ORDERS)
def test_a_builder_on_another_mesh_refuses_a_placed_model(runs, first,
                                                          second, kind):
    """A model placed by ``build_prefill`` on one mesh, given to a builder
    on the other (``place``, or a step called on it unplaced): a
    ``ValueError`` naming both meshes on every rank (the train step's
    before its refusal of a frozen model), as the reference's
    ``in_shardings`` name both shardings."""
    for rank in runs[0]["refusals"]:
        err = rank["other_mesh"][(first, second, kind)]
        assert err is not None and err[0] == "ValueError", err
        assert MESH_NAME[first] in err[1] and MESH_NAME[second] in err[1]


def test_a_rebuilt_equal_mesh_takes_the_model_bit_equal(runs):
    """``init_mesh`` called again with the same shape and names: its
    builder takes the placed model and answers bit-equal logits."""
    for rank in runs[0]["refusals"]:
        assert rank["rebuilt"] is None and rank["rebuilt_equal"]


@pytest.mark.parametrize("entry", ["forward", "prefill", "decode_step",
                                   "loss_fn", "make_local_train_step",
                                   "TrainLoop"])
@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_a_local_call_refuses_a_model_placed_on_two_ranks(runs, mesh,
                                                          entry):
    """A family's entry point outside any step, on a model whose leaves
    are shards: a ``ValueError`` naming the mesh and ``full_tree``, never
    the out-of-range lookup or the DTensor mix of an unchecked call."""
    for rank in runs[0]["refusals"]:
        err = rank["local"][(mesh, entry)]
        assert err is not None and err[0] == "ValueError", err
        assert MESH_NAME[mesh] in err[1] and "full_tree" in err[1]


@pytest.mark.parametrize("first,second", ORDERS)
@pytest.mark.parametrize("name", REFUSALS)
def test_a_decode_step_refuses_a_state_from_another_mesh(runs, name, first,
                                                         second):
    """A decode step on one mesh given a state a prefill made on the other
    (the reference refuses it by its ``in_shardings``): refused on every
    rank by its shapes, where gemma3_1b's (1, 2) state answered on (2, 1)
    before (its cache half as long, twice the rows)."""
    for rank in runs[0]["refusals"]:
        err = rank["state"][(name, first, second)]
        assert err is not None and err[0] == "ValueError", err
        assert MESH_NAME[second] in err[1]


def _one_rank_serving(seed_b=1):
    """A one-rank group's mesh, two prefill and two decode builders, two
    models (seeds 0 and ``seed_b``) and a prompt of reduced gemma3_1b."""
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    cfg = get_config("gemma3_1b", reduced=True)
    shape = Shape("s", 32, 2, "decode")
    mod = get_model(cfg)
    a, b = (mod.init(cfg, seed=s, dtype=torch.float32, device="cpu")
            for s in (0, seed_b))
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12)))
    return cfg, shape, mod, a, b, {"tokens": tokens}


def test_a_step_runs_the_model_it_is_given():
    """``pre`` placed A; B placed by a second builder on the same mesh:
    ``pre(B)`` and ``dec(B)`` answer B's logits and tokens, bit-equal to
    B's own builders', not A's (which they answered before)."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_mesh, process_group
    cfg, shape, mod, a, b, batch = _one_rank_serving()
    with process_group("cpu"):
        mesh = init_mesh((1, 1), ("data", "model"), "cpu")
        pre, _ = steps.build_prefill(cfg, shape, mesh, dtype=torch.float32)
        dec, _ = steps.build_decode_step(cfg, shape, mesh,
                                         dtype=torch.float32)
        pre_b, _ = steps.build_prefill(cfg, shape, mesh, dtype=torch.float32)
        dec_b, _ = steps.build_decode_step(cfg, shape, mesh,
                                           dtype=torch.float32)
        dec.place(pre.place(a))
        dec_b.place(pre_b.place(b))
        got, state = pre(b, batch)
        want, want_state = pre_b(b, batch)
        of_a = pre(a, batch)[0]
        assert torch.equal(got, want)
        assert not torch.equal(got, of_a)
        tok = want[:, -1:].argmax(-1)
        for _ in range(3):
            t, state = dec(b, state, {"tokens": tok})
            tok, want_state = dec_b(b, want_state, {"tokens": tok})
            assert torch.equal(t, tok)
        assert torch.equal(state["k"], want_state["k"])


def test_a_step_refuses_a_model_never_placed():
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_mesh, process_group
    cfg, shape, mod, a, b, batch = _one_rank_serving()
    with process_group("cpu"):
        mesh = init_mesh((1, 1), ("data", "model"), "cpu")
        pre, _ = steps.build_prefill(cfg, shape, mesh, dtype=torch.float32)
        dec, _ = steps.build_decode_step(cfg, shape, mesh,
                                         dtype=torch.float32)
        logits, state = pre(pre.place(a), batch)
        tok = {"tokens": logits[:, -1:].argmax(-1)}
        with pytest.raises(RuntimeError, match=r"place\(model\) first"):
            pre(b, batch)
        with pytest.raises(RuntimeError, match=r"place\(model\) first"):
            dec(b, state, tok)
        with pytest.raises(RuntimeError, match=r"place\(model\) first"):
            pre.run(b, lambda m: None)


def test_a_rebuilt_equal_mesh_takes_a_placed_model():
    """``init_mesh`` called twice with the same shape and names: the
    second mesh's builder takes the model the first placed, and answers
    bit-equal logits."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_mesh, process_group
    cfg, shape, mod, a, b, batch = _one_rank_serving()
    with process_group("cpu"):
        first = init_mesh((1, 1), ("data", "model"), "cpu")
        pre, _ = steps.build_prefill(cfg, shape, first, dtype=torch.float32)
        want = pre(pre.place(a), batch)[0]
        second = init_mesh((1, 1), ("data", "model"), "cpu")
        again, _ = steps.build_prefill(cfg, shape, second,
                                       dtype=torch.float32)
        assert again.place(a) is a
        assert torch.equal(again(a, batch)[0], want)


def test_a_local_call_at_one_rank_is_bit_equal():
    """On a one-rank mesh the leaves are whole: once a step has run the
    model, the family's ``prefill`` and ``forward`` outside any step
    answer bit-equal to an unplaced model's, as the reference computes a
    call on committed arrays."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_mesh, process_group
    cfg, shape, mod, a, b, batch = _one_rank_serving(seed_b=0)
    f32 = dict(cache_dtype=torch.float32)
    want = mod.prefill(b, batch, 32, **f32)[0]
    want_fwd = mod.forward(b, batch)
    with process_group("cpu"):
        mesh = init_mesh((1, 1), ("data", "model"), "cpu")
        pre, _ = steps.build_prefill(cfg, shape, mesh, dtype=torch.float32)
        assert torch.equal(pre(pre.place(a), batch)[0], want)
        assert torch.equal(mod.prefill(a, batch, 32, **f32)[0], want)
        assert torch.equal(mod.forward(a, batch), want_fwd)


def test_a_train_step_refuses_a_model_placed_for_inference():
    """A placed model is taken by the next builder on its mesh, but a
    train step does not take one an inference builder froze (a one-rank
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
