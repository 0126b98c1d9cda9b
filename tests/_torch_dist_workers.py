"""Rank bodies of ``tests/test_torch_distributed.py``, in a module of
their own so that a spawned rank imports only torch and the port.  Not
collected by pytest.

Each rank joins a gloo group over a ``file://`` store under the test's
``tmp_path`` (no TCP port: the suite runs in parallel workers), runs the
named jobs, and leaves its results in ``out/<job>_<rank>.pt``."""
import os

import numpy as np
import torch
import torch.distributed as dist

CPU = "cpu"


def run(rank, n, store, out, jobs, inputs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        for job in jobs:
            res = globals()[f"_{job}"](rank, n, inputs)
            torch.save(res, os.path.join(out, f"{job}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _dp_dt(rank, n, inputs):
    """Data-parallel DT training on the carried reference weights."""
    from repro_torch.checkpoint import dt_params_from_reference, load_reference
    from repro_torch.core import dataset as tds, model as tm, train as ttr
    from repro_torch.distributed.sharding import data_parallel_mesh
    ds = tds.TrajectoryDataset(**inputs["corpus"])
    model = dt_params_from_reference(load_reference(inputs["weights"]),
                                     n_heads=1, device=CPU)
    mesh = data_parallel_mesh(device=CPU)
    model, log = ttr.train_model(tm.dt_loss, model, ds,
                                 ttr.TrainConfig(**inputs["tc"]), mesh=mesh,
                                 device=CPU)
    return {"losses": log["losses"],
            "params": {k: v.detach().clone()
                       for k, v in tm.param_tree(model).items()}}


def _gpipe(rank, n, inputs):
    """The reference test's ``tanh(x @ W)`` stages, S = n."""
    from repro_torch.distributed.pipeline import (make_stage_mesh,
                                                  pipeline_forward)
    rng = np.random.default_rng(0)
    S, n_micro, mb, d = n, 8, 2, 16
    Ws = torch.as_tensor(rng.normal(size=(S, d, d)) / np.sqrt(d),
                         dtype=torch.float32)
    xs = torch.as_tensor(rng.normal(size=(n_micro, mb, d)),
                         dtype=torch.float32)
    out = pipeline_forward(Ws, xs, lambda W, x: torch.tanh(x @ W),
                           make_stage_mesh(S, device=CPU),
                           n_microbatches=n_micro)
    want = xs
    for i in range(S):
        want = torch.tanh(want @ Ws[i])
    return float((out - want).abs().max())


def _fsdp(rank, n, inputs):
    """``build_train_step`` on a (data=n, model=1) mesh against the
    one-device step, for each arch of ``inputs["archs"]``."""
    from repro_torch import optim
    from repro_torch.configs import Shape, get_config
    from repro_torch.core.model import param_tree
    from repro_torch.launch import steps, train as lt
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import get_model
    mesh = init_mesh((n, 1), ("data", "model"), CPU)
    res = {}
    for arch in inputs["archs"]:
        cfg = get_config(arch, reduced=True)
        S, B = 32, 4
        step, _ = steps.build_train_step(cfg, Shape("t", S, B, "train"),
                                         mesh, dtype=torch.float32)
        mod = get_model(cfg)
        model = step.place(mod.init(cfg, seed=0, dtype=torch.float32,
                                    device=CPU))
        opt = step.init_opt(model)
        ref = mod.init(cfg, seed=0, dtype=torch.float32, device=CPU)
        tx = optim.adamw(3e-4, weight_decay=0.01, max_grad_norm=1.0)
        local = lt.make_local_train_step(cfg, tx)
        ropt = tx.init(param_tree(ref))
        batch_fn = lt.make_batch_fn(cfg, seq_len=S, global_batch=B,
                                    device=CPU)
        losses = []
        for i in range(3):
            b = batch_fn(i)
            model, opt, loss = step(model, opt, b)
            ref, ropt, rl = local(ref, ropt, b)
            losses.append((float(loss), float(rl)))
        full = step.full_tree(model)
        mu = step.gather_opt(model, opt).mu
        # where sqrt(v_hat) is within 10x of Adam's eps (1e-8) the update
        # is ~g / eps: the rounding of a gradient that cancels to ~0 is
        # lifted to a share of lr
        atol = inputs["fsdp_atol"][arch]
        errs = [((full[k].detach() - v.detach()).abs(),
                 (ropt.nu[k] / (1 - 0.999 ** 3)).sqrt() < 1e-7)
                for k, v in param_tree(ref).items()]
        res[arch] = {
            "losses": losses,
            "param_err": max(float(torch.where(a, 0.0, e).max())
                             for e, a in errs),
            "amplified": sum(int((a & (e > atol)).sum()) for e, a in errs),
            "amplified_err": max(float(torch.where(a, e, 0.0).max())
                                 for e, a in errs),
            "mu_err": max(float((mu[k] - v).abs().max())
                          for k, v in ropt.mu.items()),
            "sharded": sum(p.placements[0].dim != 0 for p in
                           param_tree(model).values())}
    return res


def _loop(rank, n, inputs):
    """``TrainLoop(shardings=)`` at n ranks: straight against crashed and
    restarted, bit for bit."""
    from repro_torch.configs import Shape, get_config
    from repro_torch.launch import steps, train as lt
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import get_model
    from repro_torch.runtime import TrainLoop
    mesh = init_mesh((n, 1), ("data", "model"), CPU)
    cfg = get_config("gemma3_1b", reduced=True)
    S, B = 16, 4
    batch_fn = lt.make_batch_fn(cfg, seq_len=S, global_batch=B, device=CPU)

    def loop(ckpt):
        step, _ = steps.build_train_step(cfg, Shape("t", S, B, "train"),
                                         mesh, dtype=torch.float32)
        model = step.place(get_model(cfg).init(cfg, seed=0,
                                               dtype=torch.float32,
                                               device=CPU))
        return step, TrainLoop(step, model, step.init_opt(model), batch_fn,
                               ckpt_dir=ckpt, ckpt_every=2, shardings=step,
                               log_every=1)
    step, a = loop(os.path.join(inputs["dir"], "a"))
    a.run(6)
    straight = step.full_tree(a.model)
    _, b = loop(os.path.join(inputs["dir"], "b"))
    try:
        b.run(6, crash_at=3)
    except RuntimeError:
        pass
    step, c = loop(os.path.join(inputs["dir"], "b"))
    start = c.start_step
    c.run(6)
    resumed = step.full_tree(c.model)
    return {"start": start,
            "equal": all(torch.equal(straight[k], resumed[k])
                         for k in straight),
            "losses": (a.losses[-1], c.losses[-1])}


def _tp(rank, n, inputs):
    """A (data=1, model=n) mesh: every step builder builds and runs
    (reduced gemma3_1b: a train step, a prefill and a decode step)."""
    from repro_torch.configs import Shape, get_config
    from repro_torch.launch import steps, train as lt
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import get_model
    mesh = init_mesh((1, n), ("data", "model"), CPU)
    cfg = get_config("gemma3_1b", reduced=True)
    shape = Shape("t", 16, 2, "train")
    model = get_model(cfg).init(cfg, seed=0, dtype=torch.float32, device=CPU)
    train, _ = steps.build_train_step(cfg, shape, mesh, dtype=torch.float32)
    model = train.place(model)
    b = lt.make_batch_fn(cfg, seq_len=16, global_batch=2, device=CPU)(0)
    model, opt, loss = train(model, train.init_opt(model), b)
    pre, _ = steps.build_prefill(cfg, shape, mesh, dtype=torch.float32)
    dec, _ = steps.build_decode_step(cfg, shape, mesh, dtype=torch.float32)
    assert pre.place(model) is model and dec.place(model) is model
    logits, state = pre(model, {"tokens": b["tokens"][:, :8]})
    tok, state = dec(model, state, {"tokens": logits[:, -1:].argmax(-1)})
    return [float(loss), tuple(logits.shape), tuple(tok.shape)]


# -- tensor, expert and sequence parallelism (tests/test_torch_tp.py) -------

def _tp_mesh(shape):
    from repro_torch.launch.mesh import init_mesh
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return init_mesh(shape, names, CPU)


def _tp_model(cell):
    from repro_torch.checkpoint import load_reference, lm_params_from_reference
    return lm_params_from_reference(load_reference(cell["weights"]),
                                     cell["cfg"], device=CPU)


def _tp_train(cell, mesh, S, B):
    """Two ``build_train_step`` steps against ``make_local_train_step`` on
    the same carried weights: losses, and the parameters and moments
    gathered whole (``_fsdp``'s recipe, applied after every step: an element
    may pass the atol only where Adam's sqrt(v_hat) fell below 10 eps at
    some step, where the update is ~g / eps and the rounding of a
    gradient that cancels to ~1e-8 moves it by a share of lr)."""
    from repro_torch import optim
    from repro_torch.configs import Shape
    from repro_torch.core.model import param_tree
    from repro_torch.launch import steps, train as lt
    cfg = cell["cfg"]
    step, _ = steps.build_train_step(cfg, Shape("t", S, B, "train"), mesh,
                                     dtype=torch.float32)
    model = step.place(_tp_model(cell))
    opt = step.init_opt(model)
    ref = _tp_model(cell)
    tx = optim.adamw(3e-4, weight_decay=0.01, max_grad_norm=1.0)
    local = lt.make_local_train_step(cfg, tx)
    ropt = tx.init(param_tree(ref))
    batch_fn = lt.make_batch_fn(cfg, seq_len=S, global_batch=B, device=CPU)
    losses, moved = [], []
    amp = {k: torch.zeros(v.shape, dtype=torch.bool)
           for k, v in param_tree(ref).items()}
    for i in range(2):
        b = batch_fn(i)
        step.par.moved.clear()
        model, opt, loss = step(model, opt, b)
        moved.append(dict(step.par.moved))
        ref, ropt, rl = local(ref, ropt, b)
        losses.append((float(loss), float(rl)))
        for k in amp:
            amp[k] |= (ropt.nu[k] / (1 - 0.999 ** (i + 1))).sqrt() < 1e-7
    full = step.full_tree(model)
    mu = step.gather_opt(model, opt).mu
    errs = [((full[k].detach() - v.detach()).abs(), amp[k])
            for k, v in param_tree(ref).items()]
    return {"losses": losses,
            "param_err": max(float(torch.where(a, 0.0, e).max())
                             for e, a in errs),
            "amplified_err": max(float(torch.where(a, e, 0.0).max())
                                 for e, a in errs),
            "mu_err": max(float((mu[k] - v).abs().max())
                          for k, v in ropt.mu.items()),
            "tp_sharded": sum(step.model_sharded(k) for k in step.specs),
            "moved": moved}


def _tp_serve(cell, mesh, B):
    """``build_prefill`` + 3 decode steps against the one-device prefill
    and decode steps on the same weights and inputs: each step's logits
    (gathered whole) and tokens.  A decode step runs the family's
    ``decode_step`` under the ``build_decode_step`` placement, as the
    step does, to read its logits; the step's own token is their
    argmax."""
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    cfg, serve = cell["cfg"], cell["serve"]
    shape = serve["shape"]
    pre, _ = steps.build_prefill(cfg, shape, mesh, dtype=torch.float32)
    dec, _ = steps.build_decode_step(cfg, shape, mesh, dtype=torch.float32)
    model = pre.place(_tp_model(cell))
    dec.place(model)
    one = _tp_model(cell)
    mod = get_model(cfg)
    batch = {k: torch.as_tensor(v[:B]) for k, v in serve["prompt"].items()}
    step = lambda m, s, b: mod.decode_step(m, s, b, impl="kernel")
    logits, state = pre(model, batch)
    want, wstate = mod.prefill(one, batch, pre.max_len,
                               cache_dtype=torch.float32)
    got, ref = [logits], [want]
    toks, wtoks, moved = [], [], [dict(pre.par.moved)]
    for i in range(3):
        step_in = serve["steps"][i]
        tok_w = want[:, -1:].argmax(-1)
        sb = {"embeds": torch.as_tensor(step_in[:B])} if cfg.embed_inputs \
            and cfg.family != "encdec" else {"tokens": tok_w}
        dec.par.moved.clear()
        dec.par.seq = dec._seq(sb, dec.max_len)
        logits, state = dec.run(model, step, state, dec.share(sb))
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        moved.append(dict(dec.par.moved))
        want, wstate = mod.decode_step(one, wstate, sb)
        toks.append(tok)
        wtoks.append(want[:, -1:].argmax(-1).to(torch.int32))
        got.append(logits[:, -1:])
        ref.append(want)
    got, ref = torch.cat(got, 1), torch.cat(ref, 1)
    rows = pre.share(batch)
    lo = pre.rank * next(iter(rows.values())).shape[0] \
        if B % pre.n == 0 else 0
    ref = ref[lo:lo + got.shape[0]]
    wtoks = torch.cat(wtoks, 1)[lo:lo + got.shape[0]]
    return {"logit_err": float((got - ref).abs().max()),
            "logit_max": float(ref.abs().max()),
            "tokens_equal": bool(torch.equal(torch.cat(toks, 1), wtoks)),
            "logits": got.numpy(), "rows": lo, "moved": moved}


def _tp_cells(rank, n, inputs):
    """Every cell of ``inputs["cells"]`` on the mesh ``inputs["mesh"]``:
    train (2 steps) and serve (prefill + 3 decode steps), each against
    the one-device port."""
    from repro_torch.configs import Shape
    mesh = _tp_mesh(inputs["mesh"])
    res = {}
    for name, cell in inputs["cells"].items():
        res[name] = {"train": _tp_train(cell, mesh, inputs["S"],
                                        inputs["B"]),
                     "serve": _tp_serve(cell, mesh, inputs["B"])}
        if inputs.get("batch1") == name:       # the SP form of a 1-row batch
            res[name]["serve1"] = _tp_serve(cell, mesh, 1)
    return res


def _refusal(fn):
    """``(type name, message)`` of what ``fn()`` raised, None if it ran."""
    try:
        fn()
    except Exception as e:                 # recorded, and asserted by the test
        return type(e).__name__, str(e)
    return None


def _tp_refusals(rank, n, inputs):
    """The placement contract on two ranks, a (1, 2) mesh and a (2, 1) one
    over the same group, on the cells ``inputs["refusals"]`` (the first
    for every check, the rest for the decode state's): a model placed by
    ``build_prefill`` on one mesh given to each builder on the other
    (placed, and called without placing), and to a builder on the first
    mesh built again (its logits against the first builder's); the
    family's local entry points on a placed model; a decode step on one
    mesh given a state a prefill made on the other.  Each rank records
    what each call raised."""
    from repro_torch import optim
    from repro_torch.core.model import param_tree
    from repro_torch.launch import steps, train as lt
    from repro_torch.models import get_model
    from repro_torch.runtime import TrainLoop
    meshes = {"1x2": _tp_mesh((1, 2)), "2x1": _tp_mesh((2, 1))}
    again = _tp_mesh((1, 2))
    build = {"prefill": steps.build_prefill,
             "decode": steps.build_decode_step,
             "train": steps.build_train_step}
    res = {"other_mesh": {}, "local": {}, "state": {}}
    for i, name in enumerate(inputs["refusals"]):
        cell = inputs["cells"][name]
        cfg, shape = cell["cfg"], cell["serve"]["shape"]
        mod = get_model(cfg)
        batch = {k: torch.as_tensor(v) for k, v in
                 cell["serve"]["prompt"].items()}
        for a, b in (("1x2", "2x1"), ("2x1", "1x2")):
            pre, _ = steps.build_prefill(cfg, shape, meshes[a],
                                         dtype=torch.float32)
            model = pre.place(_tp_model(cell))
            logits, state = pre(model, batch)
            tok = logits[:, -1:].argmax(-1)
            other = {k: f(cfg, shape, meshes[b], dtype=torch.float32)[0]
                     for k, f in build.items()}
            dec, _ = steps.build_decode_step(cfg, shape, meshes[b],
                                             dtype=torch.float32)
            mine = dec.place(_tp_model(cell))
            res["state"][(name, a, b)] = _refusal(
                lambda: dec(mine, state, {"tokens": tok}))
            if i:
                continue
            for k, step in other.items():
                res["other_mesh"][(a, b, k)] = _refusal(
                    lambda: step.place(model))
            res["other_mesh"][(a, b, "prefill call")] = _refusal(
                lambda: other["prefill"](model, batch))
            res["other_mesh"][(a, b, "decode call")] = _refusal(
                lambda: other["decode"](model, state, {"tokens": tok}))
            if a == "1x2":
                pre2, _ = steps.build_prefill(cfg, shape, again,
                                              dtype=torch.float32)
                res["rebuilt"] = _refusal(lambda: pre2.place(model))
                res["rebuilt_equal"] = bool(torch.equal(
                    pre2(model, batch)[0], logits))
            tx = optim.adamw(3e-4, weight_decay=0.01, max_grad_norm=1.0)
            train = lt.make_batch_fn(cfg, seq_len=inputs["S"],
                                     global_batch=inputs["B"], device=CPU)
            opt = tx.init(param_tree(model))
            local = lt.make_local_train_step(cfg, tx)
            calls = {
                "forward": lambda: mod.forward(model, batch),
                "prefill": lambda: mod.prefill(model, batch, pre.max_len),
                "decode_step": lambda: mod.decode_step(model, state,
                                                       {"tokens": tok}),
                "loss_fn": lambda: mod.loss_fn(model, train(0)),
                "make_local_train_step": lambda: local(model, opt, train(0)),
                "TrainLoop": lambda: TrainLoop(
                    local, model, opt, train, ckpt_dir=os.path.join(
                        inputs["dir"], f"{a}_{rank}")).run(1)}
            for k, call in calls.items():
                res["local"][(a, k)] = _refusal(call)
    return res


# -- bf16 training of the mixed-type LMs (tests/test_torch_fsdp_mixed.py) ---

def bf16_model(weights, cfg):
    """The reference's perturbed weights carried in f32, then each leaf
    cast to the type a bf16 model gives it (f32 for the router, RWKV's
    decay and the SSM's state, bf16 for the rest)."""
    from repro_torch.checkpoint import load_reference, lm_params_from_reference
    from repro_torch.core.model import param_tree
    from repro_torch.launch.steps import abstract_model
    model = lm_params_from_reference(load_reference(weights), cfg, device=CPU)
    types = {k: t.dtype for k, t in param_tree(abstract_model(cfg)).items()}
    for k, p in param_tree(model).items():
        p.data = p.data.to(types[k])
    return model


def _mixed_train(cell, mesh, S, B, n_steps, remat):
    """``n_steps`` bf16 ``build_train_step`` steps at ``remat`` against bf16
    ``make_local_train_step`` on the same weights: losses, the leaves'
    types, each f32 leaf's update, and what the 'model' collectives
    moved a step."""
    from repro_torch import optim
    from repro_torch.configs import Shape
    from repro_torch.core.model import param_tree
    from repro_torch.launch import steps, train as lt
    cfg = cell["cfg"]
    step, _ = steps.build_train_step(cfg, Shape("t", S, B, "train"), mesh,
                                     remat=remat)
    model = step.place(bf16_model(cell["weights"], cfg))
    opt = step.init_opt(model)
    ref = bf16_model(cell["weights"], cfg)
    start = {k: v.detach().clone() for k, v in param_tree(ref).items()}
    tx = optim.adamw(3e-4, weight_decay=0.01, max_grad_norm=1.0)
    local = lt.make_local_train_step(cfg, tx)
    ropt = tx.init(param_tree(ref))
    batch_fn = lt.make_batch_fn(cfg, seq_len=S, global_batch=B, device=CPU)
    losses, moved = [], []
    for i in range(n_steps):
        b = batch_fn(i)
        step.par.moved.clear()
        model, opt, loss = step(model, opt, b)
        moved.append(dict(step.par.moved))
        ref, ropt, rl = local(ref, ropt, b)
        losses.append((float(loss), float(rl)))
    full = step.full_tree(model)
    local_tree = param_tree(ref)
    f32 = sorted(k for k, v in start.items() if v.dtype == torch.float32)
    return {"losses": losses, "whole": sorted(step.whole), "f32": f32,
            "types": {k: (start[k].dtype, full[k].dtype,
                          local_tree[k].dtype) for k in start},
            "update": {k: ((full[k].detach() - start[k]).float(),
                           (local_tree[k].detach() - start[k]).float())
                       for k in f32},
            "moved": moved}


def _fsdp_mixed(rank, n, inputs):
    """Every (mesh, cell) of ``inputs["runs"]`` in this group."""
    res = {}
    meshes = {}
    for mesh, name, remat in inputs["runs"]:
        if mesh not in meshes:
            meshes[mesh] = _tp_mesh(mesh)
        res[(mesh, name, remat)] = _mixed_train(
            inputs["cells"][name], meshes[mesh], inputs["S"], inputs["B"],
            inputs["steps"], remat)
    return res
