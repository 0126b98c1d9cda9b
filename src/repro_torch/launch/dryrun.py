"""Dry-run of every (arch x shape) cell on the production meshes: the
per-device budget of a sharded step, without devices (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3_1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table [--out DIR]

The reference lowers and compiles each cell on 256/512 fake host devices
and reads XLA's memory and cost analyses.  The port runs the cell's step
on ``meta`` and fake tensors on one host and prices it by the plan
(``distributed.sharding``), per device of a ``launch.mesh.MeshSpec``:

- argument bytes, exact from the plan: each parameter's, AdamW moment's
  (train), batch leaf's and decode-state leaf's shard;
- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the whole step
  (forward and backward for train, at ``remat="full"`` as
  ``launch.steps.build_train_step`` runs it, the recomputed forward
  counted) on ``meta`` tensors at one device,
  divided by the data-parallel size and, module by module, by the TP
  size where the plan shards that module's weights ('model' replicated
  leaves, the head-count vetoes, are counted on every TP rank);
- temporaries: ``torch.distributed._tools.mem_tracker.MemTracker`` under
  ``FakeTensorMode``, the larger of two peaks: the step's at one
  device's share of the batch (activations, the whole model's gradients
  and temporaries; a bound, where FSDP2 keeps a gradient shard and TP
  would shard activations) and a train step's update's, scaled by the
  plan's per-device share of the parameters;
- collective bytes: from the plan (``launch.cost_analysis``: FSDP's
  gathers and scatters, and the TP, EP and SP payloads the sharded steps
  make, held equal to what the CPU ranks of the tests count);
- the three roofline terms on H100 datasheet constants and the
  bottleneck.  All are predictions.

The port's layer loops are Python loops (so are Hymba's SSM scan, RWKV's
``wkv_scan`` and the chunked attention), and a full-depth count would
walk every layer: as the reference does (its ``dryrun.py:80-95``), each
cell is counted at L = 1 and L = 2 and extrapolated linearly to the
config's depth (the reference enters ``nn.flags.force_unroll`` there to
unroll its scans; the port has no scan to unroll).  ``impl="dense"`` (the
reference's ``"xla"``): the kernels do not run on ``meta``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch

__all__ = ["lower_cell", "run_cell", "step_costs", "argument_bytes",
           "with_layers", "main"]


def with_layers(cfg, n: int):
    kw = {"n_layers": n}
    if cfg.family == "encdec":
        kw["encoder_layers"] = n
    return dataclasses.replace(cfg, **kw)


def _local_shape(shape, mesh):
    """One device's share of the batch (a batch below the data-parallel
    size stays whole)."""
    from .mesh import axis_sizes, dp_axes
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in dp_axes(mesh))
    B = shape.global_batch
    return dataclasses.replace(shape, global_batch=B // dp if B % dp == 0
                               else B)


def _run_step(cfg, shape, args, dtype, remat: str = "full"):
    """The cell's step on the given (meta or fake) arguments; a train
    step at ``remat`` (``launch.steps.build_train_step``'s default)."""
    from ..models import registry
    mod = registry.get_model(cfg)
    if shape.kind == "train":
        model, _, batch = args
        loss = mod.loss_fn(model, batch, impl="dense", remat=remat)
        loss.backward()
    elif shape.kind == "prefill":
        model, batch = args
        mod.prefill(model, batch, registry.decode_cache_len(cfg, shape),
                    impl="dense", cache_dtype=dtype)
    else:
        model, state, batch = args
        mod.decode_step(model, state, batch, impl="dense")


def _tp_divisors(cfg, specs: dict, tp: int):
    """``(div, root)``: ``div(path)`` is the TP divisor of the FLOPs of a
    block's sublayer (``attn``, ``mlp``, ``moe``, RWKV's ``r``...): the TP
    size where the plan shards a weight under it on 'model' (attention:
    where the query heads divide), else 1; ``root`` that of the model's
    own leaves (the vocab-sharded embedding and head)."""
    under: dict[str, list] = {}
    for k, s in specs.items():
        parts = k.split("/")
        if parts[0] in ("blocks", "enc_blocks", "dec_blocks") \
                and len(parts) > 2 and parts[1].isdigit():
            under.setdefault(parts[2], []).append(s)

    def div(sub: str) -> int:
        if sub in ("attn", "xattn"):
            return tp if cfg.n_heads % tp == 0 else 1
        return tp if any("model" in s for s in under.get(sub, ())) else 1
    root = tp if any("model" in specs.get(k, ()) for k in
                     ("head/w", "embed/emb", "tok/emb")) else 1
    return div, root


_COUNTS: dict = {}
_ARGS: dict = {}


def _abstract(cfg, shape, dtype):
    """``steps.abstract_args`` of the cell, built once a process (meta
    tensors: nothing is allocated, and nothing writes them)."""
    from . import steps
    key = (repr(cfg), repr(shape), str(dtype))
    if key not in _ARGS:
        if len(_ARGS) > 8:
            _ARGS.clear()
        _ARGS[key] = steps.abstract_args(cfg, shape, dtype=dtype)
    return _ARGS[key]


def _flops(cfg, shape, mesh, dtype, specs) -> tuple[float, float]:
    """(FLOPs of the whole step at one device, per-device FLOPs under the
    plan) on ``meta`` tensors.  The counter attributes a backward op to
    the module whose hook is live, which can be a sibling leaf of the one
    that owns the weight, and merges same-named blocks, so the division
    is made per block sublayer (``Block.attn`` with its leaves), where
    the attribution is whole.  The rest (the embedding, head and loss, and
    a block's products outside its sublayers: the MoE expert products,
    the WKV recurrence) is divided as the head is."""
    from torch.utils.flop_counter import FlopCounterMode
    from . import steps
    from .mesh import axis_sizes, dp_axes
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in dp_axes(mesh))
    key = (repr(cfg), repr(shape), str(dtype))
    if key not in _COUNTS:              # the count is the mesh's to divide
        args = steps.abstract_args(cfg, shape, dtype=dtype)
        with FlopCounterMode(display=False) as fc:
            _run_step(cfg, shape, args, dtype)
        _COUNTS[key] = (float(fc.get_total_flops()), {
            k: float(sum(v.values()))
            for k, v in fc.get_flop_counts().items() if k != "Global"})
    total, counts = _COUNTS[key]
    div, root_div = _tp_divisors(cfg, specs, sizes["model"])
    per, subs = 0.0, 0.0
    for name, v in counts.items():
        if name.count(".") == 1:
            subs += v
            per += v / div(name.split(".")[1])
    per += (total - subs) / root_div
    return total, per / dp


def _temporaries(cfg, shape, dtype) -> tuple[float, float]:
    """``(step, update)``: the peak activation + gradient + temporary
    bytes of the step at ``shape`` (one device's share; forward and
    backward for train), and of a train step's update (the clip and
    AdamW of ``launch.steps`` over the whole model, whose ``_foreach``
    results are whole-size temporaries; 0 otherwise), each from its own
    ``MemTracker`` under ``FakeTensorMode``.  Each is linear in the depth
    where their maximum is not, so they are extrapolated apart."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType
    from .. import optim
    from ..core.model import param_tree
    from ..models import registry
    from .steps import MAX_GRAD_NORM
    with FakeTensorMode():
        model = registry.get_model(cfg).MODEL(cfg, device="cpu", dtype=dtype)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
                 registry.input_specs(cfg, shape, act_dtype=dtype).items()}
        tx = optim.adamw(3e-4, weight_decay=0.01,
                         max_grad_norm=MAX_GRAD_NORM)
        params = param_tree(model)
        opt = tx.init(params) if shape.kind == "train" else None
        if shape.kind == "train":
            args = (model, opt, batch)
        elif shape.kind == "prefill":
            args = (model, batch)
        else:
            state = registry.get_model(cfg).init_decode_state(
                cfg, shape.global_batch, registry.decode_cache_len(cfg, shape),
                dtype=dtype, device="cpu")
            args = (model, state, batch)
        peaks = []
        for phase in ("step", "update"):
            if phase == "update" and opt is None:
                peaks.append(0.0)
                continue
            mt = MemTracker()
            mt.track_external(model)
            with mt:
                if phase == "step":
                    _run_step(cfg, shape, args, dtype)
                else:
                    grads = {k: torch.zeros_like(p) if p.grad is None
                             else p.grad for k, p in params.items()}
                    updates, _ = tx.update(grads, opt, params)
                    optim.apply_updates(params, updates)
            per_dev = next(iter(mt.get_tracker_snapshot("peak").values()))
            peaks.append(float(sum(per_dev.get(t, 0) for t in (
                _MemRefType.ACT, _MemRefType.TEMP, _MemRefType.GRAD,
                _MemRefType.OTH))))
    return peaks[0], peaks[1]


def argument_bytes(cfg, shape, mesh, *, dtype=torch.bfloat16) -> dict:
    """Per-device bytes of the step's arguments under the plan, exact:
    ``{"params", "moments", "batch", "state", "total"}``."""
    from ..distributed.sharding import (batch_specs,
                                        decode_state_specs_sharded,
                                        param_specs, shard_bytes)
    from ..core.model import param_tree
    args = _abstract(cfg, shape, dtype)
    model, batch = args[0], args[-1]
    leaves = param_tree(model)
    specs = param_specs(leaves, mesh, cfg)
    out = {"params": sum(shard_bytes(t.shape, t.element_size(), specs[k],
                                     mesh) for k, t in leaves.items()),
           "moments": 0, "batch": 0, "state": 0}
    if shape.kind == "train":
        out["moments"] = 2 * sum(shard_bytes(t.shape, 4, specs[k], mesh)
                                 for k, t in leaves.items())
    bs = batch_specs(batch, mesh, shard_seq=False)
    out["batch"] = sum(shard_bytes(t.shape, t.element_size(), bs[k], mesh)
                       for k, t in batch.items())
    if shape.kind == "decode":
        state = args[1]
        ss = decode_state_specs_sharded(state, mesh,
                                        shard_seq=shape.global_batch == 1)

        def walk(tree, spec):
            n = 0
            for k, v in tree.items():
                if isinstance(v, dict):
                    n += walk(v, spec[k])
                elif isinstance(v, torch.Tensor):
                    n += shard_bytes(v.shape, v.element_size(), spec[k],
                                     mesh)
            return n
        out["state"] = walk(state, ss)
    out["total"] = sum(out[k] for k in ("params", "moments", "batch",
                                        "state"))
    return out


def step_costs(cfg, shape, mesh, *, dtype=torch.bfloat16) -> dict:
    """FLOPs (whole step and per device) and temporaries of the cell at
    ``cfg``'s depth, from its L = 1 and L = 2 variants.  The update's
    temporaries are elementwise over each device's shards, so they are
    scaled by the plan's per-device share of the parameter bytes; the
    step's hold the whole model's gradients (a bound: FSDP2 keeps a
    device's shard of each block's gradients once the backward has
    passed it)."""
    from ..core.model import param_tree
    from ..distributed.sharding import param_specs, shard_bytes
    from . import steps
    vals = []
    local = _local_shape(shape, mesh)
    for n in (1, 2):
        c = with_layers(cfg, n)
        leaves = param_tree(steps.abstract_model(c, dtype))
        specs = param_specs(leaves, mesh, c)
        total, per = _flops(c, shape, mesh, dtype, specs)
        share = sum(shard_bytes(t.shape, t.element_size(), specs[k], mesh)
                    for k, t in leaves.items()) / sum(
            t.numel() * t.element_size() for t in leaves.values())
        step, update = _temporaries(c, local, dtype)
        vals.append((total, per, step, update * share))
    L = cfg.n_layers
    ext = lambda i: max(vals[0][i] + (vals[1][i] - vals[0][i]) * (L - 1),
                        0.0)
    return {"flops_total": ext(0), "flops_per_device": ext(1),
            "temp_bytes": max(ext(2), ext(3)), "temp_step": ext(2),
            "temp_update": ext(3)}


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6 N_active D for train, 2 N_active D
    otherwise (one token a sequence for decode)."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        return 2.0 * n * shape.global_batch
    k = 6.0 if shape.kind == "train" else 2.0
    return k * n * shape.global_batch * shape.seq_len


def lower_cell(arch, shape_name, *, multi_pod: bool = False, mesh=None,
               dtype=torch.bfloat16, cfg=None, shape=None) -> dict:
    """The per-device budget of one cell (``arch``/``shape_name``, or a
    given ``cfg``/``shape`` and ``mesh``) on the production mesh."""
    from ..configs import SHAPES, get_config
    from ..core.model import param_tree
    from ..distributed.sharding import param_specs
    from . import cost_analysis as ca
    from .mesh import make_production_mesh, mesh_size, MeshSpec
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        if not isinstance(mesh, MeshSpec):
            mesh = MeshSpec(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    n_dev = mesh_size(mesh)
    t0 = time.perf_counter()
    args = argument_bytes(cfg, shape, mesh, dtype=dtype)
    costs = step_costs(cfg, shape, mesh, dtype=dtype)
    cell = _abstract(cfg, shape, dtype)
    leaves = param_tree(cell[0])
    specs = param_specs(leaves, mesh, cfg)
    act = torch.empty((), dtype=dtype).element_size()
    coll = ca.collective_bytes(specs, leaves, cfg, shape, mesh,
                               act_bytes=act)
    if shape.kind == "train":
        touched = 4 * args["params"] + 2 * args["moments"] + args["batch"]
    elif shape.kind == "prefill":
        touched = args["params"] + args["batch"]
    else:
        touched = args["params"] + 2 * args["state"] + args["batch"]
    byts = touched + 2 * costs["temp_bytes"]
    rep = ca.roofline_terms(flops=costs["flops_per_device"],
                            bytes_accessed=byts, coll_bytes=coll["total"],
                            n_devices=n_dev,
                            model_flops=model_flops(cfg, shape),
                            peak=ca.peak_flops(dtype), link=ca.link_rate(mesh))
    name = "x".join(str(s) for s in axis_tuple(mesh))
    return {
        "arch": cfg.name if arch is None else arch,
        "shape": shape.name, "mesh": name, "n_devices": n_dev,
        "kind": shape.kind, "impl": "dense", "dtype": str(dtype),
        "remat": "full" if shape.kind == "train" else None, "ok": True,
        "t_count_s": time.perf_counter() - t0,
        "memory": {"argument_size_in_bytes": args["total"],
                   "arguments": args,
                   "temp_size_in_bytes": costs["temp_bytes"],
                   "temp_step": costs["temp_step"],
                   "temp_update": costs["temp_update"],
                   "temp_source": "MemTracker under FakeTensorMode, one "
                                  "device's batch share, the update by "
                                  "the plan's parameter share; the "
                                  "step's gradients whole, activations "
                                  "not TP-aware",
                   "peak_size_in_bytes": args["total"]
                   + costs["temp_bytes"]},
        "flops_total": costs["flops_total"],
        "flops_per_device": costs["flops_per_device"],
        "bytes_per_device": byts, "collectives": coll,
        "roofline": rep.as_dict(), "prediction": True,
    }


def axis_tuple(mesh) -> tuple:
    from .mesh import axis_sizes
    return tuple(axis_sizes(mesh).values())


def run_cell(arch, shape_name, multi_pod, out_dir, force=False, **kw):
    tag = f"{arch}__{shape_name}__{'2x16x16' if multi_pod else '16x16'}"
    path = out_dir / f"{tag}.json"
    if path.exists() and not force:
        rec = json.loads(path.read_text())
        if rec.get("ok"):
            print(f"[cached] {tag}: "
                  f"{rec.get('roofline', {}).get('bottleneck')}")
            return rec
    try:
        rec = lower_cell(arch, shape_name, multi_pod=multi_pod, **kw)
    except Exception as e:  # a failure here is a bug in the system
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16", "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    path.write_text(json.dumps(rec, indent=1))
    if rec["ok"]:
        r, m = rec["roofline"], rec["memory"]
        print(f"[ok] {tag}: counted in {rec['t_count_s']:.1f}s, args "
              f"{m['argument_size_in_bytes'] / 2**30:.2f} GiB/dev, temp "
              f"{m['temp_size_in_bytes'] / 2**30:.2f} GiB/dev, terms c/m/x = "
              f"{r['t_compute'] * 1e3:.2f}/{r['t_memory'] * 1e3:.2f}/"
              f"{r['t_collective'] * 1e3:.2f} ms -> {r['bottleneck']}")
    else:
        print(f"[FAIL] {tag}: {rec['error']}")
    return rec


def _figures(r: dict) -> str:
    """One cell's figures per device, "16x16 / 2x16x16" where both meshes
    were run: argument + temporary GiB, TFLOPs, collective GB, the
    bottleneck, the compute / memory / collective terms in ms on the first
    mesh, and the host seconds the counts took."""
    if not all(x.get("ok") for x in r):
        return "failed"

    def both(get, spec=".2f"):
        return "/".join(format(get(x), spec) for x in r)
    t = r[0]["roofline"]
    return (f"{both(lambda x: x['memory']['argument_size_in_bytes'] / 2**30)}"
            f" + {both(lambda x: x['memory']['temp_size_in_bytes'] / 2**30)}"
            f" GiB; {both(lambda x: x['flops_per_device'] / 1e12, '.3f')} "
            f"TFLOP; {both(lambda x: x['collectives']['total'] / 1e9)} GB; "
            f"{both(lambda x: x['roofline']['bottleneck'], '')}; "
            f"{t['t_compute'] * 1e3:.1f}/{t['t_memory'] * 1e3:.1f}/"
            f"{t['t_collective'] * 1e3:.1f} ms; "
            f"{both(lambda x: x['t_count_s'], '.1f')} s")


_SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def table(out_dir) -> str:
    """The cells saved under ``out_dir`` as a markdown table, a row an arch
    and a column a shape, each cell as :func:`_figures` gives it."""
    cells: dict = {}
    for path in sorted(pathlib.Path(out_dir).glob("*.json")):
        r = json.loads(path.read_text())
        cells.setdefault(r["arch"], {}).setdefault(r["shape"], {})[
            r["mesh"]] = r
    shapes = sorted({s for by in cells.values() for s in by},
                    key=lambda s: (_SHAPE_ORDER + (s,)).index(s))
    rows = ["| arch | " + " | ".join(shapes) + " |",
            "|" + "---|" * (len(shapes) + 1)]
    for arch, by_shape in sorted(cells.items()):
        figs = []
        for s in shapes:
            by_mesh = by_shape.get(s)
            figs.append("—" if by_mesh is None else _figures(
                [by_mesh[m] for m in ("16x16", "2x16x16") if m in by_mesh]))
        rows.append(f"| {arch} | " + " | ".join(figs) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--table", action="store_true",
                    help="print the cells under --out as a markdown table")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    if args.table:
        print(table(out_dir))
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    from ..configs import cells
    if args.all:
        todo = [(a, s) for a, s, ok, why in cells(include_skipped=False)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    n_fail = 0
    t0 = time.perf_counter()
    for a, s in todo:
        for mp in meshes:
            rec = run_cell(a, s, mp, out_dir, force=args.force)
            n_fail += 0 if rec.get("ok") else 1
    print(f"done: {len(todo) * len(meshes)} cells, {n_fail} failures, "
          f"{time.perf_counter() - t0:.1f} s")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
