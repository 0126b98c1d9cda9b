"""Where the time of the port's main path goes, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.profile_main_path [--out DIR]
        [--only gsampler,dt_one_shot,corpus,train_step,serving,qwen3_8b,
                rwkv6_3b]

Slice 1: answers the smoke grid (6 CNNs x 5 parts x 4 budgets, batch 64,
nmax 64) with the G-Sampler (paper config) and with the DT one-shot
episode (full width, hw-conditioned, seeded random weights).  Slice 7:
builds the teacher corpus of that grid (``generate_teacher_corpus``: the
GA, top 8 elites and 2 jittered copies of the top 4, one ``prefix_scan``
decoration; phase ``corpus``) and runs 20 training steps of the same DT on
it (the reference's TrainConfig, batch 64; phase ``train_step``, which
also reports launches and host milliseconds a step).  Slice 8: the
serving stream of the smoke run (``workloads.grid.serving_stream``; its
first 64 requests, bursts of 16-64) through ``repro_torch.serve`` warmed
over the 6 CNNs with the same DT (phase ``serving``; each run takes a
freshly warmed engine, so its cache starts empty).  Slices 2
and 3: qwen3_8b and rwkv6_3b at full width and depth (seeded random
weights) each score 2 x 4096 tokens in bf16 (``forward``), and, in f32
after a 1024-token prefill of batch 4, run 8 greedy decode steps
(``decode_step``).  Each phase
runs once to warm up, once timed without the profiler and once under
``torch.profiler``.  ``--only`` runs the named phases alone, so that one
mapper's wall can be compared between two trees in fresh processes.
Prints one JSON line per phase: host wall time with and without the
profiler, device busy time (the sum of kernel
times; everything runs on one stream, so kernels do not overlap), the
device's idle share, the number of kernel launches, the launches of the
port's own kernels, and the kernels that take the most device time.
Chrome traces go to ``DIR`` (see ``--help`` for the default).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

import numpy as np

from .configs import get_config
from .core import accel, cost_model as cm, dataset, gsampler as gs, infer
from .core import model as dtm, train
from .serving import MapRequest
from .kernels import flash_attention as fa, flash_decode as fd
from .kernels import fusion_eval as fe, rwkv6_scan as rk
from .models import lm, rwkv_lm
from .workloads import CNN_ZOO
from .workloads.grid import paper_grid, serving_stream

PORT_KERNELS = {"fusion_eval": fe, "flash_attention": fa,
                "flash_decode": fd, "wkv6": rk}

__all__ = ["profile_phase", "main"]

TRAIN_STEPS = 20


SERVE_REQUESTS = 64   # the stream's first requests: 1.5M launches a full
                      # stream of 480 is more than the profiler keeps up with


def stream_phase(model, parts, dev):
    """A function that runs the serving stream's first
    :data:`SERVE_REQUESTS` requests once on a freshly warmed engine (three
    are warmed up front, one for each run of :func:`profile_phase`)."""
    from . import serve
    nets = {n: CNN_ZOO[n]() for n in sorted(CNN_ZOO)}
    conds, arrivals = serving_stream(parts, SERVE_REQUESTS)
    reqs = [MapRequest(nets[n], bt, b * 2.0 ** 20, accel.ACCEL_ZOO[p])
            for n, p, b, bt in conds]
    scheds = [serve(model, warm=list(nets.values()), device=dev)
              for _ in range(3)]
    return lambda: scheds.pop().serve_stream(reqs, arrivals)


def profile_phase(name: str, fn, out_dir: pathlib.Path, top: int = 8) -> dict:
    """Run ``fn`` once to warm up, once timed, then once under the
    profiler."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for mod in PORT_KERNELS.values():
        mod.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    port = {k: mod.STATS.launches for k, mod in PORT_KERNELS.items()}
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"{name}.json.gz"))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name: dict[str, list] = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        acc = per_name.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += us
    busy_us = sum(v[1] for v in per_name.values())
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"phase": name, "wall_ms": wall * 1e3,
            "wall_ms_unprofiled": unprofiled * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
            "kernel_launches": len(kernels),
            "port_kernel_launches": port,
            "host_us_per_launch": wall * 1e6 / max(len(kernels), 1),
            "top": [{"kernel": k[:80], "n": v[0], "ms": v[1] / 1e3}
                    for k, v in ranked]}


def lm_phases(arch: str, mod, rng, dev, out_dir: pathlib.Path) -> None:
    """``arch`` scores 2 x 4096 tokens in bf16, then decodes 8 greedy steps
    in f32 after a 1024-token prefill of batch 4."""
    cfg = get_config(arch)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 4096)), device=dev)
    net = mod.init(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    print(json.dumps(profile_phase(
        f"{arch}_scoring", lambda: mod.forward(net, {"tokens": toks}),
        out_dir)))
    del net
    torch.cuda.empty_cache()
    net = mod.init(cfg, seed=0, dtype=torch.float32, device=dev)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 1024)),
                             device=dev)
    _, state = mod.prefill(net, {"tokens": prompt}, 1160,
                           cache_dtype=torch.float32)
    tok = prompt[:, -1:]

    def decode8():
        nonlocal tok
        for _ in range(8):
            logits, _ = mod.decode_step(net, state, {"tokens": tok})
            tok = logits[:, -1].argmax(-1)[:, None]

    print(json.dumps(profile_phase(f"{arch}_decode_8_steps", decode8,
                                   out_dir)))
    del net, state
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile",
                    help="directory for the chrome traces")
    ap.add_argument("--only", default="gsampler,dt_one_shot,corpus,"
                    "train_step,serving,qwen3_8b,rwkv6_3b", help="comma-separated phases to run (the "
                    "LMs' name both their scoring and decode phases)")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    parts = sorted(accel.ACCEL_ZOO)
    conds, workloads, batches, budgets = paper_grid(parts)
    hws = [accel.ACCEL_ZOO[p] for _, p, _ in conds]
    packed = cm.stack_workloads([cm.pack_workload(w, h, 64, device=dev)
                                 for w, h in zip(workloads, hws)])
    model = dtm.dt_init(dtm.DTConfig(hw_dim=accel.HW_FEATURE_DIM), seed=0,
                        device=dev)
    out_dir = pathlib.Path(args.out)
    phases = {
        "gsampler": lambda: gs.gsampler_search_grid(
            workloads, hws, batches, budgets, nmax=64, cfg=gs.GSamplerConfig(),
            top_k=4, packed=packed, device=dev),
        "dt_one_shot": lambda: infer.dnnfuser_infer_batch(
            model, packed, batches, budgets, hws, device=dev),
    }
    nets = workloads[::len(parts) * 4]
    corpus = lambda: dataset.generate_teacher_corpus(
        nets, [accel.ACCEL_ZOO[p] for p in parts], batch=64,
        budgets_mb=[8, 16, 32, 64], max_steps=64, top_k=8, seed=0,
        augment_jitter=2, device=dev)
    phases["corpus"] = corpus
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "conditions": len(conds)}))
    for name, fn in phases.items():
        if name in only:
            print(json.dumps(profile_phase(name, fn, out_dir)))
    if "train_step" in only:
        ds = corpus()
        cfg = train.TrainConfig(steps=TRAIN_STEPS, log_every=TRAIN_STEPS)
        step = lambda: train.train_model(dtm.dt_loss, model, ds, cfg,
                                         device=dev)
        r = profile_phase("train_step", step, out_dir)
        r.update(steps=TRAIN_STEPS,
                 ms_per_step_unprofiled=r["wall_ms_unprofiled"] / TRAIN_STEPS,
                 launches_per_step=r["kernel_launches"] / TRAIN_STEPS)
        print(json.dumps(r))
    if "serving" in only:
        r = profile_phase("serving", stream_phase(model, parts, dev), out_dir)
        r.update(requests=SERVE_REQUESTS,
                 req_per_s_unprofiled=SERVE_REQUESTS / (
                     r["wall_ms_unprofiled"] / 1e3))
        print(json.dumps(r))
    del model, packed

    rng = np.random.default_rng(1)
    for arch, mod in (("qwen3_8b", lm), ("rwkv6_3b", rwkv_lm)):
        if arch in only:
            lm_phases(arch, mod, rng, dev, out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
