"""Where the time of the port's main path goes, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.profile_main_path [--out DIR]
        [--only gsampler,dt_one_shot,qwen3_8b,rwkv6_3b]

Slice 1: answers the smoke grid (6 CNNs x 5 parts x 4 budgets, batch 64,
nmax 64) with the G-Sampler (paper config) and with the DT one-shot
episode (full width, hw-conditioned, seeded random weights).  Slices 2
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
from .core import accel, cost_model as cm, gsampler as gs, infer
from .core import model as dtm
from .kernels import flash_attention as fa, flash_decode as fd
from .kernels import fusion_eval as fe, rwkv6_scan as rk
from .models import lm, rwkv_lm
from .workloads.grid import paper_grid

PORT_KERNELS = {"fusion_eval": fe, "flash_attention": fa,
                "flash_decode": fd, "wkv6": rk}

__all__ = ["profile_phase", "main"]


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
    ap.add_argument("--only", default="gsampler,dt_one_shot,qwen3_8b,"
                    "rwkv6_3b", help="comma-separated phases to run (the "
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
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "conditions": len(conds)}))
    for name, fn in phases.items():
        if name in only:
            print(json.dumps(profile_phase(name, fn, out_dir)))
    del model, packed

    rng = np.random.default_rng(1)
    for arch, mod in (("qwen3_8b", lm), ("rwkv6_3b", rwkv_lm)):
        if arch in only:
            lm_phases(arch, mod, rng, dev, out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
