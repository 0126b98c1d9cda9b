"""Where the time of the port's main path goes, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.profile_main_path [--out DIR]

Answers the smoke grid (6 CNNs x 5 parts x 4 budgets, batch 64, nmax 64)
with the G-Sampler (paper config) and with the DT one-shot episode
(full width, hw-conditioned, seeded random weights), each once to warm up
and once under ``torch.profiler``.  Prints one JSON line per phase: host
wall time, device busy time (the sum of kernel times; everything runs on
one stream, so kernels do not overlap), the device's idle share, the
number of kernel launches, and the kernels that take the most device
time.  Chrome traces go to ``DIR`` (default ``chiprun_out/profile``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from .core import accel, cost_model as cm, gsampler as gs, infer
from .core import model as dtm
from .kernels import fusion_eval as fe
from .workloads.grid import paper_grid

__all__ = ["profile_phase", "main"]


def profile_phase(name: str, fn, out_dir: pathlib.Path, top: int = 8) -> dict:
    """Run ``fn`` once to warm up, then once under the profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fe.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches_fe = fe.STATS.launches
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
            "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
            "kernel_launches": len(kernels),
            "fusion_eval_launches": launches_fe,
            "host_us_per_launch": wall * 1e6 / max(len(kernels), 1),
            "top": [{"kernel": k[:80], "n": v[0], "ms": v[1] / 1e3}
                    for k, v in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile",
                    help="directory for the chrome traces")
    args = ap.parse_args(argv)
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
        print(json.dumps(profile_phase(name, fn, out_dir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
