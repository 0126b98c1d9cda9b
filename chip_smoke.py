#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: name, power limit, torch and CUDA versions;
2. build: ``nvcc`` builds ``kernels/csrc/fusion_eval.cu`` for sm_90a from
   this checkout, and a probe kernel launches;
3. kernel against its plain version: ``fusion_eval`` and
   ``fusion_eval_grid_stats_plain`` on the same card inputs (every zoo part
   serving an edge packing, so the BPE rescale runs; the main path's
   P=64 x pop 40 grid and a population of 133), bit for bit;
4. G-Sampler on the card: the paper's config over 120 conditions (6 CNNs
   x 5 parts x 4 budgets, batch 64, nmax 64), through the kernel;
5. DT one shot on the card: a full-width, hw-conditioned DT with seeded
   random weights answers the same 120 conditions in one batched episode,
   and its strategies are re-scored through the kernel.

The last lines are the card's ``nvidia-smi`` name and power limit, a JSON
line with each kernel's launches, error and times, and
``{"ok": true, "device": {...}}``.  It imports nothing of JAX and nothing
of the JAX package, and exits non-zero without output when no CUDA device
is present or the port's sources are not beside it.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

NMAX = 64
BATCH = 64
BUDGETS_MB = (8, 16, 32, 64)
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
FE_OPS_PER_POSITION = 48        # f32 operations of one live (candidate, pos)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fe_bound_ms(C: int, POP: int, P: int, live_positions: int):
    """Least time for one fusion_eval call: each input read once, each
    output written once, over HBM; f32 operations over the f32 peak."""
    bytes_ = (C * POP * P * 4                    # strategies
              + C * P * (5 * 4 + 4)              # A W F OE UC, SKIP
              + C * (4 + 4 + 4 + 10 * 4)         # n, batch, BPE, hw row
              + 7 * C * POP * P * 4)             # six f32 + gid outputs
    ops = POP * live_positions * FE_OPS_PER_POSITION
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), bytes_


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import accel, cost_model as cm, gsampler as gs
    from repro_torch.core import infer, model as dtm
    from repro_torch.kernels import _build, fusion_eval as fe
    from repro_torch.workloads import CNN_ZOO
    from repro_torch.workloads.grid import paper_grid

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1/5] device: {kind} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | devices "
          f"{torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(fe.SOURCE)
    fe.compiled_backend_supported()
    info = _build.build_info(fe.SOURCE)
    print(f"[2/5] build: fusion_eval.cu in {info['build_s']:.2f} s "
          f"(cached={info['cached']}), probe ok, phase "
          f"{time.perf_counter() - t0:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"      ptxas: {line.strip()}")

    # -- conditions ---------------------------------------------------------
    parts = sorted(accel.ACCEL_ZOO)
    conds, workloads, batches, budgets = paper_grid(parts, BUDGETS_MB, BATCH)
    C = len(conds)
    hws = [accel.ACCEL_ZOO[p] for _, p, _ in conds]
    packed = cm.stack_workloads([cm.pack_workload(w, h, NMAX, device=dev)
                                 for w, h in zip(workloads, hws)])
    n_of = np.array([w.n for w in workloads])
    names = sorted(CNN_ZOO)
    wls = {n: CNN_ZOO[n]() for n in names}
    rng = np.random.default_rng(0)

    def population(n_rows, pop):
        return torch.as_tensor(np.stack([
            np.stack([cm.random_strategy(rng, int(k), NMAX, BATCH,
                                         p_sync=0.1 + 0.6 * (j % 5) / 4)
                      for j in range(pop)]) for k in n_rows]), device=dev)

    # -- 3. kernel against its plain version ---------------------------------
    edge_packed = cm.stack_workloads([
        cm.pack_workload(wls[n], accel.ACCEL_ZOO["edge"], NMAX, device=dev)
        for n in names for _ in parts])
    edge_hw = [accel.ACCEL_ZOO[p] for _ in names for p in parts]
    edge_n = [wls[n].n for n in names for _ in parts]
    cases = [("zoo-served-edge-pack pop40", edge_packed, edge_hw, edge_n, 40),
             ("zoo-served-edge-pack pop133", edge_packed, edge_hw, edge_n,
              133),
             ("main-path grid pop40", packed, hws, n_of, 40)]
    max_err = 0.0
    main_args = None
    for label, wl_rows, hw_rows, n_rows, pop in cases:
        strat = population(n_rows, pop)
        Cc = strat.shape[0]
        args = fe.kernel_args(wl_rows, strat,
                              torch.full((Cc,), float(BATCH), device=dev),
                              hw_rows)
        got = fe.fusion_eval_raw(*args)
        want = fe.fusion_eval_grid_stats_plain(*args)
        torch.cuda.synchronize()
        mask = wl_rows["mask"][:, None, :].expand_as(got[6])
        check(torch.equal(got[6][mask], want[6][mask]),
              f"{label}: gid differs under the mask")
        check(torch.equal(got[5], want[5]), f"{label}: glen differs")
        errs = [float((g - w).abs().max()) for g, w in zip(got[:5], want[:5])]
        max_err = max(max_err, *errs)
        for nm, g, w in zip(("C_g", "T_g", "O_g", "M_g", "wave_g"), got, want):
            check(torch.equal(g, w), f"{label}: {nm} not bit-equal to the "
                  f"plain version (max abs err {float((g - w).abs().max())})")
        print(f"[3/5] kernel == plain on {label} [{Cc}x{pop}x{NMAX}]: "
              f"bit-equal (max abs err {max(errs)})")
        if label.startswith("main-path"):
            main_args = args
    tiny_args = (main_args[0][:1, :1],) + tuple(a[:1] for a in main_args[1:])
    k_ms = time_ms(lambda: fe.fusion_eval_raw(*main_args), 200)
    p_ms = time_ms(lambda: fe.fusion_eval_grid_stats_plain(*main_args), 20)
    launch_ms = time_ms(lambda: fe.fusion_eval_raw(*tiny_args), 200)
    live = int(n_of.sum())
    bound_ms, bound_by, nbytes = fe_bound_ms(C, 40, NMAX, live)
    print(f"      fusion_eval at [{C}x40x{NMAX}]: kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, "
          f"{nbytes} bytes); one-candidate call {launch_ms:.4f} ms")

    # -- 4. G-Sampler on the card -------------------------------------------
    cfg = gs.GSamplerConfig()
    fe.reset_launches()
    t0 = time.perf_counter()
    res = gs.gsampler_search_grid(workloads, hws,
                                  batches, budgets, nmax=NMAX, cfg=cfg,
                                  top_k=4, packed=packed, device=dev)
    gs_wall = time.perf_counter() - t0
    gs_launches = fe.STATS.launches
    want_launches = 18 + cfg.generations * (1 + cfg.repair_tries) + 1
    check(gs_launches == want_launches,
          f"G-Sampler launched fusion_eval {gs_launches} times, expected "
          f"{want_launches}")
    best = np.where(res.valid, res.speedup, 0.0).max(1)
    check(np.isfinite(res.latency).all() and res.strategies.shape ==
          (C, 4, NMAX), "G-Sampler result malformed")
    check(res.valid[:, 0].mean() > 0.5, "G-Sampler found too few valid "
          "strategies")
    print(f"[4/5] G-Sampler pop {cfg.population} x {cfg.generations} gens "
          f"over {C} conditions: wall {gs_wall:.3f} s, fusion_eval launches "
          f"{gs_launches}, mean best speedup {best.mean():.4f}, valid share "
          f"{res.valid[:, 0].mean():.4f}")

    # -- 5. DT one shot on the card -----------------------------------------
    model = dtm.dt_init(dtm.DTConfig(hw_dim=accel.HW_FEATURE_DIM), seed=0,
                        device=dev)
    infer.dnnfuser_infer_batch(model, packed, batches, budgets, hws,
                               device=dev)             # warm-up
    torch.cuda.synchronize()
    fe.reset_launches()
    t0 = time.perf_counter()
    out = infer.dnnfuser_infer_batch(model, packed, batches, budgets, hws,
                                     device=dev)
    torch.cuda.synchronize()
    dt_wall = time.perf_counter() - t0
    re = cm.evaluate_grid(packed, out["strategy"][:, None, :], batches,
                          budgets, hws)
    torch.cuda.synchronize()
    dt_launches = fe.STATS.launches
    check(dt_launches == 1, f"re-score launched fusion_eval {dt_launches} "
          f"times, expected 1")
    strat = out["strategy"].cpu().numpy()
    check(((strat[:, 0] >= 1) & (strat[:, 0] <= BATCH)).all(),
          "DT input micro-batch out of range")
    for k in ("latency", "peak_mem", "traffic"):
        a = getattr(re, k)[:, 0].cpu().numpy()
        b = out[k].cpu().numpy()
        check(np.isfinite(b).all(), f"DT {k} not finite")
        check(np.allclose(a, b, rtol=1e-5, atol=0),
              f"DT {k} differs from the kernel re-score "
              f"(max rel {np.max(np.abs(a - b) / np.abs(b))})")
    check(torch.equal(re.valid[:, 0], out["valid"]), "DT valid differs")
    check(torch.equal(re.n_groups[:, 0], out["n_groups"]),
          "DT n_groups differs")
    dt_valid = out["valid"].float().mean().item()
    dt_speed = out["speedup"][out["valid"]].mean().item() if dt_valid else 0.0
    print(f"[5/5] DT one shot (3x2x128, hw_dim 10, seeded random weights) "
          f"over {C} conditions: wall {dt_wall:.4f} s, valid share "
          f"{dt_valid:.4f}, mean valid speedup {dt_speed:.4f}; re-score "
          f"matches (rtol 1e-5); G-Sampler/DT wall ratio "
          f"{gs_wall / dt_wall:.1f} (informative)")
    print(f"      total {time.perf_counter() - t_all:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fusion_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fusion_eval.cu",
        "replaces": "src/repro/kernels/fusion_eval.py:57",
        "launches": gs_launches + dt_launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
