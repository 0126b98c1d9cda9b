"""Quickstart on the PyTorch port: the full DNNFuser pipeline.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The twin of ``examples/quickstart.py`` on ``repro_torch``; it runs on the
CUDA card unless ``--device cpu`` is given.

1. G-Sampler (the search-based teacher) searches fusion strategies for
   VGG16 at a few on-chip-buffer conditions;
2. the trajectories are decorated into (reward, state, action) sequences
   and a decision transformer is imitation-trained on them;
3. the trained mapper infers a strategy one shot at an unseen 28 MB
   condition (no search), and a fresh search answers the same condition.
"""
import argparse
import time

from repro_torch.core import (DTConfig, FusionEnv, PAPER_ACCEL, TrainConfig,
                              collect_teacher_data, dnnfuser_infer, dt_init,
                              dt_loss, gsampler_search, train_model)
from repro_torch.workloads import vgg16

MB = 2 ** 20


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device
    wl = vgg16()
    print(wl.summary())

    print("\n[1/3] teacher: G-Sampler searching @ 16/32/48/64 MB ...")
    t0 = time.perf_counter()
    ds = collect_teacher_data([wl], PAPER_ACCEL, batch=64,
                              budgets_mb=[16, 32, 48, 64], max_steps=20,
                              device=dev)
    print(f"      {len(ds)} trajectories in {time.perf_counter()-t0:.1f}s; "
          f"teacher speedups up to {max(m[2] for m in ds.meta):.2f}x")

    print("[2/3] student: imitation-training the decision transformer ...")
    cfg = DTConfig(max_steps=20)
    model = dt_init(cfg, seed=0, device=dev)
    model, log = train_model(dt_loss, model, ds,
                             TrainConfig(steps=300, batch_size=16),
                             device=dev)
    print(f"      final imitation loss {log['final_loss']:.4f} "
          f"({log['wall_s']:.0f}s)")

    print("[3/3] one-shot inference at UNSEEN condition 28 MB ...")
    env = FusionEnv(wl, PAPER_ACCEL, batch=64, budget_bytes=28 * MB,
                    nmax=20, device=dev)
    df = dnnfuser_infer(model, env)
    gs = gsampler_search(env)
    n = wl.n
    print(f"      DNNFuser : speedup {df.speedup:.2f}x usage "
          f"{df.peak_mem/MB:5.1f}MB in {df.wall_s*1e3:6.0f} ms (one shot)")
    print(f"      G-Sampler: speedup {gs.speedup:.2f}x usage "
          f"{gs.peak_mem/MB:5.1f}MB in {gs.wall_s*1e3:6.0f} ms (2k samples)")
    print("      strategy:", [int(v) for v in df.strategy[: n + 1]])


if __name__ == "__main__":
    main()
