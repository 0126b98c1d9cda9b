"""One mapper, one engine, one loop, on the PyTorch port: serving that
repairs itself.

    PYTHONPATH=src python examples/serve_mapper_torch.py [--device cpu]
        [--requests 96] [--steps 300]

The twin of ``examples/serve_mapper.py`` on ``repro_torch``; it runs on the
CUDA card unless ``--device cpu`` is given.

1. train an hw-conditioned mapper on a G-Sampled corpus (edge + mobile);
2. ``repro_torch.serve`` builds the engine and the async scheduler from one
   ``ServingConfig`` and warms the engine up;
3. a mixed stream arrives one request at a time: the scheduler coalesces
   it into batched episodes and answers repeats from the strategy cache,
   with no new signature;
4. the strategy cache is saved and a FRESH engine answers the stream from
   the file, with no episode;
5. the traffic drifts to a part the mapper never trained on: the drift
   monitor fires, a ``RefreshWorker`` G-Samples the drifted region,
   fine-tunes off the serving path and, if the candidate passes the probe
   gate, swaps it in behind the running scheduler, keeping the
   non-drifted cached answers bit-exact.
"""
import argparse
import pathlib
import tempfile
import time

import numpy as np

import repro_torch
from repro_torch import (ACCEL_ZOO, DriftConfig, DTConfig, GSamplerConfig,
                         HW_FEATURE_DIM, MapperEngine, MapRequest,
                         RefreshWorker, ServingConfig, TrainConfig, dt_init,
                         dt_loss, generate_teacher_corpus, train_model)
from repro_torch.workloads import resnet18, tiny_cnn, vgg16

MB = 2 ** 20


def pump_stream(sched, stream, worker=None, gap_s=1e-3):
    """Submit one request per ``gap_s`` of simulated time; with a refresh
    worker, poll it between pumps (the refresh runs between ticks, never
    on a request)."""
    futures = []
    for i, req in enumerate(stream):
        futures.append(sched.submit(req, now=i * gap_s))
        sched.pump(now=i * gap_s)
        if worker is not None:
            worker.poll()
    sched.drain(now=len(stream) * gap_s)
    if worker is not None:
        worker.poll()
    return futures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--tick", type=int, default=16)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    dev = args.device

    train_nets = [vgg16(), tiny_cnn()]
    train_accels = [ACCEL_ZOO["edge"], ACCEL_ZOO["mobile"]]
    print("[1/5] training an hw-conditioned mapper "
          "(teacher @ 16-64 MB on edge + mobile) ...")
    ds = generate_teacher_corpus(
        train_nets, train_accels, batch=64, budgets_mb=[16, 32, 48, 64],
        max_steps=20, ga_cfg=GSamplerConfig(population=24, generations=20),
        device=dev)
    cfg = DTConfig(max_steps=20, hw_dim=HW_FEATURE_DIM)
    model = dt_init(cfg, seed=0, device=dev)
    model, log = train_model(dt_loss, model, ds,
                             TrainConfig(steps=args.steps, batch_size=16),
                             device=dev)
    print(f"      {len(ds)} trajectories; final imitation loss "
          f"{log['final_loss']:.4f}")

    serve_nets = [vgg16(), tiny_cnn(), resnet18()]
    serve_accels = [ACCEL_ZOO["edge"], ACCEL_ZOO["mobile"],
                    ACCEL_ZOO["laptop"]]
    cache_file = pathlib.Path(tempfile.mkdtemp()) / "strategies.json"
    config = ServingConfig(
        cache_path=cache_file, flush_ms=25.0, max_wave=args.tick,
        known_accels=tuple(a.name for a in serve_accels),
        known_workloads=tuple(w.name for w in serve_nets),
        drift=DriftConfig(window=32))
    print(f"[2/5] repro_torch.serve: engine + async scheduler from one "
          f"ServingConfig; warmup (ticks <= {args.tick}) ...")
    t0 = time.perf_counter()
    sched = repro_torch.serve(model, config, warm=serve_nets,
                              accel=ACCEL_ZOO["edge"], device=dev)
    engine = sched.engine
    print(f"      warmed in {time.perf_counter() - t0:.1f} s: "
          f"{engine.compile_count} signatures (nmax buckets "
          f"{engine.nmax_buckets})")

    rng = np.random.default_rng(0)
    budgets = np.linspace(7.0, 50.0, 12) * MB
    stream = [MapRequest(serve_nets[rng.integers(3)],
                         int(rng.choice([16, 32, 64])),
                         float(rng.choice(budgets)),
                         serve_accels[rng.integers(3)])
              for _ in range(args.requests)]
    print(f"[3/5] async front door: {args.requests} mixed requests, one at "
          f"a time, coalesced up to {args.tick} wide ...")
    sigs = engine.compile_count
    t0 = time.perf_counter()
    futures = pump_stream(sched, stream)
    wall = time.perf_counter() - t0
    s = engine.stats()
    lat = sorted(f.latency_s for f in futures)
    print(f"      {len(stream)} requests in {wall * 1e3:.0f} ms = "
          f"{len(stream) / wall:.0f} req/s; p50 {lat[len(lat) // 2] * 1e3:.0f}"
          f" ms (scheduler clock); {s['scheduler']['resolved_at_submit']} "
          f"resolved at submit; hit rate {s['strategy_hit_rate']:.2f}; "
          f"{s['device_calls']} episodes; new signatures "
          f"{engine.compile_count - sigs} (must be 0)")

    engine.save_cache()
    fresh = MapperEngine.from_config(engine.model, config, device=dev)
    replay = fresh.serve(stream)
    same = all(np.array_equal(a.strategy, f.result().strategy)
               for a, f in zip(replay, futures))
    print(f"[4/5] warm restart: a fresh engine loaded "
          f"{fresh.strategies.loads} persisted strategies and replayed the "
          f"stream with {fresh.device_calls} episodes (must be 0); "
          f"bit-identical: {same}")

    dc = ACCEL_ZOO["datacenter"]
    drift_budgets = [10.0 * MB, 30.0 * MB]
    drifted = [MapRequest(train_nets[rng.integers(2)], 64,
                          float(drift_budgets[rng.integers(2)]), dc)
               if rng.random() < 0.75 else stream[rng.integers(len(stream))]
               for _ in range(2 * config.drift.window)]
    worker = RefreshWorker(
        engine, train=TrainConfig(steps=200, batch_size=16, lr=3e-4,
                                  warmup=20),
        ga=GSamplerConfig(population=32, generations=24), seed=1)
    probe = stream[0]                    # a non-drifted key to pin bit-exact
    pre = engine.serve([probe])[0]
    print(f"[5/5] drift: {len(drifted)} requests, 75% on '{dc.name}' "
          f"(never trained on); monitor windows of {config.drift.window} ...")
    sigs = engine.compile_count
    pump_stream(sched, drifted, worker=worker)
    d = engine.stats()["drift"]
    res = worker.last_result
    if res is None:
        print("      no drift report fired: the stream stayed in "
              "distribution")
    else:
        print(f"      {d['reports_fired']} drift report(s); refresh: corpus "
              f"{res['corpus_size']} trajectories, probe "
              f"{res['live_score']:.2f} -> {res['candidate_score']:.2f}, "
              f"accepted={res['accepted']}")
    print(f"      {d['swaps_accepted']} hot swap(s), "
          f"{d['cache_invalidated']} drifted cache entries invalidated, "
          f"new signatures {engine.compile_count - sigs} (must be 0)")
    post = engine.serve([probe])[0]
    same = bool(post.cached and np.array_equal(pre.strategy, post.strategy))
    print(f"      non-drifted key still cached and bit-exact: {same}")


if __name__ == "__main__":
    main()
