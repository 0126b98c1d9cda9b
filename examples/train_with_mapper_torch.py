"""End-to-end LM training with a learned fusion mapper in the loop, on the
PyTorch port.

    PYTHONPATH=src python examples/train_with_mapper_torch.py [--arch gemma3_1b] [--device cpu]

The twin of ``examples/train_with_mapper.py`` on ``repro_torch``; it runs
on the CUDA card unless ``--device cpu`` is given.

Stage 1 trains the DNNFuser mapper for this arch: the arch is lowered to
an LM-block fusion workload, the grid G-Sampler teacher sweeps a grid of
activation budgets through ``fusion_eval`` (``generate_teacher_corpus``),
and the imitation trainer fits the decision transformer, checkpointing
under ``artifacts/mapper_<arch>``; a re-run reuses a finished checkpoint
instead of retraining.  (The reference trains it data-parallel over a
mesh; the port's trainer runs on one device.)

Stage 2: the learned mapper infers the input micro-batch one shot under
the activation budget, the trainer uses it as the gradient-accumulation
micro-batch, and the loop checkpoints in the background and resumes if
re-run (stop it midway and run it again to see).
"""
import argparse

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core import (DTConfig, GSamplerConfig, PAPER_ACCEL,
                              TrainConfig, dt_init, dt_loss,
                              generate_teacher_corpus, restore_params,
                              train_model)
from repro_torch.launch.train import train
from repro_torch.workloads.lm_workloads import lm_workload


def train_mapper(arch: str, *, seq_len: int, global_batch: int,
                 ckpt_dir: str, steps: int = 400, device=None):
    """Teacher corpus -> imitation training for one arch's LM workload, on
    ``device``; reuses ``ckpt_dir`` when it already holds ``steps``."""
    cfg = get_config(arch, reduced=True)
    wl = lm_workload(cfg, seq_len=seq_len, batch=global_batch, mode="train")
    dt_cfg = DTConfig(max_steps=max(16, wl.n + 1))
    template = dt_init(dt_cfg, seed=0, device=device)
    if (Checkpointer(ckpt_dir).latest_step() or 0) >= steps:
        # fully trained: skip the teacher's search entirely
        print(f"[mapper-train] checkpoint {ckpt_dir} complete; reusing it")
        return restore_params(ckpt_dir, template)
    corpus = generate_teacher_corpus(
        [wl], PAPER_ACCEL, batch=global_batch,
        budgets_mb=[4.0, 8.0, 16.0, 24.0, 48.0], max_steps=dt_cfg.max_steps,
        ga_cfg=GSamplerConfig(generations=25, seed=0), seed=0, device=device)
    model, log = train_model(
        dt_loss, template, corpus,
        TrainConfig(steps=steps, batch_size=32, log_every=100,
                    ckpt_every=max(steps // 2, 1)),
        ckpt_dir=ckpt_dir, device=device)
    print(f"[mapper-train] {len(corpus)} teacher trajectories, resumed from "
          f"step {log['start_step']}, final loss {log['final_loss']}")
    return model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--mapper-steps", type=int, default=400)
    ap.add_argument("--gsampler", action="store_true",
                    help="skip mapper training; fall back to a fresh "
                    "G-Sampler search (the teacher)")
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    args = ap.parse_args(argv)

    dt = None
    if not args.gsampler:
        dt = train_mapper(args.arch, seq_len=128, global_batch=8,
                          ckpt_dir=f"{args.artifacts}/mapper_{args.arch}",
                          steps=args.mapper_steps, device=args.device)

    loop, info = train(args.arch, steps=args.steps, global_batch=8,
                       seq_len=128, reduced=True,
                       ckpt_dir=f"{args.artifacts}/example_train_{args.arch}",
                       use_mapper=True, act_budget_mb=8.0, dt_params=dt,
                       device=args.device)
    src = "G-Sampler search" if dt is None else "one-shot DNNFuser"
    print(f"\nmapper ({src}) chose micro_batch={info['micro_batch']} "
          f"(grad_accum={info['grad_accum']}), modeled fusion speedup "
          f"{info['speedup']:.2f}x")
    print("loss curve:", [(s, round(l, 3)) for s, l in loop.losses])
    print(f"median step {loop.monitor.median * 1e3:.0f} ms; "
          f"straggler events: {len(loop.monitor.events)}")
    print("re-run this script to see checkpoint resume "
          f"(start_step was {loop.start_step})")
    return loop, info


if __name__ == "__main__":
    main()
