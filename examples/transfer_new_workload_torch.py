"""Transfer learning (paper §5.4) on the PyTorch port: adapt the general
mapper to a NEW workload with ~10% of the training, warm-started from a
checkpoint, trained data-parallel.

    PYTHONPATH=src python examples/transfer_new_workload_torch.py [--device cpu]

The twin of ``examples/transfer_new_workload.py`` on ``repro_torch``; it
runs on the CUDA card unless ``--device cpu`` is given.  Pre-training
uses the grid teacher (one G-Sampler over the VGG16/ResNet18 x budget
grid, each population scored by one ``fusion_eval`` launch on the card)
and the data-parallel trainer on ``data_parallel_mesh()`` (one process
here: a world-size-1 group opened by ``launch.mesh.process_group``; under
``torchrun`` every rank takes its share of each batch), and checkpoints
under ``--artifacts`` (re-runs skip straight to fine-tuning).
``fine_tune`` then warm-starts from that checkpoint on an MnasNet corpus
with unseen budget conditions, on the same mesh.
"""
import argparse

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import (DTConfig, FusionEnv, PAPER_ACCEL, TrainConfig,
                              dnnfuser_infer_fused, dt_init, dt_loss,
                              fine_tune, generate_teacher_corpus,
                              gsampler_search, train_model)
from repro_torch.distributed.sharding import data_parallel_mesh
from repro_torch.launch.mesh import process_group
from repro_torch.workloads import mnasnet_b1, resnet18, vgg16

MB = 2 ** 20
T = 56


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    ap.add_argument("--artifacts", default="artifacts/transfer_pretrain_torch")
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    dev, ckpt = args.device, args.artifacts
    cfg = DTConfig(max_steps=T)
    with process_group(dev):
        mesh = data_parallel_mesh(device=dev)
        print("pre-training the general mapper on VGG16 + ResNet18 "
              "(grid teacher, data-parallel trainer; resumes from "
              "checkpoint) ...")
        if (Checkpointer(ckpt).latest_step() or 0) >= args.steps:
            print(f"  checkpoint {ckpt} complete; skipping teacher + "
                  f"training")
        else:
            ds_gen = generate_teacher_corpus(
                [vgg16(), resnet18()], PAPER_ACCEL, batch=64,
                budgets_mb=[16, 32, 48, 64], max_steps=T, seed=0,
                device=dev)
            _, log = train_model(
                dt_loss, dt_init(cfg, seed=0, device=dev), ds_gen,
                TrainConfig(steps=args.steps, batch_size=16,
                            ckpt_every=args.steps // 2),
                mesh=mesh, ckpt_dir=ckpt, device=dev)
            print(f"  {len(ds_gen)} teacher trajectories; "
                  f"start_step={log['start_step']}, "
                  f"final loss {log['final_loss']}")

        print("transfer: fine-tuning on MnasNet with 10% of the steps ...")
        wl = mnasnet_b1()
        ds_new = generate_teacher_corpus([wl], PAPER_ACCEL, batch=64,
                                         budgets_mb=[25, 45], max_steps=T,
                                         seed=1, device=dev)
        model, log = fine_tune(
            dt_loss, ckpt, ds_new,
            TrainConfig(steps=max(args.steps // 10, 1), batch_size=16,
                        lr=1e-4, warmup=5),
            template=dt_init(cfg, seed=0, device=dev), mesh=mesh,
            device=dev)
    print(f"fine-tune loss {log['final_loss']:.4f} in {log['wall_s']:.0f}s")

    for cond in (25.0, 35.0, 55.0):
        env = FusionEnv(wl, PAPER_ACCEL, batch=64, budget_bytes=cond * MB,
                        nmax=T, device=dev)
        df = dnnfuser_infer_fused(model, env)
        gs = gsampler_search(env)
        print(f"  {cond:4.0f}MB: Transfer-DF "
              f"{df.speedup:5.2f}x (valid={df.valid})  vs  GS full search "
              f"{gs.speedup:5.2f}x")


if __name__ == "__main__":
    main()
