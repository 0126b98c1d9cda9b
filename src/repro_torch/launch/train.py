"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``
(port of ``repro.launch.train``).

A fault-tolerant loop (restore-from-latest, checkpoints in the background,
straggler monitor: ``runtime.TrainLoop``) over the synthetic pipeline
(``data.SyntheticLM``), on the card unless ``--device cpu``.
``--fusion-mapper`` turns on the paper's technique as a framework
feature: the arch is lowered to a fusion workload
(``workloads.lm_workload``), the mapper (a trained DNNFuser if given, else
a G-Sampler search on ``fusion_eval``) infers the input micro-batch under
the activation-memory budget, and the trainer uses it as the
gradient-accumulation micro-batch: the paper's micro-batching strategy
steering a real training loop.

The step differentiates each family's ``loss_fn`` at ``impl="dense"``,
the reference's ``impl="xla"``: the attention and WKV kernels have no
backward (nor have the reference's Pallas kernels) and refuse inputs that
require grad.  Parameters, gradients and AdamW moments are f32.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import optim, resolve_device
from ..configs import get_config
from ..core import PAPER_ACCEL, FusionEnv, GSamplerConfig, gsampler_search
from ..core.infer import dnnfuser_infer
from ..core.model import param_tree
from ..core.train import make_train_step
from ..data import SyntheticLM
from ..models import registry
from ..runtime import TrainLoop
from ..workloads.lm_workloads import lm_workload

__all__ = ["mapper_microbatch", "make_local_train_step", "train",
           "batch_keys", "make_batch_fn", "main"]

MB = float(2 ** 20)
MAPPER_NMAX = 128


def mapper_microbatch(cfg, *, seq_len: int, global_batch: int,
                      act_budget_mb: float, dt_params=None,
                      device=None) -> dict:
    """Infer a micro-batching strategy for (arch, shape) under a budget,
    on ``device`` (``cuda`` unless ``"cpu"``).

    Returns ``{"micro_batch", "grad_accum", "strategy", "speedup"}``.
    With a trained DNNFuser (``dt_params``, the port's DT on ``device``)
    inference is one shot; otherwise the G-Sampler searches (the teacher),
    each population scored by one ``fusion_eval`` launch on the card.
    The reference's ``dt_cfg`` has no counterpart: the port's DT carries
    its config."""
    wl = lm_workload(cfg, seq_len=seq_len, batch=global_batch, mode="train")
    env = FusionEnv(wl, PAPER_ACCEL, batch=global_batch,
                    budget_bytes=act_budget_mb * MB, nmax=MAPPER_NMAX,
                    device=device)
    if dt_params is not None:
        res = dnnfuser_infer(dt_params, env)
    else:
        res = gsampler_search(env, GSamplerConfig(generations=20, seed=0))
    mb0 = int(max(1, res.strategy[0]))
    while global_batch % mb0:           # a divisor of the global batch
        mb0 -= 1
    return {"micro_batch": mb0, "grad_accum": global_batch // mb0,
            "strategy": res.strategy[: wl.n + 1], "speedup": res.speedup}


def make_local_train_step(cfg, tx, *, grad_accum: int = 1,
                          impl: str = "dense"):
    """Single-device step ``(model, opt_state, batch) -> (model, opt_state,
    loss)`` of ``cfg``'s family's ``loss_fn``, the model updated in place.
    With ``grad_accum > 1`` the batch is cut into ``[grad_accum, mb]``
    chunks whose gradients are averaged in f32."""
    model_mod = registry.get_model(cfg)
    step = make_train_step(
        lambda model, b: model_mod.loss_fn(model, b, impl=impl), tx,
        grad_accum=grad_accum)
    if grad_accum == 1:
        return step

    def accumulated(model, opt_state, batch):
        mb = next(iter(batch.values())).shape[0] // grad_accum
        chunks = {k: v[: mb * grad_accum].reshape((grad_accum, mb)
                                                  + v.shape[1:])
                  for k, v in batch.items()}
        return step(model, opt_state, chunks)

    return accumulated


def batch_keys(cfg) -> tuple[str, ...]:
    """The ``SyntheticLM`` fields ``cfg``'s ``loss_fn`` takes."""
    if cfg.family == "encdec":
        return ("embeds", "tokens", "labels")
    if cfg.embed_inputs:
        return ("embeds", "labels")
    return ("tokens", "labels")


def make_batch_fn(cfg, *, seq_len: int, global_batch: int, seed: int = 0,
                  device=None):
    """``step -> batch``: the ``SyntheticLM`` batch of ``step`` (the
    reference's stream) with the fields of :func:`batch_keys`, as tensors
    on ``device`` (integers as int64)."""
    dev = resolve_device(device)
    src = SyntheticLM(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed,
        embed_dim=cfg.d_model if cfg.embed_inputs else None,
        dec_len=max(seq_len // 8, 8) if cfg.family == "encdec" else None)
    keys = batch_keys(cfg)

    def batch_fn(step: int) -> dict:
        b = src.batch_at(step)
        return {k: torch.as_tensor(b[k].astype(np.int64) if b[k].dtype.kind
                                   == "i" else b[k], device=dev)
                for k in keys}

    return batch_fn


def train(arch: str, *, steps: int = 200, global_batch: int = 8,
          seq_len: int = 128, reduced: bool = True, lr: float = 3e-4,
          ckpt_dir: str = "artifacts/train", use_mapper: bool = False,
          act_budget_mb: float = 24.0, dt_params=None, dt_cfg=None,
          crash_at: int | None = None, seed: int = 0, device=None):
    """Train ``arch`` (f32, seeded weights) on ``device`` (``cuda`` unless
    ``"cpu"``) for ``steps`` steps; returns ``(loop, mapper_info)``, the
    trained model in ``loop.model``.  Resumes from the latest checkpoint
    under ``ckpt_dir``, the reference's or the port's.  ``dt_cfg`` keeps
    the reference's signature and is unused: the port's DT
    (``dt_params``) carries its config."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    model_mod = registry.get_model(cfg)
    grad_accum = 1
    mapper_info = None
    if use_mapper:
        mapper_info = mapper_microbatch(cfg, seq_len=seq_len,
                                        global_batch=global_batch,
                                        act_budget_mb=act_budget_mb,
                                        dt_params=dt_params, device=dev)
        grad_accum = mapper_info["grad_accum"]
        print(f"[mapper] micro_batch={mapper_info['micro_batch']} "
              f"grad_accum={grad_accum} "
              f"(modeled fusion speedup {mapper_info['speedup']:.2f}x)")

    model = model_mod.init(cfg, seed=seed, dtype=torch.float32, device=dev)
    tx = optim.adamw(optim.cosine_with_warmup(lr, 20, steps),
                     weight_decay=0.01, max_grad_norm=1.0)
    opt_state = tx.init(param_tree(model))
    step_fn = make_local_train_step(cfg, tx, grad_accum=grad_accum)
    batch_fn = make_batch_fn(cfg, seq_len=seq_len, global_batch=global_batch,
                             seed=seed, device=dev)
    loop = TrainLoop(step_fn, model, opt_state, batch_fn,
                     ckpt_dir=ckpt_dir, ckpt_every=max(steps // 4, 10))
    loop.run(steps, crash_at=crash_at)
    return loop, mapper_info


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train an LM arch on the "
                                 "synthetic pipeline.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the full (published) config instead of the "
                    "reduced one")
    ap.add_argument("--fusion-mapper", action="store_true")
    ap.add_argument("--act-budget-mb", type=float, default=24.0)
    ap.add_argument("--ckpt-dir", default="artifacts/train")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    loop, _ = train(args.arch, steps=args.steps,
                    global_batch=args.global_batch, seq_len=args.seq_len,
                    reduced=not args.full, lr=args.lr,
                    ckpt_dir=args.ckpt_dir, use_mapper=args.fusion_mapper,
                    act_budget_mb=args.act_budget_mb, device=args.device)
    print("losses:", loop.losses)
    print("median step s:", round(loop.monitor.median, 4),
          "straggler events:", len(loop.monitor.events))


if __name__ == "__main__":
    main()
