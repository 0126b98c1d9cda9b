"""Imitation-learning trainer for the DT mapper (paper §4.5.1 step 3).

Port of ``repro.core.train``: AdamW (``optim.adamw``, hand-written) with a
cosine schedule and global-norm clipping, in f32, on the model's device.
A step is one forward and backward of ``loss_fn(model, batch)``
(``grad_accum > 1`` accumulates microbatches in f32), then the optimizer
updates the model's parameters in place.

The loop is resumable and bit-exact: the batch of step ``it`` is drawn
from ``np.random.default_rng([seed, it])`` (the reference's stream, so
both packages train on the same batches), and ``ckpt_dir`` saves
{params, opt_state} checkpoints in the reference's format and keys
(``checkpoint.Checkpointer``).  A run restarted from any saved step
replays the same tail and ends on the same parameters bit for bit.
``fine_tune`` (paper §4.6.2) is the same loop warm-started from
pre-trained weights, a model or a checkpoint directory.

With a ``mesh`` (``distributed.data_parallel_mesh()``, a 1-D ``("data",)``
``DeviceMesh``) the step is data-parallel: every rank draws the whole
batch of the step, takes its contiguous share of the (micro)batch, and
holds the parameters and AdamW state replicated.  The loss is a masked
mean (``dt_loss`` is ``sum(err * mask) / max(sum(mask), 1)``), so a mean
of the ranks' means would not be the global one when their mask counts
differ: each microbatch's mask count (rows when the batch has no
``mask``) is summed over the ranks before the backward, each rank's loss
is weighted by ``max(count_r, 1) / max(count, 1)``, and the weighted
gradients and losses are summed over the ranks in one ``all_reduce``
each.  Clipping (inside ``tx.update``) then sees the global gradient.
At one rank the weight is exactly 1 and the sums are copies, so the step
is bit-identical to ``mesh=None``.  Only rank 0 writes checkpoints.
"""
from __future__ import annotations

import copy
import pathlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import optim, resolve_device
from ..checkpoint.checkpointer import Checkpointer, restore_subtree
from .model import load_param_tree, param_tree

__all__ = ["TrainConfig", "train_model", "make_train_step", "fine_tune",
           "restore_params"]


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 3000
    batch_size: int = 64
    lr: float = 3e-4
    warmup: int = 100
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    seed: int = 0
    log_every: int = 200
    grad_accum: int = 1        # microbatches accumulated per optimizer step
    ckpt_every: int = 0        # save cadence (0 = only the final checkpoint)
    ckpt_keep: int = 3


def make_train_step(loss_fn, tx, mesh=None, grad_accum: int = 1):
    """``step(model, opt_state, batch) -> (model, opt_state, loss)``, the
    model's parameters updated in place.  ``loss_fn(model, batch)`` returns
    a scalar tensor; with ``grad_accum > 1`` each batch leaf carries
    leading ``[grad_accum, microbatch]`` axes.  With a ``mesh`` the step
    takes the global batch and runs data-parallel (module docstring)."""
    if mesh is not None:
        return _dp_train_step(loss_fn, tx, mesh, grad_accum)

    def step(model, opt_state, batch):
        params = param_tree(model)
        f = lambda b: loss_fn(model, b)
        if grad_accum == 1:
            loss, grads = optim.value_and_grad(f, params, batch)
        else:
            loss, grads = optim.accumulated_value_and_grad(f, params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
        return model, opt_state, loss

    return step


_SCALE = "__dp_scale__"


def _dp(mesh) -> tuple:
    """``(group, rank, size)`` of a mesh's 'data' axis."""
    return (mesh.get_group("data"), mesh.get_local_rank("data"),
            mesh.size(mesh.mesh_dim_names.index("data")))


def _share(x: torch.Tensor, axis: int, rank: int, n: int) -> torch.Tensor:
    if x.shape[axis] % n:
        raise ValueError(f"a batch axis of {x.shape[axis]} rows does not "
                         f"divide over {n} data-parallel ranks")
    m = x.shape[axis] // n
    return x.narrow(axis, rank * m, m)


def _count(batch: dict) -> torch.Tensor:
    """The denominator of a microbatch's mean: its mask's sum, or its rows
    when it has no ``mask``."""
    if "mask" in batch:
        return batch["mask"].sum(dtype=torch.float32)
    rows = next(iter(batch.values())).shape[0]
    return torch.tensor(float(rows), device=next(iter(batch.values())).device)


def _all_reduce_tree(tree: dict, group) -> dict:
    """``tree``'s leaves summed over ``group`` in place, in one
    ``all_reduce`` of a flat buffer per dtype.  The sums are copied back
    into the leaves' own storage: a view into the flat buffer may start off
    a 16-byte boundary, where ``_foreach_norm`` (the clip) reduces in
    another order on the card."""
    import torch.distributed as dist
    by_dtype: dict = {}
    for k, v in tree.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([tree[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, group=group)
        for k, piece in zip(keys, flat.split([tree[k].numel()
                                              for k in keys])):
            tree[k].copy_(piece.view_as(tree[k]))
    return tree


def _dp_train_step(loss_fn, tx, mesh, grad_accum: int):
    import torch.distributed as dist
    group, rank, n = _dp(mesh)
    axis = 1 if grad_accum > 1 else 0

    def scaled(model, b):
        rest = {k: v for k, v in b.items() if k != _SCALE}
        return loss_fn(model, rest) * b[_SCALE]

    def step(model, opt_state, batch):
        params = param_tree(model)
        local = {k: _share(v, axis, rank, n) for k, v in batch.items()}
        if grad_accum == 1:
            counts = _count(local).reshape(1)
        else:
            counts = torch.stack([_count({k: v[i] for k, v in local.items()})
                                  for i in range(grad_accum)])
        total = counts.clone()
        dist.all_reduce(total, group=group)
        scale = torch.clamp_min(counts, 1.0) / torch.clamp_min(total, 1.0)
        local[_SCALE] = scale[0] if grad_accum == 1 else scale
        f = lambda b: scaled(model, b)
        if grad_accum == 1:
            loss, grads = optim.value_and_grad(f, params, local)
        else:
            loss, grads = optim.accumulated_value_and_grad(f, params, local)
        grads = _all_reduce_tree(grads, group)
        loss = loss.clone()
        dist.all_reduce(loss, group=group)
        updates, opt_state = tx.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
        return model, opt_state, loss

    return step


def _step_batch(dataset, cfg: TrainConfig, it: int, device) -> dict:
    """Batch of step ``it`` from a counter-based RNG, a function of
    (seed, step) only, as tensors on ``device``."""
    rng = np.random.default_rng([cfg.seed, it])
    b = dataset.sample(rng, cfg.batch_size)
    if cfg.grad_accum > 1:
        if cfg.batch_size % cfg.grad_accum:
            raise ValueError(
                f"batch_size {cfg.batch_size} must divide into grad_accum "
                f"{cfg.grad_accum} microbatches")
        mb, acc = cfg.batch_size // cfg.grad_accum, cfg.grad_accum
        b = {k: np.asarray(v).reshape((acc, mb) + np.asarray(v).shape[1:])
             for k, v in b.items()}
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in b.items()}


def _on(model, device) -> torch.device:
    """The device the loop runs on (``cuda`` unless ``device`` says
    otherwise); the model must already be there."""
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have != dev:
        raise ValueError(f"model is on {have}, the loop runs on {dev}")
    return dev


def train_model(loss_fn, model, dataset, cfg: TrainConfig = TrainConfig(),
                mesh=None, eval_fn=None, ckpt_dir=None, resume: bool = True,
                crash_at: int | None = None, device=None) -> tuple:
    """Train ``model`` in place on ``device`` (``cuda`` unless ``"cpu"``;
    the model must be there) on ``dataset`` (anything with
    ``TrajectoryDataset.sample``).

    With ``ckpt_dir`` the loop saves {params, opt_state} every
    ``cfg.ckpt_every`` steps (in the background) and at the end, and with
    ``resume`` picks up from the latest checkpoint there.  ``crash_at``
    stops after that step without a final save (the fault-injection hook
    of the resume tests).  With a ``mesh`` (a ``("data",)`` ``DeviceMesh``
    of the model's device type) the loop is data-parallel: every rank
    starts from rank 0's parameters and draws the same global batches,
    and only rank 0 writes checkpoints.  Returns ``(model, log)``;
    ``log`` holds the logged ``(step, loss)`` pairs, ``final_loss``,
    ``start_step`` and the wall time."""
    tx = optim.adamw(optim.cosine_with_warmup(cfg.lr, cfg.warmup, cfg.steps),
                     weight_decay=cfg.weight_decay,
                     max_grad_norm=cfg.max_grad_norm)
    dev = _on(model, device)
    params = param_tree(model)
    writer = True
    if mesh is not None:
        import torch.distributed as dist
        if mesh.device_type != dev.type:
            raise ValueError(f"mesh is on {mesh.device_type}, the loop "
                             f"runs on {dev}")
        group, rank, _ = _dp(mesh)
        writer = rank == 0
        with torch.no_grad():
            for p in params.values():
                dist.broadcast(p, dist.get_global_rank(group, 0),
                               group=group)
    opt_state = tx.init(params)
    start = 0
    ckpt = None
    if ckpt_dir is not None:
        ckpt = Checkpointer(ckpt_dir, keep=cfg.ckpt_keep)
        if resume and ckpt.latest_step() is not None:
            step0, tree = ckpt.restore({"params": params,
                                        "opt_state": opt_state})
            start = min(int(step0), cfg.steps)
            load_param_tree(model, tree["params"])
            opt_state = tree["opt_state"]

    step_fn = make_train_step(loss_fn, tx, mesh, cfg.grad_accum)
    losses, t0 = [], time.perf_counter()
    interrupted = False
    for it in range(start, cfg.steps):
        batch = _step_batch(dataset, cfg, it, dev)
        model, opt_state, loss = step_fn(model, opt_state, batch)
        if it % cfg.log_every == 0 or it == cfg.steps - 1:
            losses.append((it, float(loss)))
        done = it + 1
        if ckpt is not None and writer and cfg.ckpt_every \
                and done % cfg.ckpt_every == 0 and done < cfg.steps:
            ckpt.save_async(done, {"params": params, "opt_state": opt_state})
        if crash_at is not None and done >= crash_at:
            interrupted = True
            break
    if ckpt is not None:
        if writer and not interrupted and cfg.steps > start:
            ckpt.save(cfg.steps, {"params": params, "opt_state": opt_state})
        ckpt.wait()   # never hand back with a half-written checkpoint
        if mesh is not None:      # every rank returns once the file is whole
            dist.barrier(group=group)
    log = {"losses": losses, "wall_s": time.perf_counter() - t0,
           "final_loss": losses[-1][1] if losses else None,
           "start_step": start}
    if eval_fn is not None:
        log["eval"] = eval_fn(model)
    return model, log


def restore_params(ckpt_dir, template, step: int | None = None):
    """A copy of ``template`` with the params of a {params, opt_state}
    training checkpoint (default: the latest step), without the optimizer
    state."""
    model = copy.deepcopy(template)
    tree = restore_subtree(Checkpointer(ckpt_dir).path(step), "params",
                           param_tree(model))
    return load_param_tree(model, tree)


def fine_tune(loss_fn, pretrained, dataset, cfg: TrainConfig, *,
              template=None, mesh=None, eval_fn=None, ckpt_dir=None,
              device=None) -> tuple:
    """Transfer fine-tuning (paper §4.6.2): the training loop warm-started
    from pre-trained weights, with a fresh optimizer state.

    ``pretrained`` is a model (copied, so the caller's survives) or a
    checkpoint directory (then ``template``, e.g. a fresh ``dt_init``,
    gives the architecture and device).  The paper's recipe (~10% of the
    pre-training steps, a lower lr) is the caller's ``cfg``; ``mesh``
    makes the loop data-parallel, as in :func:`train_model`."""
    if isinstance(pretrained, (str, pathlib.Path)):
        if template is None:
            raise ValueError("a template model is required to warm-start "
                             "from a checkpoint directory")
        model = restore_params(pretrained, template)
    else:
        model = copy.deepcopy(pretrained)
    return train_model(loss_fn, model, dataset, cfg, mesh=mesh,
                       eval_fn=eval_fn, ckpt_dir=ckpt_dir, resume=False,
                       device=device)
