"""GPipe-style pipeline parallelism over ``torch.distributed``
point-to-point (port of ``repro.distributed.pipeline``).

Stage ``s`` of S lives on rank ``s`` of a 1-D ``("stage",)`` mesh;
microbatches stream through the classic (n_micro + S - 1)-tick schedule,
activations hopping stage -> stage + 1 each tick by a paired send and
receive (``batch_isend_irecv``), where the reference uses
``lax.ppermute``.  The 40-cell dry-run uses DP x TP; this module is the
pipeline building block, held to sequential stages by the tests.
"""
from __future__ import annotations

import torch

from ..launch.mesh import init_mesh

__all__ = ["pipeline_forward", "make_stage_mesh"]


def make_stage_mesh(n_stages: int, *, device=None):
    """A ``("stage",)`` ``DeviceMesh`` of ``n_stages`` ranks (the process
    group's world size), on ``device``'s type (``cuda`` unless
    ``"cpu"``)."""
    from .. import resolve_device
    return init_mesh((n_stages,), ("stage",), resolve_device(device).type)


def pipeline_forward(stage_params, inputs, stage_fn, mesh, *,
                     n_microbatches: int):
    """Run ``stage_fn(params_s, x) -> x`` over S pipeline stages.

    ``stage_params``: a tensor, or a dict of tensors, stacked [S, ...]
    (this rank takes row ``stage``); ``inputs``: [n_micro, mb, ...] microbatches, the same
    on every rank (consumed by stage 0).  Returns the [n_micro, mb, ...]
    outputs of stage S-1 on every rank.  The schedule:

        tick t: every stage computes on its held activation, then sends
                it to stage + 1; stage 0 injects microbatch t.

    Stage S-1 writes microbatch t - (S-1) at tick t; a sum over the
    stages (every other stage contributes zeros) gives every rank the
    outputs, as the reference's ``psum`` does.  At S = 1 this is
    ``stage_fn`` over the microbatches, with no communication."""
    import torch.distributed as dist
    group = mesh.get_group("stage")
    S = mesh.size()
    stage = mesh.get_local_rank("stage")
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(stage + 1) % S], ranks[(stage - 1) % S]
    T = n_microbatches + S - 1
    params = (stage_params[stage] if isinstance(stage_params, torch.Tensor)
              else {k: v[stage] for k, v in stage_params.items()})
    mb_shape = inputs.shape[1:]
    hold = torch.zeros(mb_shape, dtype=inputs.dtype, device=inputs.device)
    outs = torch.zeros((n_microbatches,) + tuple(mb_shape),
                       dtype=inputs.dtype, device=inputs.device)
    for t in range(T):
        if stage == 0:
            cur = (inputs[t] if t < n_microbatches else
                   torch.zeros_like(hold))
        else:
            cur = hold
        y = stage_fn(params, cur)
        out_idx = t - (S - 1)
        if stage == S - 1 and out_idx >= 0:
            outs[out_idx] = y
        if S == 1:
            hold = y
            continue
        y = y.contiguous()
        hold = torch.empty_like(y)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y, nxt, group),
            dist.P2POp(dist.irecv, hold, prv, group)])
        for r in reqs:
            r.wait()
    if S > 1:
        dist.all_reduce(outs, group=group)
    return outs
