"""Hand-written optimizers (port of ``repro.optim.adamw``).

An optimizer is a pair of functions over flat parameter trees
(``dict[str, Tensor]``, e.g. ``core.model.param_tree``):

    init(params)                        -> opt_state
    update(grads, opt_state, params)    -> (updates, opt_state)

and ``apply_updates`` adds the updates to the parameters in place.

The update is the reference's, operation by operation and in the same
order: clip by global norm first, moments kept in f32, the schedule
evaluated at ``step + 1``, eps added to ``sqrt(v / bc2)``, and weight
decay computed from the old parameters.  Each elementwise operation runs
over all leaves at once as one ``torch._foreach_*`` call (a few launches
for the whole tree instead of one a leaf).  The step count is a host
integer, so the bias corrections and the learning rate are f32 scalars
computed on the host: an update makes no host sync.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["GradientTransformation", "AdamWState", "SGDState", "adamw",
           "sgd", "apply_updates", "global_norm", "clip_by_global_norm",
           "value_and_grad", "accumulated_value_and_grad"]


def _f32(x) -> float:
    """``x`` rounded to f32 (the reference computes its scalars in f32)."""
    return float(torch.tensor(x, dtype=torch.float32))


def value_and_grad(loss_fn, params: dict, batch) -> tuple:
    """``(loss, grads)`` of ``loss_fn(batch)`` with respect to the tensors
    of ``params``; a parameter the loss does not reach gets zeros."""
    loss = loss_fn(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def accumulated_value_and_grad(loss_fn, params: dict, chunks: dict):
    """Mean ``(loss, grads)`` over the leading microbatch axis of every
    leaf of ``chunks``, accumulated in f32 in microbatch order."""
    n = next(iter(chunks.values())).shape[0]
    keys = list(params)
    loss_s = torch.zeros((), device=next(iter(params.values())).device)
    g_s = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params.values()]
    for i in range(n):
        loss, g = value_and_grad(loss_fn, params,
                                 {k: v[i] for k, v in chunks.items()})
        loss_s = loss_s + loss
        torch._foreach_add_(g_s, [g[k].float() for k in keys])
    inv = 1.0 / n
    return loss_s * inv, dict(zip(keys, torch._foreach_mul(g_s, inv)))


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor)."""
    norms = torch._foreach_norm([x.float() for x in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(tree: dict, max_norm: float):
    """``tree`` scaled by ``min(1, max_norm / (norm + 1e-9))``, and the
    norm; the scale stays on the device."""
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return dict(zip(tree, torch._foreach_mul(list(tree.values()), scale))), \
        norm


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """``params += updates`` in place (updates cast to each leaf's type)."""
    keys = list(params)
    torch._foreach_add_([params[k] for k in keys],
                        [updates[k].to(params[k].dtype) for k in keys])
    return params


class AdamWState(NamedTuple):
    step: np.ndarray      # 0-dim int32, updates applied so far
    mu: dict              # f32 first moments, keyed as the params
    nu: dict              # f32 second moments


def _zeros_f32(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          max_grad_norm: float | None = None) -> GradientTransformation:
    """AdamW with optional global-norm clipping.  ``lr`` is a float or a
    ``step -> lr`` schedule (``optim.schedule``).  Moments are f32 whatever
    the parameters' type."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: dict) -> AdamWState:
        return AdamWState(np.int32(0), _zeros_f32(params), _zeros_f32(params))

    @torch.no_grad()
    def update(grads: dict, state: AdamWState, params: dict):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        keys = list(params)
        step = np.int32(state.step + 1)
        g32 = [grads[k].float() for k in keys]
        mu = torch._foreach_mul([state.mu[k] for k in keys], b1)
        torch._foreach_add_(mu, torch._foreach_mul(g32, 1 - b1))
        gg = torch._foreach_mul(g32, 1 - b2)
        torch._foreach_mul_(gg, g32)
        nu = torch._foreach_mul([state.nu[k] for k in keys], b2)
        torch._foreach_add_(nu, gg)
        s = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1 - b1 ** s)
        bc2 = float(1 - b2 ** s)
        lr_t = _f32(lr_fn(step))

        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_mul_(u, lr_t)
        torch._foreach_div_(u, den)
        torch._foreach_neg_(u)
        if weight_decay:
            decay = torch._foreach_mul([params[k].float() for k in keys],
                                       _f32(lr_t * np.float32(weight_decay)))
            torch._foreach_sub_(u, decay)
        return (dict(zip(keys, u)),
                AdamWState(step, dict(zip(keys, mu)), dict(zip(keys, nu))))

    return GradientTransformation(init, update)


class SGDState(NamedTuple):
    step: np.ndarray
    mom: dict


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.9,
        max_grad_norm: float | None = None) -> GradientTransformation:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: dict) -> SGDState:
        return SGDState(np.int32(0), _zeros_f32(params))

    @torch.no_grad()
    def update(grads: dict, state: SGDState, params: dict):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        keys = list(params)
        step = np.int32(state.step + 1)
        mom = torch._foreach_mul([state.mom[k] for k in keys], momentum)
        torch._foreach_add_(mom, [grads[k].float() for k in keys])
        updates = torch._foreach_mul(mom, -_f32(lr_fn(step)))
        return dict(zip(keys, updates)), SGDState(step, dict(zip(keys, mom)))

    return GradientTransformation(init, update)
