"""Gradient compression with error feedback (port of
``repro.optim.compression``).

int8 block-quantized gradients for a bandwidth-bound all-reduce: per
block of 256 values one f32 scale ``max |x| / 127`` and the values
rounded half to even to ``[-127, 127]`` (``torch.round`` rounds as
``jnp.round`` does, so ``q`` equals the reference's on the same f32
input).  Error feedback (Seide et al., EF-SGD) carries each step's
quantization residual into the next step's gradient, so convergence is
kept.  The reference computes this in plain ``jnp``, in no kernel, so
plain torch is its port.

Usage: ``tx = compressed(optim.adamw(...))``: the gradients are
quantized and dequantized before the inner update, and the residuals
live in the optimizer state (``CompressedState(inner, err)``), which
checkpoints like everything else.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .adamw import GradientTransformation

__all__ = ["quantize_int8", "dequantize_int8", "compressed",
           "CompressedState"]


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Per-block symmetric int8 quantization along the flattened axis:
    ``(q [nb, block] int8, scale [nb, 1] f32, shape, n)``."""
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    fp = torch.nn.functional.pad(flat, (0, (-n) % block)).reshape(-1, block)
    scale = fp.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(fp / torch.clamp_min(scale, 1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale, tuple(x.shape), n


def dequantize_int8(q, scale, shape, n) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def _roundtrip(x: torch.Tensor) -> torch.Tensor:
    return dequantize_int8(*quantize_int8(x))


class CompressedState(NamedTuple):
    inner: object       # the wrapped optimizer's state
    err: dict           # error-feedback residuals, f32, keyed as the params


def compressed(tx: GradientTransformation) -> GradientTransformation:
    """``tx`` fed int8-roundtripped gradients with error feedback."""
    def init(params: dict) -> CompressedState:
        return CompressedState(
            tx.init(params),
            {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()})

    @torch.no_grad()
    def update(grads: dict, state: CompressedState, params: dict):
        acc = {k: grads[k].float() + state.err[k] for k in params}
        sent = {k: _roundtrip(a) for k, a in acc.items()}  # crosses the wire
        err = {k: acc[k] - sent[k] for k in acc}
        updates, inner = tx.update(sent, state.inner, params)
        return updates, CompressedState(inner, err)

    return GradientTransformation(init, update)
