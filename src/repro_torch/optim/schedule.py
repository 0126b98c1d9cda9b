"""Learning-rate schedules, ``step -> lr`` (port of ``repro.optim.schedule``).

Each schedule evaluates its formula in f32 on the host, operation by
operation as the reference does, and returns the f32 value as a Python
float: the optimizer's step count is a host integer, so an update needs
no device value to find its learning rate.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "linear_warmup", "cosine_with_warmup"]


def _step(step) -> torch.Tensor:
    return torch.tensor(float(step), dtype=torch.float32)


def constant(lr: float):
    return lambda step: float(torch.tensor(lr, dtype=torch.float32))


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s = _step(step)
        return float(lr * torch.clamp_max((s + 1) / max(warmup_steps, 1),
                                          1.0))
    return fn


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def fn(step):
        s = _step(step)
        warm = lr * torch.clamp_max((s + 1) / max(warmup_steps, 1), 1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return float(torch.where(s < warmup_steps, warm, lr * cos))
    return fn
