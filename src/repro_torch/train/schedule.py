"""Learning-rate schedules (functional, step -> lr).

The counterpart of :mod:`repro.train.schedule`: each schedule maps the
optimizer's int32 step tensor to a float32 learning-rate tensor on the
step's device, with the reference's float32 arithmetic.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "warmup_linear", "constant"]


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_linear(base_lr: float, warmup_steps: int):
    def fn(step):
        s = step.to(torch.float32)
        return base_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup_steps, warm, cos)
    return fn
