"""Learning-rate schedules, step -> lr (port of
``repro.optim.schedules``): each takes the optimizer's int32 step tensor
and returns a float32 tensor on its device, with the reference's
float32 arithmetic."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def cosine(lr: float, total_steps: int, final_frac: float = 0.0):
    def f(step):
        s = torch.as_tensor(step).to(torch.float32)
        t = torch.clamp(s / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.0):
    def f(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * torch.where(s < warmup_steps, warm,
                                final_frac + (1 - final_frac) * cos)
    return f
