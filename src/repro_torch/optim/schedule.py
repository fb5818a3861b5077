"""LR schedules."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak_lr``. The schedule
    takes the step as an int or a tensor (the optimizer's on-device count)
    and returns an fp32 tensor on the step's device."""

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
