"""Learning-rate schedules (port of ``repro.optim.schedule``). The paper
(App. B.1/B.3) uses linear warmup for the first 10% of steps followed by
linear decay to zero. A schedule maps a step (int or tensor) to an f32
tensor; a tensor step keeps the result on its device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def linear_warmup_linear_decay(max_lr: float, total_steps: int,
                               warmup_frac: float = 0.1):
    warmup = max(int(total_steps * warmup_frac), 1)

    def schedule(step):
        step = _f32(step)
        warm = step / warmup
        decay = torch.clamp_min((total_steps - step) /
                                max(total_steps - warmup, 1), 0.0)
        return max_lr * torch.where(step < warmup, warm, decay)
    return schedule


def cosine_schedule(max_lr: float, total_steps: int, warmup_frac: float = 0.1,
                    min_lr: float = 0.0):
    warmup = max(int(total_steps * warmup_frac), 1)

    def schedule(step):
        step = _f32(step)
        warm = step / warmup
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0, 1)
        cos = min_lr + 0.5 * (max_lr - min_lr) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, max_lr * warm, cos)
    return schedule


def constant_schedule(lr: float):
    def schedule(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), lr, dtype=torch.float32, device=dev)
    return schedule
