"""Learning-rate schedule: linear warmup, then cosine decay to ``min_lr``.
The counterpart of ``dinox_tpu.train.schedule``. Steps are optimizer steps.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def get_lr(step: int, total_steps: Optional[int], warmup_steps: int, base_lr: float,
           min_lr: float) -> float:
    """The LR at optimizer step *step*: the base LR is held when
    *total_steps* is None, and ``min_lr`` is kept past the horizon."""
    if warmup_steps > 0 and step < warmup_steps:
        return base_lr * (step + 1) / warmup_steps
    if total_steps is None:
        return base_lr
    if step >= total_steps:
        return min_lr
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    cos = 0.5 * (1.0 + math.cos(math.pi * frac))
    return min_lr + cos * (base_lr - min_lr)


def get_lr_tensor(step: torch.Tensor, total_steps: Optional[int], warmup_steps: int,
                  base_lr: float, min_lr: float) -> torch.Tensor:
    """Twin of :func:`get_lr` for an integer step tensor; float32, on the
    step's device."""
    step_f = step.to(torch.float32)
    warm = base_lr * (step_f + 1.0) / max(warmup_steps, 1)
    if total_steps is None:
        after = torch.full_like(step_f, base_lr)
    else:
        frac = (step_f - warmup_steps) / max(total_steps - warmup_steps, 1)
        cos = 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(frac, 0.0, 1.0)))
        after = min_lr + cos * (base_lr - min_lr)
    if warmup_steps <= 0:
        return after
    return torch.where(step < warmup_steps, warm, after)
