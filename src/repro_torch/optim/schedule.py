"""Learning-rate schedules as pure functions of the step counter.

The partner of ``repro/optim/schedule.py``: each schedule takes the
optimizer's step count (an integer tensor) and returns the rate as a
float32 tensor on its device, computed in float32 as the reference does.
"""

from __future__ import annotations

import math

import torch


def linear_warmup(peak_lr: float, warmup_steps: int):
    """``peak_lr · min(1, step / warmup_steps)``."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        return peak_lr * torch.clamp(s / max(1, warmup_steps), max=1.0)
    return fn


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    """Linear warmup → cosine decay to ``final_frac · peak``."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(1, warmup_steps)
        prog = torch.clamp((s - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup_steps, warm, cos)
    return fn


__all__ = ["cosine_schedule", "linear_warmup"]
