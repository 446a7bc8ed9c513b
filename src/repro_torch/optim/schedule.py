"""Learning-rate schedules (warmup + cosine, constant).

A schedule maps the optimizer's step count to a learning rate computed in
float32, as the reference's schedules compute it from an int32 count; the
value comes back as a 0-dim float32 tensor on the CPU (the count is known
on the host, so the rate never waits on the card).
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step) -> torch.Tensor:
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return lr


def constant(lr_value: float):
    def lr(step) -> torch.Tensor:
        return _f32(lr_value)

    return lr
