"""LR schedules as pure functions of the step counter.

Counterpart of ``repro/optim/schedule.py``: ``step`` is an integer tensor
(or a number), and the scale comes back as a 0-dim float32 tensor on its
device.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1):
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return final_frac + (1.0 - final_frac) * cos


def linear_warmup_cosine(step, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    s = _f32(step)
    warm = s / max(warmup_steps, 1)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(
        math.pi * t))
    return torch.where(s < warmup_steps, warm, cos)
