"""Learning-rate schedules: float32 tensors, pure functions of the step
counter (an int tensor or a Python int).  Counterpart of
``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch

from repro_torch.core.quantize import div


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps: int, peak: float):
    ratio = div(_step(step) + 1, max(warmup_steps, 1))
    return peak * torch.clamp(ratio, max=1.0)


def cosine_schedule(step, *, peak: float, warmup_steps: int,
                    total_steps: int, floor: float = 0.0):
    s = _step(step)
    warm = linear_warmup(s, warmup_steps, peak)
    t = torch.clamp(div(s - warmup_steps,
                        max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * t))
    return torch.where(s < warmup_steps, warm, cos)


def constant_schedule(step, peak: float, **_):
    return torch.full_like(_step(step), peak)
