"""LR schedules: pure functions of the step tensor, no host sync.

Counterpart of ``repro/optim/schedule.py``. The divisors are 0-dim f32
tensors, so each quotient is a true division on every device (JAX's; a
Python float divisor on the card is a multiply by its reciprocal).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import f32

__all__ = ["cosine_schedule"]


def cosine_schedule(step: torch.Tensor, *, warmup: int = 100,
                    total: int = 10000, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps, then a cosine from 1 down to
    ``min_ratio`` at ``total``: a 0-dim f32 tensor on ``step``'s device
    (0 at step 0)."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / f32(max(warmup, 1), s.device), max=1.0)
    prog = torch.clamp((s - warmup) / f32(max(total - warmup, 1), s.device),
                       0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
