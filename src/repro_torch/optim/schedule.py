"""LR schedules."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``min_ratio *
    peak_lr`` at ``total_steps``.  ``step`` may be a device tensor: the
    result is an fp32 tensor on its device, with no host round trip."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps,
                                                   1), 0, 1)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
