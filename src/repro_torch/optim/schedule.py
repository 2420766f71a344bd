"""LR schedules (warmup + cosine / WSD): the JAX package's
``optim/schedule.py``.  Each schedule maps a step tensor to a float32
tensor on its device with torch ops only (no ``.item()``), so it runs
inside a captured train step."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return fn


def wsd(peak: float, warmup: int, total: int, decay_frac: float = 0.1):
    """Warmup-Stable-Decay."""
    decay_start = int(total * (1 - decay_frac))

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
        dec = peak * (1.0 - prog)
        stable = torch.full_like(step, peak)
        return torch.where(step < warmup, warm, torch.where(step < decay_start, stable, dec))

    return fn
