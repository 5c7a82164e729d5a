"""Learning-rate schedules (paper §4.1), port of ``repro.optim.schedule``.

Schedules are callables ``step (int32 tensor) -> lr (float32 tensor)``,
stepped once per batch.
"""
from __future__ import annotations

import math

import torch


def constant(peak: float):
    def fn(step):
        return torch.tensor(peak, dtype=torch.float32, device=step.device)
    return fn


def linear(peak: float, total_steps: int, end_factor: float = 0.0):
    total = max(total_steps, 1)

    def fn(step):
        frac = torch.clamp(step.to(torch.float32) / total, 0.0, 1.0)
        return peak * ((1.0 - frac) + end_factor * frac)

    return fn


def cawr(peak: float, period: int, t_mult: float = 1.0,
         min_factor: float = 0.0):
    """Cosine annealing with warm restarts (fixed period when t_mult == 1)."""
    period = max(period, 1)

    def fn(step):
        s = step.to(torch.float32)
        if t_mult == 1.0:
            pos = torch.remainder(s, period) / period
        else:
            ratio = s * (t_mult - 1.0) / period + 1.0
            n = torch.floor(torch.log(torch.clamp(ratio, min=1.0))
                            / math.log(t_mult))
            start = period * (t_mult ** n - 1.0) / (t_mult - 1.0)
            cur = period * t_mult ** n
            pos = (s - start) / cur
        cos = 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(pos, 0.0, 1.0)))
        return peak * (min_factor + (1.0 - min_factor) * cos)

    return fn


def make(name: str, peak: float, total_steps: int,
         period: int | None = None):
    if name in ("none", "constant"):
        return constant(peak)
    if name == "linear":
        return linear(peak, total_steps)
    if name == "cawr":
        return cawr(peak, period or max(total_steps // 15, 1))
    raise ValueError(f"unknown schedule {name!r}")
