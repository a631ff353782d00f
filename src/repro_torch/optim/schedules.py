"""LR schedules — cosine and WSD (warmup-stable-decay, minicpm-2b), as
functions of the step computed in float32 the way
``repro/optim/schedules.py`` computes them.  The step may be a Python
number or a tensor (the optimizer's on-device step counter); the result
is a 0-d float32 tensor on the step's device."""

from __future__ import annotations

import math
from typing import Callable

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine(peak_lr: float, warmup: int, total: int,
           final_frac: float = 0.1) -> Callable:
    def f(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return f


def wsd(peak_lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.01) -> Callable:
    """Warmup-Stable-Decay (minicpm): linear warmup, flat plateau,
    exponential-ish (here: linear in log space) decay tail."""
    def f(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clip((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = peak_lr * torch.exp(prog * math.log(final_frac))
        peak = torch.full_like(step, peak_lr)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable, peak, dec))
    return f


def constant(lr: float) -> Callable:
    def f(step):
        device = step.device if isinstance(step, torch.Tensor) else None
        # a fill on the step's device: a copy from host memory cannot be
        # captured into a CUDA graph
        return torch.full((), lr, dtype=torch.float32, device=device)
    return f
