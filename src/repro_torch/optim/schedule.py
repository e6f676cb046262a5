"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step, computed in float32 tensors on the step's device
(a train step passes its device step counter, so no host read)."""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        # cos rounded once from float64: torch's float32 cos is an ulp
        # off the correctly rounded value the reference gets here
        c = torch.cos((math.pi * t).double()).to(torch.float32)
        cos = lr * (final_frac + (1 - final_frac) * 0.5 * (1 + c))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def rsqrt(lr: float, warmup_steps: int):
    def f(step):
        step = _f32(step) + 1.0
        # a true division: ``int / tensor`` is reciprocal-then-multiply in
        # torch, an ulp off the reference's quotient
        warm = torch.full_like(step, warmup_steps)
        return lr * torch.minimum(step / warmup_steps,
                                  torch.sqrt(warm / step))
    return f
