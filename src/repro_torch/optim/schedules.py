"""Learning-rate schedules (counterpart of ``repro.optim.schedules``):
plain callables step -> lr, a 0-d f32 tensor computed in f32 as the
reference computes it."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def constant(lr: float):
    return lambda step: _f32(lr)


def linear_warmup(lr: float, warmup: int):
    def f(step):
        s = _f32(step)
        return lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
    return f


def cosine(lr: float, warmup: int, total: int, floor: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = torch.clamp((s + 1) / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return f
