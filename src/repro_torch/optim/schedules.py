"""Learning-rate schedules: counterpart of ``repro.optim.schedules``.

Each is a ``step -> lr`` function of an integer step (a Python int or a
0-d integer tensor) returning a 0-d float32 tensor on the CPU, computed in
the reference's float32 steps.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32).cpu()


def constant(lr: float):
    return lambda step: _f32(lr)


def exponential(lr: float, decay: float, steps_per_epoch: int = 1):
    """Paper §4.2 (KWS): lr * decay^epoch."""
    def f(step):
        epoch = torch.div(_step(step), steps_per_epoch, rounding_mode="floor")
        return _f32(lr) * torch.pow(_f32(decay), epoch.to(_F32))
    return f


def step_decay(lr: float, boundaries: Sequence[int], factor: float):
    """Paper §4.3 (ResNet-32): decay by ``factor`` at each boundary."""
    bs = torch.tensor(list(boundaries), dtype=torch.int32)

    def f(step):
        k = torch.sum(_step(step) >= bs)
        return _f32(lr) * torch.pow(_f32(factor), k.to(_F32))
    return f


def cosine(lr: float, total_steps: int, warmup: int = 0,
           final_frac: float = 0.1):
    def f(step):
        step = torch.minimum(_step(step), torch.tensor(total_steps,
                                                       dtype=torch.int32))
        s = step.to(_F32)
        warm = (torch.div(s, _f32(max(warmup, 1))) if warmup > 0
                else _f32(1.0))
        t = torch.clamp(torch.div(s - warmup,
                                  _f32(max(total_steps - warmup, 1))),
                        0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(_f32(math.pi) * t))
        return _f32(lr) * torch.minimum(warm, _f32(1.0)) * cos
    return f


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, floor_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, a
    flat plateau, a sharp final decay to a floor."""
    w = max(int(total_steps * warmup_frac), 1)
    d = max(int(total_steps * decay_frac), 1)
    s0 = total_steps - d

    def f(step):
        step = torch.minimum(_step(step), torch.tensor(total_steps,
                                                       dtype=torch.int32))
        s = step.to(_F32)
        warm = torch.div(s, _f32(w))
        dec = 1.0 - torch.div((1.0 - floor_frac) * (s - s0), _f32(d))
        lr_t = torch.where(step < w, warm,
                           torch.where(step < s0, _f32(1.0), dec))
        return _f32(lr) * lr_t
    return f
