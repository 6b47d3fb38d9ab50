"""Sampling on the last-token logits (counterpart of ``repro.serve.decode``'s
``SampleConfig`` and ``sample``).

Greedy (temperature 0) is the argmax, the first maximum in both frameworks.
Sampled decoding is ``jax.random.categorical`` in jax 0.9's default "low"
mode, ``argmax(logits + gumbel)``, with the Gumbel draws the reference's
bit for bit: ``-log(-log(u))`` of ``uniform(key, minval=tiny, maxval=1)``
(``core.prng.uniform``) through ``core.quant.log``, XLA's float32 log. The
temperature divides tensor by tensor (CUDA turns a division by a Python
number into a reciprocal multiply); top-k keeps the logits at or above the
k-th largest (``torch.topk``) and sets the rest to -1e30.

Not ported: the float transformer's ``make_serve_step``, ``cache_specs``,
``jit_serve_step`` and ``generate`` (they need ``models.transformer`` and
``models.sharding``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import prng, quant

_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    temperature: float = 0.0
    top_k: int = 0


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in "low" mode: -log(-log(u)), u
    uniform in [tiny, 1), float32, on the key's device."""
    u = prng.uniform(key, shape, _TINY, 1.0)
    return -quant.log(-quant.log(u))


def sample(key, logits: torch.Tensor, sc: SampleConfig) -> torch.Tensor:
    """logits (B, T, V) -> tokens (B, 1) int32 from the last position."""
    lg = logits[:, -1].to(torch.float32)
    if sc.temperature <= 0.0:
        return torch.argmax(lg, -1, keepdim=True).to(torch.int32)
    f32 = dict(dtype=torch.float32, device=lg.device)
    lg = torch.div(lg, torch.tensor(sc.temperature, **f32))
    if sc.top_k > 0:
        kth = torch.topk(lg, sc.top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.tensor(-1e30, **f32), lg)
    g = gumbel(key.to(lg.device), tuple(lg.shape))
    return torch.argmax(g + lg, -1, keepdim=True).to(torch.int32)
