"""int8 gradient codes for the cross-pod all-reduce: counterpart of
``repro.optim.grad_compress``.

The paper's abs-max quantizer applied to a gradient tensor: int8 codes and
one float32 scale a tensor, 4x fewer bytes over the slow links between
pods. ``compressed_psum_pod`` and ``cross_pod_mean`` (the collective over a
``pod`` mesh axis) come with the mesh slice.
"""
from __future__ import annotations

from typing import Tuple

import torch


def q8_encode(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale) of ``g``: ``round(g / s)`` in float32,
    ``s`` = max(abs-max, 1e-20) / 127; divisions tensor by tensor (C7)."""
    g = g.to(torch.float32)
    amax = torch.max(torch.abs(g))
    scale = torch.div(torch.clamp_min(amax, 1e-20),
                      torch.full_like(amax, 127.0))
    return torch.round(torch.div(g, scale)).to(torch.int8), scale


def q8_decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale
