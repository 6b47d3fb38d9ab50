"""Shared transformer building blocks with the FQ quantization contract.

Counterpart of ``repro.models.layers``. Every projection is an FQ layer
(eq. 4 of the paper is stated for dot products): learned-quantized input
and weights in Q mode; in FQ mode the pre-projection RMSNorm is removed
(its gain folded into the weights, the saturating quantizer taking over the
normalizing role, as the paper removes BN, §3.4) and the projection output
is bounded by the b = -1 quantizer. Softmax, SiLU gates and recurrent state
updates stay in float.

Random initialisation draws from an explicit ``torch.Generator`` on the
generator's device; with ``gen=None`` the leaves are allocated on the
``meta`` device (shapes and dtypes only, as ``transformer.param_struct``
wants). The reference draws from ``jax.random``, so the two give other
numbers for one seed; tests carry the reference's params across
(``repro_torch.interop.params_from_numpy``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import fq_layers as fql
from ..core.quant import QuantConfig, WEIGHT_BOUND, init_scale
from . import sharding as shd

META = torch.device("meta")


def device_of(gen: Optional[torch.Generator]) -> torch.device:
    """Where ``gen`` draws (``meta`` for None)."""
    return META if gen is None else gen.device


def normal(gen: Optional[torch.Generator], shape, dtype) -> torch.Tensor:
    """Standard normals of ``shape`` in ``dtype`` on ``gen``'s device (an
    empty ``meta`` tensor for ``gen=None``)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=META)
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def log_scale(w: torch.Tensor, dims=None) -> torch.Tensor:
    """``quant.init_scale``: log max|w| (over ``dims``, keeping them), on
    the host, as the port's other initialisers take it."""
    if w.is_meta:
        shape = () if dims is None else tuple(
            1 if i in dims else s for i, s in enumerate(w.shape))
        return torch.empty(shape, dtype=torch.float32, device=META)
    if dims is None:
        return init_scale(w)
    m = torch.amax(torch.abs(w.detach().float()), dim=dims, keepdim=True)
    return torch.log(torch.clamp(m, min=1e-8).cpu()).to(w.device)


def scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def init_proj(gen, din: int, dout: int, dtype=torch.float32):
    w = normal(gen, (din, dout), dtype) * math.sqrt(2.0 / din)
    return {"w": w, "s_w": log_scale(w), "s_in": scalar(0.0, w),
            "s_out": scalar(0.0, w)}


def dequant(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``codes.astype(dtype) * scale.astype(dtype)`` in one op: the int8
    code is exact in ``dtype`` and the product rounds once, as in the
    reference; the weight is written once in ``dtype``."""
    return torch.mul(codes, scale.to(dtype))


def proj(p, x, qcfg: QuantConfig, *, b_in: float = WEIGHT_BOUND, rng=None,
         noise=None):
    if "w_codes" in p:
        # deployed serving path (paper §3.4 eq. 4): int8 codes, real value
        # e^s / n * code, dequantized on load
        return torch.matmul(x, dequant(p["w_codes"], p["w_scale"], x.dtype))
    return fql.fq_linear(p, x, qcfg, b_in=b_in, relu_out=False, noise=noise,
                         rng=rng)


def init_rmsnorm(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, *, eps: float = 1e-6):
    var = torch.mean(torch.square(x.float()), -1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * p["scale"]


def maybe_norm(np_, x, qcfg: QuantConfig):
    """RMSNorm in FP / Q mode; the identity in FQ mode (norm folded, the
    quantizer normalizes: paper §3.4)."""
    return x if qcfg.fq else rmsnorm(np_, x)


def fold_rmsnorm(norm_p, proj_p):
    """Fold an RMSNorm gain into the following projection's weights (exact:
    W diag(g)) before FQ retraining; re-init the weight quant scale."""
    w = norm_p["scale"][:, None] * proj_p["w"]
    new = dict(proj_p)
    new["w"] = w
    new["s_w"] = init_scale(w)
    return new


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


_FREQS = {}


def rope_freqs(d: int, theta: float, device) -> torch.Tensor:
    """theta^(-2i/d), i < d/2, in float32 as the reference takes them; one
    table per (d, theta, device), kept (a decode step ropes every layer)."""
    key = (d, theta, str(device))
    if key not in _FREQS:
        f32 = dict(dtype=torch.float32, device=device)
        expo = torch.div(-torch.arange(0, d, 2, **f32),
                         torch.tensor(d, **f32))
        _FREQS[key] = torch.pow(torch.tensor(theta, **f32), expo)
    return _FREQS[key]


def rope_tables(positions, d: int, theta: float, dtype, device):
    """(cos, sin) of the angles positions x freqs, (..., T, D/2) in
    ``dtype``: the part of :func:`rope` that depends on the positions
    alone, so that a decode step takes it once for all its layers."""
    freqs = rope_freqs(d, theta, device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., T, D/2)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """Rotate x (..., T, D)'s (even, odd) pairs by the tables."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def rope(x, positions, *, theta: float = 10000.0):
    """x: (..., T, D) with D even; positions: (T,) or broadcastable."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta, x.dtype,
                                      x.device))


def shard_activations(x):
    """(B, T, d) hidden-state constraint: batch over the DP axes."""
    return shd.constrain(x, "batch", None, None)
