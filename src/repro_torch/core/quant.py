"""Learned quantization (paper eq. 1 & 2): the integer-inference subset.

Counterpart of ``repro.core.quant``:

    quantize(x) = round(clip(x, b, 1) * n) / n              (1)
    Q(x)        = e^s * quantize(x / e^s)                   (2)

with ``b`` the clip lower bound (-1 for weights / linear outputs, 0 for
quantized ReLUs) and ``n = 2^(nb-1) - 1`` positive levels for ``nb`` bits.
``torch.round`` rounds half to even, like ``jnp.round``, so codes that sit
exactly on a half-LSB land on the same integer as in the reference.

The training-side helpers (STE, learned_quantize) and the packed weight
formats belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

WEIGHT_BOUND = -1.0  # b for weights / conv outputs / network inputs
RELU_BOUND = 0.0     # b for quantized ReLUs


def n_levels(bits: int) -> int:
    """Number of positive quantization levels, n = 2^(nb-1) - 1 (paper §3.1)."""
    if bits < 2:
        raise ValueError(f"bits must be >= 2 (got {bits}); bits=2 is ternary")
    return 2 ** (bits - 1) - 1


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Bitwidths for one gradual-quantization ladder stage.

    ``None`` means full precision. ``fq`` marks the fully quantized mode in
    which the output quantizer doubles as the nonlinearity.
    """

    bits_w: Optional[int] = None
    bits_a: Optional[int] = None
    bits_out: Optional[int] = None
    fq: bool = False

    @property
    def is_fp(self) -> bool:
        return self.bits_w is None and self.bits_a is None

    def label(self) -> str:
        def f(v):
            return "32" if v is None else str(v)

        base = f"W{f(self.bits_w)}A{f(self.bits_a)}"
        return ("FQ" if self.fq else "Q") + base


def quantize_to_int(x: torch.Tensor, s: torch.Tensor, *, bits: int, b: float,
                    dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Integer codes round(clip(x/e^s, b, 1) * n); real value = e^s / n * code."""
    n = n_levels(bits)
    scale = torch.exp(torch.as_tensor(s, device=x.device)).to(x.dtype)
    return torch.round(torch.clamp(x / scale, b, 1.0) * n).to(dtype)


def dequantize_int(codes: torch.Tensor, s: torch.Tensor, *,
                   bits: int) -> torch.Tensor:
    """Inverse of :func:`quantize_to_int`: e^s * code / n."""
    n = n_levels(bits)
    s = torch.as_tensor(s, device=codes.device)
    return torch.exp(s) * codes.to(torch.float32) / n


def init_scale(x: torch.Tensor) -> torch.Tensor:
    """Log-scale s with e^s covering max|x|.

    The reference's ``percentile`` option is not on the serving path and
    is not ported yet.
    """
    m = torch.max(torch.abs(x.to(torch.float32)))
    return torch.log(torch.clamp(m, min=1e-8))
