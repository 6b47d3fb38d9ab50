"""Noise on the integer path (paper §4.4): counterpart of ``repro.core.noise``.

Models the analog accelerator's non-idealities on an integer stack: noisy
memory cells (weights), DACs (activations) and ADCs (MAC results). Sigma is
a fraction of one LSB, the paper's parameterization, so Table 7's
(sigma_w, sigma_a, sigma_MAC) triples map onto :class:`NoiseConfig`.

  * :func:`perturb_codes` adds Gaussian noise in code units (one code step
    is one LSB), rounds and clips to the quantizer range. Its draws come
    from the reference's keys through :mod:`.prng`; the rounded codes equal
    the reference's except where a normal draw differs by an ulp right at a
    rounding boundary (counted by the tests).
  * :func:`mac_noise_field` is the deterministic counter-hash Gaussian
    field over global output-element indices that the kernels' ADC-noise
    epilogue (K4, ``kernels/csrc/noise.cuh``) evaluates on the card: integer
    hashes and float32 adds in the reference's order, bit-exact on any
    device. ``chunks = K`` models the chunked-accumulation mitigation: K
    per-chunk ADC draws of std sigma / K, summing to std sigma / sqrt(K).

Every uint32 value is held in int64 and masked with ``0xFFFFFFFF``
(PyTorch has no CPU ``>>`` on uint32); a wrapping 32-bit multiply is split
into the constant's 16-bit halves so no partial product reaches 2^63.

The float training path draws its noise with :func:`add_lsb_noise`:
Gaussian on the dequantized tensors, sigma in fractions of the
quantizer's LSB, from the reference's keys.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import prng
from .prng import M32
from .quant import lsb


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """sigma_* as fractions of one LSB (paper's % / 100)."""

    sigma_w: float = 0.0
    sigma_a: float = 0.0
    sigma_mac: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.sigma_w > 0 or self.sigma_a > 0 or self.sigma_mac > 0


# Table 7's five test conditions, (sigma_w, sigma_a, sigma_mac) in % LSB.
TABLE7_CONDITIONS = [
    NoiseConfig(0.01, 0.01, 0.05),
    NoiseConfig(0.05, 0.05, 0.25),
    NoiseConfig(0.10, 0.10, 0.50),
    NoiseConfig(0.20, 0.20, 1.00),
    NoiseConfig(0.30, 0.30, 1.50),
]


def add_lsb_noise(x: torch.Tensor, key: Optional[torch.Tensor], sigma: float,
                  s: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """x + N(0, sigma * LSB), LSB = e^s / n of the given quantizer.

    The draw is ``jax.random.normal(key, x.shape)`` as :mod:`.prng` makes
    it, on x's device. No-op when sigma == 0, key is None, or the tensor is
    full precision (bits is None).
    """
    if sigma <= 0.0 or key is None or bits is None:
        return x
    step = lsb(s, bits).to(x.dtype)
    return x + sigma * step * prng.normal(key.to(x.device), x.shape)


def perturb_codes(codes: torch.Tensor, key: Optional[torch.Tensor],
                  sigma: float, *, lo: int, hi: int) -> torch.Tensor:
    """Code-domain Gaussian noise: clip(round(codes + sigma * g), lo, hi).

    ``g`` is ``jax.random.normal(key, codes.shape)`` as :mod:`.prng` draws
    it, on the codes' device. No-op (nothing drawn) when sigma == 0 or key
    is None.
    """
    if sigma <= 0.0 or key is None:
        return codes
    g = prng.normal(key.to(codes.device), codes.shape)
    y = torch.round(codes.to(torch.float32) + sigma * g)
    return torch.clamp(y, lo, hi).to(codes.dtype)


def derive_seed(key: torch.Tensor) -> torch.Tensor:
    """The uint32 seed of the kernel noise field, ``jax.random.bits(key)``:
    a 0-d ``torch.uint32`` tensor on the key's device."""
    return prng.bits(key).to(torch.uint32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), by c's 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The reference's avalanche mix on uint32 values (int64 tensor)."""
    x = x & M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


_GOLDEN = 0x9E3779B9   # 2^32 / phi, the odd salt constant
_IH_DRAWS = 12         # Irwin-Hall(12): sum of 12 U(0,1) has variance 1


def _seed_u32(seed) -> torch.Tensor:
    """A uint32 seed (tensor of any integer dtype, or int) as int64."""
    return torch.as_tensor(seed).to(torch.int64) & M32


def unit_normal_field(idx: torch.Tensor, seed, salt: int = 0) -> torch.Tensor:
    """Deterministic ~N(0, 1) per element of ``idx`` (uint32 indices held in
    int64): twelve hashed 24-bit uniforms summed in order in float32, then
    x 2^-24 - 6."""
    s = _seed_u32(seed).to(idx.device)
    base = hash_u32((idx & M32) ^ hash_u32((s + ((salt * _GOLDEN) & M32))
                                           & M32))
    u_sum = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for k in range(_IH_DRAWS):
        h = hash_u32((base + (((k + 1) * _GOLDEN) & M32)) & M32)
        u_sum = u_sum + (h >> 8).to(torch.float32)
    return u_sum * 2.0 ** -24 - 6.0


def mac_noise_field(idx: torch.Tensor, seed, sigma: torch.Tensor, *,
                    chunks: int = 1) -> torch.Tensor:
    """ADC noise for the int32 MAC accumulator, in accumulator units:
    (sigma / chunks) * the sum over chunk salts 0 .. chunks-1 of
    :func:`unit_normal_field`, in float32.

    ``sigma`` is a float32 tensor (sigma_mac / rescale); the division is a
    tensor division, correctly rounded like the reference's (PyTorch
    multiplies by a reciprocal when dividing by a Python number).
    """
    if chunks < 1:
        raise ValueError(f"mac_chunks must be >= 1, got {chunks}")
    total = unit_normal_field(idx, seed, salt=0)
    for c in range(1, chunks):
        total = total + unit_normal_field(idx, seed, salt=c)
    sigma = torch.as_tensor(sigma, dtype=torch.float32).to(idx.device)
    return torch.div(sigma, torch.full_like(sigma, chunks)) * total


def output_index(rows: int, cols: int, device=None) -> torch.Tensor:
    """The field's global index ``row * cols + col`` of a (rows, cols)
    output, as the reference computes it: int32 arithmetic that wraps,
    read as uint32 (held in int64)."""
    r = torch.arange(rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    return (r[:, None] * cols + c[None, :]) & M32
